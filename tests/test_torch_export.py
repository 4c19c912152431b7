"""``hygrid_tpu_torch.utils.export`` (``torch.export``) against
``hygrid_tpu.utils.export`` (``jax.export``), and the ``hygrid`` ops that
keep the kernels in an exported program.

* ``hexcnn_tiny`` (GN and the default BN) at 32^2, weights drawn from a
  numpy seed in flax and carried over by ``hexcnn_state_dict_from_flax``:
  the port's saved and reloaded artifact against the reference's
  (``export_inference`` -> ``save_exported`` -> ``load_exported``) within
  1e-4 relative max-abs in float32, and ``torch.equal`` to the port's
  eager model, at a fixed batch; with a symbolic batch at b = 1 and 4
  against the reference's results at those sizes (its own symbolic export
  refuses the GN model);
* the GN graph keeps ``hygrid.plan_gather`` and ``hygrid.hex_conv_layer``
  and no ``aten`` gather (the artifact runs the kernels on the card);
* ``export_fn`` with a symbolic batch at b = 1, 3, 7 against the
  reference's, the shared-leading-dim ``ValueError``, ``exported_info``;
* an export from empty plan caches leaves no FakeTensor in them: an eager
  call after it equals one before;
* each op (``torch.library.opcheck``: schema and fake implementation) at
  tiny sizes, in every table form, and exported alone as one node, its
  loaded program ``torch.equal`` to the eager call at two batch sizes;
* the programs ``chip_smoke.py`` phase 27 exports on the card, at small
  sizes: HexUNet (the split layer), the per-module HexCNN on
  ``hex_conv_single``, the fused pipeline and a frame processor on the
  shift route, each with its ops' nodes and ``torch.equal`` to eager.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from hygrid_tpu import models as jm
from hygrid_tpu.utils import export as jexp
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.kernels import conv_single, conv_stack, pool, resample
from hygrid_tpu_torch.kernels import resample_shift
from hygrid_tpu_torch.models import video
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.utils import export as texp
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax
from hygrid_tpu_torch.viz import render
from test_torch_modules import random_flax_variables

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-4
OPCHECK = ("test_schema", "test_faketensor")


def _rect(seed, b, size=32):
    return np.random.default_rng(seed).random((b, 3, size, size)).astype(
        np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", params=["GN", "BN"])
def tiny(request):
    """(norm, flax model, its variables, port model with the same weights,
    the port's state dict)."""
    kw = {"norm": "GN"} if request.param == "GN" else {}
    model = jm.hexcnn_tiny(num_classes=5, **kw)
    variables = random_flax_variables(
        model, jm.hexify_batch(jnp.asarray(_rect(1, 2))), seed=7)
    state = hexcnn_state_dict_from_flax(variables)
    port = tm.hexcnn_tiny(num_classes=5, device="cpu", **kw)
    port.load_state_dict(state)
    return request.param, model, variables, port.eval(), state


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    """``get(symbolic)`` -> (the exported program, its saved path): ``tiny``'s
    port model with its state dict at a b=2 example, each of the fixed and
    the symbolic batch exported and saved once."""
    _, _, _, port, state = tiny
    made = {}

    def get(symbolic):
        if symbolic not in made:
            exp = texp.export_inference(port, state,
                                        torch.from_numpy(_rect(2, 2)),
                                        symbolic_batch=symbolic)
            path = str(tmp_path_factory.mktemp("artifact") / "port.pt2")
            texp.save_exported(path, exp)
            made[symbolic] = exp, path
        return made[symbolic]
    return get


@pytest.mark.parametrize("symbolic", [False, True])
def test_artifact_matches_reference_artifact(tiny, artifact, symbolic,
                                             tmp_path):
    norm, model, variables, port, state = tiny
    x = _rect(2, 2)
    if symbolic:
        # the reference's symbolic export refuses its GN stack (a shape
        # check on the batch); its results at each batch size instead
        ref_fn = jax.jit(lambda v: model.apply(variables, jm.hexify_batch(v)))
    else:
        jexp.save_exported(str(tmp_path / "ref.jaxexp"), jexp.export_inference(
            model, variables, jnp.asarray(x)))
        ref_fn = jexp.load_exported(str(tmp_path / "ref.jaxexp"))
    exp, path = artifact(symbolic)
    fn = texp.load_exported(path)
    for b in ((1, 4) if symbolic else (2,)):
        xb = _rect(10 + b, b)
        got = fn(torch.from_numpy(xb))
        want = np.asarray(ref_fn(jnp.asarray(xb)))
        assert got.shape == want.shape == (b, 5)
        assert _rel(got.numpy(), want) <= REL
        with torch.no_grad():
            eager = port(tm.hexify_batch(torch.from_numpy(xb)))
        assert torch.equal(got, eager)
    targets = {n.target for n in exp.program.graph.nodes
               if n.op == "call_function"}
    assert torch.ops.hygrid.plan_gather.default in targets
    # the plain gather-blend would show as an index_select
    assert torch.ops.aten.index_select.default not in targets
    if norm == "GN":
        assert torch.ops.hygrid.hex_conv_layer.default in targets


def test_export_fn_symbolic_batch_matches_reference(tmp_path):
    def port_pipe(x):
        return torch.sum(tm.hexify_batch(x), dim=(1, 2, 3))

    def ref_pipe(x):
        return jnp.sum(jm.hexify_batch(x), axis=(1, 2, 3))

    x1 = _rect(3, 1, 16)
    texp.save_exported(str(tmp_path / "sym.pt2"), texp.export_fn(
        port_pipe, (torch.from_numpy(x1),), symbolic_batch=True))
    fn = texp.load_exported(str(tmp_path / "sym.pt2"))
    ref_fn = jexp.export_fn(ref_pipe, (jnp.asarray(x1),),
                            symbolic_batch=True).call
    for b in (1, 3, 7):
        xb = _rect(b, b, 16)
        got = fn(torch.from_numpy(xb))
        assert torch.equal(got, port_pipe(torch.from_numpy(xb)))
        assert _rel(got.numpy(), np.asarray(ref_fn(jnp.asarray(xb)))) <= REL


def test_symbolic_batch_requires_shared_leading_dim():
    with pytest.raises(ValueError, match="shared leading dim"):
        texp.export_fn(lambda a, b: a, (torch.zeros(2, 3), torch.zeros(4, 3)),
                       symbolic_batch=True)


@pytest.mark.parametrize("symbolic", [False, True])
def test_exported_info(artifact, symbolic):
    _, path = artifact(symbolic)
    info = texp.exported_info(path)
    lead = "b" if symbolic else "2"
    assert info["platforms"] == ["cpu"]
    assert f"{lead},3,32,32" in info["in_avals"][0].replace(" ", "")
    assert info["out_avals"] == [f"float32[{lead},5]"]
    assert info["nr_devices"] == 1
    # the artifact carries no copy of the example input
    assert torch.export.load(path).example_inputs is None


def test_load_exported_moves_only_to_its_platforms(tiny, artifact):
    _, _, _, port, _ = tiny
    x = torch.from_numpy(_rect(5, 2))
    _, path = artifact(False)
    with pytest.raises(ValueError, match="exported for"):
        texp.load_exported(path, device="meta")
    with torch.no_grad():
        want = port(tm.hexify_batch(x))
    assert torch.equal(texp.load_exported(path, device="cpu")(x), want)


def _fakes(obj):
    """The FakeTensors among a plan cache entry's device copies."""
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _fakes(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _fakes(v)]
    if hasattr(obj, "_device_copies"):
        return _fakes(obj._device_copies)
    return [obj] if isinstance(obj, FakeTensor) else []


def test_export_leaves_no_fake_tensor_in_the_caches(tiny):
    _, _, _, port, _ = tiny
    x = torch.from_numpy(_rect(6, 1))
    tgeo._PLAN_CACHE.clear()
    with torch.no_grad():
        before = port(tm.hexify_batch(x))
    tgeo._PLAN_CACHE.clear()
    texp.export_inference(port, None, x, symbolic_batch=True)
    plans = list(tgeo._PLAN_CACHE.values())
    assert plans
    assert not [t for p in plans
                for t in _fakes([p._device_copies, p._derived])]
    with torch.no_grad():
        assert torch.equal(port(tm.hexify_batch(x)), before)


# --- the ops -------------------------------------------------------------

H = np.array([[1.2, 0.1, 0.0], [-0.1, 0.9, 0.0], [0.0, 0.0, 1.0]])
# plan_gather's table forms: name -> (plan, its index / weight form)
GATHER = {
    "parity-factored": (lambda: tgeo.rect_to_hex_plan(16, 20, 8, 10,
                                                      "bilinear"),
                        ("parity", "factored")),
    "parity-select": (lambda: tgeo.rect_to_hex_plan(16, 20, 8, 10,
                                                    "nearest"),
                      ("parity", "pixel")),
    "rows": (lambda: tgeo.hex_to_rect_plan(8, 10, 16, 20, "linear"),
             ("rows", "pixel")),
    "dense": (lambda: tgeo.warp_plan(12, 14, H, "linear"),
              ("dense", "pixel")),
}
# shift_resample's weight-table forms: name -> plan
SHIFT = {
    "phase": lambda: tgeo.rect_to_hex_plan(16, 20, 8, 10, "bilinear"),
    "select": lambda: render._mosaic_sample_plan(17, 30, 68, 120, 0, None),
    "dense": lambda: tgeo.hex_to_rect_plan(70, 8, 150, 8, "linear"),
}


def _randn(seed, *shape, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _layer_args(kind, split, dtype=torch.float32):
    """``hygrid::hex_conv_layer``'s arguments: b=2, 6x7 hex, 3 (+2 split)
    -> 8 channels, radius 2."""
    x = _randn(1, 2, 6, 7, 3, dtype=dtype)
    x2 = _randn(2, 2, 6, 7, 2, dtype=dtype) if split else None
    k = _randn(3, 8, 5 if split else 3, 7, dtype=dtype) * 0.3
    p, q = (_randn(4, 8) + 1, _randn(5, 8)) if kind else (None, None)
    return (x, x2, k, _randn(6, 8), p, q, 2, 1, kind, 4 if kind == "gn"
            else 0, True, kind == "affine")


OP_CASES = {
    **{f"plan_gather-{name}-{dt}": (
        lambda plan=plan, dt=dt: resample._op_args(
            _randn(7, 2, 3, *plan().src_shape, dtype=dt), plan()))
       for name, (plan, _) in GATHER.items()
       for dt in (torch.float32, torch.bfloat16)},
    **{f"shift_resample-{name}": (
        lambda plan=plan: (lambda p: (
            _randn(8, 2, *p.src_shape), *resample_shift._op_args(
                p, resample_shift.shift_decompose_cached(p), "cpu")))(plan()))
       for name, plan in SHIFT.items()},
    **{f"hex_conv_single-parity{par}": (
        lambda par=par: (_randn(9, 2, 3, 10, 12), _randn(10, 4, 3, 7), par,
                         2, 1)) for par in (0, 1)},
    **{f"hex_conv_layer-{kind}{'-split' if split else ''}": (
        lambda kind=kind, split=split: _layer_args(kind, split))
       for kind in ("gn", "affine", None) for split in (False, True)},
    "hex_conv_layer-gn-bf16": lambda: _layer_args("gn", False,
                                                  torch.bfloat16),
    "hex_conv_fused_stack": lambda: (
        _randn(11, 2, 6, 7, 4), [_randn(12, 4, 4, 7), _randn(13, 4, 4, 7)],
        [_randn(14, 4), None], 2, 1, [True, False]),
    **{f"hex_max_pool-{tag}-{'mask' if mask else 'values'}": (
        lambda dt=dt, mask=mask: (_randn(15, 2, 7, 9, 4, dtype=dt), 2, 2, 2,
                                  2, mask))
       for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
       for mask in (False, True)},
    **{f"hex_max_pool_backward-{tag}": (
        lambda dt=dt: (_randn(16, 2, 3, 4, 4, dtype=dt),
                       torch.ops.hygrid.hex_max_pool(
                           _randn(15, 2, 7, 9, 4, dtype=dt), 2, 2, 2, 2,
                           True)[1], 7, 9, 2, 2, 2, 2))
       for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))},
}


@pytest.mark.parametrize("name", list(OP_CASES))
def test_opcheck(name):
    op = getattr(torch.ops.hygrid, name.split("-")[0]).default
    torch.library.opcheck(op, OP_CASES[name](), test_utils=OPCHECK)


@pytest.mark.parametrize("name", list(GATHER))
def test_gather_forms(name):
    """The op-check cases reach every table form the kernel reads."""
    plan, forms = GATHER[name]
    tables = resample.gather_tables_cached(plan(), 4)
    assert (tables.index_form, tables.weight_form) == forms


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("name", list(GATHER))
def test_dense_plan_is_the_plan(name, esz):
    """plan_gather's CPU implementation reads the plan back from the op's
    table tensors, bit for bit (``GatherTables.expand``'s torch twin)."""
    plan = GATHER[name][0]()
    tables = resample.gather_tables(plan, esz)
    tabs = tables.tensors("cpu")
    k, h1, w1, _, w = tables.shape
    idx, weights = resample.dense_plan(
        *(tabs[n] for n in ("idx", "dk", "weights", "rowf", "colf",
                            "rowbase", "tile_col_lo")),
        w, h1, w1, esz, tables.index_form, tables.weight_form)
    np.testing.assert_array_equal(idx.numpy(), plan.idx.reshape(k, -1))
    np.testing.assert_array_equal(weights.numpy().view(np.uint32),
                                  plan.weights.reshape(k, -1).view(np.uint32))


def test_shift_forms():
    assert [resample_shift.shift_decompose_cached(p()).form
            for p in SHIFT.values()] == list(SHIFT)


# one small program for each op: (op, fn(close_over, *xs) or fn(*xs)
# without close_over, close_over, example inputs from a batch size)
KS = [_randn(30 + i, 4, 4, 7) * 0.3 for i in range(3)]
SINGLE = {
    "plan_gather-h2r": (
        "plan_gather", lambda x: tgeo.hex_to_rect_resample(
            x, (16, 20), "linear"), None,
        lambda b: (_randn(40, b, 3, 8, 10),)),
    "shift_resample": (
        "shift_resample",
        lambda x: resample_shift.shift_resample(x, SHIFT["phase"]()),
        None, lambda b: (_randn(41, b, 3, 16, 20),)),
    "hex_conv_single": (
        "hex_conv_single", lambda c, x: conv_single.hex_conv_single(
            x, c, radius=2, padding=1), KS[0],
        lambda b: (_randn(42, b, 4, 10, 12),)),
    "hex_conv_layer-split": (
        "hex_conv_layer", lambda c, a, x: conv_stack.hex_conv_stack(
            a, [c[0]], radius=2, norms=[("gn", 2, *c[1:])], extra_input=x,
            data_format="NHWC"),
        (_randn(43, 4, 6, 7) * 0.3, _randn(20, 4) + 1, _randn(21, 4)),
        lambda b: (_randn(44, b, 6, 7, 2), _randn(45, b, 6, 7, 4))),
    "hex_conv_fused_stack": (
        "hex_conv_fused_stack", lambda c, x: conv_stack.hex_conv_stack(
            x, c, radius=2, fused=True), KS,
        lambda b: (_randn(46, b, 4, 6, 7),)),
    "hex_max_pool": (
        "hex_max_pool", lambda x: pool.hex_max_pool(x, (2, 2), (2, 2)), None,
        lambda b: (_randn(47, b, 7, 9, 4),)),
}


@pytest.mark.parametrize("name", list(SINGLE))
def test_op_exports_as_one_node(name, tmp_path):
    op, fn, const, inputs = SINGLE[name]
    exp = texp.export_fn(fn, inputs(2), close_over=const,
                         symbolic_batch=True)
    nodes = [n for n in exp.program.graph.nodes if n.op == "call_function"
             and n.target == getattr(torch.ops.hygrid, op).default]
    assert len(nodes) == 1
    texp.save_exported(str(tmp_path / "op.pt2"), exp)
    loaded = texp.load_exported(str(tmp_path / "op.pt2"))
    for b in (1, 3):
        xs = inputs(b)
        with torch.no_grad():
            want = fn(*xs) if const is None else fn(const, *xs)
        assert torch.equal(loaded(*xs), want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def programs():
    """chip_smoke phase 27's programs at small sizes on the CPU: name ->
    (fn(x), example input from a batch size, hygrid op -> nodes)."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(27)
    unet = tm.HexUNet(num_classes=4, widths=(8, 16, 32), device="cpu",
                      generator=gen).eval()
    bn = smoke.build_permodule_hexcnn(device="cpu", generator=gen).eval()
    pipe, _ = smoke.build_pipeline((32, 32), 4, 2, 2, torch.float32,
                                   fused=True, device="cpu")
    proc = video.make_frame_processor(8, 1280, device="cpu")
    return {
        "hexunet": (lambda x: unet(tm.hexify_batch(x)),
                    lambda b: _rect(50 + b, b),
                    {"plan_gather": 1, "hex_conv_layer": 3,
                     "hex_conv_layer_split": 2}),
        "permodule-bn": (lambda x: bn(tm.hexify_batch(x)),
                         lambda b: _rect(60 + b, b),
                         {"plan_gather": 1, "hex_conv_single": 5}),
        "pipeline-fused": (pipe, lambda b: _rect(70 + b, b),
                           {"plan_gather": 2, "hex_conv_fused_stack": 1}),
        "frame-720p-route": (proc, lambda b: np.random.default_rng(80).random(
            (3, 8, 1280)).astype(np.float32), {"shift_resample": 1}),
    }


@pytest.mark.parametrize("name", ["hexunet", "permodule-bn",
                                  "pipeline-fused", "frame-720p-route"])
def test_chip_phase_programs_export(programs, name, tmp_path):
    fn, example, ops = programs[name]
    symbolic = name != "frame-720p-route"
    exp = texp.export_fn(fn, (torch.from_numpy(example(2)),),
                         symbolic_batch=symbolic)
    counts = {}
    for n in exp.program.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith("hygrid."):
            op = str(n.target).split(".")[1]
            if op == "hex_conv_layer" and n.args[1] is not None:
                op = "hex_conv_layer_split"
            counts[op] = counts.get(op, 0) + 1
    assert counts == ops
    texp.save_exported(str(tmp_path / "p.pt2"), exp)
    loaded = texp.load_exported(str(tmp_path / "p.pt2"))
    for b in ((1, 3) if symbolic else (2,)):
        x = torch.from_numpy(example(b))
        with torch.no_grad():
            assert torch.equal(loaded(x), fn(x))
