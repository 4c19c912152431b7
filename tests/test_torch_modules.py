"""The port's per-module conv route against hygrid_tpu: ``HexConvModule``
for every norm, activation, order, padding layer and spectral norm (eval,
and train with the ``batch_stats`` update), the conv layers, the pool
classes, the cfg builders and ``HexConvStack``'s per-op chain.  Flax
variables drawn from numpy seeds are carried by the converter; the flax
side runs under ``jax.jit``.  Float32; within 1e-5 absolute (outputs are
O(1); only summation orders differ)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.nn import layers as JL
from hygrid_tpu.nn import modules as JM
from hygrid_tpu_torch.nn import layers as TL
from hygrid_tpu_torch.nn import modules as TM
from hygrid_tpu_torch.utils import hexconvmodule_state_dict_from_flax

TOL = 1e-5
CIN, COUT = 4, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_flax_variables(module, x, seed, **init_kw):
    """Flax variables of ``module`` on input ``x``, drawn from a numpy seed.
    ``jax.eval_shape`` gives the tree without running flax's init: kernels
    normal with std 1/sqrt(fan-in) (conv ``(O, I, kn)``, Dense ``(in,
    out)``), norm scales and spectral sigmas near 1, BN variances in
    [0.5, 1.5), PReLU slopes near 0.25, everything else (biases, BN means,
    spectral ``u``) normal, so that no norm is the identity."""
    shapes = jax.eval_shape(functools.partial(module.init, **init_kw),
                            jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key).rsplit("/", 1)[-1]
        shape = leaf.shape
        if name == "kernel":
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            value = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif name == "var":
            value = 0.5 + rng.random(shape)
        elif name in ("scale", "sigma"):
            value = 1 + rng.normal(0, 0.1, shape)
        elif name == "negative_slope":
            value = 0.25 + rng.normal(0, 0.05, shape)
        else:
            value = rng.normal(0, 0.3, shape)
        return np.asarray(value, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# (id, HexConvModule kwargs): every norm, activation, order and padding
# layer, spectral norm, and the per-module kernel route
CONFIGS = [
    ("plain-relu", dict()),
    ("bn", dict(norm_cfg=dict(type="BN"))),
    ("syncbn-leaky", dict(norm_cfg=dict(type="SyncBN"),
                          act_cfg=dict(type="LeakyReLU", negative_slope=0.2))),
    ("bn-noaffine-momentum", dict(norm_cfg=dict(type="BN", affine=False,
                                                momentum=0.8, eps=1e-3))),
    ("gn-prelu", dict(norm_cfg=dict(type="GN", num_groups=4),
                      act_cfg=dict(type="PReLU"))),
    ("ln-gelu", dict(norm_cfg=dict(type="LN"), act_cfg=dict(type="GELU"))),
    ("in-hsigmoid", dict(norm_cfg=dict(type="IN"),
                         act_cfg=dict(type="HSigmoid"))),
    ("gn-bias-on", dict(norm_cfg=dict(type="GN", num_groups=3), bias=True)),
    ("order-norm-conv-act", dict(norm_cfg=dict(type="BN"),
                                 order=("norm", "conv", "act"))),
    ("order-act-conv-norm", dict(norm_cfg=dict(type="GN", num_groups=2),
                                 act_cfg=dict(type="ELU"),
                                 order=("act", "conv", "norm"))),
    ("pad-reflect-tanh", dict(padding_mode="reflect",
                              act_cfg=dict(type="Tanh"))),
    ("pad-replicate-sigmoid", dict(padding_mode="replicate",
                                   act_cfg=dict(type="Sigmoid"))),
    ("pad-zero-relu6", dict(padding_mode="zero", act_cfg=dict(type="ReLU6"))),
    ("pad-circular-swish", dict(padding_mode="circular",
                                act_cfg=dict(type="Swish"))),
    ("spectral-silu", dict(with_spectral_norm=True,
                           act_cfg=dict(type="SiLU"))),
    ("spectral-bn", dict(with_spectral_norm=True, norm_cfg=dict(type="BN"))),
    ("pallas-bn", dict(conv_cfg=dict(type="HexConv2d", impl="pallas"),
                       norm_cfg=dict(type="BN"))),
    ("adaptive-noact", dict(conv_cfg=dict(type="HexConv2dAdaptivePadding"),
                            act_cfg=None)),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_hexconvmodule_matches_jax(name, kw, train):
    seed = len(name)
    offset = seed % 2
    x = np.random.default_rng(seed).normal(
        0, 1, (2, CIN, 9, 11)).astype(np.float32)
    jmod = JM.HexConvModule(in_channels=CIN, out_channels=COUT,
                            even_odd_offset=offset, hexkernel_radius=2,
                            padding=1, **kw)
    variables = random_flax_variables(jmod, jnp.asarray(x), seed)
    run = (functools.partial(jmod.apply, train=True, mutable=["batch_stats"])
           if train else jmod.apply)
    # the interpreted Pallas kernel runs faster eagerly than under jit
    out = (run if "conv_cfg" in kw else jax.jit(run))(variables, x)
    want, updates = out if train else (out, None)
    tmod = TM.HexConvModule(CIN, COUT, offset, 2, padding=1, device="cpu",
                            **kw)
    tmod.load_state_dict(hexconvmodule_state_dict_from_flax(variables))
    with torch.no_grad():
        got = tmod(_t(x), train=train)
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL
    if train and "batch_stats" in variables:
        after = hexconvmodule_state_dict_from_flax(
            {"params": variables["params"],
             "batch_stats": _np(updates["batch_stats"])})
        state = tmod.state_dict()
        stats = [k for k in after if "running" in k or k.endswith(
            ("_u", "_sigma"))]
        assert stats
        for key in stats:
            assert float((state[key] - after[key]).abs().max()) <= TOL, key


def test_forward_flags_skip_norm_and_activation():
    x = np.random.default_rng(0).normal(0, 1, (2, CIN, 9, 11)).astype(
        np.float32)
    kw = dict(norm_cfg=dict(type="BN"), act_cfg=dict(type="GELU"))
    jmod = JM.HexConvModule(in_channels=CIN, out_channels=COUT,
                            even_odd_offset=0, hexkernel_radius=2, **kw)
    variables = random_flax_variables(jmod, jnp.asarray(x), 0)
    tmod = TM.HexConvModule(CIN, COUT, 0, 2, device="cpu", **kw)
    tmod.load_state_dict(hexconvmodule_state_dict_from_flax(variables))
    for flags in (dict(activate=False), dict(norm=False),
                  dict(activate=False, norm=False)):
        want = np.asarray(jax.jit(functools.partial(jmod.apply, **flags))(
            variables, x))
        with torch.no_grad():
            got = tmod(_t(x), **flags).numpy()
        assert float(np.abs(got - want).max()) <= TOL, flags


def test_module_tree_maps_one_to_one():
    """Every torch parameter and buffer has a flax counterpart, and the
    names are flax's (``stage``-free single bundle)."""
    for kw in (dict(norm_cfg=dict(type="BN"), with_spectral_norm=True),
               dict(norm_cfg=dict(type="IN"), act_cfg=dict(type="PReLU"))):
        jmod = JM.HexConvModule(in_channels=CIN, out_channels=COUT,
                                even_odd_offset=0, hexkernel_radius=2, **kw)
        variables = random_flax_variables(jmod, jnp.zeros((1, CIN, 8, 8)),
                                          0)
        tmod = TM.HexConvModule(CIN, COUT, 0, 2, device="cpu", **kw)
        assert sorted(hexconvmodule_state_dict_from_flax(variables)) == \
            sorted(tmod.state_dict())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("cls", ["HexConv2d", "HexConv2dAdaptivePadding"])
def test_conv_layers_match_jax(cls, dtype):
    rng = np.random.default_rng(len(cls))
    x = rng.random((2, CIN, 10, 9)).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    kw = dict(stride=1, padding=1, dilation=1)
    jl = getattr(JL, cls)(in_channels=CIN, out_channels=COUT,
                          even_odd_offset=1, hexkernel_radius=2, dtype=jdt,
                          **kw)
    params = random_flax_variables(jl, jnp.asarray(x), 1)
    want = np.asarray(jax.jit(jl.apply)(params, x))
    tl = getattr(TL, cls)(CIN, COUT, 1, 2, dtype=tdt, device="cpu", **kw)
    tl.load_state_dict({k: _t(v) for k, v in params["params"].items()})
    with torch.no_grad():
        got = tl(_t(x))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = TOL if want.dtype == np.float32 else 2e-2
    assert float(np.abs(got.float().numpy() - want.astype(np.float32)).max()
                 ) <= tol * max(1.0, float(np.abs(want).max()))


def test_conv_layer_init_and_checks():
    gen = torch.Generator().manual_seed(0)
    layer = TL.HexConv2d(6, 4, 0, 3, groups=2, device="cpu", generator=gen)
    assert tuple(layer.kernel.shape) == (4, 3, 19)
    bound = 1 / np.sqrt(3 * 19)
    assert float(layer.kernel.detach().abs().max()) <= bound
    assert layer.kernelnum == 19 and layer.out_even_odd_offset == 0
    assert TL.HexConv2d(4, 4, 0, 2, use_bias=False, device="cpu").bias is None
    with pytest.raises(ValueError, match="divisible"):
        TL.HexConv2d(5, 4, 0, 2, groups=2, device="cpu")


@pytest.mark.parametrize("kw", [dict(kernel_size=2, stride=2),
                                dict(kernel_size=3, stride=2, padding=1),
                                dict(kernel_size=2, ceil_mode=True)])
@pytest.mark.parametrize("method", ["max", "average"])
def test_pool_classes_match_jax(method, kw):
    x = np.random.default_rng(2).random((2, 3, 13, 12)).astype(np.float32)
    for jcls, tcls, args in ((JL.HexPool2d, TL.HexPool2d, (method,)),
                             (JL.HexAdaptivePool2d, TL.HexAdaptivePool2d,
                              ((4, 3), method)),
                             (JL.HexGlobalPool2d, TL.HexGlobalPool2d,
                              (method,))):
        kwargs = kw if jcls is JL.HexPool2d else {}
        want = np.asarray(jax.jit(jcls(*args, **kwargs))(x))
        got = tcls(*args, **kwargs)(_t(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_builders_follow_the_reference():
    conv = TM.build_hexconv_layer(dict(type="HexConv2d", impl="pallas"),
                                  CIN, COUT, 1, 2, bias=False, device="cpu")
    assert isinstance(conv, TL.HexConv2d) and conv.bias is None
    assert conv.impl == "pallas" and conv.even_odd_offset == 1
    assert isinstance(TM.build_hexconv_layer(None, CIN, COUT, 0, 2,
                                             device="cpu"), TL.HexConv2d)
    assert set(TM.CONV_LAYERS) >= {"HexConv2d", "HexConv2dAdaptivePadding",
                                   "HexConvStack"}
    for name in ("BN", "SyncBN", "GN", "LN", "IN"):
        tname, _ = TM.build_hexnorm_layer(dict(type=name), 8, postfix=1,
                                          device="cpu")
        jname, _ = JM.build_hexnorm_layer(dict(type=name), 8, postfix=1)
        assert tname == jname
    for build, cfg in ((TM.build_hexconv_layer, dict(type="Nope")),
                       (TM.build_hexnorm_layer, dict(type="Nope")),
                       (TM.build_hexactivation_layer, dict(type="Nope")),
                       (TM.build_hexpadding_layer, dict(type="Nope"))):
        with pytest.raises(KeyError):
            build(cfg, 8) if build is not TM.build_hexactivation_layer \
                else build(cfg)
    with pytest.raises(TypeError):
        TM.build_hexnorm_layer("BN", 8)

    @TM.register_conv_layer("MyConv")
    class MyConv(TL.HexConv2d):
        pass

    try:
        assert isinstance(TM.build_hexconv_layer(dict(type="MyConv"), 2, 2, 0,
                                                 2, device="cpu"), MyConv)
    finally:
        del TM.CONV_LAYERS["MyConv"]


def test_hexconvstack_offset_1_matches_jax():
    """An odd input offset runs the reference's per-op chain
    (hex_conv2d(impl="auto") + GN + ReLU) in both packages."""
    xin = np.random.default_rng(5).random((2, 3, 10, 9)).astype(np.float32)
    jstack = JL.HexConvStack(in_channels=3, width=8, depth=2,
                             even_odd_offset=1, norm="GN", num_groups=4)
    params = random_flax_variables(jstack, jnp.asarray(xin), 2)
    want = np.asarray(jax.jit(jstack.apply)(params, xin))
    tstack = TL.HexConvStack(3, 8, 2, even_odd_offset=1, norm="GN",
                             num_groups=4, device="cpu")
    tstack.load_state_dict({k: _t(v) for k, v in params["params"].items()})
    with torch.no_grad():
        got = tstack(_t(xin))
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * np.abs(
        want).max()
