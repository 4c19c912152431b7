"""Gloo worlds for the port's ``parallel`` tests, on the CPU.

:func:`run_world` spawns ``world`` processes (the ``spawn`` context; a
``file://`` rendezvous in a fresh temporary directory, so concurrent test
workers never share a port), each of which initialises a gloo process
group with a 60 s timeout, runs one of this module's world functions on
its rank and returns its results (numpy arrays and plain values) to the
parent through a queue.  A rank that raises, hangs or dies fails the call
within ``timeout`` seconds; every process is joined or killed before it
returns.  The world functions import torch and the port only: the JAX
reference runs in the test process, on the same numpy inputs.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np

WORLD_TIMEOUT_S = 150


def run_world(name: str, world: int, payload=None,
              timeout: float = WORLD_TIMEOUT_S):
    """Run world function ``name`` on ``world`` gloo ranks; returns the
    list of each rank's result."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = [None] * world
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rendezvous")
        q = ctx.Queue()
        procs = [ctx.Process(target=_entry,
                             args=(name, rank, world, init, tmp, payload, q),
                             daemon=True)
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        errors = []
        try:
            got = 0
            while got < world and not errors:
                try:
                    rank, ok, value = q.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result within {timeout} s")
                    continue
                got += 1
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5)
                       if not errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        if errors:
            raise RuntimeError(f"world {name} failed\n" + "\n".join(errors))
        assert all(not p.is_alive() for p in procs)
    return results


def _entry(name, rank, world, init, tmp, payload, q):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            out = globals()[name](rank, tmp, payload)
            q.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        q.put((rank, False, traceback.format_exc()))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _raises(fn):
    """The name of the exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # the test checks the type by name
        return type(e).__name__
    return None


# ---------------------------------------------------------------------------
# inputs, made from seeds: the same arrays in the ranks and the test


def halo_input():
    return np.arange(32.0, dtype=np.float32).reshape(1, 1, 32, 1)


def halo_weights():
    return np.random.default_rng(5).normal(
        size=(4, 1, 1, 12, 1)).astype(np.float32)


CONV_CASES = {   # name -> (seed, x shape, cout, radius, offset, mesh, size?)
    "sp4_r2_o0": (3, (2, 3, 32, 20), 5, 2, 0, {"sp": 4}),
    "sp4_r3_o1": (3, (2, 3, 32, 20), 5, 3, 1, {"sp": 4}),
    "mesh2x2": (9, (2, 3, 36, 42), 5, 2, 0, {"spr": 2, "spc": 2}),
    "sp4_rows30": (4, (1, 3, 30, 16), 3, 2, 0, {"sp": 4}),
}


def conv_input(case):
    seed, shape, cout, radius, _, _ = CONV_CASES[case]
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(cout, shape[1], hex_kernel_num(radius))).astype(
        np.float32)
    k2 = rng.normal(size=(cout, cout, hex_kernel_num(radius))).astype(
        np.float32) * 0.3
    return x, k, k2


RESAMPLE_CASES = {  # name -> (seed, kind, dsize, interp, shape, mesh, axes)
    "r2h_bilinear": (11, "rect_to_hex", (32, 24), "bilinear", (2, 3, 64, 48),
                     {"sp": 4}, ("sp", None)),
    "r2h_nearest": (12, "rect_to_hex", (32, 24), "nearest", (2, 3, 64, 48),
                    {"sp": 4}, ("sp", None)),
    "hexresize": (13, "hexresize", (48, 36), "linear", (2, 3, 64, 48),
                  {"sp": 4}, ("sp", None)),
    "h2r": (14, "hex_to_rect", (64, 48), "linear", (1, 3, 32, 24),
            {"sp": 4}, ("sp", None)),
    "nondividing": (4, "hexresize", (20, 16), "linear", (1, 3, 30, 16),
                    {"sp": 4}, ("sp", None)),
    "parity_sp2": (1, "rect_to_hex", (18, 12), "bilinear", (1, 3, 36, 24),
                   {"dp": 2, "sp": 2}, ("sp", None)),
    "2d_r2h": (21, "rect_to_hex", (32, 24), "bilinear", (2, 3, 64, 48),
               {"spr": 2, "spc": 2}, ("spr", "spc")),
    "2d_hexresize": (22, "hexresize", (46, 34), "linear", (1, 3, 62, 46),
                     {"spr": 2, "spc": 2}, ("spr", "spc")),
    "2d_h2r": (23, "hex_to_rect", (64, 48), "linear", (1, 3, 32, 24),
               {"spr": 2, "spc": 2}, ("spr", "spc")),
}


def resample_input(case):
    seed, _, _, _, shape, _, _ = RESAMPLE_CASES[case]
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def pipeline_stack(L=8, C=4, r=2, seed=0):
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    rng = np.random.default_rng(seed)
    ks = rng.normal(0, 0.3, (L, C, C, hex_kernel_num(r))).astype(np.float32)
    x = rng.normal(size=(8, C, 12, 12)).astype(np.float32)
    return ks, x, r


def generic_stages():
    rng = np.random.default_rng(3)
    stages = [{"w": rng.normal(0, 0.5, (6, 6)).astype(np.float32),
               "b": rng.normal(size=(6,)).astype(np.float32)}
              for _ in range(4)]
    x = rng.normal(size=(8, 6)).astype(np.float32)
    return stages, x


def census_input():
    rng = np.random.default_rng(0)
    x = rng.random((1, 3, 64, 64)).astype(np.float32)
    kerns = [(rng.random((3, 3, 7)) * 0.1).astype(np.float32)
             for _ in range(4)]
    return x, kerns


# ---------------------------------------------------------------------------
# world functions: (rank, tmp dir, payload) -> this rank's results


def parallel_world(rank, tmp, payload):
    """Every case of the spatial and pipeline tests, on 4 ranks."""
    import torch
    from hygrid_tpu_torch import parallel
    from hygrid_tpu_torch.nn import functional as F
    from hygrid_tpu_torch.ops import geometry
    from hygrid_tpu_torch.parallel import _comm, spatial

    out = {}
    sp4 = parallel.create_mesh({"sp": 4})
    spec4 = parallel.spatial_spec(sp4)

    # halo exchange, and its gradient
    x = parallel.shard_batch(halo_input(), sp4, spec4, device="cpu")
    x.requires_grad_(True)
    y = parallel.halo_exchange(x, 2, 2, sp4.group("sp"))
    (y * torch.from_numpy(halo_weights()[rank])).sum().backward()
    out["halo"], out["halo_grad"] = _np(y), _np(x.grad)

    # sharded hex conv
    meshes = {"sp4": sp4, "2x2": parallel.create_mesh({"spr": 2, "spc": 2})}
    for case, (_, shape, _, radius, offset, axes) in CONV_CASES.items():
        xg, k, k2 = conv_input(case)
        mesh = meshes["2x2" if "spr" in axes else "sp4"]
        names = list(axes)
        kw = dict(axis_name=names[0],
                  col_axis_name=names[1] if len(names) > 1 else None)
        spec = parallel.P(None, None, names[0], kw["col_axis_name"])
        xs = parallel.shard_batch(xg, mesh, spec, device="cpu")
        size = shape[-2:]
        h = parallel.sharded_hex_conv2d(
            xs, torch.from_numpy(k), mesh, even_odd_offset=offset,
            radius=radius, size=size, **kw)
        out[f"conv_{case}"] = _np(h)
        if case == "sp4_rows30":   # a second layer reads the zeroed rows
            out[f"conv_{case}_chain"] = _np(parallel.sharded_hex_conv2d(
                h, torch.from_numpy(k2), mesh, radius=radius, size=size,
                **kw))

    # sharded resample
    meshes["dp2sp2"] = parallel.create_mesh({"dp": 2, "sp": 2})
    for case, (_, kind, dsize, interp, shape, axes, names) in \
            RESAMPLE_CASES.items():
        mesh = (meshes["2x2"] if "spr" in axes else
                meshes["dp2sp2"] if "dp" in axes else sp4)
        spec = parallel.P(None, None, names[0], names[1])
        xs = parallel.shard_batch(resample_input(case), mesh, spec,
                                  device="cpu")
        got = parallel.sharded_resample(
            xs, mesh, kind, dsize, interp, axis_name=names[0],
            col_axis_name=names[1], size=shape[-2:])
        out[f"resample_{case}"] = _np(got)
        nr = mesh.shape[names[0]]
        nc = mesh.shape[names[1]] if names[1] else 1
        out[f"groups_{case}"] = len(spatial.shard_plans(
            kind, shape[-2:], dsize, interp, nr, nc).plans)
    # the canonical lift, bit-equal to the port's monolithic plan
    xg = resample_input("r2h_nearest")
    out["monolithic_r2h_nearest"] = _np(geometry.rect_to_hex_resample(
        torch.from_numpy(xg), (32, 24), "nearest"))
    # the errors: more shard patterns than max_groups (odd output slabs
    # alternate the hex parity: two patterns), halos beyond a slab
    xs = parallel.shard_batch(resample_input("parity_sp2"), meshes["dp2sp2"],
                              parallel.P(None, None, "sp", None),
                              device="cpu")
    out["err_max_groups"] = _raises(lambda: parallel.sharded_resample(
        xs, meshes["dp2sp2"], "rect_to_hex", (18, 12), "bilinear",
        max_groups=1, size=(36, 24)))
    xs = parallel.shard_batch(np.zeros((1, 3, 64, 48), np.float32), sp4,
                              spec4, device="cpu")
    out["err_halo"] = _raises(lambda: parallel.sharded_resample(
        xs, sp4, "hexresize", (5, 4), "linear", size=(64, 48)))

    # the halo path's collectives: a resample, 4 convs, a resample back
    xg, kerns = census_input()
    _comm.reset_counts()
    h = parallel.sharded_resample(
        parallel.shard_batch(xg, sp4, spec4, device="cpu"), sp4,
        "rect_to_hex", (32, 64), "bilinear", size=(64, 64))
    for k in kerns:
        h = parallel.sharded_hex_conv2d(h, torch.from_numpy(k), sp4,
                                        radius=2, size=(32, 64))
    h = parallel.sharded_resample(h, sp4, "hex_to_rect", (64, 64), "linear",
                                  size=(32, 64))
    out["census"] = dict(_comm.COUNTS)
    out["census_out"] = _np(h)

    # pipeline
    pp4 = parallel.create_mesh({"pp": 4})
    ks, xp, r = pipeline_stack()
    ks_t, xp_t = torch.from_numpy(ks), torch.from_numpy(xp)

    def sequential(x, k, act=None):
        for i in range(k.shape[0]):
            x = F.hex_conv2d(x, k[i], even_odd_offset=0, radius=r,
                             padding=r - 1)
            x = act(x) if act is not None else x
        return x

    out["pipe"] = _np(parallel.pipeline_hex_conv_stack(
        xp_t, ks_t, pp4, radius=r, microbatches=4))
    out["pipe_seq"] = _np(sequential(xp_t, ks_t))
    dp2pp2 = parallel.create_mesh({"dp": 2, "pp": 2})
    out["pipe_relu"] = _np(parallel.pipeline_hex_conv_stack(
        xp_t, ks_t, dp2pp2, radius=r, microbatches=8,
        activation=torch.relu))
    # one image a microbatch: the sequential stack on the same batches
    out["pipe_relu_seq"] = _np(torch.cat([sequential(
        xp_t[i:i + 1], ks_t, torch.relu) for i in range(8)]))
    ks4 = torch.from_numpy(pipeline_stack(L=4)[0]).requires_grad_(True)
    (parallel.pipeline_hex_conv_stack(xp_t, ks4, pp4, radius=r,
                                      microbatches=4) ** 2).sum().backward()
    out["pipe_grad"] = _np(ks4.grad)
    ks4s = torch.from_numpy(pipeline_stack(L=4)[0]).requires_grad_(True)
    (sequential(xp_t, ks4s) ** 2).sum().backward()
    out["pipe_grad_seq"] = _np(ks4s.grad)
    stages, xg = generic_stages()
    params = parallel.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"] + p["b"])

    out["pipe_generic"] = _np(parallel.pipeline_apply(
        stage_fn, params, torch.from_numpy(xg), pp4, microbatches=4))
    ks6 = torch.from_numpy(pipeline_stack(L=6)[0])
    out["pipe_errors"] = [
        _raises(lambda: parallel.pipeline_hex_conv_stack(
            xp_t, ks6, pp4, radius=r)),
        _raises(lambda: parallel.pipeline_hex_conv_stack(
            xp_t, ks_t, pp4, radius=r, microbatches=2)),
        _raises(lambda: parallel.pipeline_hex_conv_stack(
            xp_t, ks_t, pp4, radius=r, microbatches=4, even_odd_offset=1)),
        _raises(lambda: parallel.pipeline_apply(
            lambda p, v: v, torch.zeros((4, 1)), xp_t, pp4,
            microbatches=5))]
    # pipeline-parallel training: SGD through the ring schedule
    rng = np.random.default_rng(7)
    kt = torch.from_numpy(rng.normal(0, 0.2, (8, 4, 4, 7)).astype(
        np.float32)).requires_grad_(True)
    xt = torch.from_numpy(rng.normal(size=(8, 4, 12, 12)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(8, 4, 12, 12)).astype(
        np.float32))
    opt = torch.optim.SGD([kt], lr=1e-2)
    losses = []
    for _ in range(6):
        opt.zero_grad()
        loss = ((parallel.pipeline_hex_conv_stack(
            xt, kt, pp4, radius=2, microbatches=4, activation=torch.relu)
            - target) ** 2).mean()
        loss.backward()
        # each rank holds its stage's grad: sum them, as one optimiser
        _comm.all_reduce_(kt.grad, pp4.group("pp"))
        opt.step()
        losses.append(loss.item())
    out["pipe_train_losses"] = losses
    return out


def dp_world(rank, tmp, payload):
    """Data-parallel training on 4 ranks: one ``train_step`` without norms
    and one with BN from the payload's weights, then ``fit``."""
    import torch
    from hygrid_tpu_torch import models, parallel
    from hygrid_tpu_torch.utils import checkpoint

    out = {}
    mesh = parallel.create_mesh({"dp": 4})
    x, y = payload["x"], payload["y"]
    for norm in ("none", "BN"):
        model = models.hexcnn_tiny(norm=None if norm == "none" else "BN",
                                   device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in payload[f"sd_{norm}"].items()})
        state = models.create_train_state(model)
        xs = parallel.shard_batch(x, mesh, device="cpu")
        ys = parallel.shard_batch(y, mesh, device="cpu")
        state, metrics = models.train_step(state, xs, ys, mesh=mesh)
        out[f"step_{norm}"] = {
            "loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "state": {k: _np(v) for k, v in model.state_dict().items()},
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}

    # fit over the mesh with per-epoch checkpoints; count the writers
    written = []
    save = checkpoint.save_checkpoint

    def spy(path, tree, **kw):
        written.append(os.path.basename(path))
        return save(path, tree, **kw)

    checkpoint.save_checkpoint = spy
    try:
        model = models.hexcnn_tiny(norm=None, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in payload["sd_none"].items()})
        if rank:   # rank 0's weights reach every rank
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        state, hist = models.fit(
            model, payload["batches"], num_epochs=3,
            eval_data=payload["batches"][:1], log_every=2, mesh=mesh,
            checkpoint_path=os.path.join(tmp, "ck"))
    finally:
        checkpoint.save_checkpoint = save
    out["fit_hist"] = hist
    out["fit_written"] = written
    out["fit_params"] = {k: _np(p) for k, p in model.named_parameters()}
    torch.distributed.barrier()
    if rank == 0:
        fresh = models.hexcnn_tiny(norm=None, device="cpu")
        checkpoint.restore_checkpoint(os.path.join(tmp, "ck_e2.npz"), fresh)
        out["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                              model.parameters()))
        out["files"] = sorted(f for f in os.listdir(tmp)
                              if f.startswith("ck"))
    out["local_slice"] = parallel.host_local_batch_slice(32)
    return out
