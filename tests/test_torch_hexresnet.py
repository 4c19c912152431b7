"""The residual hex families on the CPU: hygrid_tpu's flax
``HexConvNeXtBlock``, ``HexResBlock`` (with and without its ``proj``) and
``HexResNet`` against the port's, the same weights carried by
``hexconvnext_state_dict_from_flax`` / ``hexresnet_state_dict_from_flax``.

Float32; outputs and every grad (parameters and input, of ``sum(out *
g)``) within 1e-4 relative max-abs error (LayerNorm and GroupNorm rescale
summation-order differences).  Flax runs under ``jax.jit`` on variables
drawn from numpy seeds (``jax.eval_shape``, no flax init).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.utils import (hexconvnext_state_dict_from_flax,
                                    hexresnet_state_dict_from_flax)
from test_torch_modules import random_flax_variables

REL = 1e-4
# id -> (flax module, port module, converter, input shape)
CASES = {
    "convnext": (lambda: jm.HexConvNeXtBlock(width=8),
                 lambda: tm.HexConvNeXtBlock(8, device="cpu"),
                 hexconvnext_state_dict_from_flax, (2, 8, 12, 11)),
    "resblock-proj": (lambda: jm.HexResBlock(width=16),
                      lambda: tm.HexResBlock(8, 16, device="cpu"),
                      hexresnet_state_dict_from_flax, (2, 8, 10, 9)),
    "resblock": (lambda: jm.HexResBlock(width=8),
                 lambda: tm.HexResBlock(8, 8, device="cpu"),
                 hexresnet_state_dict_from_flax, (2, 8, 10, 9)),
    "resnet": (lambda: jm.HexResNet(num_classes=7, widths=(8, 16),
                                    blocks_per_stage=1),
               lambda: tm.HexResNet(num_classes=7, widths=(8, 16),
                                    blocks_per_stage=1, device="cpu"),
               hexresnet_state_dict_from_flax, (2, 3, 16, 16)),
}


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(name, seed):
    make_flax, make_port, convert, shape = CASES[name]
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    flax_model = make_flax()
    params = random_flax_variables(flax_model, x[:1], seed)["params"]
    port = make_port()
    port.load_state_dict(convert(params))
    return flax_model, params, port, convert, x


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_flax(name):
    flax_model, params, port, _, x = _pair(name, 0)
    want = jax.jit(flax_model.apply)({"params": params}, x)
    assert _rel(port(torch.from_numpy(x)), want) <= REL


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax(name):
    flax_model, params, port, convert, x = _pair(name, 1)
    g = np.random.default_rng(2).normal(
        size=np.shape(jax.eval_shape(flax_model.apply, {"params": params},
                                     x))).astype(np.float32)

    def loss(p, x):
        return jnp.sum(flax_model.apply({"params": p}, x) * g)

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    want = convert(jax.tree_util.tree_map(np.asarray, want_p))
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(g)).sum().backward()
    assert sorted(want) == sorted(n for n, _ in port.named_parameters())
    for n, p in port.named_parameters():
        assert _rel(p.grad, want[n]) <= REL, n
    assert _rel(xt.grad, want_x) <= REL


def test_hexresnet_trains():
    """Four steps on synthetic hex-CIFAR lower the loss."""
    x, y = tm.synthetic_hex_cifar(np.random.default_rng(3), 16,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = tm.HexResNet(widths=(8, 16), blocks_per_stage=1, device="cpu",
                         generator=gen)
    state = tm.create_train_state(model, learning_rate=1e-3)
    losses = [float(tm.train_step(state, x, y)[1]["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0], losses
