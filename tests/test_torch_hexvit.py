"""HexViT on the CPU: hygrid_tpu's flax HexViT and the port's, the same
weights carried by ``hexvit_state_dict_from_flax``.

Float32; logits and every grad (parameters and input, of ``sum(logits *
g)``) within 1e-4 relative max-abs error (LayerNorm and softmax rescale
summation-order differences); the key bias, whose grad is 0 (the softmax
cancels it), within 1e-4 of the largest grad.  Flax runs under
``jax.jit`` on variables drawn from numpy seeds (``jax.eval_shape``, no
flax init).  The reference's errors are kept (an (H, W) that does not divide the patch factor raises
``ValueError``) and its fault is not (attention dropout above 0 raises).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.models.hexvit import _fused_attention
from hygrid_tpu_torch.utils import hexvit_state_dict_from_flax
from test_torch_modules import random_flax_variables

REL = 1e-4
CONFIGS = {
    "d32-L1-h2-k2": (dict(num_classes=7, dim=32, depth=1, heads=2,
                          patch_halvings=2), "HexViT"),
    "tiny": (dict(), "hexvit_tiny"),
}


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(name, seed=0):
    kw, ctor = CONFIGS[name]
    x = np.random.default_rng(seed).random((2, 3, 16, 16)).astype(np.float32)
    flax_model = getattr(jm, ctor)(**kw)
    params = random_flax_variables(flax_model, x[:1], seed)["params"]
    port = getattr(tm, ctor)(device="cpu", **kw)
    port.load_state_dict(hexvit_state_dict_from_flax(params))
    return flax_model, params, port, x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_flax(name):
    flax_model, params, port, x = _pair(name)
    want = jax.jit(flax_model.apply)({"params": params}, x)
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grads_match_jax(name):
    flax_model, params, port, x = _pair(name, seed=1)
    g = np.random.default_rng(2).normal(
        size=(2, port.head.out_features)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(flax_model.apply({"params": p}, x) * g)

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    want = hexvit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, want_p))
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(g)).sum().backward()
    assert sorted(want) == sorted(n for n, _ in port.named_parameters())
    # the key projection's bias adds one constant to a query's logits, which
    # the softmax cancels: its grad is 0, and both sides hold rounding
    # residue, held to REL of the largest grad of any leaf instead
    scale = max(np.abs(v.numpy()).max() for v in want.values())
    for n, p in port.named_parameters():
        if n.endswith("attn.key.bias"):
            assert max(np.abs(p.grad.numpy()).max(),
                       np.abs(want[n].numpy()).max()) <= REL * scale, n
        else:
            assert _rel(p.grad, want[n]) <= REL, n
    assert _rel(xt.grad, want_x) <= REL


def test_size_errors():
    """The reference's ValueError where (H, W) does not divide 2^k, at
    construction (the port's position embedding) and on the input; a
    token count other than the embedding's raises too."""
    kw = dict(num_classes=7, dim=32, depth=1, heads=2, patch_halvings=2)
    with pytest.raises(ValueError) as ref:
        jm.HexViT(**kw).init(jax.random.key(2), jnp.ones((1, 3, 18, 16)))
    with pytest.raises(ValueError) as got:
        tm.HexViT(hex_size=(18, 16), device="cpu", **kw)
    assert str(got.value) == str(ref.value)
    model = tm.HexViT(device="cpu", **kw)
    with pytest.raises(ValueError, match="must divide the patch factor 4"):
        model(torch.ones((1, 3, 18, 16)))
    with pytest.raises(ValueError, match="position embedding has 16"):
        model(torch.ones((1, 3, 32, 16)))


def test_attention_dropout_raises():
    q = torch.rand((1, 4, 2, 8))
    want = torch.nn.functional.scaled_dot_product_attention(
        *(q.transpose(1, 2),) * 3).transpose(1, 2)
    assert torch.equal(_fused_attention(q, q, q), want)
    with pytest.raises(NotImplementedError, match="dropout"):
        _fused_attention(q, q, q, dropout_rate=0.1)


def test_bf16_model_keeps_float32_parameters():
    """dtype=bfloat16 computes in bf16 (logits bf16); the parameters and
    their grads stay float32 through a train_step, as flax's param_dtype
    keeps them for the optimiser."""
    gen = torch.Generator().manual_seed(0)
    model = tm.hexvit_tiny(dtype=torch.bfloat16, device="cpu", generator=gen)
    x = torch.rand((2, 3, 16, 16), generator=gen)
    assert model(x).dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = tm.train_step(tm.create_train_state(model), x,
                                   torch.tensor([1, 3]))
    assert np.isfinite(float(metrics["loss"]))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())


def test_hexvit_tiny_trains():
    """Five steps on synthetic hex-CIFAR lower the loss, as the reference's
    own test of hexvit_tiny asks (tests/test_models_parallel.py)."""
    x, y = tm.synthetic_hex_cifar(np.random.default_rng(1), 16,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = tm.create_train_state(tm.hexvit_tiny(device="cpu", generator=gen),
                                  learning_rate=1e-3)
    losses = [float(tm.train_step(state, x, y)[1]["loss"]) for _ in range(5)]
    assert losses[-1] < losses[0], losses
