"""HexViT: a vision transformer over brick-wall hex storage, PyTorch port of
``hygrid_tpu/models/hexvit.py``.

Only the patch stem is hex-aware: ``patch_halvings`` stride-2 'same' hex
convolutions (padding ``radius - 1``, offset 0, GELU between them) turn
hexagonal super-cells of ``4^k`` cells into one token each.  The tokens,
in the reference's row-major order, get a learned position embedding and
flow through pre-LN transformer blocks, then a final LayerNorm, a mean over
the tokens and a linear head.

The stem's convs run ``impl="auto"`` (``hex_conv2d``'s plain "direct" conv:
cuDNN on the card, as the reference runs XLA's conv there), and attention
runs ``torch.nn.functional.scaled_dot_product_attention``, as the reference
runs XLA's ``jax.nn.dot_product_attention``: no hand-written kernel runs in
the model; on the card the rect->hex input (:func:`hexify_batch`) does.

flax's semantics are kept where torch's defaults differ: LayerNorm eps
1e-6 with float32 statistics, GELU's tanh approximation, parameters
stored in float32 and cast to ``dtype`` where they are used.  torch
builds parameters up front, so the model takes the input's hex size
(``hex_size``), which fixes the token grid of the position embedding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.layers import HexConv2d
from .hexcnn import _dense, _gelu, _layer_norm, _linear

__all__ = ["HexViT", "hexvit_tiny"]


def _fused_attention(query: torch.Tensor, key: torch.Tensor,
                     value: torch.Tensor, dropout_rate: float = 0.0
                     ) -> torch.Tensor:
    """Attention on flax's ``(B, T, heads, head_dim)`` layout through
    ``scaled_dot_product_attention`` (scale ``1/sqrt(head_dim)``), returned
    in the same layout (``hygrid_tpu/models/hexvit.py:31-40``).  The
    reference accepts ``dropout_rate`` and ignores it; here a rate above 0
    raises."""
    if dropout_rate > 0:
        raise NotImplementedError(
            f"attention dropout ({dropout_rate}) is not implemented: the "
            "reference ignores it silently, the port refuses it")
    out = nn.functional.scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2))
    return out.transpose(1, 2)


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention): ``query``,
    ``key``, ``value`` and ``out`` as ``nn.Linear(dim, dim)`` (flax's
    ``(dim, heads, head_dim)`` and ``(heads, head_dim, dim)`` kernels
    flattened), the three projections run as one matmul."""

    def __init__(self, dim: int, heads: int, device, generator):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _dense(dim, dim, device, generator))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        b, t, d = x.shape
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        bias = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        qkv = nn.functional.linear(x.to(dtype), w.to(dtype), bias.to(dtype))
        q, k, v = qkv.view(b, t, 3, self.heads, d // self.heads).unbind(2)
        return _linear(_fused_attention(q, k, v).reshape(b, t, d), self.out,
                       dtype)


class _Block(nn.Module):
    """Pre-LN transformer block (``hygrid_tpu/models/hexvit.py:43-62``):
    ``x + attn(LN(x))``, then ``x + Dense(GELU(Dense(LN(x))))`` with a
    ``mlp_ratio * dim`` hidden width.  flax names: ``LayerNorm_0`` ->
    ``ln1``, ``attn``, ``LayerNorm_1`` -> ``ln2``, ``Dense_0`` -> ``fc1``,
    ``Dense_1`` -> ``fc2``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, dtype, device,
                 generator):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = _Attention(dim, heads, device, generator)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.fc1 = _dense(dim, mlp_ratio * dim, device, generator)
        self.fc2 = _dense(mlp_ratio * dim, dim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.ln1, self.dtype), self.dtype)
        y = _gelu(_linear(_layer_norm(x, self.ln2, self.dtype), self.fc1,
                          self.dtype))
        return x + _linear(y, self.fc2, self.dtype)


class HexViT(nn.Module):
    """Transformer classifier on hex images ``(B, C, H, W)``, offset 0.

    Args:
        num_classes: head width.
        dim: token dimension.
        depth: transformer blocks.
        heads: attention heads.
        patch_halvings: stride-2 hex convs in the stem (tokens ``(H / 2^k)
            * (W / 2^k)``); H and W must be divisible by ``2^k``.
        radius: hex kernel radius of the stem convs.
        hex_size: the input's ``(H, W)`` (default hex-CIFAR's 16 x 16): it
            fixes the token grid, and so the position embedding.
        in_channels: the input's channels.
        dtype: compute dtype; parameters stay float32 (flax's
            ``param_dtype`` default, kept for the optimiser's update).
        device / generator: where the parameters live (the card unless the
            caller asks for the CPU) and what initialises them.

    Parameters carry flax's names where they can: ``stem{i}.kernel`` /
    ``.bias``, ``pos_embedding`` ``(1, T, dim)``, ``block{i}.*`` (see
    :class:`_Block`), ``norm`` (flax ``LayerNorm_0``) and ``head``.
    """

    def __init__(self, num_classes: int = 10, dim: int = 128, depth: int = 4,
                 heads: int = 4, patch_halvings: int = 2, radius: int = 2,
                 hex_size: Tuple[int, int] = (16, 16), in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_halvings, self.depth, self.dtype = (patch_halvings, depth,
                                                       dtype)
        self.hex_size = h, w = self._check_size(hex_size)
        p = 2 ** patch_halvings
        widths = [max(dim // 2 ** (patch_halvings - 1 - i), dim // 4)
                  for i in range(patch_halvings - 1)] + [dim]
        cin = in_channels
        for i, width in enumerate(widths):
            self.add_module(f"stem{i}", HexConv2d(
                cin, width, 0, radius, stride=2, padding=radius - 1,
                dtype=dtype, device=device, generator=generator))
            cin = width
        pos = torch.empty((1, (h // p) * (w // p), dim), device=device)
        with torch.no_grad():
            pos.normal_(0.0, 0.02, generator=generator)
        self.pos_embedding = nn.Parameter(pos)
        for i in range(depth):
            self.add_module(f"block{i}", _Block(dim, heads, 4, dtype, device,
                                                generator))
        self.norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.head = _dense(dim, num_classes, device, generator)

    def _check_size(self, hw) -> Tuple[int, int]:
        h, w = hw
        p = 2 ** self.patch_halvings
        if h % p or w % p:
            raise ValueError(f"(H, W) = {(h, w)} must divide the patch "
                             f"factor {p}")
        return h, w

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits ``(B, num_classes)`` in ``dtype``; ``train`` is the
        reference's flag (no layer differs in training)."""
        self._check_size(x.shape[-2:])
        x = x.to(self.dtype)
        for i in range(self.patch_halvings):
            x = getattr(self, f"stem{i}")(x)
            if i < self.patch_halvings - 1:
                x = _gelu(x)
        b, d, th, tw = x.shape
        if th * tw != self.pos_embedding.shape[1]:
            raise ValueError(
                f"{th * tw} tokens from a {tuple(x.shape[-2:])} grid; the "
                f"position embedding has {self.pos_embedding.shape[1]} (build "
                f"the model with this input's hex_size)")
        tokens = x.reshape(b, d, th * tw).transpose(1, 2)
        tokens = tokens.to(self.dtype) + self.pos_embedding.to(self.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        pooled = _layer_norm(tokens, self.norm, self.dtype).mean(dim=1)
        return _linear(pooled, self.head, self.dtype)


def hexvit_tiny(num_classes: int = 10, **kw) -> HexViT:
    return HexViT(num_classes=num_classes, dim=64, depth=2, heads=2,
                  patch_halvings=1, **kw)
