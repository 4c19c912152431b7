"""Weights and inputs from the seed, made on the device in a few large
draws: the same seed gives the same weights and the same batches."""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 8 + stream) % 2 ** 63)


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Float32 weights for the named parameter shapes, from one uniform
    draw in [-1, 1): a matrix or kernel ``u * sqrt(3 / fan_in)`` (standard
    deviation ``1 / sqrt(fan_in)``), a norm's scale ``1 + u / 10``, any
    other vector ``u / 10``."""
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(seed, 0, device),
                   device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        v = u[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if len(shape) > 1:
            v = v * math.sqrt(3.0 / math.prod(shape[1:]))
        elif "scale" in name.rsplit(".", 1)[-1]:
            v = 1 + v / 10
        else:
            v = v / 10
        out[name] = v.contiguous()
    return out


def rect_images(cell, seed: int, device) -> torch.Tensor:
    """``pool`` distinct batches of rect images, uniform in [0, 1), in the
    mix's dtype: shape (pool, batch, channels, height, width)."""
    t, cfg = cell.traffic, cell.cfg
    x = torch.rand((t["pool"], t["batch"], cfg["in_channels"], *cfg["image"]),
                   generator=generator(seed, 1, device), device=device)
    return x.to(DTYPES[t["dtype"]])
