"""Hex-native data augmentation, PyTorch port of
``hygrid_tpu/ops/augment.py``.

The augmentations the hex lattice supports on ``(B, C, H, W)`` brick-wall
batches: exact 60-degree rotations about a cell on the same canvas,
horizontal and vertical mirrors, and parity-preserving translations (row
shifts even only, so offset-0 storage stays offset-0).  Everything is a
permutation with zero fill, so results are bit-equal to the reference's.

A ``torch.Generator`` takes the place of the reference's JAX key, in the
same position; the draws are made on the generator's device (the image's
when it is None).  :func:`augment_draws` makes the draws of
:func:`augment_hex_batch`, so that the same parameters can be replayed
through :func:`hexrot60_same`, :func:`hexflip_where` and
:func:`hex_translate`.

The six same-canvas rotation maps are built once per ``(H, W, pivot)`` in
numpy; the per-image ``k`` selects among them inside one ``torch.gather``
over the batch (the counterpart of the reference's XLA gather; no Pallas
kernel on the TPU, no kernel of ours here).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .hexrot import _axial_of, _offset_of, _rot_axial

__all__ = ["hexrot60_same", "random_hexrot60", "random_hexflip",
           "random_hex_translate", "augment_hex_batch", "augment_draws",
           "apply_augment", "hexflip_where", "hex_translate"]

_SAME_PLAN_CACHE: dict = {}


def _rot_maps_same(h: int, w: int, pivot: Optional[Tuple[int, int]]):
    """(6, H, W) int32 flat source index + (6, H, W) float32 validity for
    all six same-canvas rotations (inverse-mapped: output cell -> source
    cell), built once per (h, w, pivot) in numpy."""
    key = (h, w, pivot)
    if key not in _SAME_PLAN_CACHE:
        ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        q, r = _axial_of(ii, jj)
        pi, pj = pivot if pivot is not None else (h // 2, w // 2)
        qc, rc = _axial_of(np.array(pi), np.array(pj))
        idxs, valids = [], []
        for k in range(6):
            qs, rs = _rot_axial(q - qc, r - rc, -k)     # inverse rotation
            si, sj = _offset_of(qs + qc, rs + rc)
            valid = (si >= 0) & (si < h) & (sj >= 0) & (sj < w)
            idxs.append(np.where(valid, si * w + sj, 0))
            valids.append(valid)
        if len(_SAME_PLAN_CACHE) > 32:
            _SAME_PLAN_CACHE.pop(next(iter(_SAME_PLAN_CACHE)))
        _SAME_PLAN_CACHE[key] = dict(
            idx=np.stack(idxs).astype(np.int32),
            valid=np.stack(valids).astype(np.float32), device={})
    return _SAME_PLAN_CACHE[key]


def _rot_maps_on(h, w, pivot, device):
    """``(idx (6, H*W) int64, valid (6, H, W) bool)`` on ``device``,
    uploaded once per device."""
    maps = _rot_maps_same(h, w, pivot)
    key = str(torch.device(device))
    if key not in maps["device"]:
        maps["device"][key] = (
            torch.from_numpy(maps["idx"].reshape(6, -1)).to(device).long(),
            torch.from_numpy(maps["valid"]).to(device).bool())
    return maps["device"][key]


def _as_tensor(images, device) -> torch.Tensor:
    if torch.is_tensor(images):
        return images
    return torch.as_tensor(np.asarray(images), device=device)


def _keep(images: torch.Tensor, out: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """The reference's fill: floats multiply by the 0/1 mask (``out *
    valid``), integers select (``where``)."""
    if images.dtype.is_floating_point:
        return out * valid.to(images.dtype)
    return torch.where(valid, out, torch.zeros((), dtype=images.dtype,
                                               device=images.device))


def hexrot60_same(image, k, pivot: Optional[Tuple[int, int]] = None,
                  device="cuda"):
    """Rotate a hex image (..., H, W) by ``k * 60`` degrees exactly, on the
    same canvas (cells rotated outside it and cells with no rotated source
    become zero), so the shape is kept.

    ``k`` is an int, a 0-d tensor, or a ``(B,)`` tensor of one rotation per
    image of a ``(B, ..., H, W)`` batch.  Integer dtypes are kept exactly.
    For a fixed ``k`` the canvas-growing :func:`hexrot60` keeps every cell.
    """
    image = _as_tensor(image, device)
    h, w = image.shape[-2:]
    idx6, val6 = _rot_maps_on(h, w, pivot, image.device)
    k = torch.as_tensor(k, device=image.device).long() % 6
    if k.ndim == 0:
        flat = image.reshape(image.shape[:-2] + (h * w,))
        out = flat.index_select(-1, idx6[k]).reshape(image.shape)
        return _keep(image, out, val6[k])
    b = image.shape[0]
    if k.shape != (b,):
        raise ValueError(f"k of shape {tuple(k.shape)} for a batch of {b}")
    flat = image.reshape(b, -1, h * w)
    idx = idx6[k][:, None, :].expand(flat.shape)
    out = flat.gather(-1, idx).reshape(image.shape)
    valid = val6[k].reshape((b,) + (1,) * (image.ndim - 3) + (h, w))
    return _keep(image, out, valid)


def hexflip_where(images, flip, axis: str = "horizontal", device="cuda"):
    """Mirror the images of a batch where the ``(B,)`` bool ``flip`` is
    set (an exact permutation)."""
    images = _as_tensor(images, device)
    if axis == "horizontal":
        flipped = torch.flip(images, dims=(-1,))
    elif axis == "vertical":
        flipped = torch.flip(images, dims=(-2,))
    else:
        raise ValueError(axis)
    flip = torch.as_tensor(flip, device=images.device)
    return torch.where(flip.reshape((-1,) + (1,) * (images.ndim - 1)),
                       flipped, images)


def hex_translate(images, dy, dx, device="cuda"):
    """Shift each image of a ``(B, ..., H, W)`` batch by its ``(dy[b],
    dx[b])`` cells with zero fill.  An odd ``dy`` flips the brick-wall
    parity: :func:`random_hex_translate` draws even ones only."""
    images = _as_tensor(images, device)
    h, w = images.shape[-2:]
    b = images.shape[0]
    dy = torch.as_tensor(dy, device=images.device).long().reshape(b, 1)
    dx = torch.as_tensor(dx, device=images.device).long().reshape(b, 1)
    rows = torch.arange(h, device=images.device)[None] - dy      # (B, H)
    cols = torch.arange(w, device=images.device)[None] - dx      # (B, W)
    valid = (((rows >= 0) & (rows < h))[:, :, None]
             & ((cols >= 0) & (cols < w))[:, None, :])           # (B, H, W)
    src = (rows.clamp(0, h - 1)[:, :, None] * w
           + cols.clamp(0, w - 1)[:, None, :]).reshape(b, 1, h * w)
    flat = images.reshape(b, -1, h * w)
    out = flat.gather(-1, src.expand(flat.shape)).reshape(images.shape)
    valid = valid.reshape((b,) + (1,) * (images.ndim - 3) + (h, w))
    return torch.where(valid, out, torch.zeros((), dtype=images.dtype,
                                               device=images.device))


def _draw_device(gen, images):
    return gen.device if gen is not None else images.device


def _randint(gen, low, high, n, device):
    return torch.randint(low, high, (n,), generator=gen, device=device)


def random_hexrot60(gen, images, pivot: Optional[Tuple[int, int]] = None,
                    device="cuda"):
    """Per-image uniform rotation by 0..5 sixths of a turn.

    images: (B, ...) hex storage; returns the same shape and dtype.
    """
    images = _as_tensor(images, device)
    ks = _randint(gen, 0, 6, images.shape[0], _draw_device(gen, images))
    return hexrot60_same(images, ks.to(images.device), pivot)


def random_hexflip(gen, images, p: float = 0.5, axis: str = "horizontal",
                   device="cuda"):
    """Per-image Bernoulli(p) mirror (an exact permutation)."""
    images = _as_tensor(images, device)
    flip = torch.rand((images.shape[0],), generator=gen,
                      device=_draw_device(gen, images)) < p
    return hexflip_where(images, flip.to(images.device), axis)


def _translate_draws(gen, b, max_shift, device):
    dy = 2 * _randint(gen, -max_shift, max_shift + 1, b, device)
    dx = _randint(gen, -max_shift, max_shift + 1, b, device)
    return dy, dx


def random_hex_translate(gen, images, max_shift: int = 2, device="cuda"):
    """Per-image random translation with zero fill, parity-preserving: row
    shifts are even, in ``[-2*max_shift, 2*max_shift]`` (an odd row shift
    would flip the brick-wall parity and change the meaning of every later
    conv's ``even_odd_offset``); column shifts are in ``[-max_shift,
    max_shift]``."""
    images = _as_tensor(images, device)
    dy, dx = _translate_draws(gen, images.shape[0], max_shift,
                              _draw_device(gen, images))
    return hex_translate(images, dy.to(images.device), dx.to(images.device))


def augment_draws(gen, batch: int, *, rotate: bool = True, flip: bool = True,
                  translate: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """The draws :func:`augment_hex_batch` makes from ``gen`` for a batch
    of ``batch`` images, in its order: ``k`` (rotations), ``flip``
    (horizontal mirrors, p = 0.5), ``dy`` and ``dx`` (shifts); a key is
    present where its transform is on.  ``device`` is used where ``gen``
    is None."""
    device = gen.device if gen is not None else device
    draws = {}
    if rotate:
        draws["k"] = _randint(gen, 0, 6, batch, device)
    if flip:
        draws["flip"] = torch.rand((batch,), generator=gen,
                                   device=device) < 0.5
    if translate:
        draws["dy"], draws["dx"] = _translate_draws(gen, batch, translate,
                                                    device)
    return draws


def apply_augment(images, draws: Dict[str, torch.Tensor],
                  pivot: Optional[Tuple[int, int]] = None, device="cuda"):
    """Apply the transforms of :func:`augment_draws`' ``draws``: the
    rotation, then the mirror, then the shift."""
    images = _as_tensor(images, device)
    d = {n: v.to(images.device) for n, v in draws.items()}
    if "k" in d:
        images = hexrot60_same(images, d["k"], pivot)
    if "flip" in d:
        images = hexflip_where(images, d["flip"])
    if "dy" in d:
        images = hex_translate(images, d["dy"], d["dx"])
    return images


def augment_hex_batch(gen, images, *, rotate: bool = True,
                      flip: bool = True, translate: int = 0,
                      pivot: Optional[Tuple[int, int]] = None,
                      device="cuda"):
    """Standard hex training augmentation: random 60-degree rotation +
    random horizontal mirror (together the 12-element dihedral symmetry
    group of the hex lattice) + optional parity-preserving random
    translation by up to ``translate`` cells.  One generator in, batch
    out."""
    images = _as_tensor(images, device)
    draws = augment_draws(gen, images.shape[0], rotate=rotate, flip=flip,
                          translate=translate, device=images.device)
    return apply_augment(images, draws, pivot)
