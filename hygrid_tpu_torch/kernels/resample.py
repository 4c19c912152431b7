"""Kernel A: the plan-gather resampler (``csrc/plan_gather.cu``).

Port of ``hygrid_tpu/kernels/resample_pallas.py`` (``_resample_kernel``):
``out[n, p] = sum_k w[k, p] * src[n, idx[k, p]]`` over the B*C planes of
``(..., H, W)`` and the plan's ``h1*w1`` output pixels.  The plain version
is :func:`hygrid_tpu_torch.ops.sampling.apply_plan`.

Both keep the plan weights in float32 and accumulate in float32, also for
bf16 images, and round once to the image dtype.  This differs on purpose
from ``hygrid_tpu``, whose TPU kernel ships bf16 weights for bf16 images
and whose XLA ``apply_plan`` accumulates bf16 in bf16.
"""
from __future__ import annotations

import torch

from ..ops.sampling import SamplePlan, apply_plan
from . import _build

__all__ = ["plan_gather"]

LAUNCHES = 0
"""Number of kernel launches made by :func:`plan_gather`."""

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 8


def plan_gather(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Execute ``plan`` on ``image`` ``(..., H, W)``.

    A CPU tensor runs the plain version (:func:`apply_plan`).  A CUDA tensor
    (float32 or bfloat16, contiguous) launches the kernel; anything else
    raises.  The result has the image's dtype and shape ``(..., h1, w1)``.
    """
    global LAUNCHES
    if image.device.type == "cpu":
        return apply_plan(image, plan)
    if image.device.type != "cuda":
        raise ValueError(f"plan_gather: no kernel for device {image.device}")
    if image.dtype not in _DTYPES:
        raise TypeError(f"plan_gather: the kernel takes float32 or bfloat16 "
                        f"images, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("plan_gather: the image must be contiguous")
    h, w = plan.src_shape
    if tuple(image.shape[-2:]) != (h, w):
        raise ValueError(f"image spatial shape {tuple(image.shape[-2:])} != "
                         f"plan source {plan.src_shape}")
    k = plan.idx.shape[0]
    if k > _MAX_TAPS:
        raise ValueError(f"plan_gather: at most {_MAX_TAPS} taps, got {k}")
    idx, weights = plan.tensors(image.device)
    lead = tuple(image.shape[:-2])
    n_planes = image.numel() // (h * w)
    out = torch.empty(lead + tuple(plan.out_shape), dtype=image.dtype,
                      device=image.device)
    if n_planes == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_plan_gather(
            image.data_ptr(), out.data_ptr(), idx.data_ptr(),
            weights.data_ptr(), n_planes, h * w, idx.shape[1], k,
            _DTYPES[image.dtype], stream)
    _build.check(status, "plan_gather")
    LAUNCHES += 1
    return out
