"""Kernel A: the plan-gather resampler (``csrc/plan_gather.cu``).

Port of ``hygrid_tpu/kernels/resample_pallas.py`` (``_resample_kernel``):
``out[n, p] = sum_k w[k, p] * src[n, idx[k, p]]`` over the B*C planes of
``(..., H, W)`` and the plan's ``h1*w1`` output pixels.  The plain version
is :func:`hygrid_tpu_torch.ops.sampling.apply_plan`.

Both keep the plan weights in float32 and accumulate in float32, also for
bf16 images, and round once to the image dtype.  This differs on purpose
from ``hygrid_tpu``, whose TPU kernel ships bf16 weights for bf16 images
and whose XLA ``apply_plan`` accumulates bf16 in bf16.

:func:`plan_gather` is differentiable on both devices: its backward is
the transpose scatter :func:`plan_gather_vjp_plain` (an f32 ``index_add_``),
the counterpart of ``resample_pallas._apply_plan_pallas_bwd`` (an XLA
``segment_sum``, not a Pallas kernel, in ``hygrid_tpu``).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..ops.sampling import SamplePlan, apply_plan
from . import _build

__all__ = ["plan_gather", "plan_gather_vjp_plain"]

LAUNCHES = 0
"""Number of kernel launches made by :func:`plan_gather`."""

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 8


def plan_gather(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Execute ``plan`` on ``image`` ``(..., H, W)``.

    A CPU tensor runs the plain version (:func:`apply_plan`).  A CUDA tensor
    (float32 or bfloat16, contiguous) launches the kernel; anything else
    raises.  The result has the image's dtype and shape ``(..., h1, w1)``;
    its gradient is :func:`plan_gather_vjp_plain` on either device.
    """
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plan_gather: no kernel for device {image.device}")
    return _PlanGather.apply(image, plan)


def plan_gather_vjp_plain(grad: torch.Tensor, plan: SamplePlan
                          ) -> torch.Tensor:
    """Transpose of the plan: ``d[..., idx[k, p]] += w[k, p] * grad[..., p]``
    summed in float32, returned ``(..., H, W)`` in ``grad``'s dtype (twin
    of ``resample_pallas._apply_plan_pallas_bwd``)."""
    h, w = plan.src_shape
    idx, weights = plan.tensors(grad.device)
    lead = tuple(grad.shape[:-2])
    g = grad.reshape(-1, 1, idx.shape[1]).float()         # (N, 1, P)
    contrib = (g * weights).reshape(g.shape[0], -1)       # (N, K*P)
    out = contrib.new_zeros((g.shape[0], h * w))
    out.index_add_(1, idx.reshape(-1), contrib)
    return out.reshape(lead + (h, w)).to(grad.dtype)


class _PlanGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, plan):
        ctx.plan = plan
        if image.device.type == "cpu":
            return apply_plan(image, plan)
        return _launch(image, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return plan_gather_vjp_plain(grad, ctx.plan), None


def _launch(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    global LAUNCHES
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
