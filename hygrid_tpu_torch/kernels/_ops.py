"""The ``hygrid`` operator namespace: every forward kernel launch of the port
is one PyTorch operator, so that ``torch.export`` keeps it as one node of
an exported graph and the loaded program launches the same kernel.

Each op has a CPU implementation (the kernel's plain version), a CUDA one
(the launch) and a fake one (its outputs' shapes and dtypes from its
inputs', through which a symbolic batch flows).  The dispatcher picks the
implementation by the inputs' device.  The ops are registered with
``torch.library.Library`` rather than ``torch.library.custom_op``, whose
Python wrapper adds host time to every launch; the wrappers call them
inside their ``torch.autograd.Function``s, which carry the gradients.
Importing ``hygrid_tpu_torch`` registers them; loading an exported program
needs that import.
"""
from __future__ import annotations

import torch

__all__ = ["define"]

_LIB = torch.library.Library("hygrid", "DEF")


def define(schema: str, *, cpu, cuda, fake):
    """Register ``hygrid::<schema>`` with its CPU, CUDA and fake
    implementations; returns the op's overload to call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"hygrid::{name}", fake, lib=_LIB)
    return getattr(torch.ops.hygrid, name).default
