"""HexConvModule and cfg-dict builders, PyTorch port of
``hygrid_tpu/nn/modules.py`` (the reference's ``HexModules.py``).

The same cfg-dict surface: ``dict(type='HexConv2d', ...)`` consumed by
:func:`build_hexconv_layer`, ``dict(type='BN')`` norm cfgs and
``dict(type='ReLU')`` activation cfgs, over a small registry.  The
semantics are flax's, where PyTorch's own modules differ:

* BN is flax ``BatchNorm`` (momentum 0.9 on the running statistics, i.e.
  torch's 0.1; the running variance takes the *biased* batch variance
  ``E[x^2] - E[x]^2``, clamped at 0; statistics in float32);
* LN normalises over the channel axis only, per pixel;
* GN uses ``gcd(num_groups, C)`` groups; IN is per sample and channel;
* ``"GELU"`` is the tanh approximation, ``"HSigmoid"`` ``relu6(x+3)/6``,
  ``"PReLU"`` one scalar slope (init 0.25);
* spectral norm is flax ``nn.SpectralNorm``: the kernel ``(O, I, kn)`` is
  viewed as ``(O*I, kn)``, one power-iteration step runs from the stored
  ``u`` on every call (eval too), and ``u`` and ``sigma`` are written only
  when ``train=True``; 1-D parameters (the bias) are left alone.

Parameter names follow the flax tree so that
:func:`hygrid_tpu_torch.utils.params.hexconvmodule_state_dict_from_flax`
maps it one to one: ``conv.kernel`` / ``conv.bias`` (with spectral norm
``conv.layer_instance.*`` and the buffers ``conv.kernel_u``,
``conv.kernel_sigma``), ``norm.weight`` / ``norm.bias`` (flax ``scale`` /
``bias``) and BN's buffers ``norm.running_mean`` / ``norm.running_var``
(flax ``batch_stats`` ``mean`` / ``var``), ``activate.negative_slope``.

All modules run channel-first (B, C, H, W), like the hex ops.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import warnings
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as tF
from torch import nn

from . import functional as F
from .layers import HexConv2d, HexConv2dAdaptivePadding, HexConvStack

__all__ = [
    "CONV_LAYERS",
    "register_conv_layer",
    "build_hexconv_layer",
    "build_hexnorm_layer",
    "build_hexactivation_layer",
    "build_hexpadding_layer",
    "HexConvModule",
]

# ----------------------------- registries -----------------------------

CONV_LAYERS: Dict[str, type] = {}


def register_conv_layer(name: str, module: Optional[type] = None):
    """Register a conv layer class under a cfg ``type`` name (the shim for
    mmcv's ``CONV_LAYERS.register_module``, ``HexModules.py:16``)."""
    def _register(cls):
        CONV_LAYERS[name] = cls
        return cls
    if module is not None:
        return _register(module)
    return _register


register_conv_layer("HexConv2d", HexConv2d)
register_conv_layer("HexConv2dAdaptivePadding", HexConv2dAdaptivePadding)
register_conv_layer("HexConvStack", HexConvStack)


def build_hexconv_layer(cfg: Optional[Dict], *args, **kwargs):
    """Build a conv layer from a cfg dict (``HexModules.py:22-54``).

    Positional args follow the reference call convention:
    ``(in_channels, out_channels, even_odd_offset, hexkernel_radius)``;
    the cfg's keys override the keyword arguments, and ``bias`` is taken
    as ``use_bias``.
    """
    if cfg is None:
        cfg_ = dict(type="HexConv2d")
    else:
        if not isinstance(cfg, Mapping):
            raise TypeError("cfg must be a dict")
        if "type" not in cfg:
            raise KeyError('the cfg dict must contain the key "type"')
        cfg_ = dict(cfg)
    layer_type = cfg_.pop("type")
    if layer_type not in CONV_LAYERS:
        raise KeyError(f"Unrecognized layer type {layer_type}")
    names = ("in_channels", "out_channels", "even_odd_offset",
             "hexkernel_radius")
    kwargs = {**dict(zip(names, args)), **kwargs, **cfg_}
    if "bias" in kwargs:  # torch name -> flax name
        kwargs["use_bias"] = kwargs.pop("bias")
    return CONV_LAYERS[layer_type](**kwargs)


# ------------------------------- norms --------------------------------


def _normalize(x, mean, var, eps, weight, bias):
    """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, the statistics broadcast against ``x``."""
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean) * mul
    return y if bias is None else y + bias


def _fast_stats(x, dims):
    """flax ``_compute_stats`` (fast variance): float32 ``E[x]`` and
    ``max(0, E[x^2] - E[x]^2)`` over ``dims``, kept."""
    x = x.float()
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean, min=0)
    return mean, var


# the process group over which BN layers in training sum their batch
# statistics (a data-parallel step's "dp" group); None: this process's batch
_BATCH_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_group", default=None)


@contextlib.contextmanager
def batch_stats_group(group):
    """Within the block, BN layers in training normalise with the batch
    statistics of the whole ``group``: each rank's per-channel sum and sum
    of squares are all-reduced, differentiably, so a data-parallel step
    sees the global batch's statistics (and updates its running statistics
    from them), as XLA's collective does in ``hygrid_tpu``
    (``hygrid_tpu/nn/modules.py:131-133``).  ``None`` keeps them per
    process."""
    token = _BATCH_STATS_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_STATS_GROUP.reset(token)


def _group_stats(x, dims, group):
    """:func:`_fast_stats` over the batch of every rank of ``group``: one
    differentiable all-reduce of the local sums of ``x`` and ``x^2`` and
    the element count."""
    from ..parallel._comm import AllReduceSum
    x = x.float()
    count = x.new_full((1,), x.numel() / x.shape[1])
    local = torch.cat([x.sum(dims), (x * x).sum(dims), count])
    total = AllReduceSum.apply(local, group)
    c = x.shape[1]
    n = total[2 * c]
    shape = (1, c, 1, 1)
    mean = (total[:c] / n).reshape(shape)
    var = torch.clamp(total[c:2 * c].reshape(shape) / n - mean * mean, min=0)
    return mean, var


class _ChannelFirstNorm(nn.Module):
    """BN / GN / LN / IN on ``(B, C, H, W)`` data with flax's semantics
    (``hygrid_tpu/nn/modules.py:84-122``)."""

    def __init__(self, norm_type: str, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9, num_groups: int = 32,
                 affine: bool = True, device="cuda"):
        super().__init__()
        if norm_type not in ("BN", "GN", "LN", "IN"):
            raise KeyError(f"Unrecognized norm type {norm_type}")
        self.norm_type, self.num_features = norm_type, num_features
        self.eps, self.momentum = eps, momentum
        self.num_groups = math.gcd(num_groups, num_features)
        fkw = dict(device=device, dtype=torch.float32)
        self.weight = (nn.Parameter(torch.ones(num_features, **fkw))
                       if affine else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **fkw))
                     if affine else None)
        if norm_type == "BN":
            self.register_buffer("running_mean", torch.zeros(num_features,
                                                             **fkw))
            self.register_buffer("running_var", torch.ones(num_features,
                                                           **fkw))

    def forward(self, x, train: bool = False):
        c = self.num_features
        shape = (1, c, 1, 1)
        weight = None if self.weight is None else self.weight.reshape(shape)
        bias = None if self.bias is None else self.bias.reshape(shape)
        if self.norm_type == "BN":
            if train:
                group = _BATCH_STATS_GROUP.get()
                mean, var = (_fast_stats(x, (0, 2, 3)) if group is None
                             else _group_stats(x, (0, 2, 3), group))
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(
                        m * self.running_mean + (1 - m) * mean.flatten())
                    self.running_var.copy_(
                        m * self.running_var + (1 - m) * var.flatten())
            else:
                mean = self.running_mean.reshape(shape)
                var = self.running_var.reshape(shape)
            return _normalize(x, mean, var, self.eps, weight, bias)
        if self.norm_type == "GN":
            b, _, h, w = x.shape
            g = self.num_groups
            mean, var = _fast_stats(x.reshape(b, g, c // g, h, w), (2, 3, 4))
            mean = mean.repeat_interleave(c // g, 1).reshape(b, c, 1, 1)
            var = var.repeat_interleave(c // g, 1).reshape(b, c, 1, 1)
        elif self.norm_type == "LN":
            mean, var = _fast_stats(x, (1,))
        else:  # IN, by hand (hygrid_tpu/nn/modules.py:110-119)
            mean = x.mean((2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
        return _normalize(x, mean, var, self.eps, weight, bias)


_NORM_ABBR = {"BN": "bn", "SyncBN": "bn", "GN": "gn", "LN": "ln", "IN": "in"}


def build_hexnorm_layer(cfg: Dict, num_features: int,
                        postfix: Union[int, str] = "", *, device="cuda"
                        ) -> Tuple[str, nn.Module]:
    """Build a normalization layer; returns ``(name, module)`` like mmcv
    (``HexModules.py:69-89``).  ``SyncBN`` is plain BatchNorm, as in
    ``hygrid_tpu``; under :func:`batch_stats_group` (a data-parallel
    ``train_step``) it sums its statistics over the group, as SyncBN."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise TypeError('cfg must be a dict containing the key "type"')
    cfg_ = dict(cfg)
    layer_type = cfg_.pop("type")
    cfg_.pop("requires_grad", None)
    if layer_type not in _NORM_ABBR:
        raise KeyError(f"Unrecognized norm type {layer_type}")
    norm_type = "BN" if layer_type == "SyncBN" else layer_type
    return _NORM_ABBR[layer_type] + str(postfix), _ChannelFirstNorm(
        norm_type, num_features, device=device, **cfg_)


# ---------------------------- activations -----------------------------


class _PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar slope ``negative_slope``."""

    def __init__(self, init: float = 0.25, device="cuda"):
        super().__init__()
        self.negative_slope = nn.Parameter(
            torch.tensor(init, dtype=torch.float32, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


_ACTIVATIONS = {
    "ReLU": lambda cfg: torch.relu,
    "ReLU6": lambda cfg: (lambda x: torch.clamp(x, 0, 6)),
    "LeakyReLU": lambda cfg: functools.partial(
        tF.leaky_relu, negative_slope=cfg.get("negative_slope", 0.01)),
    "ELU": lambda cfg: tF.elu,
    "Sigmoid": lambda cfg: torch.sigmoid,
    "HSigmoid": lambda cfg: (lambda x: tF.relu6(x + 3.0) / 6.0),
    "Tanh": lambda cfg: torch.tanh,
    "GELU": lambda cfg: functools.partial(tF.gelu, approximate="tanh"),
    "Swish": lambda cfg: tF.silu,
    "SiLU": lambda cfg: tF.silu,
}


def build_hexactivation_layer(cfg: Dict, *, device="cuda"):
    """Build an activation from a cfg dict (``HexModules.py:90-91``).
    Returns a callable (a module only for the parametric PReLU, whose
    slope lives on ``device``)."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise TypeError('cfg must be a dict containing the key "type"')
    cfg_ = dict(cfg)
    t = cfg_.pop("type")
    cfg_.pop("inplace", None)  # no meaning here
    if t == "PReLU":
        return _PReLU(cfg_.get("init", 0.25), device=device)
    if t not in _ACTIVATIONS:
        raise KeyError(f"Unrecognized activation type {t}")
    return _ACTIVATIONS[t](cfg_)


# ------------------------------ padding -------------------------------

_PADDING_MODES = {"zero": "constant", "zeros": "constant",
                  "reflect": "reflect", "replicate": "replicate"}


def build_hexpadding_layer(cfg: Dict, padding):
    """Build an explicit padding callable (``HexModules.py:56-67``)."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise TypeError('cfg must be a dict containing the key "type"')
    t = cfg["type"]
    if t not in _PADDING_MODES:
        raise KeyError(f"Unrecognized padding type {t}")
    mode = _PADDING_MODES[t]
    return lambda x: F.pad2d(x, padding, mode)


# ---------------------------- spectral norm ---------------------------


def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class _SpectralNorm(nn.Module):
    """flax ``nn.SpectralNorm`` around a conv layer (its ``kernel``; the
    1-D ``bias`` is left alone).  ``kernel_u`` ``(1, kn)`` starts normal
    from ``generator``, ``kernel_sigma`` at 1."""

    def __init__(self, layer_instance: HexConv2d, n_steps: int = 1,
                 epsilon: float = 1e-12, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_instance = layer_instance
        self.n_steps, self.epsilon = n_steps, epsilon
        kn = layer_instance.kernel.shape[-1]
        self.register_buffer("kernel_u", torch.randn(
            (1, kn), generator=generator, device=device))
        self.register_buffer("kernel_sigma", torch.ones((), device=device))

    def forward(self, x, *, update_stats: bool):
        if self.n_steps < 1:
            return self.layer_instance(x)
        kernel = self.layer_instance.kernel
        value = kernel.float().reshape(-1, kernel.shape[-1])
        u0 = self.kernel_u
        with torch.no_grad():
            for _ in range(self.n_steps):
                v0 = _l2_normalize(u0 @ value.T, self.epsilon)
                u0 = _l2_normalize(v0 @ value, self.epsilon)
        sigma = (v0 @ value @ u0.T)[0, 0]
        value = value / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.kernel_u.copy_(u0)
                self.kernel_sigma.copy_(sigma)
        return self.layer_instance._conv(x, value.reshape(kernel.shape),
                                         self.layer_instance.bias)


# ---------------------------- HexConvModule ---------------------------


class HexConvModule(nn.Module):
    """Conv/norm/activation bundle (``HexModules.py:97-288``,
    ``hygrid_tpu/nn/modules.py:201-300``).

    ``bias="auto"`` (a bias only without a norm), explicit padding layers
    (``padding_mode`` "zero"/"reflect"/"replicate"; "zeros" and "circular"
    pad inside the conv, with zeros: the reference never forwards
    ``padding_mode`` to the conv), any conv/norm/act ``order``, and
    spectral norm on the conv kernel.  ``act_cfg="default"`` is ReLU and
    None disables the activation.  ``forward(x, activate=True, norm=True,
    train=False)`` mirrors the reference's flags plus flax's train flag
    (batch statistics, and the running-statistics and spectral-norm
    updates).  ``device`` / ``generator``: where the parameters live (the
    card unless the caller asks for the CPU) and what initialises them.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 even_odd_offset: int, hexkernel_radius: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: Union[bool, str] = "auto",
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Union[Dict, None, str] = "default",
                 inplace: bool = True, with_spectral_norm: bool = False,
                 padding_mode: str = "zeros",
                 order: tuple = ("conv", "norm", "act"), *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert conv_cfg is None or isinstance(conv_cfg, Mapping)
        assert norm_cfg is None or isinstance(norm_cfg, Mapping)
        assert isinstance(order, tuple) and len(order) == 3
        assert set(order) == {"conv", "norm", "act"}
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv_cfg, self.norm_cfg = conv_cfg, norm_cfg
        self.act_cfg = dict(type="ReLU") if act_cfg == "default" else act_cfg
        self.with_spectral_norm, self.order = with_spectral_norm, order
        self.with_explicit_padding = padding_mode not in ("zeros", "circular")

        if bias == "auto":  # bias unnecessary before a norm (HexModules.py:180-182)
            bias = not self.with_norm
        self.with_bias = bias
        if bias and self.with_norm:
            warnings.warn("Unnecessary conv bias before batch/instance norm")

        if self.with_explicit_padding:
            self.padding_layer = build_hexpadding_layer(
                dict(type=padding_mode), padding)
        conv = build_hexconv_layer(
            conv_cfg, in_channels, out_channels, even_odd_offset,
            hexkernel_radius, stride=stride,
            padding=0 if self.with_explicit_padding else padding,
            dilation=dilation, groups=groups, use_bias=bias, device=device,
            generator=generator)
        if with_spectral_norm:
            conv = _SpectralNorm(conv, device=device, generator=generator)
        self.conv = conv

        self.norm_name = None
        if self.with_norm:
            norm_channels = (out_channels if order.index("norm")
                             > order.index("conv") else in_channels)
            self.norm_name, self.norm = build_hexnorm_layer(
                norm_cfg, norm_channels, device=device)
        if self.with_activation:
            self.activate = build_hexactivation_layer(self.act_cfg,
                                                      device=device)

    @property
    def with_norm(self) -> bool:
        return self.norm_cfg is not None

    @property
    def with_activation(self) -> bool:
        return self.act_cfg is not None

    def forward(self, x, activate: bool = True, norm: bool = True,
                train: bool = False):
        for layer in self.order:
            if layer == "conv":
                if self.with_explicit_padding:
                    x = self.padding_layer(x)
                if self.with_spectral_norm:
                    x = self.conv(x, update_stats=train)
                else:
                    x = self.conv(x)
            elif layer == "norm" and norm and self.with_norm:
                x = self.norm(x, train=train)
            elif layer == "act" and activate and self.with_activation:
                x = self.activate(x)
        return x
