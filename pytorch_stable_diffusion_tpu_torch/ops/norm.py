"""GroupNorm / LayerNorm with fp32 statistics (port of ``ops/norm.py``).

``group_norm`` takes channels-first tensors (N, C, ...), the port's layout;
``layer_norm`` normalizes the last axis.  Both cast to ``policy.norm_dtype``
(fp32) explicitly, normalize, apply the affine there, and cast back — GN
over 512-channel activations loses visible precision in bf16.  eps = 1e-5.

The folded variants (``conv_backend="fold"``/``"kernel_fold"``) keep the
statistics in ``policy.norm_dtype`` but apply the normalize as a
per-(batch, channel) or per-token affine in x's dtype, with no fp32
full-tensor intermediate; they differ from the exact ones only by the
rounding of that apply.

Under a row split (sequence parallelism, ``core/mesh.split_rows``) the
GroupNorm statistics are the whole tensor's: each rank's sums, sums of
squares and counts are added over the model group
(``core/mesh.split_var_mean``).  The folded tiers do not run there: the
pipeline takes the "plain" conv tier under sequence parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import mesh as mesh_mod
from ..core.dtypes import FP32, Policy
from .act import silu
from .cuda.conv import fold_gn_affine

EPS = 1e-5


class Norm(nn.Module):
    """Parameter holder: affine ``weight`` (the JAX ``scale``) and ``bias``."""

    def __init__(self, num_channels: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_channels, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(num_channels, dtype=dtype,
                                             device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        del generator  # deterministic: ones / zeros
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()


def group_norm(p: Norm, x: torch.Tensor, num_groups: int = 32,
               eps: float = EPS, policy: Policy = FP32) -> torch.Tensor:
    """x: (N, C, ...) with C divisible by num_groups (torch semantics)."""
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    nd = policy.norm_dtype
    if mesh_mod.row_split() is None:
        y = F.group_norm(x.to(nd), num_groups, p.weight.to(nd), p.bias.to(nd), eps)
        return y.to(x.dtype)
    xg = x.to(nd).unflatten(1, (num_groups, c // num_groups))
    var, mean = mesh_mod.split_var_mean(xg, tuple(range(2, xg.dim())))
    stat = (x.shape[0], num_groups) + (1,) * (xg.dim() - 2)
    y = ((xg - mean.reshape(stat)) * torch.rsqrt(var + eps).reshape(stat)).flatten(1, 2)
    affine = (1, c) + (1,) * (x.dim() - 2)
    return (y * p.weight.to(nd).reshape(affine) + p.bias.to(nd).reshape(affine)).to(x.dtype)


def group_norm_silu(p: Norm, x: torch.Tensor, num_groups: int = 32,
                    eps: float = EPS, policy: Policy = FP32) -> torch.Tensor:
    return silu(group_norm(p, x, num_groups, eps, policy))


def layer_norm(p: Norm, x: torch.Tensor, eps: float = EPS,
               policy: Policy = FP32) -> torch.Tensor:
    nd = policy.norm_dtype
    y = F.layer_norm(x.to(nd), (x.shape[-1],), p.weight.to(nd), p.bias.to(nd),
                     eps)
    return y.to(x.dtype)


def group_norm_silu_folded(p: Norm, x: torch.Tensor, num_groups: int = 32,
                           eps: float = EPS, policy: Policy = FP32,
                           temb: Optional[torch.Tensor] = None,
                           apply_silu: bool = True) -> torch.Tensor:
    """GN of x (N, C, ...) (+ ``temb`` (N, C) added per channel) -> SiLU,
    the normalize applied as ``x * scale + shift`` in x's dtype
    (:func:`~.cuda.conv.fold_gn_affine`)."""
    scale, shift = fold_gn_affine(p, x, num_groups, eps=eps, temb=temb,
                                  norm_dtype=policy.norm_dtype)
    bshape = scale.shape + (1,) * (x.dim() - 2)
    y = x * scale.reshape(bshape).to(x.dtype) + shift.reshape(bshape).to(x.dtype)
    return silu(y) if apply_silu else y


def layer_norm_folded(p: Norm, x: torch.Tensor, eps: float = EPS,
                      policy: Policy = FP32) -> torch.Tensor:
    """LayerNorm over the last axis with statistics in ``policy.norm_dtype``
    and the normalize applied as ``x * scale + shift`` in x's dtype."""
    nd = policy.norm_dtype
    var, mean = torch.var_mean(x.to(nd), dim=-1, keepdim=True, unbiased=False)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    gamma = p.weight.to(nd)
    scale = (rstd * gamma).to(x.dtype)
    shift = (p.bias.to(nd) - mean * rstd * gamma).to(x.dtype)
    return x * scale + shift
