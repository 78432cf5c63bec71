"""Dense layer (port of ``ops/linear.py``).

The JAX package stores kernels as (in, out); the port keeps PyTorch's
(out, in) ``weight`` so CompVis checkpoints load untransposed.

``quant`` (the UNet's int8 tiers, ``ops/quant.py``), as the JAX package
dispatches it: "w8" runs every matmul weight-only int8, "wide" and "conv"
run dynamic w8a8 where the contraction is at least ``quant.MIN_K`` wide.

A row-parallel layer of tensor parallelism (``parallel/tp.py`` sets its
``tp_group``) holds an input-channel slice of the weight: its partial
products are summed over the group, and its bias is added after the sum.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import FP32, Policy


class Linear(nn.Module):
    """Parameter holder: ``weight`` (out, in), optional ``bias`` (out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(d_out, dtype=dtype, device=device)) \
            if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, as the JAX init."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=generator)


def apply(p: Linear, x: torch.Tensor, policy: Policy = FP32,
          quant: str = "none") -> torch.Tensor:
    cd = policy.compute_dtype
    row = getattr(p, "tp_group", None)
    if quant != "none":
        from . import quant as quant_mod

        if quant == "w8":  # weight-only: every matmul
            return quant_mod.w8_linear(x, p.weight, p.bias, cd, k_group=row).to(cd)
        if quant_mod.matmul_wants_int8(quant, p.weight.shape[1] * (
                1 if row is None else torch.distributed.get_world_size(row))):
            return quant_mod.int8_linear(x, p.weight, p.bias, k_group=row).to(cd)
    w = p.weight.to(cd)
    b = None if p.bias is None else p.bias.to(cd)
    if row is None:
        return F.linear(x.to(cd), w, b)
    y = F.linear(x.to(cd), w).float()
    torch.distributed.all_reduce(y, group=row)
    return (y if b is None else y + b.float()).to(cd)
