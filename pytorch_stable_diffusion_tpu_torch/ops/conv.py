"""2-D convolution, NCHW (port of ``ops/conv.py``).

The port keeps PyTorch's NCHW shapes with OIHW ``weight``s, so CompVis
weights load untransposed; on CUDA the models run in ``channels_last``
memory format, which cuDNN executes as NHWC.

Padding semantics the reference relies on:
  * VAE-encoder downsampling: stride 2, no padding after a manual
    right/bottom-only pad (:data:`ASYM_DOWN`).
  * UNet downsampling: stride 2 with symmetric pad 1.
``padding`` is an int (symmetric) or ((top, bottom), (left, right)).

Seamless tiling (A1111's ``--tiling``): under :func:`circular_padding`
every conv with non-zero padding wrap-pads its input (``F.pad(mode=
"circular")``, the asymmetric downsample pad included) and convolves
VALID, so that the image tiles without a seam.  The mode is per request:
``generate(tiling=True)`` holds it around the whole request.  K5 pads with
zeros, so ``models/unet.ResBlock`` takes a plain-conv tier under it
(:func:`circular_padding_active`), as the JAX package takes its Pallas conv
off the path.

``quant`` (the UNet's int8 tiers, ``ops/quant.py``), as the JAX package
dispatches it: "w8" runs every conv weight-only int8, "wide" and "conv"
run dynamic w8a8 where ``quant.conv_wants_int8`` says (every 3x3 conv
under "conv").

Sequence parallelism (``core/mesh.split_rows``): each rank holds its rows
of every level.  A conv first fetches the rows its output rows read past
its own (``core/mesh.fetch_rows``: a halo row each side for a 3x3 conv,
the row above for the stride-2 downsample, zeros or the wrapped rows at
the level's border), pads W itself and convolves VALID, the int8 tiers
included; :func:`upsample_nearest_2x` moves its output onto the fine
level's rows where the two levels' blocks do not line up.  A rank with no
rows takes part in every collective and returns none.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import mesh as mesh_mod
from ..core.dtypes import FP32, Policy

PadT = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]

#: right/bottom-only padding used by VAE-encoder stride-2 convs
ASYM_DOWN: PadT = ((0, 1), (0, 1))

#: every conv pads circularly instead of with zeros (seamless tiling)
_CIRCULAR = contextvars.ContextVar("conv_circular", default=False)


@contextlib.contextmanager
def circular_padding(on: bool = True):
    """Every conv inside the ``with`` block pads circularly (``on``), and the
    mode before it is restored on the way out, also on an exception."""
    token = _CIRCULAR.set(on)
    try:
        yield
    finally:
        _CIRCULAR.reset(token)


def circular_padding_active() -> bool:
    """Whether convs pad circularly here: the res blocks' fused conv K5,
    which pads with zeros, is then off the path."""
    return _CIRCULAR.get()


class Conv(nn.Module):
    """Parameter holder: ``weight`` (out, in, k, k), optional ``bias``."""

    def __init__(self, c_in: int, c_out: int, ksize: int = 3, bias: bool = True,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, ksize, ksize,
                                               dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype, device=device)) \
            if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the JAX init."""
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        self.weight.data.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=generator)


def apply(p: Conv, x: torch.Tensor, stride: int = 1, padding: PadT = 0,
          policy: Policy = FP32, quant: str = "none") -> torch.Tensor:
    """x: (N, C_in, H, W) -> (N, C_out, H', W')."""
    x = x.to(policy.compute_dtype)
    empty = False
    if mesh_mod.row_split() is not None:
        x, empty = _split_rows_input(x, p.weight.shape[2], stride, padding)
        padding = 0
    elif _CIRCULAR.get() and padding not in (0, ((0, 0), (0, 0))):
        # seamless tiling: wrap-pad (periodic boundary), then VALID
        (top, bottom), (left, right) = ((padding,) * 2,) * 2 if isinstance(padding, int) \
            else padding
        channels_last = not x.is_contiguous() and \
            x.is_contiguous(memory_format=torch.channels_last)
        x = F.pad(x, (left, right, top, bottom), mode="circular")
        if channels_last:  # keep the card's layout for the conv and after it
            x = x.contiguous(memory_format=torch.channels_last)
        padding = 0
    elif not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    y = _conv(p, x, stride, padding, policy, quant)
    return y[:, :, :0] if empty else y


def _conv(p: Conv, x: torch.Tensor, stride: int, padding: int, policy: Policy,
          quant: str) -> torch.Tensor:
    if quant != "none":
        from . import quant as quant_mod

        cd = policy.compute_dtype
        if quant == "w8":  # weight-only: every conv
            return quant_mod.w8_conv(x, p.weight, stride=stride, padding=padding,
                                     bias=p.bias, compute_dtype=cd).to(cd)
        if quant_mod.conv_wants_int8(quant, p.weight.shape[1], p.weight.shape[2]):
            return quant_mod.int8_conv(x, p.weight, stride=stride, padding=padding,
                                       bias=p.bias).to(cd)
    w = p.weight.to(policy.compute_dtype)
    b = None if p.bias is None else p.bias.to(policy.compute_dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _split_rows_input(x: torch.Tensor, k: int, stride: int, padding: PadT):
    """Under a row split: the rows of x's level that this rank's output
    rows read (fetched from their owners), W padded as ``padding`` says
    (circularly under seamless tiling) -> (the input of a VALID conv,
    whether this rank's output has no rows: the input is then ``k`` zero
    rows, whose one output row the caller drops)."""
    split = mesh_mod.row_split()
    (top, bottom), (left, right) = ((padding,) * 2,) * 2 if isinstance(padding, int) \
        else padding
    circular = _CIRCULAR.get()
    if k == 1 and stride == 1 and top == bottom == 0:
        x_in = x  # a 1x1 conv reads the rank's own rows
    else:
        rows = split.level_rows(x.shape[-1])
        rows_out = (rows + top + bottom - k) // stride + 1
        needs = [range(a * stride - top, (b - 1) * stride - top + k) if b > a else ()
                 for a, b in split.spans(rows_out)]
        x_in = mesh_mod.fetch_rows(x, needs, circular=circular)
    empty = x_in.shape[2] == 0
    if empty:
        x_in = x.new_zeros(x.shape[:2] + (k, x.shape[3]))
    if left or right:
        x_in = F.pad(x_in, (left, right, 0, 0), mode="circular" if circular else "constant")
    if x_in.is_cuda:
        x_in = x_in.contiguous(memory_format=torch.channels_last)
    return x_in, empty


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (N, C, H, W).  Under a row split
    the output holds the fine level's rows of this rank: the coarse rows
    upsampled where the two levels' blocks line up, else taken from the
    whole coarse level."""
    split = mesh_mod.row_split()
    if split is None:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    rows = split.level_rows(x.shape[-1])
    if all(fine == (2 * a, 2 * b) for fine, (a, b) in zip(split.spans(2 * rows),
                                                          split.spans(rows))):
        if x.shape[2] == 0:
            return x.new_zeros(x.shape[:2] + (0, 2 * x.shape[3]))
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    lo, hi = split.span(2 * rows)
    whole = F.interpolate(mesh_mod.gather_rows(x, split), scale_factor=2.0, mode="nearest")
    return whole[:, :, lo:hi]
