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
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

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
          policy: Policy = FP32) -> torch.Tensor:
    """x: (N, C_in, H, W) -> (N, C_out, H', W')."""
    x = x.to(policy.compute_dtype)
    if _CIRCULAR.get() and padding not in (0, ((0, 0), (0, 0))):
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
    w = p.weight.to(policy.compute_dtype)
    b = None if p.bias is None else p.bias.to(policy.compute_dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (N, C, H, W)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
