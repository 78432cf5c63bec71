"""Image resampling without jax: :func:`resize`, the counterpart of
``jax.image.resize`` that ``hires_fix`` runs on latents and
``inpaint(full_res=True)`` on images.

``torch.nn.functional.interpolate`` matches none of jax's methods, so the
separable weight matrices are built here as ``jax._src.image.scale``
builds them, and applied with one matmul per resized axis:

* half-pixel centres: output pixel i samples input coordinate
  ``(i + 0.5) · in/out - 0.5``;
* on a downscale the kernel's support widens by in/out (antialiasing);
  each column of weights is normalised to sum 1, and a sample that falls
  outside the input gets none;
* "bilinear" is the triangle kernel, "cubic" Keys' cubic with a = -0.5
  (torch's bicubic uses -0.75), "lanczos3" the radius-3 Lanczos kernel;
* "nearest" takes input ``floor((i + 0.5) · in/out)``, torch's
  ``nearest-exact``.

An axis whose size does not change is left as it is, as in jax.  The
weights are float32, as jax computes them for float32 inputs.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

METHODS = ("nearest", "bilinear", "cubic", "lanczos3")


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x, radius: float = 3.0):
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    den = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos3}


def weight_matrix(n_in: int, n_out: int, method: str) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis (jax's
    ``compute_weight_mat`` at translation 0, antialiased)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() \
        / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(n_in: int, n_out: int) -> torch.Tensor:
    offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.floor(offsets).to(torch.int64)


def resize(x, shape: Sequence[int], method: str):
    """``x`` (a numpy array or a float tensor, any rank) resampled to
    ``shape``, an output size for every axis, by ``method`` (one of
    :data:`METHODS`): the result of ``jax.image.resize(x, shape, method)``
    as a float32 array or tensor of the input's kind (on its device)."""
    if method not in METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    shape = tuple(int(n) for n in shape)
    as_numpy = not isinstance(x, torch.Tensor)
    t = torch.as_tensor(np.asarray(x, np.float32)) if as_numpy else x.float()
    if len(shape) != t.dim():
        raise ValueError(f"shape must have length equal to the number of dimensions of x; "
                         f" {shape} vs {tuple(t.shape)}")
    for d, (n_in, n_out) in enumerate(zip(t.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            t = t.index_select(d, _nearest_index(n_in, n_out).to(t.device))
        else:
            w = weight_matrix(n_in, n_out, method).to(t.device)
            t = torch.tensordot(t.movedim(d, -1), w, dims=1).movedim(-1, d)
    t = t.contiguous()
    return t.numpy() if as_numpy else t
