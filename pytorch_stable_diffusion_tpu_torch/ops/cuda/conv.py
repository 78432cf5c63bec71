"""Fused GroupNorm -> SiLU -> 3x3 conv (the UNet res-block half), K5.

Port of ``pytorch_stable_diffusion_tpu/ops/pallas/conv.py``:

* :func:`fold_gn_affine` collapses GroupNorm (and the res block's
  per-(batch, channel) time-embedding add) into fp32 (B, C) ``scale`` and
  ``shift``, so the kernel never needs group logic or ``x + t``.
* :func:`scaled_silu_conv3x3` is ``conv3x3(silu(x*scale + shift)) + bias``
  with SAME zero padding applied after the activation: CUDA kernel
  ``csrc/scaled_silu_conv3x3.cu`` (the Pallas ``_kernel``; in bf16 a wgmma
  implicit GEMM fed by TMA, the activation applied once per halo element,
  Cin split over a thread-block cluster where the grid is small), with its
  plain PyTorch version :func:`scaled_silu_conv3x3_plain` beside it.
* :func:`gn_silu_conv3x3` is a whole res-block half.

Tensors are the port's NCHW; on the card, x and the conv weight must be in
``channels_last`` memory (NHWC bytes, and (Cout, 3, 3, Cin) for the
weight, as ``build_models`` lays them out): the kernel reads both in place
and the wrapper raises rather than copy them.  The kernel is the
``torch.library`` op ``torch.ops.sdt_torch.scaled_silu_conv3x3``
(``ops/cuda/flash_attention.py`` says why): its CPU implementation runs the
plain version, its CUDA implementation launches the kernel or raises (there
is no fallback), its fake implementation gives the output's shape, dtype
and memory format and launches nothing.  Launches are counted in
``scaled_silu_conv3x3.launches``, inside the CUDA implementation.

The JAX package's ``eligible``, ``_pick_blocks`` and ``_estimate_vmem`` are
TPU rules (128-lane channels, W a multiple of 8, a VMEM model) and are not
ported: the kernel takes any H and W, and channels that are multiples of 8.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import define_op

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fold_gn_affine(norm_p, x: torch.Tensor, num_groups: int, *, eps: float = 1e-5,
                   temb: Optional[torch.Tensor] = None,
                   norm_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm of x (N, C, ...) (+ ``temb`` (N, C) added per channel) as
    ``gn(v) = v * scale + shift`` -> ``scale``, ``shift`` (N, C) in
    ``norm_dtype``.

    The statistics are taken in ``norm_dtype`` over the spatial dims and the
    channels of each group of ``x + temb``, with the sum rounded to x's
    dtype as the exact path rounds it; ``temb * scale`` then joins the shift,
    so that the conv reads the raw ``x``."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    v = x if temb is None else x + temb.reshape(n, c, *([1] * (x.dim() - 2))).to(x.dtype)
    vg = v.to(norm_dtype).unflatten(1, (num_groups, c // num_groups))
    var, mean = torch.var_mean(vg, dim=tuple(range(2, vg.dim())), unbiased=False)
    rstd = torch.reciprocal(torch.sqrt(var + eps))                       # (N, G)
    groups = (num_groups, c // num_groups)
    scale = rstd[:, :, None] * norm_p.weight.to(norm_dtype).view(groups)
    shift = norm_p.bias.to(norm_dtype).view(groups) - mean[:, :, None] * scale
    scale, shift = scale.reshape(n, c), shift.reshape(n, c)
    if temb is not None:
        shift = shift + temb.to(norm_dtype) * scale
    return scale, shift


def scaled_silu_conv3x3_plain(x: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: the activation in fp32, rounded to x's dtype, then
    the conv in x's dtype with zero padding after the activation."""
    dt = x.dtype
    a = F.silu(x.float() * scale.float()[:, :, None, None]
               + shift.float()[:, :, None, None]).to(dt)
    return F.conv2d(a, weight.to(dt), bias.to(dt), padding=1)


def _check(x, scale, shift, weight, bias):
    if x.dim() != 4:
        raise ValueError("scaled_silu_conv3x3 wants x of shape (B, C, H, W)")
    b, c = x.shape[:2]
    if weight.shape[1:] != (c, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not (Cout, {c}, 3, 3)")
    if scale.shape != (b, c) or shift.shape != (b, c):
        raise ValueError(f"scale/shift must be ({b}, {c}), got {tuple(scale.shape)} "
                         f"and {tuple(shift.shape)}")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match {weight.shape[0]} "
                         "output channels")
    if len({t.device for t in (x, scale, shift, weight, bias)}) != 1:
        raise ValueError("x, scale, shift, weight and bias must share a device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scaled_silu_conv3x3 runs on CPU or CUDA, not {x.device.type}")


def _launch(x, scale, shift, weight, bias):
    from .build import load

    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"scaled_silu_conv3x3 kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if cin % 8 or cout % 8:
        raise ValueError(f"scaled_silu_conv3x3 kernel takes channel counts that are "
                         f"multiples of 8, got {cin} -> {cout}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("scaled_silu_conv3x3 kernel needs x in channels_last memory")
    weight = weight.to(x.dtype)
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("scaled_silu_conv3x3 kernel needs the weight in channels_last "
                         "memory ((Cout, 3, 3, Cin) bytes, as build_models lays it out)")
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    bias = bias.float().contiguous()
    if any(t.data_ptr() % 16 for t in (x, weight, scale, shift, bias)):
        raise ValueError("scaled_silu_conv3x3 kernel needs 16-byte aligned x, weight, "
                         "scale, shift and bias")
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    lib, _ = load("scaled_silu_conv3x3")
    fn = lib.sdt_scaled_silu_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
             bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
             _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        lib.sdt_cuda_error_string.restype = ctypes.c_char_p
        lib.sdt_cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"scaled_silu_conv3x3 launch failed ({err}): "
                           f"{lib.sdt_cuda_error_string(err).decode()}")
    scaled_silu_conv3x3.launches += 1
    return out


def _k5_cpu(x, scale, shift, weight, bias):
    return scaled_silu_conv3x3_plain(x, scale, shift, weight, bias)  # looked up when called


def _k5_fake(x, scale, shift, weight, bias):
    if x.device.type == "cuda":  # the kernel writes NHWC
        b, _, h, w = x.shape
        return torch.empty((b, weight.shape[0], h, w), dtype=x.dtype, device=x.device,
                           memory_format=torch.channels_last)
    # the plain version's conv, on an activation laid out as x
    dt = x.dtype
    return F.conv2d(torch.empty_like(x), weight.to(dt), bias.to(dt), padding=1)


define_op("scaled_silu_conv3x3(Tensor x, Tensor scale, Tensor shift, Tensor weight, "
          "Tensor bias) -> Tensor", _k5_cpu, _launch, _k5_fake)


def scaled_silu_conv3x3(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K5: ``conv3x3(silu(x*scale[b] + shift[b]), weight) + bias``, SAME zero
    padding after the activation.

    x: (B, Cin, H, W); scale/shift: (B, Cin) fp32 (see :func:`fold_gn_affine`);
    weight: (Cout, Cin, 3, 3); bias: (Cout,).  Returns (B, Cout, H, W) in x's
    dtype (channels_last memory on the card)."""
    _check(x, scale, shift, weight, bias)
    return torch.ops.sdt_torch.scaled_silu_conv3x3(x, scale, shift, weight, bias)


scaled_silu_conv3x3.launches = 0


def gn_silu_conv3x3(norm_p, conv_p, x: torch.Tensor, num_groups: int, *,
                    eps: float = 1e-5,
                    temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A whole res-block half: GN(x [+ temb]) -> SiLU -> 3x3 conv, with
    ``norm_p``/``conv_p`` the ``Norm``/``Conv`` parameter holders."""
    scale, shift = fold_gn_affine(norm_p, x, num_groups, eps=eps, temb=temb)
    return scaled_silu_conv3x3(x, scale, shift, conv_p.weight, conv_p.bias)
