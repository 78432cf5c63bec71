"""Int8 tiers of the UNet's contractions (port of ``ops/quant.py``).

Symmetric dynamic quantization, no zero points, as in the JAX package:

* weights: per-output-channel absmax scales;
* activations (w8a8): one per-tensor absmax scale each call, over the
  whole batch;
* w8a8 accumulates int8 x int8 -> int32 (``torch._int_mm``: cuBLASLt's
  int8 tensor-core product on the card), then dequantizes as
  ``acc.float() * (x_scale * w_scale)`` and adds the bias in fp32, in the
  JAX package's order, so that on equal inputs the int8 values and the
  int32 accumulators are the JAX package's bit for bit;
* w8 (weight-only) runs the product in the compute dtype on the int8
  values (exact in bf16) and applies the weight scale to the fp32 output.

torch has no CUDA int8 convolution, so :func:`int8_conv` is an im2col over
the padded int8 input followed by the same ``_int_mm``.  ``_int_mm``'s CUDA
shape rules (M > 16, K and N multiples of 8) are met by zero padding after
the scales are taken (:func:`int_mm`); a failing ``_int_mm`` raises, it
never turns into a float product.

The weights' quantization is hoisted out of the denoise loop: inside
:func:`weight_cache` (``pipeline.generate`` holds one around a request)
each weight is quantized once, w8's int8 values stored once in the compute
dtype.

Under a data axis (``parallel/dp.py``) a rank holds a slice of the batch,
and under sequence parallelism its rows of each UNet level, so the
activation absmax is reduced (MAX) over the groups of
``core.mesh.reduce_groups()`` (a conv's halo rows are rows of the same
tensor, so the MAX is unchanged by them); under tensor parallelism a row-parallel
layer's contraction is split over the model group (``k_group``): its
activation and per-channel weight absmax are reduced (MAX) over it and its
int32 accumulators summed before the dequantize.  Either way the scales,
the int8 values and the accumulators are those of one device.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..core import mesh as mesh_mod

#: contractions narrower than this stay in bf16/fp32 (the JAX package's
#: threshold: the TPU probe lost at K=320 and won from K=1280)
MIN_K = 1280

_CACHE = contextvars.ContextVar("quant_weight_cache", default=None)


@contextlib.contextmanager
def weight_cache():
    """Quantize each weight once inside the block (a request): the weights
    are loop invariants, as XLA hoists them in the JAX package."""
    token = _CACHE.set({})
    try:
        yield
    finally:
        _CACHE.reset(token)


def _cached(key, weights, make):
    cache = _CACHE.get()
    if cache is None:
        return make()
    hit = cache.get(key)
    if hit is None:
        # the weights ride along, so that no id is reused while cached
        hit = cache[key] = (make(), weights)
    return hit[0]


def fused(parts):
    """The weights (and biases) of same-input linears concatenated on the
    out dim, once a request (``ops/attention._fused_proj``)."""
    def make():
        b = None if parts[0].bias is None else torch.cat([p.bias for p in parts])
        return torch.cat([p.weight for p in parts], 0), b
    return _cached(("cat",) + tuple(id(p.weight) for p in parts), parts, make)


def _absmax_scale(x: torch.Tensor, dims, eps: float = 1e-12, groups=()) -> torch.Tensor:
    """Symmetric absmax scale over ``dims`` (kept), fp32; reduced (MAX)
    over ``groups`` where the tensor is split across ranks."""
    if x.numel():
        m = torch.amax(x.float().abs(), dim=dims, keepdim=True)
    else:  # a rank with no rows of the tensor (sequence parallelism)
        m = torch.zeros([1 if d in dims else n for d, n in enumerate(x.shape)],
                        device=x.device)
    m = mesh_mod.all_reduce_max(m, groups)
    # a tensor divisor: torch divides by a Python scalar on the card as a
    # product with its reciprocal, one ulp off the CPU's and XLA's quotient
    return torch.clamp(m, min=eps) / torch.full_like(m, 127.0)


def quantize(x: torch.Tensor, dims, groups=()):
    """x -> (int8 values, fp32 scale with kept dims): round half to even,
    as ``jnp.round``, then clip to [-127, 127]."""
    s = _absmax_scale(x, dims, groups=groups)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    return q.to(torch.int8), s


def _pad_to(n: int, multiple: int, least: int = 0) -> int:
    return max(-(-n // multiple) * multiple, least)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32 through ``torch._int_mm``,
    zero-padded to its CUDA shape rules (M > 16, K and N multiples of 8)
    and sliced back; zero rows and columns add nothing to the sums."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = _pad_to(m, 8, 24), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a.contiguous(), b.contiguous().t())
    return acc[:m, :n]


def _weight_int8(weight: torch.Tensor, k_group):
    """(O, ...) weight -> (int8 (O, K), fp32 scales (O,)), per output
    channel, quantized once a request."""
    def make():
        dims = tuple(range(1, weight.dim()))
        q, s = quantize(weight, dims, groups=() if k_group is None else (k_group,))
        return q.reshape(weight.shape[0], -1), s.reshape(-1)
    return _cached(("int8", id(weight), id(k_group)), weight, make)


def _dequantize(acc, xs, ws, bias, k_group):
    if k_group is not None:
        torch.distributed.all_reduce(acc, group=k_group)  # int32: exact
    y = acc.float() * (xs.reshape(()) * ws)
    if bias is not None:
        y = y + bias.float()
    return y


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias=None, *, k_group=None):
    """(..., K) @ (O, K)ᵀ with dynamic w8a8 -> (..., O) fp32.  ``weight``
    is PyTorch's (out, in); per-output-channel weight scales, one
    per-tensor activation scale.  ``k_group``: the process group over which
    K is split (a row-parallel layer)."""
    wq, ws = _weight_int8(weight, k_group)
    groups = mesh_mod.reduce_groups() + (() if k_group is None else (k_group,))
    xq, xs = quantize(x, tuple(range(x.dim())), groups=groups)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq)
    return _dequantize(acc, xs, ws, bias, k_group).reshape(*x.shape[:-1], -1)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1, padding: int = 1,
              bias=None):
    """NCHW conv with dynamic w8a8 -> fp32 (N, O, H', W') in channels_last
    memory.  ``weight``: OIHW, per-O-channel scales.  An im2col of the
    zero-padded int8 input (patch order (C, kh, kw), the weight's) through
    :func:`int_mm`.  ``padding``: the same on every side (``conv.apply``
    pads an asymmetric conv's input before it dispatches)."""
    wq, ws = _weight_int8(weight, None)
    xq, xs = quantize(x, (0, 1, 2, 3), groups=mesh_mod.reduce_groups())
    acc = conv_int32(xq, wq, weight.shape[2:], stride=stride, padding=padding)
    y = _dequantize(acc.reshape(-1, acc.shape[-1]), xs, ws, bias, None)
    return y.reshape(acc.shape).permute(0, 3, 1, 2)


def conv_int32(xq: torch.Tensor, wq: torch.Tensor, ksize, *, stride: int = 1,
               padding: int = 1) -> torch.Tensor:
    """The int32 accumulators of an int8 NCHW conv, (N, H', W', O): the
    zero-padded input's (C, kh, kw) patches (im2col) times ``wq`` (O,
    C·kh·kw) through :func:`int_mm`."""
    if padding:
        xq = F.pad(xq, (padding,) * 4)
    cols = xq.permute(0, 2, 3, 1).unfold(1, ksize[0], stride).unfold(2, ksize[1], stride)
    n, ho, wo = cols.shape[:3]
    return int_mm(cols.reshape(n * ho * wo, -1), wq.reshape(wq.shape[0], -1)) \
        .reshape(n, ho, wo, -1)


def _weight_w8(weight: torch.Tensor, compute_dtype, k_group):
    """w8's stored weight: the int8 values in the compute dtype (exact for
    bf16 and fp32) and the fp32 per-output-channel scales."""
    def make():
        q, s = _weight_int8(weight, k_group)
        return q.reshape(weight.shape).to(compute_dtype), s
    return _cached(("w8", id(weight), id(k_group), compute_dtype), weight, make)


def _w8_out(y, ws, bias, k_group):
    y = y.float()
    if k_group is not None:
        torch.distributed.all_reduce(y, group=k_group)
    y = y * ws
    if bias is not None:
        y = y + bias.float()
    return y


def w8_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
              compute_dtype=torch.bfloat16, *, k_group=None):
    """(..., K) @ (O, K)ᵀ with weight-only int8 (w8a16) -> fp32: the
    product in the compute dtype on the int8 values, the per-channel scale
    on the fp32 output (no dequantized weight)."""
    wq, ws = _weight_w8(weight, compute_dtype, k_group)
    return _w8_out(F.linear(x.to(compute_dtype), wq), ws, bias, k_group)


def w8_conv(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1, padding: int = 1,
            bias=None, compute_dtype=torch.bfloat16):
    """NCHW conv with weight-only int8 (see :func:`w8_linear`) -> fp32;
    ``padding`` as :func:`int8_conv` takes it."""
    wq, ws = _weight_w8(weight, compute_dtype, None)
    y = F.conv2d(x.to(compute_dtype), wq, None, stride=stride, padding=padding)
    return _w8_out(y, ws[:, None, None], bias[:, None, None] if bias is not None else None,
                   None)


def conv_wants_int8(quant: str, c_in: int, kh: int = 3) -> bool:
    """Dispatch predicate for convs: "conv" every conv whose effective
    K = kh²·c_in >= MIN_K (every 3x3 SD conv; 1x1s at the wide levels),
    "wide" only c_in >= MIN_K."""
    if quant == "conv":
        return kh * kh * c_in >= MIN_K
    if quant == "wide":
        return c_in >= MIN_K
    return False


def matmul_wants_int8(quant: str, k: int) -> bool:
    """Dispatch predicate for channel matmuls (attention/GeGLU projections)."""
    return quant in ("wide", "conv") and k >= MIN_K
