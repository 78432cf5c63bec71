"""The yardstick's arithmetic: the H100's peaks, the operations and bytes of
a kernel call from its shapes, and the operations a request needs from the
configuration's shapes.

Operations are those of the matrix products and convolutions (a multiply
and an add each); normalisation, softmax and elementwise work are not
counted.  A kernel's bytes count each input read once and the output
written once, whatever the kernel reads again.  The functions of a kernel
call follow ``chip_smoke.py``'s ``bound_ms`` and ``conv_flops``.
"""

from __future__ import annotations

import math
from typing import Sequence

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16_BYTES = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


# ------------------------------------------------------------ kernel calls
def attention_flops(q_shape: Sequence[int], k_shape: Sequence[int]) -> float:
    """QKᵀ and PV of one attention call: 4 · rows · keys · channels, with
    q as (B, Sq, H·Dh) or (B, H, Sq, Dh) and k alike."""
    if len(q_shape) == 3:  # heads packed in channels
        b, sq, c = q_shape
        return 4.0 * b * sq * k_shape[1] * c
    b, h, sq, dh = q_shape
    return 4.0 * b * h * sq * k_shape[2] * dh


def attention_bytes(q_shape, k_shape, v_shape, itemsize: int = BF16_BYTES) -> float:
    """q, k and v read once and the output (q's shape) written once."""
    return itemsize * (2 * math.prod(q_shape) + math.prod(k_shape) + math.prod(v_shape))


def conv_flops(b: int, h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout * h * w * b


def k5_bytes(x_shape, weight_shape, itemsize: int = BF16_BYTES) -> float:
    """K5 (GN affine, SiLU, 3x3 conv): x and the weight read once, the output
    written once, the fp32 per-(batch, channel) scale and shift and the bias."""
    b, cin, h, w = x_shape
    cout = weight_shape[0]
    return itemsize * (b * cin * h * w + math.prod(weight_shape) + b * cout * h * w) \
        + 4 * (2 * b * cin + cout)


# ------------------------------------------------------------- the models
def _linear(rows: float, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def _unet_levels(u: dict):
    depth = u["transformer_depth"]
    mults = u["channel_mult"]
    depth = list(depth) if isinstance(depth, list) else [depth] * len(mults)
    return [(u["model_channels"] * m, 2 ** i in u["attention_resolutions"], depth[i])
            for i, m in enumerate(mults)]


def _res(b, h, w, cin, cout, t_dim):
    f = conv_flops(b, h, w, cin, cout) + conv_flops(b, h, w, cout, cout) \
        + _linear(b, t_dim, cout)
    if cin != cout:
        f += conv_flops(b, h, w, cin, cout, 1)
    return f


def _transformer(b, s, c, depth, ctx_len, d_ctx):
    per_layer = _linear(b * s, c, c) * 4 + 4.0 * b * s * s * c \
        + _linear(b * s, c, c) * 2 + _linear(b * ctx_len, d_ctx, c) * 2 \
        + 4.0 * b * s * ctx_len * c + _linear(b * s, c, 8 * c) + _linear(b * s, 4 * c, c)
    return _linear(b * s, c, c) * 2 + depth * per_layer


def unet_flops(u: dict, b: int, h: int, w: int, ctx_len: int) -> float:
    """One UNet evaluation of a batch of ``b`` latents of (h, w)."""
    c0, t_dim = u["model_channels"], 4 * u["model_channels"]
    levels = _unet_levels(u)
    f = _linear(b, c0, t_dim) + _linear(b, t_dim, t_dim)
    if u.get("adm_in_channels"):
        f += _linear(b, u["adm_in_channels"], t_dim) + _linear(b, t_dim, t_dim)
    f += conv_flops(b, h, w, u["in_channels"], c0)
    skips, c_prev = [c0], c0
    for i, (c, attn, depth) in enumerate(levels):
        hh, ww = h >> i, w >> i
        for _ in range(u["num_res_blocks"]):
            f += _res(b, hh, ww, c_prev, c, t_dim)
            if attn:
                f += _transformer(b, hh * ww, c, depth, ctx_len, u["context_dim"])
            c_prev = c
            skips.append(c)
        if i < len(levels) - 1:
            f += conv_flops(b, hh // 2, ww // 2, c, c)
            skips.append(c)
    n = len(levels) - 1
    c_mid, _, d_mid = levels[-1]
    f += 2 * _res(b, h >> n, w >> n, c_mid, c_mid, t_dim) \
        + _transformer(b, (h >> n) * (w >> n), c_mid, d_mid, ctx_len, u["context_dim"])
    for i in reversed(range(len(levels))):
        c, attn, depth = levels[i]
        hh, ww = h >> i, w >> i
        for j in range(u["num_res_blocks"] + 1):
            f += _res(b, hh, ww, c_prev + skips.pop(), c, t_dim)
            if attn:
                f += _transformer(b, hh * ww, c, depth, ctx_len, u["context_dim"])
            c_prev = c
            if j == u["num_res_blocks"] and i > 0:
                f += conv_flops(b, 2 * hh, 2 * ww, c, c)
    return f + conv_flops(b, h, w, c0, u["out_channels"])


def text_flops(te: dict, rows: int) -> float:
    """One tower over ``rows`` prompts of its context length: the layers
    the hidden state needs, or all of them where the pooled vector is
    taken."""
    from .reference.model import tower_stop

    n, d, ff = te["context_length"], te["width"], te["mlp_width"]
    layers = te["layers"] if te.get("always_return_pooled") else tower_stop(te)
    per_layer = _linear(rows * n, d, d) * 4 + 4.0 * rows * n * n * d \
        + _linear(rows * n, d, ff) + _linear(rows * n, ff, d)
    f = layers * per_layer
    if te.get("always_return_pooled"):
        f += _linear(rows, d, d)
    return f


def _vae_res(b, h, w, cin, cout):
    f = conv_flops(b, h, w, cin, cout) + conv_flops(b, h, w, cout, cout)
    return f + (conv_flops(b, h, w, cin, cout, 1) if cin != cout else 0.0)


def vae_decode_flops(v: dict, b: int, h: int, w: int) -> float:
    """The decoder over a batch of ``b`` latents of (h, w)."""
    chs = [v["ch"] * m for m in v["ch_mult"]]
    z, top = v["z_channels"], chs[-1]
    s = h * w
    f = conv_flops(b, h, w, v["embed_dim"], z, 1) + conv_flops(b, h, w, z, top)
    f += 2 * _vae_res(b, h, w, top, top) + _linear(b * s, top, top) * 4 + 4.0 * b * s * s * top
    c_prev, hh, ww = top, h, w
    for lv in reversed(range(len(chs))):
        c = chs[lv]
        for i in range(v["num_res_blocks"] + 1):
            f += _vae_res(b, hh, ww, c_prev if i == 0 else c, c)
        c_prev = c
        if lv > 0:
            hh, ww = 2 * hh, 2 * ww
            f += conv_flops(b, hh, ww, c, c)
    return f + conv_flops(b, hh, ww, chs[0], v["out_ch"])


def pass_flops(model: dict, b: int, height: int, width: int, steps: int,
               start: int = 0) -> float:
    """One denoising pass of ``b`` images: the towers over their cond and
    uncond prompts, and the UNet evaluations from ``start`` to ``steps`` at
    the CFG batch ``2 b``."""
    f_lat = 2 ** (len(model["first_stage_config"]["ch_mult"]) - 1)
    ctx = model["text_encoders"][0]["context_length"]
    return sum(text_flops(te, 2 * b) for te in model["text_encoders"]) \
        + (steps - start) * unet_flops(model["unet_config"], 2 * b, height // f_lat,
                                       width // f_lat, ctx)


def decode_flops(model: dict, b: int, height: int, width: int) -> float:
    """The decode of ``b`` images of ``height`` x ``width``."""
    f_lat = 2 ** (len(model["first_stage_config"]["ch_mult"]) - 1)
    return vae_decode_flops(model["first_stage_config"], b, height // f_lat, width // f_lat)


_ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def call_bound_s(call) -> float:
    """The roofline bound of one recorded call of the program's kernel ops
    (``trace.OpCall``): attention ops take (q, k, v, ...), K5 (x, scale,
    shift, weight, bias)."""
    shapes = call.shapes
    item = _ITEMSIZE.get((call.dtypes or ["c10::BFloat16"])[0], 2)
    if call.name.endswith("scaled_silu_conv3x3"):
        b, cin, h, w = shapes[0]
        return bound_s(conv_flops(b, h, w, cin, shapes[3][0]),
                       k5_bytes(shapes[0], shapes[3], item))
    return bound_s(attention_flops(shapes[0], shapes[1]),
                   attention_bytes(shapes[0], shapes[1], shapes[2], item))


def roofline_pct(op_calls, op: str):
    """Σ bound over Σ device time of the calls of ``op``, in percent; None
    where the window holds no such call or no device time for it."""
    calls = [c for c in op_calls if c.name == op]
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(call_bound_s(c) for c in calls) / device_s
