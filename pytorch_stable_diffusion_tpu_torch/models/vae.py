"""AutoencoderKL — VAE encoder + decoder (port of ``models/vae.py``).

encoder: conv_in -> levels of 2 res blocks with stride-2 downsamples that
         pad right/bottom only -> mid res/attn/res -> GN+SiLU -> conv_out
         (C -> 2L) -> 1x1 quant_conv -> mean/logvar, logvar clamped to
         [-30, 20], reparameterized with caller-supplied noise, x 0.18215.
decoder: / 0.18215 -> 1x1 post_quant_conv -> conv_in -> mid -> levels of 3
         res blocks with nearest-2x upsample + conv -> GN+SiLU -> conv_out.

:func:`apply_encoder_tiled` and :func:`apply_decoder_tiled` bound the
memory of high-resolution encodes and decodes: the image-resolution convs
run over overlapping spatial tiles, one at a time, while the mid block and
its global attention run whole at latent resolution.

``reference_quirks=True`` reproduces the reference's mid-block attention
bugs: it never calls its GroupNorm, and its un-transpose is a no-op, so the
(n, h·w, c) attention output is read back as (n, c, h, w) memory.

Tensors are NCHW; parameter names follow the JAX pytree paths.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, conv, norm
from ..ops.conv import ASYM_DOWN, upsample_nearest_2x
from .config import VAEConfig


class ResBlock(nn.Module):
    """GN -> SiLU -> conv3x3, twice, + identity/1x1 skip."""

    def __init__(self, c_in: int, c_out: int, **kw):
        super().__init__()
        self.norm1 = norm.Norm(c_in, **kw)
        self.conv1 = conv.Conv(c_in, c_out, 3, **kw)
        self.norm2 = norm.Norm(c_out, **kw)
        self.conv2 = conv.Conv(c_out, c_out, 3, **kw)
        self.shortcut = conv.Conv(c_in, c_out, 1, **kw) if c_in != c_out else None

    def forward(self, x, groups: int, policy: Policy):
        h = norm.group_norm_silu(self.norm1, x, groups, policy=policy)
        h = conv.apply(self.conv1, h, padding=1, policy=policy)
        h = norm.group_norm_silu(self.norm2, h, groups, policy=policy)
        h = conv.apply(self.conv2, h, padding=1, policy=policy)
        res = x if self.shortcut is None else conv.apply(self.shortcut, x,
                                                         policy=policy)
        return h + res


class AttnBlock(nn.Module):
    """1-head spatial self-attention over H*W tokens, no mask."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.norm = norm.Norm(channels, **kw)
        self.attn = attention.Attention(channels, **kw)

    def forward(self, x, groups: int, policy: Policy, *, backend: str = "plain",
                reference_quirks: bool = False):
        n, c, h, w = x.shape
        y = x if reference_quirks else norm.group_norm(self.norm, x, groups,
                                                       policy=policy)
        y = y.permute(0, 2, 3, 1).reshape(n, h * w, c)
        y = attention.apply(self.attn, y, n_heads=1, backend=backend,
                            policy=policy).contiguous()
        if reference_quirks:
            # the (n, h·w, c) memory reinterpreted as (n, c, h, w)
            y = y.reshape(n, c, h, w)
        else:
            y = y.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return x + y


class Mid(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.res1 = ResBlock(ch, ch, **kw)
        self.attn = AttnBlock(ch, **kw)
        self.res2 = ResBlock(ch, ch, **kw)

    def forward(self, x, groups, policy, backend, quirks):
        x = self.res1(x, groups, policy)
        x = self.attn(x, groups, policy, backend=backend, reference_quirks=quirks)
        return self.res2(x, groups, policy)


class Level(nn.Module):
    """One resolution level: ``res`` blocks and an optional resampling conv
    (``downsample`` in the encoder, ``upsample`` in the decoder)."""

    def __init__(self, res, downsample=None, upsample=None):
        super().__init__()
        self.res = nn.ModuleList(res)
        self.downsample, self.upsample = downsample, upsample


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        chs = cfg.level_channels
        self.conv_in = conv.Conv(cfg.in_channels, chs[0], 3, **kw)
        down, c_prev = [], chs[0]
        for i, c in enumerate(chs):
            down.append(Level([ResBlock(c_prev, c, **kw), ResBlock(c, c, **kw)],
                              downsample=conv.Conv(c, c, 3, **kw)
                              if i < len(chs) - 1 else None))
            c_prev = c
        self.down = nn.ModuleList(down)
        self.mid = Mid(chs[-1], **kw)
        self.norm_out = norm.Norm(chs[-1], **kw)
        self.conv_out = conv.Conv(chs[-1], 2 * cfg.latent_channels, 3, **kw)
        self.quant_conv = conv.Conv(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1, **kw)

    def forward(self, image, noise, policy: Policy = FP32, *,
                attention_backend: str = "plain", reference_quirks: bool = False):
        """image: (N, 3, H, W) in [-1, 1]; noise: (N, latent_ch, H/f, W/f).

        Returns scaled latents (N, latent_ch, H/f, W/f)."""
        return self.tail(self.down_path(image, policy), noise, policy,
                         attention_backend, reference_quirks)

    def down_path(self, image, policy: Policy):
        """Image-resolution prefix (conv_in + res/downsample levels): local
        convs and GroupNorms only, so it tiles."""
        cfg = self.cfg
        x = conv.apply(self.conv_in, image, padding=1, policy=policy)
        for level in self.down:
            for rb in level.res:
                x = rb(x, cfg.groups, policy)
            if level.downsample is not None:
                x = conv.apply(level.downsample, x, stride=2, padding=ASYM_DOWN,
                               policy=policy)
        return x

    def tail(self, x, noise, policy: Policy, attention_backend: str,
             reference_quirks: bool):
        """Latent-resolution suffix: the mid block (global attention, run
        whole), the head convs and the reparameterized sample."""
        cfg = self.cfg
        x = self.mid(x, cfg.groups, policy, attention_backend, reference_quirks)
        x = norm.group_norm_silu(self.norm_out, x, cfg.groups, policy=policy)
        x = conv.apply(self.conv_out, x, padding=1, policy=policy)
        x = conv.apply(self.quant_conv, x, policy=policy)
        mean, log_var = x.chunk(2, dim=1)
        log_var = log_var.to(policy.norm_dtype).clamp(*cfg.logvar_clamp)
        std = torch.exp(0.5 * log_var).to(mean.dtype)
        latents = mean + std * noise.to(mean.dtype)
        return latents * cfg.scale_factor


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        chs = cfg.level_channels
        self.post_quant_conv = conv.Conv(cfg.latent_channels,
                                         cfg.latent_channels, 1, **kw)
        self.conv_in = conv.Conv(cfg.latent_channels, chs[-1], 3, **kw)
        self.mid = Mid(chs[-1], **kw)
        up, c_prev = [], chs[-1]  # top level (smallest spatial) first
        for i in reversed(range(len(chs))):
            c = chs[i]
            up.append(Level([ResBlock(c_prev, c, **kw), ResBlock(c, c, **kw),
                             ResBlock(c, c, **kw)],
                            upsample=conv.Conv(c, c, 3, **kw) if i > 0 else None))
            c_prev = c
        self.up = nn.ModuleList(up)
        self.norm_out = norm.Norm(chs[0], **kw)
        self.conv_out = conv.Conv(chs[0], cfg.in_channels, 3, **kw)

    def forward(self, latents, policy: Policy = FP32, *,
                attention_backend: str = "plain", reference_quirks: bool = False):
        """latents: (N, latent_ch, H/f, W/f) -> image (N, 3, H, W), ~[-1, 1]."""
        return self.tail(self.head(latents, policy, attention_backend,
                                   reference_quirks), policy)

    def head(self, latents, policy: Policy, attention_backend: str,
             reference_quirks: bool):
        """Latent-resolution prefix: scale, 1x1/3x3 convs and the mid block
        (global attention, run whole)."""
        cfg = self.cfg
        x = (latents / cfg.scale_factor).to(policy.compute_dtype)
        x = conv.apply(self.post_quant_conv, x, policy=policy)
        x = conv.apply(self.conv_in, x, padding=1, policy=policy)
        return self.mid(x, cfg.groups, policy, attention_backend, reference_quirks)

    def tail(self, x, policy: Policy):
        """Upsampling tail: local convs and GroupNorms only, so it tiles."""
        cfg = self.cfg
        for level in self.up:
            for rb in level.res:
                x = rb(x, cfg.groups, policy)
            if level.upsample is not None:
                x = conv.apply(level.upsample, upsample_nearest_2x(x), padding=1,
                               policy=policy)
        x = norm.group_norm_silu(self.norm_out, x, cfg.groups, policy=policy)
        return conv.apply(self.conv_out, x, padding=1, policy=policy)


# ------------------------------------------------------------------ tiling
def down_receptive_halo(cfg: VAEConfig) -> int:
    """Conv receptive-field radius of the encoder down path, in latent px:
    conv_in, 2 res blocks x 2 convs a level at that level's scale, and the
    stride-2 downsample conv; SD-1.5: 68 image px -> ceil(68 / 8) = 9."""
    r, scale = 1.0, 1.0  # conv_in
    for i in range(len(cfg.ch_mults)):
        r += 4.0 * scale
        if i < len(cfg.ch_mults) - 1:
            r += 1.0 * scale
            scale *= 2.0
    return int(math.ceil(r / cfg.downsample_factor))


def tail_receptive_halo(cfg: VAEConfig) -> int:
    """Conv receptive-field radius of the decoder tail, in latent px: per
    level 3 res blocks x 2 convs, the upsample conv at the finer scale, and
    conv_out; SD-1.5: ceil(12.25) = 13."""
    r, scale = 0.0, 1.0
    n_levels = len(cfg.ch_mults)
    for i in range(n_levels):
        r += 6.0 * scale
        if i < n_levels - 1:
            scale /= 2.0
            r += 1.0 * scale
    r += 1.0 * scale  # conv_out
    return int(math.ceil(r))


def _windows(h: int, w: int, tile: int, halo: int):
    """Window size and, per tile in row-major order, (window start row,
    start col, tile row, tile col), all in latent px.  Border windows are
    clamped to the image, so conv zero padding at the true border matches
    the whole computation."""
    if h % tile or w % tile:
        raise ValueError(f"latent dims {h}x{w} must be multiples of "
                         f"tile={tile} (pick a divisor)")
    win = tile + 2 * halo
    if win > min(h, w):
        halo = (min(h, w) - tile) // 2
        win = tile + 2 * halo
    starts = [(min(max(i - halo, 0), h - win), min(max(j - halo, 0), w - win), i, j)
              for i in range(0, h, tile) for j in range(0, w, tile)]
    return win, starts


def _empty_like_layout(like: torch.Tensor, shape) -> torch.Tensor:
    """Uninitialized (N, C, H, W) in ``like``'s dtype and device, in the
    memory format the models run in there (channels_last on CUDA)."""
    fmt = torch.channels_last if like.is_cuda else torch.contiguous_format
    return torch.empty(shape, dtype=like.dtype, device=like.device, memory_format=fmt)


def apply_encoder_tiled(encoder: Encoder, image, noise, policy: Policy = FP32, *,
                        tile: int = 64, halo: Optional[int] = None,
                        attention_backend: str = "plain",
                        reference_quirks: bool = False):
    """Memory-bounded encode (port of ``apply_encoder_tiled``).

    The down path runs window by window (``tile`` latent px plus ``halo``
    on each side, default :func:`down_receptive_halo`) and each tile's
    interior is written into the whole latent-resolution activation; the
    mid block and the sample run whole.  Tile interiors are conv-exact; the
    only approximation is per-window GroupNorm statistics."""
    cfg = encoder.cfg
    f = cfg.downsample_factor
    n, _, h_img, w_img = image.shape
    h, w = h_img // f, w_img // f
    if h <= tile and w <= tile:
        return encoder(image, noise, policy, attention_backend=attention_backend,
                       reference_quirks=reference_quirks)
    win, starts = _windows(h, w, tile, down_receptive_halo(cfg) if halo is None else halo)
    x = None
    for si, sj, i, j in starts:  # sequential: one window's activations live at a time
        y = encoder.down_path(image[:, :, si * f:(si + win) * f, sj * f:(sj + win) * f],
                              policy)
        if x is None:
            x = _empty_like_layout(y, (n, y.shape[1], h, w))
        x[:, :, i:i + tile, j:j + tile] = y[:, :, i - si:i - si + tile, j - sj:j - sj + tile]
    return encoder.tail(x, noise, policy, attention_backend, reference_quirks)


def apply_decoder_tiled(decoder: Decoder, latents, policy: Policy = FP32, *,
                        tile: int = 64, halo: Optional[int] = None,
                        attention_backend: str = "plain",
                        reference_quirks: bool = False):
    """Memory-bounded decode (port of ``apply_decoder_tiled``).

    The head, with the mid block's global attention, runs whole at latent
    resolution; the upsampling tail runs window by window (``tile`` latent
    px plus ``halo`` on each side, default :func:`tail_receptive_halo`), and
    each tile's interior is written into the output image.  Tile interiors
    are conv-exact; GroupNorm statistics are per window (the standard
    tiled-VAE approximation)."""
    x = decoder.head(latents, policy, attention_backend, reference_quirks)
    n, _, h, w = x.shape
    if h <= tile and w <= tile:
        return decoder.tail(x, policy)
    up = decoder.cfg.downsample_factor
    win, starts = _windows(h, w, tile,
                           tail_receptive_halo(decoder.cfg) if halo is None else halo)
    out = None
    for si, sj, i, j in starts:  # sequential: one window's activations live at a time
        y = decoder.tail(x[:, :, si:si + win, sj:sj + win], policy)
        if out is None:
            out = _empty_like_layout(y, (n, y.shape[1], h * up, w * up))
        oi, oj = (i - si) * up, (j - sj) * up
        out[:, :, i * up:(i + tile) * up, j * up:(j + tile) * up] = \
            y[:, :, oi:oi + tile * up, oj:oj + tile * up]
    return out
