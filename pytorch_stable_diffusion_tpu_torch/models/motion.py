"""AnimateDiff motion modules (port of ``models/motion.py``; Guo et al. 2023,
the published ``guoyww/AnimateDiff`` ``TemporalTransformer3DModel`` of the
``mm_sd_v15_v2`` family).

* GroupNorm (32 groups, or ``c // 4`` where 32 does not divide the
  channels: the tiny test configs) -> tokens -> Linear ``proj_in``;
* each block: two temporal self-attentions, each LayerNorm -> the tokens
  rearranged onto the FRAME axis -> + the fixed sinusoidal positional
  encoding -> attention (bias-free q/k/v, biased out) -> residual; then
  LayerNorm -> GEGLU feed-forward -> residual;
* Linear ``proj_out`` -> back to the grid -> the long residual.

A module sits after every encoder and decoder res(+attn) stage and in the
bottleneck (21 at SD-1.5's v2 topology), keyed as the JAX package keys
them: ``enc_{stage}``, ``dec_{stage}`` and ``mid``; the UNet takes the
modules per call (``UNet.forward(motion=, frames=)``), so the base UNet
stays shared.  Tokens attend only across the ``frames`` axis, each spatial
position and each lane group on its own: a batch of ``G * frames`` lanes
is G groups with the frame index fastest.  The attention runs materialized
("plain"): its KV is the frame count, far under the kernels' 256 tokens,
as the JAX package runs it on XLA.  Weight files: ``weights/animatediff.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, linear, norm
from ..ops.act import geglu
from .config import UNetConfig


def positional_encoding(length: int, channels: int) -> np.ndarray:
    """The modules' fixed sinusoidal table (torch ``PositionalEncoding``: sin
    on even channels, cos on odd, log-spaced frequencies), built in float64
    and returned as float32 (length, channels); a copy of the JAX
    package's."""
    assert channels % 2 == 0
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, channels, 2, dtype=np.float64)
                 * (-np.log(10000.0) / channels))
    pe = np.zeros((length, channels), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class MotionBlock(nn.Module):
    """One temporal transformer block: ``attn1``/``norm1``, ``attn2``/``norm2``
    and the GEGLU feed-forward ``ff_proj``/``ff_out`` after ``ff_norm``."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.attn1 = attention.Attention(c, in_bias=False, **kw)
        self.norm1 = norm.Norm(c, **kw)
        self.attn2 = attention.Attention(c, in_bias=False, **kw)
        self.norm2 = norm.Norm(c, **kw)
        self.ff_proj = linear.Linear(c, 8 * c, **kw)
        self.ff_out = linear.Linear(4 * c, c, **kw)
        self.ff_norm = norm.Norm(c, **kw)


class MotionModule(nn.Module):
    """The temporal transformer of one site, parameters named as the JAX
    pytree (``norm``, ``proj_in``, ``blocks.{b}.attn1.q``, ``proj_out``)."""

    def __init__(self, c: int, n_blocks: int = 1, **kw):
        super().__init__()
        self.norm = norm.Norm(c, **kw)
        self.proj_in = linear.Linear(c, c, **kw)
        self.blocks = nn.ModuleList(MotionBlock(c, **kw) for _ in range(n_blocks))
        self.proj_out = linear.Linear(c, c, **kw)

    def forward(self, x: torch.Tensor, frames: int, policy: Policy = FP32, *,
                n_heads: int = 8) -> torch.Tensor:
        """x: (G * frames, C, h, w), G lane groups of ``frames`` lanes each,
        the frame index fastest -> the same shape."""
        gf, c, h, w = x.shape
        g = gf // frames
        y = norm.group_norm(self.norm, x, 32 if c % 32 == 0 else c // 4, policy=policy)
        y = linear.apply(self.proj_in, y.permute(0, 2, 3, 1).reshape(gf, h * w, c), policy)
        # (G * F, hw, C) -> (G * hw, F, C): the tokens of a sequence are frames
        y = y.reshape(g, frames, h * w, c).transpose(1, 2).reshape(g * h * w, frames, c)
        pe = torch.from_numpy(positional_encoding(frames, c)).to(y.device, y.dtype)[None]
        for blk in self.blocks:
            for attn, ln in ((blk.attn1, blk.norm1), (blk.attn2, blk.norm2)):
                t = norm.layer_norm(ln, y, policy=policy) + pe
                y = y + attention.apply(attn, t, n_heads=n_heads, backend="plain",
                                        policy=policy)
            t = norm.layer_norm(blk.ff_norm, y, policy=policy)
            t = geglu(linear.apply(blk.ff_proj, t, policy))
            y = y + linear.apply(blk.ff_out, t, policy)
        y = y.reshape(g, h * w, frames, c).transpose(1, 2).reshape(gf, h * w, c)
        y = linear.apply(self.proj_out, y, policy)
        return x + y.reshape(gf, h, w, c).permute(0, 3, 1, 2)


def site_channels(cfg: UNetConfig) -> Dict[str, int]:
    """{site: channels} of every place a motion module can sit: each encoder
    res(+attn) stage ``enc_{i}`` (i over the encoder's stages after
    conv_in, downsamples included), each decoder stage ``dec_{i}`` and the
    bottleneck ``mid``."""
    from .unet import decoder_plan, encoder_plan

    out = {f"enc_{i}": st["c_out"] for i, st in enumerate(encoder_plan(cfg)[1:])
           if st["kind"] == "block"}
    out.update({f"dec_{i}": st["c_out"] for i, st in enumerate(decoder_plan(cfg))})
    out["mid"] = cfg.level_channels[-1]
    return out


def build(cfg: UNetConfig, *, state_dict: Optional[Dict[str, torch.Tensor]] = None,
          generator: Optional[torch.Generator] = None, mid: bool = True,
          n_blocks: int = 1, dtype=torch.float32, device=None) -> nn.ModuleDict:
    """The motion modules of a UNet of ``cfg`` on ``device`` (the card unless
    another is named) in ``dtype``, as an ``nn.ModuleDict`` keyed by site:
    the sites and blocks of ``state_dict`` (``weights/animatediff.py``
    output, strict), or every site of the v2 topology (without ``mid``: v1)
    with ``n_blocks`` blocks each, drawn from ``generator``."""
    from . import _finish, reset_parameters, target_device

    device = target_device(device)
    widths = site_channels(cfg)
    if state_dict is None:
        blocks = {s: n_blocks for s in widths if mid or s != "mid"}
    else:
        blocks = {}
        for key in state_dict:
            site, _, rest = key.partition(".")
            if site not in widths:
                raise ValueError(f"motion module site {site!r} is not in this UNet")
            b = int(rest.split(".")[1]) + 1 if rest.startswith("blocks.") else 0
            blocks[site] = max(blocks.get(site, 0), b)
    mods = nn.ModuleDict({site: MotionModule(widths[site], n, dtype=dtype, device="meta")
                          for site, n in sorted(blocks.items())})
    mods.to_empty(device=device)
    if state_dict is None:
        reset_parameters(mods, generator)
    else:
        mods.load_state_dict(state_dict, strict=True)
    _finish(mods, device)
    return mods
