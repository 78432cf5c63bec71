"""T2I-Adapter (Mou et al. 2023), lightweight spatial conditioning (port of
``models/t2i_adapter.py``).

The published "full adapter" (the diffusers ``T2IAdapter`` layout):
``pixel_unshuffle`` of the hint image, a 3x3 conv to the UNet's base
width, then one block a UNet level: a 2x2 average pool (where the layout
pools), a 1x1 ``in_conv`` on a change of width, and ``num_res_blocks``
residual units (3x3 conv -> ReLU -> 1x1 conv, residual add).  Two layouts
(:func:`adapter_layout`): ``full_adapter`` for SD-1.x/2.x (one block a
level, unshuffle by the VAE's factor, a pool before every block but the
first) and ``full_adapter_xl`` for SDXL (n_levels + 1 blocks, unshuffle by
twice the factor, one pool before block 2; the last feature lands after
the bottleneck).

The adapter never sees the latents, the timestep or the text: its features
are a function of the hint alone, so the pipeline computes them once a
generation and every evaluation adds them (``UNet.forward(adapter=...)``,
``unet.adapter_sites``).  Its convs are plain convs (cuDNN), as in the JAX
package; K5 never takes them.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import conv
from .config import UNetConfig


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C f², H/f, W/f), channel c f² + i f + j: the
    torch order the checkpoints' ``conv_in`` was trained on (and the JAX
    package's NHWC one)."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"hint {h}x{w} not divisible by unshuffle factor {factor}")
    return F.pixel_unshuffle(x, factor)


def adapter_layout(cfg: UNetConfig, downsample_factor: int, xl: Optional[bool] = None):
    """(per-block channels, per-block pool flags, unshuffle factor) of the
    family's published adapter; ``xl=None`` picks ``full_adapter_xl`` for a
    UNet with added conditioning (SDXL).  ``full_adapter``: channels =
    level_channels, a pool before every block but the first, unshuffle =
    the VAE factor (feature i at level i's resolution).
    ``full_adapter_xl``: channels = level_channels + (last,), unshuffle =
    twice the VAE factor, one pool before block 2 ((320, 640, 1280, 1280)
    at (64, 64, 32, 32) for SDXL 1024²)."""
    if xl is None:
        xl = cfg.add_embed_dim is not None
    lc = cfg.level_channels
    if xl:
        channels = (*lc, lc[-1])
        pools = tuple(2 <= i < len(lc) for i in range(len(channels)))
        return channels, pools, downsample_factor * 2
    return lc, tuple(i > 0 for i in range(len(lc))), downsample_factor


class ResUnit(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.block1 = conv.Conv(c, c, 3, **kw)
        self.block2 = conv.Conv(c, c, 1, **kw)


class AdapterBlock(nn.Module):
    def __init__(self, c_prev: int, c: int, num_res_blocks: int, **kw):
        super().__init__()
        self.in_conv = conv.Conv(c_prev, c, 1, **kw) if c_prev != c else None
        self.resnets = nn.ModuleList(ResUnit(c, **kw) for _ in range(num_res_blocks))


class T2IAdapter(nn.Module):
    def __init__(self, cfg: UNetConfig, downsample_factor: int = 8, num_res_blocks: int = 2,
                 xl: Optional[bool] = None, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        channels, self.pools, self.factor = adapter_layout(cfg, downsample_factor, xl)
        self.conv_in = conv.Conv(3 * self.factor ** 2, channels[0], 3, **kw)
        self.body = nn.ModuleList(
            AdapterBlock(c_prev, c, num_res_blocks, **kw)
            for c_prev, c in zip((channels[0],) + tuple(channels[:-1]), channels))

    def forward(self, hint: torch.Tensor, policy: Policy = FP32) -> List[torch.Tensor]:
        """Hint image (B, 3, H, W) in [0, 1] -> one feature map an insertion
        site (``full_adapter``: one a UNet level at its resolution;
        ``full_adapter_xl``: n_levels + 1)."""
        x = pixel_unshuffle(hint.to(policy.compute_dtype), self.factor)
        x = conv.apply(self.conv_in, x, padding=1, policy=policy)
        feats = []
        for pool, blk in zip(self.pools, self.body):
            if pool:
                x = F.avg_pool2d(x, 2)
            if blk.in_conv is not None:
                x = conv.apply(blk.in_conv, x, policy=policy)
            for rn in blk.resnets:
                h = conv.apply(rn.block1, x, padding=1, policy=policy)
                x = x + conv.apply(rn.block2, torch.relu(h), policy=policy)
            feats.append(x)
        return feats


def build(cfg, *, device=None, state_dict=None,
          generator: Optional[torch.Generator] = None) -> T2IAdapter:
    """An adapter for ``cfg`` (an ``SDConfig``) on ``device`` (the card
    unless another is named), from ``state_dict`` (strict; its residual
    units a block and its layout read from its keys) or drawn from
    ``generator`` (2 units a block, the family's layout)."""
    from . import _finish, reset_parameters, target_device

    num_res_blocks, xl = 2, None
    if state_dict is not None:
        n_body = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("body."))
        num_res_blocks = len({k.split(".")[3] for k in state_dict
                              if k.startswith("body.0.resnets.")})
        xl = n_body == len(cfg.unet.ch_mults) + 1
    device = target_device(device)
    ad = T2IAdapter(cfg.unet, cfg.vae.downsample_factor, num_res_blocks, xl=xl,
                    dtype=cfg.policy.param_dtype, device="meta")
    ad.to_empty(device=device)
    if state_dict is None:
        reset_parameters(ad, generator)
    else:
        ad.load_state_dict(state_dict, strict=True)
    _finish(ad, device)
    return ad
