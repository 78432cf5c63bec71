"""The ESRGAN / RealESRGAN upscaler, RRDBNet (Wang et al. 2018; port of
``models/esrgan.py``).

conv_first -> ``num_blocks`` RRDB blocks (each three residual-dense blocks
of five convs, their residuals scaled by 0.2) -> conv_body + the long skip
-> two nearest-2x + conv + LeakyReLU stages (x4) -> conv_hr -> conv_last;
LeakyReLU 0.2 everywhere, no normalization.  RealESRGAN's x2 (x1)
checkpoints take the input pixel-unshuffled by 2 (4): 12 (48) input
channels; ``F.pixel_unshuffle``'s channel order (c * f * f + fh * f + fw) is
the JAX package's.  Parameter names are the published new-arch names
(``conv_first``, ``body.{i}.rdb{j}.conv{k}``, ``conv_up1`` ...), which are
also the JAX pytree's paths; ``weights/esrgan.py`` reads both namings.

The convs are plain ``F.conv2d`` (cuDNN on the card): the JAX package runs
them on XLA, outside any Pallas kernel.  :func:`upscale_image` runs the
net whole or over RealESRGAN's padded tiles, the tiles of one shape batched
``tile_lanes`` at a time, with the conversion to uint8 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import conv
from ..ops.conv import upsample_nearest_2x


@dataclasses.dataclass(frozen=True)
class ESRGANConfig:
    in_channels: int = 3
    out_channels: int = 3
    features: int = 64        # num_feat
    num_blocks: int = 23      # num_block (RRDB count)
    growth: int = 32          # num_grow_ch (dense growth channels)
    scale: int = 4            # output upscale factor (4, 2, or 1)

    @property
    def unshuffle(self) -> int:
        """The pixel-unshuffle factor of the input: 2 at scale 2, 4 at 1."""
        return {2: 2, 1: 4}.get(self.scale, 1)


def tiny_esrgan_config() -> ESRGANConfig:
    return ESRGANConfig(features=8, num_blocks=2, growth=4)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf: int, gc: int, **kw):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", conv.Conv(nf + (k - 1) * gc, gc, 3, **kw))
        self.conv5 = conv.Conv(nf + 4 * gc, nf, 3, **kw)

    def forward(self, x, policy: Policy):
        feats = [x]
        for k in range(1, 5):
            y = conv.apply(getattr(self, f"conv{k}"), torch.cat(feats, dim=1), padding=1,
                           policy=policy)
            feats.append(F.leaky_relu(y, 0.2))
        return conv.apply(self.conv5, torch.cat(feats, dim=1), padding=1,
                          policy=policy) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int, **kw):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc, **kw)
        self.rdb2 = ResidualDenseBlock(nf, gc, **kw)
        self.rdb3 = ResidualDenseBlock(nf, gc, **kw)

    def forward(self, x, policy: Policy):
        return self.rdb3(self.rdb2(self.rdb1(x, policy), policy), policy) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self, cfg: ESRGANConfig, **kw):
        super().__init__()
        self.cfg = cfg
        nf = cfg.features
        self.conv_first = conv.Conv(cfg.in_channels * cfg.unshuffle ** 2, nf, 3, **kw)
        self.body = nn.ModuleList(RRDB(nf, cfg.growth, **kw) for _ in range(cfg.num_blocks))
        for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
            setattr(self, name, conv.Conv(nf, nf, 3, **kw))
        self.conv_last = conv.Conv(nf, cfg.out_channels, 3, **kw)

    def forward(self, x: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
        """x: (B, 3, H, W) in [0, 1] -> (B, 3, scale * H, scale * W) in the
        compute dtype; the trunk always upsamples 4x from its (unshuffled)
        input."""
        if self.cfg.unshuffle > 1:
            x = F.pixel_unshuffle(x, self.cfg.unshuffle)
        feat = conv.apply(self.conv_first, x, padding=1, policy=policy)
        body = feat
        for blk in self.body:
            body = blk(body, policy)
        feat = feat + conv.apply(self.conv_body, body, padding=1, policy=policy)
        for name in ("conv_up1", "conv_up2"):
            feat = F.leaky_relu(conv.apply(getattr(self, name), upsample_nearest_2x(feat),
                                           padding=1, policy=policy), 0.2)
        feat = F.leaky_relu(conv.apply(self.conv_hr, feat, padding=1, policy=policy), 0.2)
        return conv.apply(self.conv_last, feat, padding=1, policy=policy)


def build(cfg: ESRGANConfig, *, state_dict=None, generator: Optional[torch.Generator] = None,
          dtype=torch.float32, device=None) -> RRDBNet:
    """An :class:`RRDBNet` of ``cfg`` on ``device`` (the card unless another
    is named) in ``dtype``: the weights of ``state_dict`` (strict), or drawn
    from ``generator``."""
    from . import _finish, reset_parameters, target_device

    device = target_device(device)
    net = RRDBNet(cfg, dtype=dtype, device="meta")
    net.to_empty(device=device)
    if state_dict is None:
        reset_parameters(net, generator)
    else:
        net.load_state_dict(state_dict, strict=True)
    _finish(net, device)
    return net


def _tile_metas(h: int, w: int, tile: int, tile_pad: int):
    """RealESRGAN's tiling grid: output tile [y0:y1, x0:x1] and its padded
    input patch [py0:py1, px0:px1], clamped at the image's bounds."""
    metas = []
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            py0, px0 = max(y0 - tile_pad, 0), max(x0 - tile_pad, 0)
            py1, px1 = min(y1 + tile_pad, h), min(x1 + tile_pad, w)
            metas.append((y0, y1, x0, x1, py0, py1, px0, px1))
    return metas


def upscale_image(net: RRDBNet, image, policy: Policy = FP32, tile: Optional[int] = None,
                  tile_pad: int = 8, tile_lanes: int = 8) -> np.ndarray:
    """uint8 or float (H, W, 3), or batched (B, H, W, 3), image -> the
    upscaled uint8 image of the same rank, on the net's device.

    A float image whose largest value is at most 1.5 is taken as [0, 1]
    (else 0..255).  The output is ``clip(round(255 * y), 0, 255)`` in
    float32 (round half to even), computed on the device.  ``tile``: run
    the net over padded tiles of this size (the pad is recomputed context,
    RealESRGAN's scheme; tiled is not equal to whole, since the pad is
    smaller than the receptive field); the patches of one shape (interior
    or clamped at a border) go through the net ``tile_lanes`` at a time,
    the last chunk zero-padded to the lane count, and every chunk is
    queued before any result is copied back."""
    arr = np.asarray(image, np.float32)
    batched = arr.ndim == 4
    if not batched:
        arr = arr[None]
    if arr.max() > 1.5:
        arr = arr / 255.0
    s = net.cfg.scale
    device = next(net.parameters()).device
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format

    def run(v: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2))).to(device)
        with torch.inference_mode():
            y = net(x.contiguous(memory_format=fmt), policy).float()
            return torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8) \
                .permute(0, 2, 3, 1)

    if tile is None:
        out = run(arr).cpu().numpy()
        return out if batched else out[0]
    b, h, w = arr.shape[:3]
    out = np.zeros((b, h * s, w * s, 3), np.uint8)
    groups = {}
    for m in _tile_metas(h, w, tile, tile_pad):
        groups.setdefault((m[5] - m[4], m[7] - m[6]), []).append(m)
    in_flight = []
    for (ph, pw), ms in groups.items():
        patches = np.concatenate([arr[:, m[4]:m[5], m[6]:m[7]] for m in ms], axis=0)
        n = patches.shape[0]
        lanes = min(n, max(1, tile_lanes))
        chunks = []
        for i in range(0, n, lanes):
            chunk = patches[i:i + lanes]
            if chunk.shape[0] < lanes:
                chunk = np.concatenate(
                    [chunk, np.zeros((lanes - chunk.shape[0], ph, pw, 3), np.float32)])
            chunks.append(run(chunk))
        in_flight.append((ms, n, chunks))
    for ms, n, chunks in in_flight:
        up = torch.cat(chunks)[:n].cpu().numpy()
        for j, (y0, y1, x0, x1, py0, py1, px0, px1) in enumerate(ms):
            out[:, y0 * s:y1 * s, x0 * s:x1 * s] = up[j * b:(j + 1) * b][
                :, (y0 - py0) * s:(y1 - py0) * s, (x0 - px0) * s:(x1 - px0) * s]
    return out if batched else out[0]
