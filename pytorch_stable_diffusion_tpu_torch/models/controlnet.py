"""ControlNet, the spatial-conditioning side network (port of
``models/controlnet.py``).

A trainable copy of the UNet's encoder and bottleneck (built from the
UNet's own ``TimeEmbed``, ``encoder_stages`` and ``Bottleneck``, so every
family's topology follows from its ``UNetConfig``), a conditioning-image
"hint" encoder (``hint_block``: 3x3 convs with SiLU between them, the
stride-2 ones downsampling to the latent grid) and zero-initialized 1x1
projections: 12 ``zero_convs`` (one a skip of the UNet's encoder at
SD-1.5) and ``mid_out``.  A fresh net is an exact no-op on the UNet: its
zero convs, ``mid_out`` and its last hint conv are zeros
(:meth:`ControlNet.zero_init_`).

``forward`` gives ``{"down": [one residual a skip], "mid": r}``, each times
the tensor ``conditioning_scale``, which ``UNet.forward(control=...)``
adds to the skips and to the bottleneck output.  The res blocks take the
request's ``conv_backend`` (K5 on "kernel"), and the self-attentions its
attention backend (K1); the hint encoder, conv_in and the zero convs are
plain convs, as in the JAX package.  The ControlNet's input is the
4-channel latents (``conv_in`` takes ``cfg.out_channels``) even where the
UNet takes 9 (inpainting) or 8 (InstructPix2Pix): the JAX package builds
that conv from ``cfg.in_channels`` and then feeds it the 4-channel latents
(ROADMAP.md §3).  ``encode_hint`` is time-independent: the pipeline runs it
once a generation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import conv
from ..ops.act import silu
from . import unet as unet_mod
from .config import UNetConfig


def hint_plan(cfg: UNetConfig, downsample_factor: int) -> List[Tuple[int, int, int]]:
    """[(c_in, c_out, stride), ...] of the conditioning embedder: conv(3,
    16), conv(16, 16), then a stride-2 conv to each next width of
    16 -> 32 -> 96 -> 256 (a stride-1 conv after each but the last), and
    the zero-initialized conv(256, model_channels).  A VAE of a smaller
    factor (the tiny test configs) takes the tail of the width ladder, so
    the hint always lands on the latent grid."""
    k = downsample_factor.bit_length() - 1  # log2
    widths = [16, 32, 96, 256][-(k + 1):]
    plan = [(3, widths[0], 1), (widths[0], widths[0], 1)]
    for i in range(1, len(widths)):
        plan.append((widths[i - 1], widths[i], 2))
        if i < len(widths) - 1:
            plan.append((widths[i], widths[i], 1))
    plan.append((widths[-1], cfg.model_channels, 1))  # zero-init projection
    return plan


def skip_channels(cfg: UNetConfig) -> List[int]:
    """The channels of the UNet encoder's skips (conv_in's, then every
    stage's), one zero conv each."""
    return [cfg.model_channels] + [st["c_out"] if st["kind"] == "block" else st["c"]
                                   for st in unet_mod.encoder_plan(cfg)[1:]]


class ControlNet(nn.Module):
    def __init__(self, cfg: UNetConfig, downsample_factor: int = 8, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg, self.downsample_factor = cfg, downsample_factor
        t_dim = cfg.time_embed_dim
        self.time_embed = unet_mod.TimeEmbed(cfg.model_channels, t_dim, **kw)
        if cfg.add_embed_dim:
            self.add_embed = unet_mod.TimeEmbed(cfg.add_embed_dim, t_dim, **kw)
        self.conv_in = conv.Conv(cfg.out_channels, cfg.model_channels, 3, **kw)
        self.encoder = unet_mod.encoder_stages(cfg, **kw)
        self.bottleneck = unet_mod.Bottleneck(cfg.level_channels[-1], t_dim, cfg.d_context,
                                              cfg.depth_for(len(cfg.ch_mults) - 1), **kw)
        self.hint_block = nn.ModuleList(conv.Conv(ci, co, 3, **kw)
                                        for ci, co, _ in hint_plan(cfg, downsample_factor))
        self.zero_convs = nn.ModuleList(conv.Conv(c, c, 1, **kw) for c in skip_channels(cfg))
        c_mid = cfg.level_channels[-1]
        self.mid_out = conv.Conv(c_mid, c_mid, 1, **kw)

    def zero_init_(self) -> None:
        """Zero the zero convs, ``mid_out`` and the last hint conv: a fresh
        ControlNet, the published training init."""
        for p in [*self.zero_convs, self.mid_out, self.hint_block[-1]]:
            p.weight.data.zero_()
            p.bias.data.zero_()

    def encode_hint(self, hint: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
        """Conditioning image (B, 3, H, W) in [0, 1] -> (B, model_channels,
        h, w) on the latent grid.  Time-independent: once a generation."""
        plan = hint_plan(self.cfg, self.downsample_factor)
        x = hint.to(policy.compute_dtype)
        for j, (_ci, _co, s) in enumerate(plan):
            x = conv.apply(self.hint_block[j], x, stride=s, padding=1, policy=policy)
            if j < len(plan) - 1:
                x = silu(x)
        return x

    def forward(self, latents, context, t, hint_features, policy: Policy = FP32, *,
                conditioning_scale, attention_backend: str = "plain", fuse_qkv: bool = True,
                add_cond: Optional[torch.Tensor] = None, conv_backend: str = "plain"):
        """latents: (B, 4, h, w); context as the UNet takes it; t: the
        timestep; hint_features: :meth:`encode_hint`'s output for the B
        lanes; conditioning_scale: a 0-d tensor.  -> {"down": [...], "mid":
        r}, aligned with the UNet's skip stack."""
        cfg = self.cfg
        t_emb = unet_mod.time_embedding(self, cfg, t, policy, latents.device, add_cond)

        def block(res, attn, x):
            x = res(x, t_emb, cfg.groups, policy, conv_backend)
            if attn is not None:
                x = attn(x, context, cfg.heads_for(x.shape[1]), cfg.groups, policy,
                         backend=attention_backend, fuse_qkv=fuse_qkv)
            return x

        def zconv(p, x):
            return conv.apply(p, x, policy=policy)

        x = conv.apply(self.conv_in, latents, padding=1, policy=policy)
        x = x + hint_features.to(x.dtype)
        downs = [zconv(self.zero_convs[0], x)]
        for i, stage in enumerate(self.encoder):
            if stage.down is not None:
                x = conv.apply(stage.down, x, stride=2, padding=1, policy=policy)
            else:
                x = block(stage.res, stage.attn, x)
            downs.append(zconv(self.zero_convs[i + 1], x))
        mid = self.bottleneck
        x = block(mid.res1, mid.attn, x)
        x = mid.res2(x, t_emb, cfg.groups, policy, conv_backend)
        s = conditioning_scale.to(policy.compute_dtype)
        return {"down": [d * s for d in downs], "mid": zconv(self.mid_out, x) * s}


def build(cfg, *, device=None, state_dict=None,
          generator: Optional[torch.Generator] = None) -> ControlNet:
    """A ControlNet for ``cfg`` (an ``SDConfig``: its UNet's topology, its
    VAE's factor, its policy's dtype) on ``device`` (the card unless
    another is named): the weights of ``state_dict`` (strict), or every
    weight drawn from ``generator`` by the port's initializers, the zero
    convs too (a net whose residuals are not zero; :meth:`zero_init_`
    gives the published init)."""
    from . import _finish, reset_parameters, target_device

    device = target_device(device)
    net = ControlNet(cfg.unet, cfg.vae.downsample_factor, dtype=cfg.policy.param_dtype,
                     device="meta")
    net.to_empty(device=device)
    if state_dict is None:
        reset_parameters(net, generator)
    else:
        net.load_state_dict(state_dict, strict=True)
    _finish(net, device)
    return net

