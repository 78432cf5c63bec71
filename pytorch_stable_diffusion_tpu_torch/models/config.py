"""Model/architecture configuration (port of ``models/config.py``).

The dataclasses keep every field of the JAX package's configs so a config
reads the same in both packages.  The port runs SD-1.5 txt2img/img2img up
to 2048², with CLIP skip (:func:`with_clip_skip`); :func:`check_ported`
refuses every field value that names a feature a later slice brings
(ROADMAP.md §1), instead of ignoring it.

Attention backends are named for what runs: ``"plain"`` is the
materialized-scores path (the JAX package's ``"xla"``) and ``"kernel"``
sends long self-attention to the hand-written flash kernel (the JAX
package's ``"pallas"``).  The conv backends are named the same way:
``"plain"`` (JAX ``"xla"``), ``"kernel"`` (``"pallas"``: every UNet
res-block half through the fused GN->SiLU->conv3x3 kernel K5), ``"fold"``
(torch convs, every UNet GroupNorm/LayerNorm normalize folded to an affine
in compute dtype) and ``"kernel_fold"`` (``"pallas_fold"``: both).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.dtypes import FP32, Policy

ATTENTION_BACKENDS = ("plain", "kernel")
CONV_BACKENDS = ("plain", "kernel", "fold", "kernel_fold")
#: the JAX package's quantization tiers (its ``generate()`` refuses any
#: other with ValueError); only "none" is ported, the rest come with slice H
QUANT_TIERS = ("none", "wide", "conv", "w8")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP ViT-L/14 text tower."""

    vocab_size: int = 49408
    d_model: int = 768
    max_len: int = 77
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    #: "quick_gelu" (SD-1.x) or "gelu" (SD-2.x OpenCLIP).
    hidden_act: str = "quick_gelu"
    #: stop after this many layers (SD-2.x penultimate / CLIP skip).
    stop_at_layer: int = None
    #: apply the final LayerNorm to the truncated hidden.
    penultimate_norm: bool = True
    #: OpenCLIP pooled-text head (SDXL bigG).
    text_projection: bool = False
    #: checkpoint key namespace: "clip" (SD-1.x) or "open_clip" (SD-2.x).
    layout: str = "clip"
    #: checkpoint key prefix override (SDXL); None -> the layout's default.
    key_prefix: str = None


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL."""

    in_channels: int = 3
    base_channels: int = 128
    ch_mults: Tuple[int, ...] = (1, 2, 4, 4)
    latent_channels: int = 4
    groups: int = 32
    scale_factor: float = 0.18215
    logvar_clamp: Tuple[float, float] = (-30.0, 20.0)

    @property
    def level_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.ch_mults)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mults) - 1)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 UNet: channel_mult (1,2,4,4), 2 res blocks/level, spatial
    attention on every level but the last."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    ch_mults: Tuple[int, ...] = (1, 2, 4, 4)
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    num_res_blocks: int = 2
    n_heads: int = 8
    #: SD-2.x fixed per-head width (overrides n_heads).
    head_dim: int = None
    d_context: int = 768
    groups: int = 32
    #: per-level transformer depth (SDXL); None -> depth 1 everywhere.
    transformer_depth: Tuple[int, ...] = None
    #: SDXL added-conditioning width.
    add_embed_dim: int = None
    #: number of SDXL add_time_ids.
    add_time_ids: int = 6
    #: LCM guidance-embedding width.
    time_cond_dim: int = None
    #: FreeU (b1, b2, s1, s2); None = off.
    freeu: Tuple[float, float, float, float] = None
    #: ToMe token merging (ratio, sx, sy, min_tokens); None = off.
    tome: Tuple[float, int, int, int] = None
    #: Hypertile (tile, min_tokens); None = off.
    hypertile: Tuple[int, int] = None

    def depth_for(self, level: int) -> int:
        if self.transformer_depth is None:
            return 1
        return self.transformer_depth[level]

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.model_channels

    @property
    def level_channels(self) -> Tuple[int, ...]:
        return tuple(self.model_channels * m for m in self.ch_mults)

    def heads_for(self, channels: int) -> int:
        """Head count for an attention block at ``channels`` width."""
        if self.head_dim is not None:
            if channels % self.head_dim:
                raise ValueError(f"channels {channels} not divisible by "
                                 f"head_dim {self.head_dim}")
            return channels // self.head_dim
        return self.n_heads


@dataclasses.dataclass(frozen=True)
class SDConfig:
    clip: CLIPConfig = CLIPConfig()
    vae: VAEConfig = VAEConfig()
    unet: UNetConfig = UNetConfig()
    policy: Policy = FP32
    #: "plain" (materialized scores) or "kernel" (flash kernel for
    #: self-attention over >= 256 tokens).
    attention_backend: str = "plain"
    #: VAE mid-block attention backend: "kernel" sends its 1-head, Dh-512
    #: attention to the multi-pass flash kernel K3.
    vae_attention_backend: str = "plain"
    #: "plain" (torch convs with separate GN/SiLU), "kernel" (the UNet
    #: res blocks through K5, the time-embedding add folded into the second
    #: half's affine), "fold" (torch convs, the UNet's GN/LN normalizes
    #: applied as compute-dtype affines) or "kernel_fold" (both).  The
    #: non-plain tiers equal "plain" up to bf16 rounding of the normalize
    #: and of the (h + t_emb) sum.
    conv_backend: str = "plain"
    #: reproduce the reference's three bugs (dropped GeGLU gate, VAE
    #: attention un-transpose no-op and skipped GroupNorm, beta_start typo).
    reference_quirks: bool = False
    #: second text tower (SDXL).
    clip2: CLIPConfig = None
    #: "epsilon" or "v".
    prediction_type: str = "epsilon"
    #: zero-terminal-SNR beta rescale.
    zero_terminal_snr: bool = False
    #: fuse same-input q/k/v projections into one matmul.
    fuse_qkv: bool = True
    #: UNet int8 tier.
    quant: str = "none"
    #: SDXL-refiner aesthetic-score conditioning value.
    aesthetic_score: float = 6.0


def tiny_sd_config(policy: Policy = FP32, **kw) -> SDConfig:
    """Scaled-down config for fast CPU tests (same topology, small dims)."""
    return SDConfig(
        clip=CLIPConfig(vocab_size=1024, d_model=32, max_len=16, n_layers=2, n_heads=4, d_ff=64),
        vae=VAEConfig(base_channels=16, ch_mults=(1, 2), groups=4),
        unet=UNetConfig(
            model_channels=16, ch_mults=(1, 2), attn_levels=(True, False),
            n_heads=4, d_context=32, groups=4,
        ),
        policy=policy,
        **kw,
    )


def sd15_config(policy: Policy = FP32, **kw) -> SDConfig:
    return SDConfig(policy=policy, **kw)


def with_clip_skip(cfg: SDConfig, clip_skip: int) -> SDConfig:
    """A1111-convention "CLIP skip": condition the UNet on an EARLIER text
    encoder layer.  ``clip_skip=1`` is the family default (no change);
    each increment stops one transformer layer earlier than that default
    (SD-1.x: 2 == penultimate layer + final LN, the webui setting used by
    anime-style checkpoints).  Port of the JAX package's ``with_clip_skip``,
    whose second tower (SDXL) the port does not run."""
    if clip_skip < 1:
        raise ValueError(f"clip_skip must be >= 1, got {clip_skip}")
    if clip_skip == 1:
        return cfg

    def shift(tower: CLIPConfig) -> CLIPConfig:
        base = tower.n_layers if tower.stop_at_layer is None \
            else tower.stop_at_layer
        stop = base - (clip_skip - 1)
        if stop < 1:
            raise ValueError(f"clip_skip {clip_skip} skips past the "
                             f"{tower.n_layers}-layer text encoder")
        return dataclasses.replace(tower, stop_at_layer=stop)

    return dataclasses.replace(
        cfg, clip=shift(cfg.clip),
        clip2=None if cfg.clip2 is None else shift(cfg.clip2))


def _refuse(what: str, where: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it comes with {where} (ROADMAP.md §1)")


def check_ported(cfg: SDConfig) -> None:
    """Raise ``NotImplementedError`` for any field value this slice does not
    run, naming the slice of ROADMAP.md §1 that brings it, and ``ValueError``
    for a value the JAX package does not know either."""
    c, u = cfg.clip, cfg.unet
    if cfg.attention_backend not in ATTENTION_BACKENDS:
        raise ValueError(f"attention_backend must be one of "
                         f"{ATTENTION_BACKENDS}, got {cfg.attention_backend!r}")
    if cfg.vae_attention_backend not in ATTENTION_BACKENDS:
        raise ValueError(f"vae_attention_backend must be one of "
                         f"{ATTENTION_BACKENDS}, got {cfg.vae_attention_backend!r}")
    if cfg.conv_backend not in CONV_BACKENDS:
        raise ValueError(f"conv_backend must be one of {CONV_BACKENDS}, got "
                         f"{cfg.conv_backend!r}")
    if cfg.quant not in QUANT_TIERS:
        raise ValueError(f"unknown quant tier {cfg.quant!r}: the JAX package's tiers "
                         f"are {QUANT_TIERS}")
    if cfg.quant != "none":
        _refuse(f"quant={cfg.quant!r}", "slice H")
    if cfg.clip2 is not None:
        _refuse("a second text tower (clip2, SDXL)", "slice C2")
    if cfg.prediction_type != "epsilon":
        _refuse(f"prediction_type={cfg.prediction_type!r} (SD-2.x)", "slice C2")
    if c.hidden_act != "quick_gelu" or c.layout != "clip" or c.text_projection \
            or c.key_prefix is not None:
        _refuse("the OpenCLIP/SDXL text towers", "slice C2")
    if u.in_channels != 4:
        _refuse(f"a {u.in_channels}-channel UNet (inpaint/ip2p presets)",
                "slice C2")
    if u.head_dim is not None or u.transformer_depth is not None \
            or u.add_embed_dim is not None:
        _refuse("SD-2.x/SDXL UNet topologies (head_dim, transformer_depth, "
                "add_embed_dim)", "slice C2")
    if u.time_cond_dim is not None:
        _refuse("the LCM guidance embedding (time_cond_dim)", "slice C2")
    if u.freeu is not None:
        _refuse("FreeU", "slice F")
    if u.tome is not None:
        _refuse("ToMe token merging", "slice F")
    if u.hypertile is not None:
        _refuse("Hypertile", "slice F")
