"""Model/architecture configuration (port of ``models/config.py``).

The dataclasses keep every field of the JAX package's configs so a config
reads the same in both packages, and every family preset is here field
for field.  The port runs SD-1.5 (:func:`sd15_config`), SD-2.1
(:func:`sd21_config`: the OpenCLIP ViT-H tower, head width 64,
v-prediction), SDXL base (:func:`sdxl_config`: CLIP-L and OpenCLIP bigG,
stacked transformer depth, pooled and size conditioning) and the SDXL
refiner (:func:`sdxl_refiner_config`), txt2img/img2img up to 2048², with
CLIP skip (:func:`with_clip_skip`), and slice F's approximate modes
(:func:`with_tome`, :func:`with_hypertile`, :func:`with_freeu`,
:func:`fast_preset`), and the UNet's int8 tiers (``quant``, slice H2);
:func:`check_ported` refuses, with ``ValueError``, every field value the
JAX package does not know either, instead of ignoring it.

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
#: other with ValueError), all ported (``ops/quant.py``)
QUANT_TIERS = ("none", "wide", "conv", "w8")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """A CLIP text tower: ViT-L/14 by default; OpenCLIP ViT-H (SD-2.x) and
    bigG (SDXL) through the presets."""

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
    #: OpenCLIP pooled-text head (SDXL bigG): a (d, d) matrix applied as
    #: ``x @ W`` to the final-normed EOT row (``CLIP.forward_with_pooled``).
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
    #: per-level transformer depth (SDXL); None -> depth 1 everywhere.  The
    #: bottleneck takes the deepest level's.
    transformer_depth: Tuple[int, ...] = None
    #: SDXL added-conditioning width: the pooled text and the size ids'
    #: sinusoidal embeddings (SDXL 1280 + 6 x 256 = 2816).
    add_embed_dim: int = None
    #: number of SDXL add_time_ids: 6 for the base (orig_h, orig_w,
    #: crop_top, crop_left, tgt_h, tgt_w), 5 for the refiner (the last the
    #: aesthetic score).
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


def tiny_sdxl_config(policy: Policy = FP32, **kw) -> SDConfig:
    """Scaled-down SDXL config (dual towers, per-level transformer depth,
    added conditioning) for fast CPU tests: the knobs of
    :func:`sdxl_config` at tiny dims."""
    return SDConfig(
        clip=CLIPConfig(vocab_size=1024, d_model=16, max_len=16, n_layers=2,
                        n_heads=2, d_ff=32, stop_at_layer=1,
                        penultimate_norm=False,
                        key_prefix="conditioner.embedders.0.transformer.text_model"),
        clip2=CLIPConfig(vocab_size=1024, d_model=32, max_len=16, n_layers=3,
                         n_heads=4, d_ff=64, hidden_act="gelu",
                         stop_at_layer=2, penultimate_norm=False,
                         text_projection=True, layout="open_clip",
                         key_prefix="conditioner.embedders.1.model"),
        vae=VAEConfig(base_channels=16, ch_mults=(1, 2), groups=4,
                      scale_factor=0.13025),
        unet=UNetConfig(model_channels=16, ch_mults=(1, 2),
                        attn_levels=(False, True), transformer_depth=(1, 2),
                        head_dim=8, d_context=48, groups=4,
                        add_embed_dim=32 + 6 * 4),  # pooled 32 + 6x4 sizes
        policy=policy,
        **kw,
    )


def sd15_config(policy: Policy = FP32, **kw) -> SDConfig:
    return SDConfig(policy=policy, **kw)


def sd15_lcm_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SD-1.5 LCM-distilled architecture: the SD-1.5 topology plus the
    256-wide guidance-embedding projection (slice C3)."""
    return SDConfig(unet=UNetConfig(time_cond_dim=256), policy=policy, **kw)


def sd15_inpaint_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SD-1.5 inpainting architecture: a 9-channel conv_in (slice C3)."""
    return SDConfig(unet=UNetConfig(in_channels=9), policy=policy, **kw)


def sd15_ip2p_config(policy: Policy = FP32, **kw) -> SDConfig:
    """InstructPix2Pix: an 8-channel conv_in (slice C3)."""
    return SDConfig(unet=UNetConfig(in_channels=8), policy=policy, **kw)


def sd2_inpaint_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SD-2.0 inpainting: SD-2 512-base (epsilon) with the 9-channel
    conv_in (slice C3)."""
    base = sd21_config(policy=policy, v_prediction=False, **kw)
    return dataclasses.replace(base, unet=dataclasses.replace(base.unet, in_channels=9))


def sd21_config(policy: Policy = FP32, v_prediction: bool = True, **kw) -> SDConfig:
    """SD-2.1: the OpenCLIP ViT-H tower (24 layers, d 1024, exact GELU,
    conditioning on the penultimate layer, final-normed), a UNet of head
    width 64 and 1024-d context; the 768-v checkpoints predict v."""
    return SDConfig(
        clip=CLIPConfig(vocab_size=49408, d_model=1024, max_len=77,
                        n_layers=24, n_heads=16, d_ff=4096,
                        hidden_act="gelu", stop_at_layer=23,
                        layout="open_clip"),
        vae=VAEConfig(),
        unet=UNetConfig(model_channels=320, ch_mults=(1, 2, 4, 4),
                        attn_levels=(True, True, True, False),
                        n_heads=8, head_dim=64, d_context=1024),
        policy=policy,
        prediction_type="v" if v_prediction else "epsilon",
        **kw,
    )


def sdxl_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SDXL base: CLIP-L (penultimate, un-normed) and OpenCLIP bigG
    (penultimate, un-normed; pooled through ``text_projection``)
    concatenated to a 2048-d context; a 3-level UNet (320/640/1280) of
    transformer depths (1, 2, 10), head width 64, and the 2816-d added
    conditioning (pooled 1280 + 6 x 256 size ids); VAE scale 0.13025."""
    return SDConfig(
        clip=CLIPConfig(vocab_size=49408, d_model=768, max_len=77,
                        n_layers=12, n_heads=12, d_ff=3072,
                        hidden_act="quick_gelu", stop_at_layer=11,
                        penultimate_norm=False,
                        key_prefix="conditioner.embedders.0.transformer.text_model"),
        clip2=CLIPConfig(vocab_size=49408, d_model=1280, max_len=77,
                         n_layers=32, n_heads=20, d_ff=5120,
                         hidden_act="gelu", stop_at_layer=31,
                         penultimate_norm=False, text_projection=True,
                         layout="open_clip",
                         key_prefix="conditioner.embedders.1.model"),
        vae=VAEConfig(scale_factor=0.13025),
        unet=UNetConfig(model_channels=320, ch_mults=(1, 2, 4),
                        attn_levels=(False, True, True),
                        transformer_depth=(1, 2, 10),
                        head_dim=64, d_context=2048, add_embed_dim=2816),
        policy=policy,
        **kw,
    )


def sdxl_inpaint_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SDXL inpainting: SDXL base with the 9-channel conv_in (slice C3)."""
    base = sdxl_config(policy=policy, **kw)
    return dataclasses.replace(base, unet=dataclasses.replace(base.unet, in_channels=9))


def sdxl_lcm_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SDXL LCM-distilled: SDXL base plus the 256-wide guidance-embedding
    projection (slice C3)."""
    base = sdxl_config(policy=policy, **kw)
    return dataclasses.replace(base, unet=dataclasses.replace(base.unet, time_cond_dim=256))


def sdxl_refiner_config(policy: Policy = FP32, **kw) -> SDConfig:
    """SDXL refiner: one OpenCLIP bigG tower whose penultimate hidden is the
    1280-d context and whose pooled vector feeds the added conditioning (no
    CLIP-L); a 4-level UNet (384/768/1536/1536) of transformer depth 4 at
    the two attention levels and the bottleneck; added conditioning pooled
    1280 + 5 x 256 ids (the last the aesthetic score); VAE scale 0.13025."""
    return SDConfig(
        clip=CLIPConfig(vocab_size=49408, d_model=1280, max_len=77,
                        n_layers=32, n_heads=20, d_ff=5120,
                        hidden_act="gelu", stop_at_layer=31,
                        penultimate_norm=False, text_projection=True,
                        layout="open_clip",
                        key_prefix="conditioner.embedders.0.model"),
        vae=VAEConfig(scale_factor=0.13025),
        # transformer_depth[-1] feeds only the bottleneck (depth_for(len-1));
        # level 3 itself has no attention
        unet=UNetConfig(model_channels=384, ch_mults=(1, 2, 4, 4),
                        attn_levels=(False, True, True, False),
                        transformer_depth=(0, 4, 4, 4),
                        head_dim=64, d_context=1280,
                        add_embed_dim=2560, add_time_ids=5),
        policy=policy,
        **kw,
    )


def with_clip_skip(cfg: SDConfig, clip_skip: int) -> SDConfig:
    """A1111-convention "CLIP skip": condition the UNet on an EARLIER text
    encoder layer.  ``clip_skip=1`` is the family default (no change);
    each increment stops one transformer layer earlier than that default
    (SD-1.x: 2 == penultimate layer + final LN, the webui setting used by
    anime-style checkpoints; SD-2.x and SDXL already condition on their
    penultimate layer, so 2 is the antepenultimate there).  Both towers of
    SDXL shift; the pooled vector still comes from the full stack.  Port of
    the JAX package's ``with_clip_skip``."""
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



#: published FreeU defaults (the paper's recommended settings per family)
FREEU_DEFAULTS_SD = (1.5, 1.6, 0.9, 0.2)
FREEU_DEFAULTS_SDXL = (1.3, 1.4, 0.9, 0.2)


def with_tome(cfg: SDConfig, ratio: float = 0.5, *, sx: int = 2, sy: int = 2,
              min_tokens: int = 4096) -> SDConfig:
    """ToMe token merging (the A1111 "Token merging ratio"; tomesd's
    defaults: a 2x2 stride, only the blocks of ``min_tokens`` tokens or
    more, at SD's native sizes the 4096-token level).  ``ratio`` is the
    fraction of all tokens merged (``ops/tome.py``); 0 turns it off.  Port
    of the JAX package's ``with_tome``."""
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"tome ratio must be in [0, 1), got {ratio}")
    if ratio == 0.0:
        return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, tome=None))
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, tome=(float(ratio), int(sx), int(sy), int(min_tokens))))


def with_hypertile(cfg: SDConfig, tile: int = 32, *, min_tokens: int = 4096) -> SDConfig:
    """Hypertile tile-local self-attention (the A1111 "Hypertile" setting):
    ``tile`` is the largest tile side in latent tokens (256 px / 8); each
    self-attention of ``min_tokens`` tokens or more attends within tiles
    whose sides are the largest divisors of its grid's sides up to
    ``tile`` (``models/unet.hypertile_sides``).  A grid that fits one tile
    runs exactly as without it; ``tile`` 0 or None turns it off.  Port of
    the JAX package's ``with_hypertile``."""
    if not tile:
        return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, hypertile=None))
    if tile < 1:
        raise ValueError(f"hypertile tile must be >= 1, got {tile}")
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, hypertile=(int(tile), int(min_tokens))))


def with_freeu(cfg: SDConfig, freeu=True) -> SDConfig:
    """FreeU (training-free re-weighting of the two deepest decoder
    levels): ``True`` takes the family's published defaults (SDXL's for a
    UNet with added conditioning), else an explicit ``(b1, b2, s1, s2)``;
    ``False`` or None returns ``cfg`` unchanged.  Port of the JAX
    package's ``with_freeu``."""
    if freeu is None or freeu is False:
        return cfg
    if freeu is True:
        freeu = FREEU_DEFAULTS_SDXL if cfg.unet.add_embed_dim else FREEU_DEFAULTS_SD
    vals = tuple(float(v) for v in freeu)
    if len(vals) != 4:
        raise ValueError(f"freeu wants (b1, b2, s1, s2), got {freeu!r}")
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, freeu=vals))


def fast_preset(cfg: SDConfig):
    """The approximate-mode bundle: -> ``(config, generate_kwargs)``,
    Hypertile at tile 32 and DeepCache at interval 3; pass the config and
    merge the keywords into ``generate()`` / ``txt2img()``.  Both trade
    exactness for speed; drop either for an exact request.  Port of the JAX
    package's ``fast_preset`` (its TPU measurements are not the port's:
    PERF.md has the H100's)."""
    return with_hypertile(cfg, 32), {"deepcache": 3}

def _check_tower(c: CLIPConfig, name: str) -> None:
    if c.hidden_act not in ("quick_gelu", "gelu"):
        raise ValueError(f"{name}.hidden_act must be 'quick_gelu' or 'gelu', got "
                         f"{c.hidden_act!r}")
    if c.layout not in ("clip", "open_clip"):
        raise ValueError(f"unknown CLIP layout {c.layout!r}")


def check_ported(cfg: SDConfig) -> None:
    """Raise ``ValueError`` for a field value the JAX package does not know
    either (every field value it knows is ported)."""
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
    if cfg.prediction_type not in ("epsilon", "v"):
        raise ValueError(f"prediction_type must be 'epsilon' or 'v', got "
                         f"{cfg.prediction_type!r}")
    _check_tower(cfg.clip, "clip")
    if cfg.clip2 is not None:
        _check_tower(cfg.clip2, "clip2")


def model_names(cfg: SDConfig) -> Tuple[str, ...]:
    """The models of ``cfg``'s family: ("clip", ["clip2",] "encoder",
    "decoder", "diffusion"), "clip2" with a second text tower (SDXL)."""
    return ("clip",) + (("clip2",) if cfg.clip2 is not None else ()) \
        + ("encoder", "decoder", "diffusion")

