"""The UNet denoiser of SD-1.x, SD-2.x, SDXL and the SDXL refiner (port of
``models/unet.py``); one code path, the topology from ``UNetConfig``.

* Sinusoidal timestep embedding, [cos, sin] order, fp32; time MLP
  320 -> 1280 -> 1280 with SiLU.  LCM-distilled UNets add the projected
  guidance embedding (``cond_proj``) to it before the MLP.  With ``add_embed_dim`` (SDXL) the added
  conditioning (pooled text + size-id embeddings) joins it:
  ``t_emb += fc2(silu(fc1(add_cond)))``.
* Res blocks: GN->SiLU->conv, + SiLU->Linear of the time embedding,
  GN->SiLU->conv, + identity/1x1 skip.
* Spatial transformer blocks on (B, HW, C) tokens: GN + 1x1 proj_in,
  then ``depth`` layers of LN->self-attn (no qkv bias), LN->cross-attn vs
  the context, LN->GeGLU FFN, then 1x1 proj_out + long residual.  Depth 1
  keeps the flat SD-1.x parameter layout; deeper blocks (SDXL) hold
  ``blocks.{j}``, as the JAX pytree does.  Heads: ``n_heads``, or channels
  / ``head_dim`` (SD-2.x/SDXL).  The reference drops the GeGLU gate —
  reproduced under ``reference_quirks``.
* Encoder: conv_in + levels of (res [+ attn]) with stride-2 pad-1
  downsamples; bottleneck res/attn/res (the attention at the deepest
  level's depth); decoder levels of (res [+ attn]) over skip-concats with
  nearest-2x upsample + conv between levels.
* ``conv_backend`` (``models/config.py``): "kernel" runs both halves of
  every res block through K5 (``ops/cuda/conv.py``), the time-embedding
  add folded into the second half's affine; "fold" applies every GN/LN
  normalize of the res and transformer blocks as a compute-dtype affine;
  "kernel_fold" does both.  ``norm_out`` stays exact in every tier.
* Slice E's side inputs, as the JAX ``unet.apply`` takes them: ControlNet
  residuals on the skips and the bottleneck, T2I-Adapter features at
  :func:`adapter_sites`, IP-Adapter k/v layers by position key, and the
  reference-only banks (attention tokens, AdaIN statistics), captured by
  one pass and read by the next.
* Slice F's modes, as the JAX ``unet.apply`` runs them: PAG's perturbed
  pass (identity self-attention in the mid block), SAG's capture of the mid
  block's layer-0 attention map, ToMe (``ops/tome.py``) and Hypertile
  (tile-local self-attention; plans static from the block's grid and the
  config), FreeU at the two deepest decoder levels, DeepCache's full and
  shallow passes (:func:`deepcache_shape`), and seamless tiling (every conv
  wraps; K5, which pads with zeros, is off the path).
* Slice G: AnimateDiff's motion modules (``models/motion.py``), passed per
  call as ``motion=`` with the ``frames`` of a lane group: each runs after
  its encoder or decoder stage's (res + attn) pair, before the skip is
  recorded, and the bottleneck's between its attention and ``res2``.

Tensors are NCHW (channels_last in memory on CUDA); parameter names follow
the JAX pytree paths (``encoder.1.attn.self_attn.q.weight``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, conv, linear, norm
from ..ops import tome as tome_mod
from ..ops.act import geglu, silu
from ..ops.conv import upsample_nearest_2x
from ..ops.cuda.conv import gn_silu_conv3x3
from .config import UNetConfig


# ------------------------------------------------------- sinusoidal timestep
def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       device=None) -> torch.Tensor:
    """t: scalar or (B,) -> (B, dim) float32, [cos, sin] order."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1)
    half = dim // 2
    freqs = torch.pow(torch.full((), max_period, dtype=torch.float32, device=t.device),
                      -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def guidance_scale_embedding(w, dim: int, max_period: float = 10000.0,
                             device=None) -> torch.Tensor:
    """LCM guidance-scale embedding (the diffusers convention fed to
    ``time_embed.cond_proj``): w scaled by 1000, a frequency ladder over
    ``half - 1``, **[sin, cos]** order, an odd ``dim`` zero-padded; all
    three differ from :func:`timestep_embedding`, and distilled weights
    bake them in.  w: scalar or (B,) -> (B, dim) float32.  Callers pass
    ``cfg_scale - 1``."""
    w = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1) * 1000.0
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.full((), max_period, dtype=torch.float32,
                                            device=w.device))
                      * torch.arange(half, dtype=torch.float32, device=w.device)
                      / (half - 1))
    args = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


# ------------------------------------------------------------- architecture plan
def encoder_plan(cfg: UNetConfig) -> List[dict]:
    """Stage descriptors: conv_in, then per level res(+attn) blocks and a
    downsample between levels."""
    stages = [{"kind": "conv_in"}]
    c_prev = cfg.model_channels
    for i, c in enumerate(cfg.level_channels):
        for _ in range(cfg.num_res_blocks):
            stages.append({"kind": "block", "c_in": c_prev, "c_out": c,
                           "attn": cfg.attn_levels[i],
                           "depth": cfg.depth_for(i)})
            c_prev = c
        if i < len(cfg.ch_mults) - 1:
            stages.append({"kind": "down", "c": c})
    return stages


def adapter_sites(cfg: UNetConfig, n_feats: int):
    """T2I-Adapter insertion plan over the encoder stage list (the
    diffusers ``down_intrablock_additional_residuals`` contract), as in the
    JAX package: ``(pre, post, mid)``.  ``pre`` maps an encoder-stage index
    to a feature index at levels WITH attention (added after the level's
    last res/attn block, before its skip is recorded); ``post`` at levels
    WITHOUT attention (added to the backbone only, after the level's final
    stage: its downsample, or its last block at the bottom level); ``mid``
    is the feature added after the bottleneck (SDXL ``full_adapter_xl``'s
    n_levels+1-th), or None."""
    n_levels = len(cfg.ch_mults)
    if n_feats not in (n_levels, n_levels + 1):
        raise ValueError(f"{n_feats} adapter features for a {n_levels}-level"
                         f" UNet (expected {n_levels} or {n_levels + 1})")
    pre, post = {}, {}
    idx = 0
    for lvl in range(n_levels):
        last_block = idx + cfg.num_res_blocks - 1
        has_down = lvl < n_levels - 1
        if cfg.attn_levels[lvl]:
            pre[last_block] = lvl
        else:
            post[last_block + 1 if has_down else last_block] = lvl
        idx = last_block + (2 if has_down else 1)
    return pre, post, (n_levels if n_feats == n_levels + 1 else None)


def decoder_plan(cfg: UNetConfig) -> List[dict]:
    """Stage descriptors derived from the encoder skip stack."""
    skips = [cfg.model_channels]
    for st in encoder_plan(cfg)[1:]:
        skips.append(st["c_out"] if st["kind"] == "block" else st["c"])
    stages = []
    c_prev = cfg.level_channels[-1]
    for i in reversed(range(len(cfg.ch_mults))):
        c = cfg.level_channels[i]
        for j in range(cfg.num_res_blocks + 1):
            stages.append({
                "kind": "block",
                "c_in": c_prev + skips.pop(),
                "c_out": c,
                "attn": cfg.attn_levels[i],
                "depth": cfg.depth_for(i),
                "upsample": (j == cfg.num_res_blocks and i > 0),
            })
            c_prev = c
    if skips:
        raise AssertionError("decoder plan left unconsumed skips")
    return stages


# ------------------------------------------------------------------ res block
class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, t_dim: int, **kw):
        super().__init__()
        self.norm1 = norm.Norm(c_in, **kw)
        self.conv1 = conv.Conv(c_in, c_out, 3, **kw)
        self.time_proj = linear.Linear(t_dim, c_out, **kw)
        self.norm2 = norm.Norm(c_out, **kw)
        self.conv2 = conv.Conv(c_out, c_out, 3, **kw)
        self.shortcut = conv.Conv(c_in, c_out, 1, **kw) if c_in != c_out else None

    def forward(self, x, t_emb, groups: int, policy: Policy,
                conv_backend: str = "plain"):
        """x: (B, C, H, W); t_emb: (B, t_dim) or (1, t_dim).  Under seamless
        tiling (``conv.circular_padding_active``) "kernel" runs as "plain"
        and "kernel_fold" as "fold": K5 pads with zeros, as the JAX
        package's Pallas conv does, which the JAX package takes off the
        path there too."""
        if conv.circular_padding_active():
            conv_backend = {"kernel": "plain", "kernel_fold": "fold"}.get(conv_backend,
                                                                          conv_backend)
        t = linear.apply(self.time_proj, silu(t_emb), policy)
        if conv_backend in ("kernel", "kernel_fold"):
            h = gn_silu_conv3x3(self.norm1, self.conv1, x, groups)
            t = t.expand(x.shape[0], -1)
            h = gn_silu_conv3x3(self.norm2, self.conv2, h, groups, temb=t)
        elif conv_backend == "fold":
            h = norm.group_norm_silu_folded(self.norm1, x, groups, policy=policy)
            h = conv.apply(self.conv1, h, padding=1, policy=policy)
            t = t.expand(x.shape[0], -1)
            h = norm.group_norm_silu_folded(self.norm2, h, groups, policy=policy,
                                            temb=t)
            h = conv.apply(self.conv2, h, padding=1, policy=policy)
        else:
            h = norm.group_norm_silu(self.norm1, x, groups, policy=policy)
            h = conv.apply(self.conv1, h, padding=1, policy=policy)
            h = h + t[:, :, None, None].to(h.dtype)
            h = norm.group_norm_silu(self.norm2, h, groups, policy=policy)
            h = conv.apply(self.conv2, h, padding=1, policy=policy)
        res = x if self.shortcut is None else conv.apply(self.shortcut, x,
                                                         policy=policy)
        return h + res


# ----------------------------------------------------------- transformer block
def _proj1x1(p: conv.Conv, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """A 1x1-conv parameter applied as a matmul over the channels of
    (B, S, C) tokens — the same math as the conv."""
    w = p.weight[:, :, 0, 0].to(policy.compute_dtype)
    b = None if p.bias is None else p.bias.to(policy.compute_dtype)
    return torch.nn.functional.linear(x.to(policy.compute_dtype), w, b)


def hypertile_sides(h: int, w: int, tile: int):
    """Largest divisors of (h, w) that are <= tile — the static tile sides
    (tfernd/HyperTile picks among divisors per step; one static choice
    keeps the graph shape fixed).  Returns None when the grid already fits
    a single tile (hypertile is then exact/off for this block).  An axis
    with no divisor in [2, tile] (e.g. a prime side) is left untiled;
    if neither axis tiles, returns None.  Port of the JAX package's."""
    def side(n):
        for d in range(min(tile, n), 1, -1):
            if n % d == 0:
                return d
        return n  # no usable divisor: keep the full side (axis untiled)
    th, tw = side(h), side(w)
    return None if (th, tw) == (h, w) else (th, tw)


def hypertile_fold(t: torch.Tensor, h: int, w: int, th: int, tw: int) -> torch.Tensor:
    """(B, h*w, C) row-major tokens -> (B*nh*nw, th*tw, C) tile-local
    sequences (tiles raster-ordered, rows within a tile raster-ordered)."""
    n, _, c = t.shape
    nh, nw = h // th, w // tw
    t = t.reshape(n, nh, th, nw, tw, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n * nh * nw, th * tw, c)


def hypertile_unfold(t: torch.Tensor, h: int, w: int, th: int, tw: int) -> torch.Tensor:
    """Inverse of :func:`hypertile_fold`."""
    nh, nw = h // th, w // tw
    n = t.shape[0] // (nh * nw)
    t = t.reshape(n, nh, nw, th, tw, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n, h * w, t.shape[-1])


def block_plans(tome, hypertile, h: int, w: int):
    """-> (ToMe plan, Hypertile sides) of a self-attention over an (h, w)
    grid, each None where it does not engage, from the config's ``tome``
    ((ratio, sx, sy, min_tokens)) and ``hypertile`` ((tile, min_tokens)):
    ToMe from ``min_tokens`` tokens on a grid its stride divides, with at
    least one token to merge (:func:`ops.tome.plan`: (dst_idx, src_idx,
    r)); Hypertile from its ``min_tokens`` where ToMe does not engage
    (:func:`hypertile_sides`), as the JAX package's ``apply_attn_block``
    plans them."""
    tome_plan = ht_plan = None
    if tome is not None:
        ratio, sx, sy, min_tokens = tome
        if h * w >= min_tokens and h % sy == 0 and w % sx == 0:
            dst_i, src_i, t_r = tome_mod.plan(h, w, sx, sy, ratio)
            if t_r > 0:
                tome_plan = (dst_i, src_i, t_r)
    if hypertile is not None and tome_plan is None and h * w >= hypertile[1]:
        ht_plan = hypertile_sides(h, w, hypertile[0])
    return tome_plan, ht_plan


def _add_layer(m: nn.Module, channels: int, d_context: int, **kw) -> None:
    """The parameters of one self + cross + FFN transformer layer, on ``m``."""
    m.ln1 = norm.Norm(channels, **kw)
    m.self_attn = attention.Attention(channels, in_bias=False, **kw)
    m.ln2 = norm.Norm(channels, **kw)
    m.cross_attn = attention.Attention(channels, d_cross=d_context, in_bias=False, **kw)
    m.ln3 = norm.Norm(channels, **kw)
    m.geglu_proj = linear.Linear(channels, 8 * channels, **kw)
    m.geglu_out = linear.Linear(4 * channels, channels, **kw)


class TransformerLayer(nn.Module):
    """One layer of a stacked (depth > 1) spatial transformer."""

    def __init__(self, channels: int, d_context: int, **kw):
        super().__init__()
        _add_layer(self, channels, d_context, **kw)


class AttnBlock(nn.Module):
    """Spatial transformer: depth 1 in the flat SD-1.x layout, deeper ones
    (SDXL) with their layers in ``blocks``."""

    def __init__(self, channels: int, d_context: int, depth: int = 1, **kw):
        super().__init__()
        self.norm = norm.Norm(channels, **kw)
        self.conv_in = conv.Conv(channels, channels, 1, **kw)
        if depth == 1:
            _add_layer(self, channels, d_context, **kw)
        else:
            self.blocks = nn.ModuleList(TransformerLayer(channels, d_context, **kw)
                                        for _ in range(depth))
        self.conv_out = conv.Conv(channels, channels, 1, **kw)

    def layers(self):
        return list(self.blocks) if hasattr(self, "blocks") else [self]

    def forward(self, x, context, n_heads: int, groups: int, policy: Policy, *,
                backend: str = "plain", reference_quirks: bool = False,
                fuse_qkv: bool = True, fold_norms: bool = False, ip=None,
                ref=None, ref_key: Optional[str] = None, pag_self_attn: bool = False,
                return_self_probs: bool = False, tome=None, hypertile=None):
        """``fold_norms``: the GroupNorm and the LayerNorms apply their
        normalize as compute-dtype affines (``conv_backend`` "fold" and
        "kernel_fold").  ``ip``: ``(layers, tokens, scale)``, one IP-Adapter
        k/v layer for each transformer layer (``ops/attention.apply``).
        ``ref``: reference-only attention, ``("capture", bank)`` banks each
        layer's pre-attention tokens under ``f"{ref_key}_{layer}"``;
        ``("read", bank, fidelity, plain_mask)`` attends over [own, banked]
        tokens, the lanes of ``plain_mask`` lerped back toward plain
        self-attention by ``fidelity``.

        Slice F, in the JAX package's order of precedence for each layer's
        self-attention: ``pag_self_attn`` (the identity map, PAG's perturbed
        pass), ``return_self_probs`` (layer 0 returns its probabilities as
        well, SAG; -> (x, probs)), ``tome`` ((ratio, sx, sy, min_tokens):
        merge, attend, unmerge), the reference banks, ``hypertile`` ((tile,
        min_tokens): the tiles folded into the batch), then plain.  ToMe and
        Hypertile engage only on grids of ``min_tokens`` tokens or more, and
        ToMe wins where both would."""
        n, c, h, w = x.shape
        tome_plan, ht_plan = block_plans(tome, hypertile, h, w)
        self_probs = None

        def tokens(t):  # (B, C, H, W) -> (B, HW, C); free for channels_last
            return t.permute(0, 2, 3, 1).reshape(n, h * w, c)

        if fold_norms:
            gn = norm.group_norm_silu_folded(self.norm, x, groups, policy=policy,
                                             apply_silu=False)
            ln = norm.layer_norm_folded
        else:
            gn = norm.group_norm(self.norm, x, groups, policy=policy)
            ln = norm.layer_norm
        y0 = tokens(x)
        y = _proj1x1(self.conv_in, tokens(gn), policy)
        for li, lp in enumerate(self.layers()):
            t = ln(lp.ln1, y, policy=policy)

            def self_attention():
                return attention.apply(lp.self_attn, t, n_heads=n_heads, backend=backend,
                                       policy=policy, fuse=fuse_qkv)

            if pag_self_attn:
                y = y + attention.apply_identity(lp.self_attn, t, policy=policy)
            elif return_self_probs and li == 0:
                a, self_probs = attention.apply(lp.self_attn, t, n_heads=n_heads,
                                                backend=backend, policy=policy,
                                                fuse=fuse_qkv, return_probs=True)
                y = y + a
            elif tome_plan is not None:
                tm, t_info = tome_mod.merge(t, *tome_plan)
                a = attention.apply(lp.self_attn, tm, n_heads=n_heads, backend=backend,
                                    policy=policy, fuse=fuse_qkv)
                y = y + tome_mod.unmerge(a, t_info)
            elif ref is None and ht_plan is not None:
                a = attention.apply(lp.self_attn, hypertile_fold(t, h, w, *ht_plan),
                                    n_heads=n_heads, backend=backend, policy=policy,
                                    fuse=fuse_qkv)
                y = y + hypertile_unfold(a, h, w, *ht_plan)
            elif ref is None:
                y = y + self_attention()
            elif ref[0] == "capture":
                ref[1][f"{ref_key}_{li}"] = t
                y = y + self_attention()
            else:
                _, bank, fidelity, plain_mask = ref
                t_kv = torch.cat([t, bank[f"{ref_key}_{li}"].to(t.dtype)], dim=1)
                a_ref = attention.apply(lp.self_attn, t, t_kv, n_heads=n_heads,
                                        backend=backend, policy=policy, fuse=False)
                if plain_mask is not None:
                    mix = (fidelity * plain_mask)[:, None, None].to(a_ref.dtype)
                    a_ref = self_attention() * mix + a_ref * (1.0 - mix)
                y = y + a_ref
            t = ln(lp.ln2, y, policy=policy)
            y = y + attention.apply(lp.cross_attn, t, context, n_heads=n_heads,
                                    backend=backend, policy=policy, fuse=fuse_qkv,
                                    ip=None if ip is None else (ip[0][li], ip[1], ip[2]))
            t = ln(lp.ln3, y, policy=policy)
            t = geglu(linear.apply(lp.geglu_proj, t, policy), reference_quirks)
            y = y + linear.apply(lp.geglu_out, t, policy)
        y = _proj1x1(self.conv_out, y, policy) + y0
        out = y.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return (out, self_probs) if return_self_probs else out


# ----------------------------------------------------------------- full UNet
class Stage(nn.Module):
    """One encoder/decoder stage: ``down`` conv, or ``res`` [+ ``attn``]
    [+ ``upsample``] — the JAX stage dicts."""

    def __init__(self, *, res=None, attn=None, down=None, upsample=None):
        super().__init__()
        self.res, self.attn, self.down, self.upsample = res, attn, down, upsample


class Bottleneck(nn.Module):
    def __init__(self, c: int, t_dim: int, d_context: int, depth: int, **kw):
        super().__init__()
        self.res1 = ResBlock(c, c, t_dim, **kw)
        self.attn = AttnBlock(c, d_context, depth, **kw)
        self.res2 = ResBlock(c, c, t_dim, **kw)


class TimeEmbed(nn.Module):
    """The time MLP (``c`` = model channels), and SDXL's added-conditioning
    MLP of the same shape (``c`` = add_embed_dim).  ``cond_dim``: LCM's
    bias-free ``cond_proj`` of the guidance embedding to ``c``."""

    def __init__(self, c: int, t_dim: int, cond_dim: Optional[int] = None, **kw):
        super().__init__()
        self.fc1 = linear.Linear(c, t_dim, **kw)
        self.fc2 = linear.Linear(t_dim, t_dim, **kw)
        if cond_dim:
            self.cond_proj = linear.Linear(cond_dim, c, bias=False, **kw)


def encoder_stages(cfg: UNetConfig, **kw) -> nn.ModuleList:
    """The encoder's stages after conv_in, from :func:`encoder_plan`: the
    UNet's, and the ControlNet's copy of it (``models/controlnet.py``)."""
    t_dim = cfg.time_embed_dim
    enc = []
    for st in encoder_plan(cfg)[1:]:
        if st["kind"] == "down":
            enc.append(Stage(down=conv.Conv(st["c"], st["c"], 3, **kw)))
        else:
            enc.append(Stage(
                res=ResBlock(st["c_in"], st["c_out"], t_dim, **kw),
                attn=AttnBlock(st["c_out"], cfg.d_context, st["depth"], **kw)
                if st["attn"] else None))
    return nn.ModuleList(enc)


def time_embedding(m: nn.Module, cfg: UNetConfig, t, policy: Policy, device,
                   add_cond: Optional[torch.Tensor] = None,
                   t_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The time MLP of ``m`` (a UNet or a ControlNet) on the sinusoidal
    embedding of ``t`` (+ LCM's projected guidance embedding ``t_cond``),
    plus SDXL's added-conditioning MLP of ``add_cond``."""
    t_emb = timestep_embedding(t, cfg.model_channels, device=device)
    if t_cond is not None:
        t_emb = t_emb + linear.apply(m.time_embed.cond_proj, t_cond, policy)
    t_emb = linear.apply(m.time_embed.fc1, t_emb, policy)
    t_emb = linear.apply(m.time_embed.fc2, silu(t_emb), policy)
    if add_cond is not None:
        a = linear.apply(m.add_embed.fc1, add_cond.to(policy.compute_dtype), policy)
        t_emb = t_emb + linear.apply(m.add_embed.fc2, silu(a), policy)
    return t_emb


def _fourier_lowpass_scale(x: torch.Tensor, scale: float, threshold: int = 1) -> torch.Tensor:
    """FreeU's spectral modulation: the lowest-frequency band of the (NCHW)
    feature map scaled by ``scale``, a 2*threshold-wide box around DC in the
    centred 2-D spectrum over H and W; the FFT in fp32, cast back to x's
    dtype and memory format.  Port of the JAX package's
    ``_fourier_lowpass_scale``."""
    h, w = x.shape[2], x.shape[3]
    f = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(2, 3)), dim=(2, 3))
    mask = torch.ones((h, w), dtype=torch.float32, device=x.device)
    crow, ccol = h // 2, w // 2
    mask[max(crow - threshold, 0):crow + threshold,
         max(ccol - threshold, 0):ccol + threshold] = scale
    f = torch.fft.ifftshift(f * mask, dim=(2, 3))
    # in x's memory format (channels_last on the card, as K5 reads it)
    return torch.empty_like(x).copy_(torch.fft.ifftn(f, dim=(2, 3)).real)


def deepcache_shape(cfg: UNetConfig, batch: int, h_lat: int, w_lat: int):
    """Shape of DeepCache's backbone feature, (B, C, h, w): the shallowest
    decoder level runs at the full latent resolution with the second
    level's channel width (its input arrives through that level's upsample
    conv); ``ValueError`` for a one-level UNet, as in the JAX package."""
    if len(cfg.ch_mults) < 2:
        raise ValueError("deepcache needs a UNet with >= 2 levels")
    return (batch, cfg.level_channels[1], h_lat, w_lat)


def adain_transform(xf, mean, var, m_ref, v_ref, fidelity, plain_mask):
    """Reference AdaIN's read transform (the diffusers community
    stable_diffusion_reference formula, as in the JAX package):
    ``(x - mean) / sqrt(max(var, 1e-6)) * sqrt(max(var_ref, 1e-6)) +
    mean_ref``, then the lanes of ``plain_mask`` lerp back toward ``x`` by
    ``fidelity``.  All fp32; (mean, var) are the per-sample, per-channel
    spatial statistics of ``xf`` (N, C, H, W)."""
    x_ad = (xf - mean) / torch.sqrt(torch.clamp(var, min=1e-6)) \
        * torch.sqrt(torch.clamp(v_ref, min=1e-6)) + m_ref
    if plain_mask is not None:
        mix = (fidelity * plain_mask)[:, None, None, None].float()
        x_ad = xf * mix + x_ad * (1.0 - mix)
    return x_ad


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        t_dim = cfg.time_embed_dim
        self.time_embed = TimeEmbed(cfg.model_channels, t_dim, cfg.time_cond_dim, **kw)
        if cfg.add_embed_dim:
            self.add_embed = TimeEmbed(cfg.add_embed_dim, t_dim, **kw)
        self.conv_in = conv.Conv(cfg.in_channels, cfg.model_channels, 3, **kw)
        self.encoder = encoder_stages(cfg, **kw)
        self.bottleneck = Bottleneck(cfg.level_channels[-1], t_dim, cfg.d_context,
                                     cfg.depth_for(len(cfg.ch_mults) - 1), **kw)
        self.decoder = nn.ModuleList(
            Stage(res=ResBlock(st["c_in"], st["c_out"], t_dim, **kw),
                  attn=AttnBlock(st["c_out"], cfg.d_context, st["depth"], **kw)
                  if st["attn"] else None,
                  upsample=conv.Conv(st["c_out"], st["c_out"], 3, **kw)
                  if st["upsample"] else None)
            for st in decoder_plan(cfg))
        self.norm_out = norm.Norm(cfg.model_channels, **kw)
        self.conv_out = conv.Conv(cfg.model_channels, cfg.out_channels, 3, **kw)

    def forward(self, latents, context, t, policy: Policy = FP32, *,
                attention_backend: str = "plain", reference_quirks: bool = False,
                fuse_qkv: bool = True, conv_backend: str = "plain",
                add_cond: Optional[torch.Tensor] = None,
                t_cond: Optional[torch.Tensor] = None, control=None, adapter=None,
                ip=None, ref=None, ref_adain=None, head: bool = True, pag: bool = False,
                return_mid_attn: bool = False, return_cache: bool = False, cache=None,
                modes: Optional[UNetConfig] = None, motion=None,
                frames: Optional[int] = None):
        """latents: (B, in_ch, h, w) (in_ch 9 for inpainting, 8 for
        InstructPix2Pix: plain convs, never K5); context: (B, S, d_context),
        or a hypernetwork's ``(ctx_k, ctx_v)`` pair of such tensors; t:
        scalar or (B,) timestep; ``add_cond``: SDXL's (B, add_embed_dim)
        added conditioning; ``t_cond``: LCM's (1|B, time_cond_dim)
        :func:`guidance_scale_embedding`, projected by ``cond_proj`` in the
        compute dtype and added to the sinusoidal embedding.

        Slice E's side inputs, as the JAX ``unet.apply`` takes them:
        ``control``, ControlNet residuals ``{"down": [one a skip], "mid":
        r}`` added to the skips and to the bottleneck output; ``adapter``,
        T2I-Adapter features added at :func:`adapter_sites`; ``ip``,
        ``(layers, tokens, scale)`` with ``layers`` mapping the position
        keys ``enc_{i}_{l}`` / ``dec_{i}_{l}`` / ``mid_{l}`` to IP-Adapter
        k/v layers; ``ref`` and ``ref_adain``, reference-only attention
        (:class:`AttnBlock`) and AdaIN: ``("capture", bank)`` or ``("read",
        bank, fidelity, plain_mask)``, AdaIN banking the fp32 per-channel
        spatial (mean, var) after every encoder and decoder res(+attn)
        stage and after the bottleneck.  ``head=False`` skips norm_out and
        conv_out and returns None (a reference capture pass).  ``motion``,
        AnimateDiff's modules by site (``enc_{i}``, ``dec_{i}``, ``mid``;
        an ``nn.ModuleDict`` of :class:`~.motion.MotionModule`), over lane
        groups of ``frames`` lanes, the frame index fastest.

        Slice F: ``pag`` runs PAG's perturbed pass (the mid block's
        self-attention layers take the identity map); ``return_mid_attn``
        -> (output, the mid block's layer-0 attention probabilities) for
        SAG; the ``tome`` and ``hypertile`` of ``modes`` (the request's
        UNet config, by default the one the UNet was built with) reach
        every attention block, and its ``freeu`` ((b1, b2, s1, s2)) scales
        the backbone's first half of channels by b and low-passes the skip
        by s at the two deepest decoder levels, neutral values skipped;
        DeepCache:
        ``return_cache`` -> (output, the feature entering the shallowest
        decoder level), and passing that feature back as ``cache`` runs only
        conv_in, the level-0 encoder blocks, the last decoder level and the
        head — with the inputs of the full pass, exactly its output.

        Returns the model output (B, out_ch, h, w): the predicted noise, or
        v for a v-prediction checkpoint."""
        if return_mid_attn and (cache is not None or return_cache):
            raise ValueError("return_mid_attn (SAG) is incompatible with "
                             "DeepCache (the shallow step skips the mid block)")
        cfg = self.cfg
        modes = modes or cfg
        t_emb = time_embedding(self, cfg, t, policy, latents.device, add_cond, t_cond)
        fold_norms = conv_backend in ("fold", "kernel_fold")

        def block(res, attn, x, key, **mid):
            x = res(x, t_emb, cfg.groups, policy, conv_backend)
            if attn is not None:
                x = attn(x, context, cfg.heads_for(x.shape[1]), cfg.groups, policy,
                         backend=attention_backend, reference_quirks=reference_quirks,
                         fuse_qkv=fuse_qkv, fold_norms=fold_norms, ip=ip_for(key, attn),
                         ref=ref, ref_key=key, tome=modes.tome, hypertile=modes.hypertile,
                         **mid)
            # the bottleneck's motion module runs after SAG's unpack, below
            return x if mid else temporal(x, key)

        def temporal(x, key):
            # AnimateDiff: the site's motion module, attending across frames
            if motion is None or key not in motion:
                return x
            return motion[key](x, frames, policy)

        def ip_for(key, attn):
            if ip is None:
                return None
            return ([ip[0][f"{key}_{li}"] for li in range(len(attn.layers()))],
                    ip[1], ip[2])

        def adain_site(x, key):
            if ref_adain is None:
                return x
            xf = x.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
            if ref_adain[0] == "capture":
                ref_adain[1][key] = (mean, var)
                return x
            _, bank, fidelity, plain_mask = ref_adain
            m_ref, v_ref = bank[key]
            return adain_transform(xf, mean, var, m_ref, v_ref, fidelity,
                                   plain_mask).to(x.dtype)

        if adapter is not None:
            ad_pre, ad_post, ad_mid = adapter_sites(cfg, len(adapter))
        dec_per_level = cfg.num_res_blocks + 1
        n_dec = len(self.decoder)
        x = conv.apply(self.conv_in, latents, padding=1, policy=policy)
        skips = [x]
        mid_probs = None
        if cache is None:
            for i, stage in enumerate(self.encoder):
                if stage.down is not None:
                    # stride-2 symmetric pad 1 (differs from the VAE's pad)
                    x = conv.apply(stage.down, x, stride=2, padding=1, policy=policy)
                else:
                    x = adain_site(block(stage.res, stage.attn, x, f"enc_{i}"), f"enc_{i}")
                    if adapter is not None and i in ad_pre:
                        x = x + adapter[ad_pre[i]].to(x.dtype)
                skips.append(x)
                if adapter is not None and i in ad_post:
                    # backbone only: the recorded skip excludes the feature
                    x = x + adapter[ad_post[i]].to(x.dtype)
            if control is not None:
                skips = [s + d.to(s.dtype) for s, d in zip(skips, control["down"])]
            mid = self.bottleneck
            x = block(mid.res1, mid.attn, x, "mid", pag_self_attn=pag,
                      return_self_probs=return_mid_attn)
            if return_mid_attn:
                x, mid_probs = x
            x = adain_site(mid.res2(temporal(x, "mid"), t_emb, cfg.groups, policy,
                                    conv_backend), "mid")
            if adapter is not None and ad_mid is not None:
                # full_adapter_xl's extra feature, before the ControlNet's
                x = x + adapter[ad_mid].to(x.dtype)
            if control is not None:
                x = x + control["mid"].to(x.dtype)
            dec_stages = list(enumerate(self.decoder))
        else:
            # DeepCache's shallow pass: the level-0 encoder blocks (the skips
            # the shallowest decoder level takes), the deep UNet replaced by
            # the cached feature; only a level-0 "pre" adapter site falls here
            for i, stage in enumerate(self.encoder[:cfg.num_res_blocks]):
                x = block(stage.res, stage.attn, x, f"enc_{i}")
                if adapter is not None and i in ad_pre:
                    x = x + adapter[ad_pre[i]].to(x.dtype)
                skips.append(x)
            if control is not None:  # zip stops at the shallow skips
                skips = [s + d.to(s.dtype) for s, d in zip(skips, control["down"])]
            x = cache.to(policy.compute_dtype)
            dec_stages = list(enumerate(self.decoder))[-dec_per_level:]
        out_cache = None
        for si, stage in dec_stages:
            if return_cache and si == n_dec - dec_per_level:
                out_cache = x
            skip = skips.pop()
            if modes.freeu is not None and si // dec_per_level < 2:
                # FreeU: boost the backbone's first half of channels, low-pass
                # the skip; neutral values skipped, so (1, 1, 1, 1) is off
                lvl = si // dec_per_level
                b, s = modes.freeu[lvl], modes.freeu[2 + lvl]
                if b != 1.0:
                    # b rounded to x's dtype, as the JAX package multiplies
                    b_x = torch.tensor(b, dtype=x.dtype).item()
                    x = x.clone()
                    x[:, :x.shape[1] // 2] *= b_x
                if s != 1.0:
                    skip = _fourier_lowpass_scale(skip, s)
            x = block(stage.res, stage.attn, torch.cat([x, skip], dim=1), f"dec_{si}")
            x = adain_site(x, f"dec_{si}")
            if stage.upsample is not None:
                x = conv.apply(stage.upsample, upsample_nearest_2x(x), padding=1,
                               policy=policy)
        if not head:
            return None
        x = norm.group_norm_silu(self.norm_out, x, cfg.groups, policy=policy)
        out = conv.apply(self.conv_out, x, padding=1, policy=policy)
        if return_cache:
            return out, out_cache
        if return_mid_attn:
            return out, mid_probs
        return out
