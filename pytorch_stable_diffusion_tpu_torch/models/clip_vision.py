"""The CLIP vision tower and the IP-Adapter's image projections (port of
``models/clip_vision.py``).

The tower is HF transformers' ``CLIPVisionModelWithProjection`` (the image
encoder the published IP-Adapters ship with): a bias-free patch conv
(stride = patch size), a learned class token prepended, learned
positions, ``pre_layrnorm``, pre-norm transformer layers (biased q/k/v/out,
bidirectional attention, fc1 -> activation -> fc2), and
``post_layernorm`` on the class token, then the bias-free
``visual_projection``.  Its attention always runs materialized scores
(``backend="plain"``), as the JAX package runs it on ``"xla"``: 257 tokens
would reach K1 on the kernel backend.  The "gelu" activation is the exact
erf form (OpenCLIP ViT-H/bigG).

The IP-Adapter's image prompt comes from either the projected embedding
(:meth:`CLIPVision.project`, then ``ImageProj``: a linear to ``n_tokens``
context tokens and a LayerNorm) or, for the "plus" adapters, the
penultimate hidden states (``stop_at_layer = n_layers - 1``) through the
perceiver ``Resampler``.  :class:`IPAdapter` holds one of those and the
per-layer ``to_k_ip``/``to_v_ip`` of every cross-attention, keyed by the
UNet's position keys (``weights/ip_adapter.py``).

``preprocess`` is the JAX package's host code, duck-typed on PIL (no PIL
import: the card's machine has none).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, conv, linear, norm
from ..ops.act import gelu, quick_gelu
from .clip import CLIPLayer


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    n_layers: int = 32
    n_heads: int = 16
    d_ff: int = 5120
    proj_dim: int = 1024
    #: "gelu" (exact erf: OpenCLIP ViT-H/bigG, the IP-Adapter encoders) or
    #: "quick_gelu" (OpenAI ViT-L).
    hidden_act: str = "gelu"

    @property
    def n_positions(self) -> int:
        return 1 + (self.image_size // self.patch_size) ** 2


def vit_h14() -> CLIPVisionConfig:
    """OpenCLIP ViT-H/14, the SD-1.5 IP-Adapter image encoder."""
    return CLIPVisionConfig()


def vit_bigg14() -> CLIPVisionConfig:
    """OpenCLIP ViT-bigG/14, the SDXL IP-Adapter image encoder."""
    return CLIPVisionConfig(width=1664, n_layers=48, n_heads=16, d_ff=8192, proj_dim=1280)


def vit_l14() -> CLIPVisionConfig:
    """OpenAI CLIP ViT-L/14 (quick_gelu)."""
    return CLIPVisionConfig(width=1024, n_layers=24, n_heads=16, d_ff=4096, proj_dim=768,
                            hidden_act="quick_gelu")


def tiny_vision_config() -> CLIPVisionConfig:
    """A scaled-down tower for CPU tests."""
    return CLIPVisionConfig(image_size=16, patch_size=8, width=32, n_layers=2, n_heads=4,
                            d_ff=64, proj_dim=24)


# CLIP preprocessing constants (OpenAI normalization — transformers
# CLIPImageProcessor defaults, which the IP-Adapter encoders keep).
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(image, cfg: CLIPVisionConfig) -> np.ndarray:
    """PIL image / uint8-ish array -> (1, S, S, 3) float32, CLIP-normalized.

    PIL inputs follow the transformers ``CLIPImageProcessor`` contract
    the published IP-Adapters were used with: bicubic resize of the
    SHORTEST edge to S, then an SxS center crop (a plain SxS resize
    would aspect-distort non-square prompts — review finding).  Arrays
    must already be (S, S, 3) or (B, S, S, 3) in [0, 255] or [0, 1].
    """
    s = cfg.image_size
    if not isinstance(image, np.ndarray) and hasattr(image, "resize"):
        image = image.convert("RGB") if hasattr(image, "convert") else image
        w0, h0 = image.size
        scale = s / min(w0, h0)
        nw, nh = round(w0 * scale), round(h0 * scale)
        image = image.resize((nw, nh), resample=3)  # 3 = BICUBIC
        left, top = (nw - s) // 2, (nh - s) // 2
        arr = np.asarray(image, np.float32)[top:top + s, left:left + s]
    else:
        arr = np.asarray(image, np.float32)
        spatial = arr.shape[1:3] if arr.ndim == 4 else arr.shape[:2]
        if spatial != (s, s):
            raise ValueError(f"ip-adapter image must be {s}x{s} when passed "
                             f"as an array, got {arr.shape}")
    if arr.ndim == 3:
        arr = arr[None]
    arr = arr[..., :3]
    if arr.max() > 1.5:  # [0,255] -> [0,1]
        arr = arr / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.width, **kw))
        self.patch_embedding = conv.Conv(3, cfg.width, cfg.patch_size, bias=False, **kw)
        self.position_embedding = nn.Parameter(torch.empty(cfg.n_positions, cfg.width, **kw))
        self.pre_ln = norm.Norm(cfg.width, **kw)
        self.layers = nn.ModuleList(CLIPLayer(cfg.width, cfg.d_ff, **kw)
                                    for _ in range(cfg.n_layers))
        self.post_ln = norm.Norm(cfg.width, **kw)
        # (in, out): the image embedding is ``pooled @ projection``
        self.projection = nn.Parameter(torch.empty(cfg.width, cfg.proj_dim, **kw))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 0.02) class token and positions, N(0, 1/width) projection,
        as the JAX init."""
        self.class_embedding.data.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.data.normal_(0.0, 0.02, generator=generator)
        self.projection.data.normal_(0.0, self.cfg.width ** -0.5, generator=generator)

    def forward(self, pixels: torch.Tensor, policy: Policy = FP32, *,
                stop_at_layer: Optional[int] = None) -> torch.Tensor:
        """pixels (B, 3, S, S), :func:`preprocess`'s -> (B, 1 + patches,
        width): the last hidden state, or the input of layer
        ``stop_at_layer`` (HF ``hidden_states[stop_at_layer]``; the "plus"
        adapters read ``n_layers - 1``), without post_layernorm."""
        cfg = self.cfg
        x = conv.apply(self.patch_embedding, pixels, stride=cfg.patch_size, policy=policy)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, width), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None].to(x.dtype)
        x = norm.layer_norm(self.pre_ln, x, policy=policy)
        act = quick_gelu if cfg.hidden_act == "quick_gelu" else gelu
        n_run = cfg.n_layers if stop_at_layer is None else stop_at_layer
        for lp in self.layers[:n_run]:
            h = norm.layer_norm(lp.ln1, x, policy=policy)
            x = x + attention.apply(lp.attn, h, n_heads=cfg.n_heads, backend="plain",
                                    policy=policy)
            h = norm.layer_norm(lp.ln2, x, policy=policy)
            x = x + linear.apply(lp.fc2, act(linear.apply(lp.fc1, h, policy)), policy)
        return x

    def project(self, pixels: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
        """-> (B, proj_dim): post_layernorm(class token) @ projection, the
        global image embedding (the JAX ``apply_projected``)."""
        pooled = norm.layer_norm(self.post_ln, self(pixels, policy)[:, 0], policy=policy)
        return pooled @ self.projection.to(pooled.dtype)


# ------------------------------------------------------- IP-Adapter image side
class ImageProj(nn.Module):
    """The standard IP-Adapter's ``ImageProjModel``: a linear from the image
    embedding to ``n_tokens * d_context``, then a LayerNorm a token."""

    def __init__(self, embed_dim: int, n_tokens: int, d_context: int, **kw):
        super().__init__()
        self.proj = linear.Linear(embed_dim, n_tokens * d_context, **kw)
        self.norm = norm.Norm(d_context, **kw)

    def forward(self, embed: torch.Tensor, policy: Policy = FP32) -> torch.Tensor:
        """(B, embed_dim) -> (B, n_tokens, d_context) (the JAX
        ``project_image_tokens``)."""
        y = linear.apply(self.proj, embed, policy)
        y = y.reshape(embed.shape[0], -1, self.norm.weight.shape[0])
        return norm.layer_norm(self.norm, y, policy=policy)


class ResamplerLayer(nn.Module):
    def __init__(self, dim: int, inner: int, ff: int, **kw):
        super().__init__()
        self.ln_x = norm.Norm(dim, **kw)
        self.ln_lat = norm.Norm(dim, **kw)
        self.q = linear.Linear(dim, inner, bias=False, **kw)
        self.kv = linear.Linear(dim, 2 * inner, bias=False, **kw)
        self.out = linear.Linear(inner, dim, bias=False, **kw)
        self.ff_ln = norm.Norm(dim, **kw)
        self.ff1 = linear.Linear(dim, ff, bias=False, **kw)
        self.ff2 = linear.Linear(ff, dim, bias=False, **kw)


class Resampler(nn.Module):
    """The IP-Adapter-plus perceiver ``Resampler``: ``n_queries`` learned
    latents cross-attend to the tower's penultimate hidden states over
    ``depth`` attention + feed-forward layers, then ``proj_out`` and
    ``norm_out``."""

    def __init__(self, n_queries: int, dim: int, embed_dim: int, out_dim: int, depth: int,
                 inner: int, ff: int, **kw):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(n_queries, dim, **kw))
        self.proj_in = linear.Linear(embed_dim, dim, **kw)
        self.layers = nn.ModuleList(ResamplerLayer(dim, inner, ff, **kw) for _ in range(depth))
        self.proj_out = linear.Linear(dim, out_dim, **kw)
        self.norm_out = norm.Norm(out_dim, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.latents.data.normal_(0.0, self.latents.shape[1] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, policy: Policy = FP32, dim_head: int = 64):
        """(B, S, embed_dim) -> (B, n_queries, out_dim) (the JAX
        ``apply_resampler``).  Each layer: LN(x), LN(latents); q from the
        latents, k/v from [x, latents] through one fused bias-free ``kv``;
        scores / sqrt(Dh) and softmax in fp32; then LN -> Linear -> exact
        GELU -> Linear.  ``dim_head`` is not in the checkpoints: 64 for
        every released adapter."""
        b = x.shape[0]
        n_heads = self.layers[0].q.weight.shape[0] // dim_head
        if n_heads < 1:
            raise ValueError(f"resampler inner dim {self.layers[0].q.weight.shape[0]} < "
                             f"dim_head {dim_head}")
        lat = self.latents.to(policy.compute_dtype).expand(b, -1, -1)
        x = linear.apply(self.proj_in, x, policy)

        def heads(t):
            return t.reshape(b, t.shape[1], n_heads, -1).transpose(1, 2)

        for lp in self.layers:
            xn = norm.layer_norm(lp.ln_x, x, policy=policy)
            ln = norm.layer_norm(lp.ln_lat, lat, policy=policy)
            q = linear.apply(lp.q, ln, policy)
            k, v = linear.apply(lp.kv, torch.cat([xn, ln], dim=1), policy).chunk(2, dim=-1)
            dh = q.shape[-1] // n_heads
            s = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2)) / dh ** 0.5
            w = torch.softmax(s, dim=-1).to(q.dtype)
            o = torch.matmul(w, heads(v)).transpose(1, 2).reshape(b, q.shape[1], -1)
            lat = lat + linear.apply(lp.out, o, policy)
            f = gelu(linear.apply(lp.ff1, norm.layer_norm(lp.ff_ln, lat, policy=policy),
                                  policy))
            lat = lat + linear.apply(lp.ff2, f, policy)
        return norm.layer_norm(self.norm_out, linear.apply(self.proj_out, lat, policy),
                               policy=policy)


class IPLayer(nn.Module):
    """One cross-attention layer's bias-free ``to_k_ip`` / ``to_v_ip``."""

    def __init__(self, d_context: int, channels: int, **kw):
        super().__init__()
        self.k = linear.Linear(d_context, channels, bias=False, **kw)
        self.v = linear.Linear(d_context, channels, bias=False, **kw)


class IPAdapter(nn.Module):
    """An IP-Adapter: ``image_proj`` (:class:`ImageProj`, or a
    :class:`Resampler` for the "plus" adapters) and ``layers``, one
    :class:`IPLayer` a cross-attention layer under its position key."""

    def __init__(self, image_proj: nn.Module, layers: dict):
        super().__init__()
        self.image_proj = image_proj
        self.layers = nn.ModuleDict(layers)

    @property
    def plus(self) -> bool:
        return isinstance(self.image_proj, Resampler)

    def image_tokens(self, tower: CLIPVision, pixels: torch.Tensor,
                     policy: Policy = FP32) -> torch.Tensor:
        """(B, 3, S, S) preprocessed pixels -> (B, n_tokens, d_context)."""
        if self.plus:
            h = tower(pixels, policy, stop_at_layer=tower.cfg.n_layers - 1)
            return self.image_proj(h, policy)
        return self.image_proj(tower.project(pixels, policy), policy)

    def negative_tokens(self, tower: CLIPVision, pixels: torch.Tensor,
                        policy: Policy = FP32) -> torch.Tensor:
        """The unconditional lane's tokens: a zero image through the tower
        for the "plus" adapters, a zero embedding projected for the
        standard one (the diffusers conventions)."""
        if self.plus:
            return self.image_tokens(tower, torch.zeros_like(pixels), policy)
        embed = torch.zeros(pixels.shape[0], tower.cfg.proj_dim, device=pixels.device,
                            dtype=policy.compute_dtype)
        return self.image_proj(embed, policy)


def ip_adapter_for(state_dict, **kw) -> IPAdapter:
    """An (empty) :class:`IPAdapter` of the shapes of a port state dict
    (``weights/ip_adapter.convert_ip_adapter``'s)."""
    sd = state_dict
    if "image_proj.latents" in sd:
        depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("image_proj.layers."))
        dim, inner = sd["image_proj.layers.0.q.weight"].shape[1], \
            sd["image_proj.layers.0.q.weight"].shape[0]
        proj = Resampler(sd["image_proj.latents"].shape[0], dim,
                         sd["image_proj.proj_in.weight"].shape[1],
                         sd["image_proj.proj_out.weight"].shape[0], depth, inner,
                         sd["image_proj.layers.0.ff1.weight"].shape[0], **kw)
    else:
        d_ctx = sd["image_proj.norm.weight"].shape[0]
        out, embed = sd["image_proj.proj.weight"].shape
        proj = ImageProj(embed, out // d_ctx, d_ctx, **kw)
    layers = {}
    for k, v in sd.items():
        if k.startswith("layers.") and k.endswith(".k.weight"):
            layers[k.split(".")[1]] = IPLayer(v.shape[1], v.shape[0], **kw)
    return IPAdapter(proj, layers)


def build_ip_adapter(state_dict, *, dtype=torch.float32, device=None) -> IPAdapter:
    """An :class:`IPAdapter` around a port state dict, on ``device`` (the
    card unless another is named) in ``dtype``."""
    from . import _finish, target_device

    device = target_device(device)
    ad = ip_adapter_for(state_dict, dtype=dtype, device="meta")
    ad.to_empty(device=device)
    ad.load_state_dict(state_dict, strict=True)
    _finish(ad, device)
    return ad


def build_clip_vision(cfg: CLIPVisionConfig, *, dtype=torch.float32, device=None,
                      state_dict=None, generator: Optional[torch.Generator] = None
                      ) -> CLIPVision:
    """A :class:`CLIPVision` of ``cfg`` on ``device`` (the card unless
    another is named) in ``dtype``: the weights of ``state_dict`` (strict),
    or drawn from ``generator``."""
    from . import _finish, reset_parameters, target_device

    device = target_device(device)
    tower = CLIPVision(cfg, dtype=dtype, device="meta")
    tower.to_empty(device=device)
    if state_dict is None:
        reset_parameters(tower, generator)
    else:
        tower.load_state_dict(state_dict, strict=True)
    _finish(tower, device)
    return tower
