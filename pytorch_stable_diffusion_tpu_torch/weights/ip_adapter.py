"""IP-Adapter and CLIP-vision weights (port of ``weights/ip_adapter.py``).

An IP-Adapter file (the h94/IP-Adapter ``.bin`` two-dict layout, or the
flat ``.safetensors`` one) holds ``image_proj`` (the standard adapter's
``ImageProjModel``, or the "plus" adapters' perceiver ``Resampler``) and
``ip_adapter``: each cross-attention layer's bias-free ``to_k_ip`` /
``to_v_ip``, keyed by INTEGER indices ``2 j + 1`` in torch's
``unet.attn_processors`` order (down_blocks, then up_blocks, then
mid_block).  :func:`ip_layer_plan` re-keys that order onto the port UNet's
position keys (``enc_{stage}_{layer}``, ``dec_{stage}_{layer}``,
``mid_{layer}``).  The converters give the port's state dicts
(``models/clip_vision.py``'s :class:`IPAdapter` and :class:`CLIPVision`
names); the port keeps torch's (out, in) layouts, so only the vision
projection is transposed.  Coverage is exact both ways, with the JAX
package's ``ValueError`` messages.  ``.bin`` files are read by the
restricted unpickler (``ckpt_reader.py``), ``.safetensors`` by the native
reader.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models import unet as unet_mod
from ..models.clip_vision import CLIPVisionConfig
from ..models.config import UNetConfig
from .convert import as_tensor


# --------------------------------------------------------------- layer plan
def _layer_widths(cfg: UNetConfig) -> Dict[str, int]:
    """Every cross-attention layer's position key -> its channels, in the
    checkpoint's flat order (down_blocks, up_blocks, mid_block)."""
    widths: Dict[str, int] = {}
    for i, st in enumerate(unet_mod.encoder_plan(cfg)[1:]):
        if st["kind"] == "block" and st["attn"]:
            widths.update({f"enc_{i}_{li}": st["c_out"] for li in range(st["depth"])})
    for i, st in enumerate(unet_mod.decoder_plan(cfg)):
        if st["attn"]:
            widths.update({f"dec_{i}_{li}": st["c_out"] for li in range(st["depth"])})
    widths.update({f"mid_{li}": cfg.level_channels[-1]
                   for li in range(cfg.depth_for(len(cfg.ch_mults) - 1))})
    return widths


def ip_layer_plan(cfg: UNetConfig) -> List[str]:
    """The port's cross-attention layer keys in the checkpoint's flat
    order."""
    return list(_layer_widths(cfg))


def synthetic_ip_state(cfg: UNetConfig, n_tok: int = 4, embed_dim: int = 24,
                       seed: int = 0, flat: bool = False) -> Dict:
    """A random IP-Adapter state dict of the published layout for ``cfg``'s
    topology (numpy arrays; the JAX package's draws for the same seed):
    ``flat=True`` the .safetensors single namespace, else the .bin two
    dicts."""
    rs = np.random.RandomState(seed)
    d_ctx = cfg.d_context
    proj = {"proj.weight": rs.randn(n_tok * d_ctx, embed_dim).astype(np.float32),
            "proj.bias": rs.randn(n_tok * d_ctx).astype(np.float32),
            "norm.weight": rs.randn(d_ctx).astype(np.float32),
            "norm.bias": rs.randn(d_ctx).astype(np.float32)}
    ada = {}
    for j, (key, c) in enumerate(_layer_widths(cfg).items()):
        ada[f"{2 * j + 1}.to_k_ip.weight"] = rs.randn(c, d_ctx).astype(np.float32)
        ada[f"{2 * j + 1}.to_v_ip.weight"] = rs.randn(c, d_ctx).astype(np.float32)
    if flat:
        out = {f"image_proj.{k}": v for k, v in proj.items()}
        out.update({f"ip_adapter.{k}": v for k, v in ada.items()})
        return out
    return {"image_proj": proj, "ip_adapter": ada}


def _nest(state: Dict) -> Dict[str, Dict]:
    """The .bin layout ({"image_proj": {...}, "ip_adapter": {...}}) or the
    flat .safetensors one ("image_proj.proj.weight", ...) -> the two
    dicts."""
    if "image_proj" in state and isinstance(state["image_proj"], dict):
        return {"image_proj": dict(state["image_proj"]),
                "ip_adapter": dict(state["ip_adapter"])}
    out: Dict[str, Dict] = {"image_proj": {}, "ip_adapter": {}}
    for k, v in state.items():
        group, rest = k.split(".", 1)
        if group not in out:
            raise ValueError(f"unexpected IP-Adapter key group {group!r}")
        out[group][rest] = v
    return out


def _f32(x) -> torch.Tensor:
    return as_tensor(x).float()


def convert_ip_adapter(state: Dict, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """An IP-Adapter state dict -> the port's :class:`IPAdapter` state dict
    (fp32): ``image_proj.*`` and ``layers.{key}.{k,v}.weight``.  Every
    checkpoint tensor consumed, every plan layer filled."""
    nested = _nest(state)
    proj_sd = nested["image_proj"]
    d_ctx = cfg.d_context
    if "latents" in proj_sd or any(k.startswith("layers.") for k in proj_sd):
        out = _convert_resampler(proj_sd, d_ctx)
    else:
        want_proj = {"proj.weight", "proj.bias", "norm.weight", "norm.bias"}
        if set(proj_sd) != want_proj:
            raise ValueError(f"unexpected image_proj keys: "
                             f"{sorted(proj_sd)} (want {sorted(want_proj)})")
        w = _f32(proj_sd["proj.weight"])
        if w.shape[0] % d_ctx:
            raise ValueError(f"image_proj out dim {w.shape[0]} not a "
                             f"multiple of d_context {d_ctx} (wrong "
                             "family?)")
        out = {"image_proj." + k: _f32(v) for k, v in proj_sd.items()}

    plan = ip_layer_plan(cfg)
    ada_sd = dict(nested["ip_adapter"])
    for j, our_key in enumerate(plan):
        idx = 2 * j + 1
        for kv in ("k", "v"):
            src = f"{idx}.to_{kv}_ip.weight"
            if src not in ada_sd:
                raise ValueError(
                    f"missing {src} — checkpoint has "
                    f"{len(ada_sd) // 2} cross-attn layers, the "
                    f"{type(cfg).__name__} plan expects {len(plan)} "
                    "(family mismatch?)")
            t = _f32(ada_sd.pop(src))  # (channels, d_ctx)
            if t.shape[1] != d_ctx:
                raise ValueError(f"{src}: context dim {t.shape[1]} != "
                                 f"UNet d_context {d_ctx}")
            out[f"layers.{our_key}.{kv}.weight"] = t
    if ada_sd:
        raise ValueError(f"unconsumed ip_adapter keys: "
                         f"{sorted(ada_sd)[:4]}...")
    return out


#: the port's Resampler names <- the published PerceiverAttention /
#: FeedForward ones, a layer (FeedForward is Sequential [LN, Linear, GELU,
#: Linear], its linears bias-free)
_RESAMPLER_LAYER = (("ln_x", "0.norm1", True), ("ln_lat", "0.norm2", True),
                    ("q", "0.to_q", False), ("kv", "0.to_kv", False),
                    ("out", "0.to_out", False), ("ff_ln", "1.0", True),
                    ("ff1", "1.1", False), ("ff2", "1.3", False))


def _convert_resampler(sd: Dict, d_ctx: int) -> Dict[str, torch.Tensor]:
    """An IP-Adapter-plus ``Resampler`` state dict -> the port's
    ``image_proj.*`` names.  Exact coverage."""
    sd = dict(sd)

    def take(key):
        if key not in sd:
            raise ValueError(f"resampler image_proj is missing {key!r}")
        return _f32(sd.pop(key))

    out = {}

    def move(ours, theirs, bias):
        out[f"image_proj.{ours}.weight"] = take(theirs + ".weight")
        if bias:
            out[f"image_proj.{ours}.bias"] = take(theirs + ".bias")

    lat = take("latents")
    out["image_proj.latents"] = lat[0] if lat.dim() == 3 else lat  # (1, nq, dim) stored
    for name in ("proj_in", "proj_out", "norm_out"):
        move(name, name, True)
    depth = 0
    while f"layers.{depth}.0.to_q.weight" in sd:
        for ours, theirs, bias in _RESAMPLER_LAYER:
            move(f"layers.{depth}.{ours}", f"layers.{depth}.{theirs}", bias)
        depth += 1
    if not depth:
        raise ValueError("resampler image_proj has no layers.*.0.to_q "
                         "keys")
    if sd:
        raise ValueError(f"unconsumed resampler keys: {sorted(sd)[:4]}...")
    if out["image_proj.proj_out.weight"].shape[0] != d_ctx:
        raise ValueError(
            f"resampler output dim {out['image_proj.proj_out.weight'].shape[0]} "
            f"!= UNet d_context {d_ctx} (wrong family?)")
    return out


def num_image_tokens(adapter) -> int:
    """The image-token count of an :class:`IPAdapter` (or its state dict):
    one a learned query of a Resampler, else the projection's width over
    the context's."""
    sd = adapter if isinstance(adapter, dict) else adapter.state_dict()
    if "image_proj.latents" in sd:
        return sd["image_proj.latents"].shape[0]
    return sd["image_proj.proj.weight"].shape[0] // sd["image_proj.norm.weight"].shape[0]


def _load(path: str):
    if path.endswith(".safetensors"):
        from .convert import load_state_dict

        return load_state_dict(path)
    from .ckpt_reader import load_torch_object

    return load_torch_object(path)


def load_ip_adapter(path: str, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """An IP-Adapter file (.bin through the restricted unpickler, or
    .safetensors) -> the port's state dict."""
    return convert_ip_adapter(_load(path), cfg)


# ------------------------------------------------- CLIP vision state dicts
def convert_clip_vision(state: Dict, cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionModelWithProjection`` state dict -> the port's
    :class:`CLIPVision` state dict (fp32).  Exact coverage
    (``position_ids`` buffers ignored)."""
    sd = {k: v for k, v in state.items() if not k.endswith("position_ids")}
    out: Dict[str, torch.Tensor] = {}

    def take(key):
        return _f32(sd.pop(key))

    def move(ours, theirs):
        out[ours + ".weight"] = take(theirs + ".weight")
        out[ours + ".bias"] = take(theirs + ".bias")

    v = "vision_model."
    out["class_embedding"] = take(v + "embeddings.class_embedding").reshape(-1)
    out["patch_embedding.weight"] = take(v + "embeddings.patch_embedding.weight")
    out["position_embedding"] = take(v + "embeddings.position_embedding.weight")
    move("pre_ln", v + "pre_layrnorm")
    for i in range(cfg.n_layers):
        p = f"{v}encoder.layers.{i}."
        for ours, theirs in (("ln1", "layer_norm1"), ("attn.q", "self_attn.q_proj"),
                             ("attn.k", "self_attn.k_proj"), ("attn.v", "self_attn.v_proj"),
                             ("attn.out", "self_attn.out_proj"), ("ln2", "layer_norm2"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            move(f"layers.{i}.{ours}", p + theirs)
    move("post_ln", v + "post_layernorm")
    out["projection"] = take("visual_projection.weight").t().contiguous()
    if sd:
        raise ValueError(f"unconsumed CLIP-vision keys: {sorted(sd)[:4]}...")
    got, exp = out["position_embedding"].shape[0], cfg.n_positions
    if got != exp:
        raise ValueError(f"position embedding rows {got} != {exp} — config "
                         f"mismatch (image_size/patch_size)")
    return out


def load_clip_vision(path: str, cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    """An image-encoder weight file (.safetensors or torch .bin) -> the
    port's state dict."""
    return convert_clip_vision(_load(path), cfg)
