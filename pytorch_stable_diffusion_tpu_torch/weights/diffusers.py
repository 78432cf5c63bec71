"""Diffusers-format checkpoints (port of ``weights/diffusers.py``).

Modern distributions ship the diffusers layout: separate ``unet/``,
``vae/`` and ``text_encoder/`` weight files with their own key names, and
for SDXL ``text_encoder_2/`` (the bigG tower, in the transformers layout
with its ``text_projection`` an ``nn.Linear``); the SDXL refiner's tree
holds only ``text_encoder_2/``, its one tower.  The rules are generated
from the architecture config as in ``weights/convert.py``, with the same
two-way coverage guarantee, and emit the port's parameter names; the port
keeps PyTorch layouts, so every tensor copies as it is (diffusers' VAE
attention is already Linear) but for the text projection, whose (out, in)
Linear weight becomes the (in, out) matrix ``x @ W`` takes, and the
transformer blocks' ``proj_in``/``proj_out``, read as convs or linears
(SD-2.x and SDXL: ``use_linear_projection``) and written as the family's
files store them.

Key-name correspondence (modern diffusers, Linear-based VAE attention):
  unet:  down_blocks.{l}.resnets/attentions/downsamplers, mid_block,
         up_blocks, time_embedding.linear_{1,2}, add_embedding.linear_{1,2}
         (SDXL), conv_in, conv_norm_out, conv_out; resnet fields norm1/
         conv1/time_emb_proj/norm2/conv2/conv_shortcut; attentions.{r}.
         transformer_blocks.{j} for each layer of a stacked block.
  vae:   encoder.down_blocks..., decoder.up_blocks... (decoder up_blocks are
         listed top-resolution-LAST, i.e. already in our processing order),
         mid_block.resnets.{0,1} + attentions.0 (group_norm, to_q/k/v,
         to_out.0 — Linear (C, C)), quant_conv, post_quant_conv.
  text_encoder[_2]: text_model.* — the transformers layout, for every
         tower (OpenCLIP's included), + text_projection.weight (bigG).
  controlnet: the UNet's encoder/mid names + controlnet_cond_embedding
         (conv_in, blocks.{i}, conv_out: the hint plan),
         controlnet_down_blocks.{i} (zero convs), controlnet_mid_block.
  t2i_adapter: [adapter.]conv_in, body.{i}.in_conv (on a change of width),
         body.{i}.resnets.{j}.block1/block2 (FullAdapter / FullAdapterXL).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..models import unet as unet_mod
from ..models.config import SDConfig, check_ported
from .convert import (Rule, StateDicts, _conv, _convert_rules, _keep, _linear, _norm,
                      attn_block_rules, invert_rules, proj_kind)


# ------------------------------------------------------------------- UNet
def _res_rules(rules, src, dst, c_in, c_out):
    _norm(rules, f"{src}.norm1", f"{dst}.norm1")
    _conv(rules, f"{src}.conv1", f"{dst}.conv1")
    _linear(rules, f"{src}.time_emb_proj", f"{dst}.time_proj")
    _norm(rules, f"{src}.norm2", f"{dst}.norm2")
    _conv(rules, f"{src}.conv2", f"{dst}.conv2")
    if c_in != c_out:
        _conv(rules, f"{src}.conv_shortcut", f"{dst}.shortcut")


def unet_rules(cfg: SDConfig) -> List[Rule]:
    u = cfg.unet
    proj = proj_kind(cfg)
    rules: List[Rule] = []
    _linear(rules, "time_embedding.linear_1", "time_embed.fc1")
    _linear(rules, "time_embedding.linear_2", "time_embed.fc2")
    if u.time_cond_dim:
        # LCM's guidance projection (time_cond_proj_dim checkpoints)
        _linear(rules, "time_embedding.cond_proj", "time_embed.cond_proj", bias=False)
    _conv(rules, "conv_in", "conv_in")
    # our flat encoder-stage list <-> diffusers down_blocks.{l}.{resnets,...}
    _encoder_rules(rules, u, proj)

    per_level = u.num_res_blocks + 1
    for j, st in enumerate(unet_mod.decoder_plan(u)):
        dst = f"decoder.{j}"
        lv, r = divmod(j, per_level)
        _res_rules(rules, f"up_blocks.{lv}.resnets.{r}", f"{dst}.res",
                   st["c_in"], st["c_out"])
        if st["attn"]:
            attn_block_rules(rules, f"up_blocks.{lv}.attentions.{r}", f"{dst}.attn",
                             st["depth"], proj)
        if st["upsample"]:
            _conv(rules, f"up_blocks.{lv}.upsamplers.0.conv", f"{dst}.upsample")

    if u.add_embed_dim:
        # SDXL's added-conditioning MLP
        _linear(rules, "add_embedding.linear_1", "add_embed.fc1")
        _linear(rules, "add_embedding.linear_2", "add_embed.fc2")
    _norm(rules, "conv_norm_out", "norm_out")
    _conv(rules, "conv_out", "conv_out")
    return rules


def _encoder_rules(rules, u, proj) -> None:
    """The encoder stages (down_blocks.{l}.{resnets,attentions,
    downsamplers}) and the mid block: the UNet's and the ControlNet's."""
    res_i = {lv: 0 for lv in range(len(u.ch_mults))}
    level = 0
    for i, st in enumerate(unet_mod.encoder_plan(u)[1:]):
        dst = f"encoder.{i}"
        if st["kind"] == "down":
            _conv(rules, f"down_blocks.{level}.downsamplers.0.conv", f"{dst}.down")
            level += 1
        else:
            r = res_i[level]
            _res_rules(rules, f"down_blocks.{level}.resnets.{r}", f"{dst}.res",
                       st["c_in"], st["c_out"])
            if st["attn"]:
                attn_block_rules(rules, f"down_blocks.{level}.attentions.{r}",
                                 f"{dst}.attn", st["depth"], proj)
            res_i[level] += 1
    c_mid = u.level_channels[-1]
    _res_rules(rules, "mid_block.resnets.0", "bottleneck.res1", c_mid, c_mid)
    attn_block_rules(rules, "mid_block.attentions.0", "bottleneck.attn",
                     u.depth_for(len(u.ch_mults) - 1), proj)
    _res_rules(rules, "mid_block.resnets.1", "bottleneck.res2", c_mid, c_mid)


# -------------------------------------------------------------------- VAE
def _vae_res_rules(rules, src, dst, c_in, c_out):
    _norm(rules, f"{src}.norm1", f"{dst}.norm1")
    _conv(rules, f"{src}.conv1", f"{dst}.conv1")
    _norm(rules, f"{src}.norm2", f"{dst}.norm2")
    _conv(rules, f"{src}.conv2", f"{dst}.conv2")
    if c_in != c_out:
        _conv(rules, f"{src}.conv_shortcut", f"{dst}.shortcut")


def _vae_mid_rules(rules, src, dst, ch):
    _vae_res_rules(rules, f"{src}.resnets.0", f"{dst}.res1", ch, ch)
    a = f"{src}.attentions.0"
    _norm(rules, f"{a}.group_norm", f"{dst}.attn.norm")
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("out", "to_out.0")):
        _linear(rules, f"{a}.{theirs}", f"{dst}.attn.attn.{ours}")
    _vae_res_rules(rules, f"{src}.resnets.1", f"{dst}.res2", ch, ch)


def vae_encoder_rules(cfg: SDConfig) -> List[Rule]:
    chs = cfg.vae.level_channels
    rules: List[Rule] = []
    _conv(rules, "encoder.conv_in", "conv_in")
    c_prev = chs[0]
    for lv, c in enumerate(chs):
        _vae_res_rules(rules, f"encoder.down_blocks.{lv}.resnets.0",
                       f"down.{lv}.res.0", c_prev, c)
        _vae_res_rules(rules, f"encoder.down_blocks.{lv}.resnets.1",
                       f"down.{lv}.res.1", c, c)
        c_prev = c
        if lv < len(chs) - 1:
            _conv(rules, f"encoder.down_blocks.{lv}.downsamplers.0.conv",
                  f"down.{lv}.downsample")
    _vae_mid_rules(rules, "encoder.mid_block", "mid", chs[-1])
    _norm(rules, "encoder.conv_norm_out", "norm_out")
    _conv(rules, "encoder.conv_out", "conv_out")
    _conv(rules, "quant_conv", "quant_conv")
    return rules


def vae_decoder_rules(cfg: SDConfig) -> List[Rule]:
    chs = cfg.vae.level_channels
    rules: List[Rule] = []
    _conv(rules, "post_quant_conv", "post_quant_conv")
    _conv(rules, "decoder.conv_in", "conv_in")
    _vae_mid_rules(rules, "decoder.mid_block", "mid", chs[-1])
    c_prev = chs[-1]
    # diffusers decoder.up_blocks.{k} are already in processing order
    for k, lv in enumerate(reversed(range(len(chs)))):
        c = chs[lv]
        for b in range(3):
            _vae_res_rules(rules, f"decoder.up_blocks.{k}.resnets.{b}",
                           f"up.{k}.res.{b}", c_prev if b == 0 else c, c)
        c_prev = c
        if lv > 0:
            _conv(rules, f"decoder.up_blocks.{k}.upsamplers.0.conv", f"up.{k}.upsample")
    _norm(rules, "decoder.conv_norm_out", "norm_out")
    _conv(rules, "decoder.conv_out", "conv_out")
    return rules


# ------------------------------------------------------------------- CLIP
def _clip_tower_rules(ccfg) -> List[Rule]:
    """HF-layout (diffusers ``text_encoder``/``text_encoder_2``) rules for
    one tower config, OpenCLIP's too; the LoRA resolver reads them."""
    src = "text_model"
    rules: List[Rule] = [
        (f"{src}.embeddings.token_embedding.weight", "token_embedding", "direct"),
        (f"{src}.embeddings.position_embedding.weight", "position_embedding", "direct"),
    ]
    for i in range(ccfg.n_layers):
        lyr = f"{src}.encoder.layers.{i}"
        dst = f"layers.{i}"
        _norm(rules, f"{lyr}.layer_norm1", f"{dst}.ln1")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            _linear(rules, f"{lyr}.self_attn.{theirs}", f"{dst}.attn.{ours}")
        _norm(rules, f"{lyr}.layer_norm2", f"{dst}.ln2")
        _linear(rules, f"{lyr}.mlp.fc1", f"{dst}.fc1")
        _linear(rules, f"{lyr}.mlp.fc2", f"{dst}.fc2")
    _norm(rules, f"{src}.final_layer_norm", "final_norm")
    if ccfg.text_projection:
        # CLIPTextModelWithProjection: a top-level (out, in) Linear, x @ W.T
        rules.append(("text_projection.weight", "text_projection", "linear_t"))
    return rules


def clip_rules(cfg: SDConfig) -> List[Rule]:
    return _clip_tower_rules(cfg.clip)


def clip2_rules(cfg: SDConfig) -> List[Rule]:
    return _clip_tower_rules(cfg.clip2)


#: diffusers files carry these non-weight keys
_IGNORE = ("text_model.embeddings.position_ids",)


def _check_leftover(sd: Mapping, used: set, name: str) -> None:
    leftover = [k for k in sd if k not in used and k not in _IGNORE]
    if leftover:
        raise KeyError(f"[{name}] {len(leftover)} unconsumed diffusers keys "
                       f"(first 10): {sorted(leftover)[:10]}")


def _convert_one(sd: Mapping, rules, name: str, used: set) -> Dict[str, torch.Tensor]:
    return _convert_rules(sd, rules, name, _keep, used, what="diffusers key")


def convert_diffusers_vae(vae_sd: Mapping, cfg: SDConfig
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A diffusers ``vae/`` state dict -> (encoder, decoder) state dicts
    (exact coverage)."""
    check_ported(cfg)
    used: set = set()
    enc = _convert_one(vae_sd, vae_encoder_rules(cfg), "vae", used)
    dec = _convert_one(vae_sd, vae_decoder_rules(cfg), "vae", used)
    _check_leftover(vae_sd, used, "vae")
    return enc, dec


def convert_diffusers(unet_sd: Mapping, vae_sd: Mapping, text_encoder_sd: Mapping,
                      cfg: SDConfig, text_encoder_2_sd: Optional[Mapping] = None
                      ) -> StateDicts:
    """Diffusers state dicts -> the port's {'clip', ['clip2',] 'encoder',
    'decoder', 'diffusion'} state dicts; exact coverage on all inputs.  A
    family with a second tower (SDXL, ``cfg.clip2``) needs
    ``text_encoder_2_sd``."""
    check_ported(cfg)
    used_u, used_c = set(), set()
    out = {"diffusion": _convert_one(unet_sd, unet_rules(cfg), "unet", used_u)}
    out["encoder"], out["decoder"] = convert_diffusers_vae(vae_sd, cfg)
    out["clip"] = _convert_one(text_encoder_sd, clip_rules(cfg), "text_encoder", used_c)
    _check_leftover(unet_sd, used_u, "unet")
    _check_leftover(text_encoder_sd, used_c, "text_encoder")
    if cfg.clip2 is not None:
        if text_encoder_2_sd is None:
            raise ValueError("SDXL config (clip2 set) requires text_encoder_2_sd")
        used_c2: set = set()
        out["clip2"] = _convert_one(text_encoder_2_sd, clip2_rules(cfg),
                                    "text_encoder_2", used_c2)
        _check_leftover(text_encoder_2_sd, used_c2, "text_encoder_2")
    return out


def deconvert_diffusers(state_dicts, cfg: SDConfig):
    """Inverse: port state dicts (or models) -> (unet_sd, vae_sd,
    text_encoder_sd), with text_encoder_2_sd appended for a family with a
    second tower (SDXL), on the tensors' device and in their dtype."""
    check_ported(cfg)

    def inv(rules, flat, sink):
        flat = flat.state_dict() if isinstance(flat, torch.nn.Module) else flat
        return invert_rules(rules, flat, sink)

    unet_sd = inv(unet_rules(cfg), state_dicts["diffusion"], {})
    vae_sd = inv(vae_encoder_rules(cfg), state_dicts["encoder"], {})
    inv(vae_decoder_rules(cfg), state_dicts["decoder"], vae_sd)
    te_sd = inv(clip_rules(cfg), state_dicts["clip"], {})
    if cfg.clip2 is not None:
        return unet_sd, vae_sd, te_sd, inv(clip2_rules(cfg), state_dicts["clip2"], {})
    return unet_sd, vae_sd, te_sd


def load_diffusers_pipeline(root: str, cfg: SDConfig) -> StateDicts:
    """Load a diffusers directory: root/{unet,vae,text_encoder[,
    text_encoder_2]}/diffusion_pytorch_model.safetensors (or .bin; the text
    encoders' model.safetensors or pytorch_model.bin) -> port state dicts.
    An SDXL-refiner tree holds only ``text_encoder_2/``: with one tower
    configured and no ``text_encoder/``, that is the tower read."""
    from .convert import load_state_dict

    def find(sub, names):
        for n in names:
            p = os.path.join(root, sub, n)
            if os.path.exists(p):
                return load_state_dict(p)
        raise FileNotFoundError(f"no weight file for {sub} under {root}")

    model = ["diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"]
    te = ["model.safetensors", "pytorch_model.bin"]
    te_dir = "text_encoder_2" if cfg.clip2 is None and not os.path.isdir(
        os.path.join(root, "text_encoder")) else "text_encoder"
    return convert_diffusers(find("unet", model), find("vae", model), find(te_dir, te), cfg,
                             find("text_encoder_2", te) if cfg.clip2 is not None else None)


# -------------------------------------------------------------- ControlNet
def controlnet_rules(cfg: SDConfig) -> List[Rule]:
    """The diffusers ``ControlNetModel`` layout: the UNet's encoder and mid
    names, ``controlnet_cond_embedding`` (conv_in / blocks.{i} / conv_out:
    the hint plan), ``controlnet_down_blocks.{i}`` (the zero convs) and
    ``controlnet_mid_block``."""
    from ..models import controlnet as controlnet_mod

    u = cfg.unet
    rules: List[Rule] = []
    _linear(rules, "time_embedding.linear_1", "time_embed.fc1")
    _linear(rules, "time_embedding.linear_2", "time_embed.fc2")
    _conv(rules, "conv_in", "conv_in")
    _encoder_rules(rules, u, proj_kind(cfg))
    n_hint = len(controlnet_mod.hint_plan(u, cfg.vae.downsample_factor))
    _conv(rules, "controlnet_cond_embedding.conv_in", "hint_block.0")
    for j in range(1, n_hint - 1):
        _conv(rules, f"controlnet_cond_embedding.blocks.{j - 1}", f"hint_block.{j}")
    _conv(rules, "controlnet_cond_embedding.conv_out", f"hint_block.{n_hint - 1}")
    for i in range(len(unet_mod.encoder_plan(u))):
        _conv(rules, f"controlnet_down_blocks.{i}", f"zero_convs.{i}")
    _conv(rules, "controlnet_mid_block", "mid_out")
    if u.add_embed_dim:
        _linear(rules, "add_embedding.linear_1", "add_embed.fc1")
        _linear(rules, "add_embedding.linear_2", "add_embed.fc2")
    return rules


def convert_controlnet_diffusers(sd: Mapping, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    """A diffusers ControlNetModel state dict -> a ControlNet state dict,
    exact coverage both ways."""
    used: set = set()
    out = _convert_one(sd, controlnet_rules(cfg), "controlnet", used)
    _check_leftover(sd, used, "controlnet")
    return out


def deconvert_controlnet_diffusers(net, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    flat = net.state_dict() if isinstance(net, torch.nn.Module) else net
    return invert_rules(controlnet_rules(cfg), flat, {})


def _weight_file(path: str, what: str) -> str:
    """``path``, or the diffusers weight file in the directory ``path``."""
    if not os.path.isdir(path):
        return path
    for n in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
        p = os.path.join(path, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {what} weight file under {path}")


def load_diffusers_controlnet(root: str, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    """A standalone diffusers controlnet directory
    (root/diffusion_pytorch_model.safetensors or .bin) -> a ControlNet
    state dict."""
    from .convert import load_state_dict

    return convert_controlnet_diffusers(
        load_state_dict(_weight_file(root, "controlnet")), cfg)


# ------------------------------------------------------------- T2I-Adapter
def t2i_adapter_rules(cfg: SDConfig, num_res_blocks: int = 2,
                      xl: Optional[bool] = None) -> List[Rule]:
    """The diffusers ``T2IAdapter`` layout (FullAdapter / FullAdapterXL,
    picked by family: ``models/t2i_adapter.adapter_layout``), without the
    ``adapter.`` prefix (the converter takes it off)."""
    from ..models.t2i_adapter import adapter_layout

    channels, _, _ = adapter_layout(cfg.unet, cfg.vae.downsample_factor, xl)
    rules: List[Rule] = []
    _conv(rules, "conv_in", "conv_in")
    c_prev = channels[0]
    for i, c in enumerate(channels):
        if c_prev != c:
            _conv(rules, f"body.{i}.in_conv", f"body.{i}.in_conv")
        for j in range(num_res_blocks):
            for part in ("block1", "block2"):
                _conv(rules, f"body.{i}.resnets.{j}.{part}", f"body.{i}.resnets.{j}.{part}")
        c_prev = c
    return rules


def convert_t2i_adapter_diffusers(sd: Mapping, cfg: SDConfig,
                                  num_res_blocks: int = 2) -> Dict[str, torch.Tensor]:
    """A diffusers T2IAdapter state dict (keys with or without the
    ``adapter.`` prefix that ``save_pretrained`` files carry) -> an adapter
    state dict, exact coverage."""
    if any(k.startswith("adapter.") for k in sd):
        sd = {k[len("adapter."):] if k.startswith("adapter.") else k: v
              for k, v in sd.items()}
    used: set = set()
    out = _convert_one(sd, t2i_adapter_rules(cfg, num_res_blocks), "t2i_adapter", used)
    _check_leftover(sd, used, "t2i_adapter")
    return out


def deconvert_t2i_adapter_diffusers(adapter, cfg: SDConfig,
                                    num_res_blocks: int = 2) -> Dict[str, torch.Tensor]:
    flat = adapter.state_dict() if isinstance(adapter, torch.nn.Module) else adapter
    sd = invert_rules(t2i_adapter_rules(cfg, num_res_blocks), flat, {})
    return {f"adapter.{k}": v for k, v in sd.items()}


def load_t2i_adapter(path: str, cfg: SDConfig,
                     num_res_blocks: int = 2) -> Dict[str, torch.Tensor]:
    """A diffusers T2IAdapter (a ``save_pretrained`` directory or one
    weight file) -> an adapter state dict."""
    from .convert import load_state_dict

    return convert_t2i_adapter_diffusers(
        load_state_dict(_weight_file(path, "t2i-adapter")), cfg, num_res_blocks)
