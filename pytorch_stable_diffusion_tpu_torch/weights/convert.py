"""Weights into the port's state dicts (port of ``weights/convert.py``).

Two sources, both giving ``{"clip", ["clip2",] "encoder", "decoder",
"diffusion"}`` state dicts for :func:`models.build_models`:

* :func:`convert` — a CompVis/sgm state dict of SD-1.x, SD-2.x, SDXL or
  the SDXL refiner (any mapping of names to torch tensors or arrays, a
  lazy one included).  The rule tables mirror the JAX package's, but emit
  the port's parameter names; because the port keeps PyTorch layouts,
  convs and linears copy untransposed and only the VAE attention's 1x1
  convs become linear weights.  The OpenCLIP towers (SD-2.x's ViT-H under
  ``cond_stage_model.model``, SDXL's bigG under
  ``conditioner.embedders.{0,1}.model``) store each layer's q/k/v as one
  fused ``attn.in_proj_weight``/``in_proj_bias``, split here into the
  port's q, k and v.  The transformer blocks' ``proj_in``/``proj_out`` are
  read as (C, C, 1, 1) convs or (C, C) linears, whichever the file holds
  (SD-2.x and SDXL store linears; the JAX package reads convs only), and
  the towers' ``logit_scale``, ``position_ids`` and unused
  ``text_projection`` are ignored (the JAX package's ignore lists name only
  SD-1.x/2.x's; ROADMAP.md §3).  Coverage is exact both ways: a missing
  source key and an unconsumed non-ignored source key both raise
  ``KeyError`` (and ``load_state_dict(strict=True)`` checks the target
  side).  :func:`deconvert` is its inverse, writing the layout of the
  family's published files.
* :func:`from_jax_params` — the JAX package's parameter pytree (numpy
  leaves): pytree path ``a/0/b/kernel`` becomes ``a.0.b.weight``; a linear
  (in, out) kernel becomes an (out, in) weight, a conv HWIO kernel OIHW,
  and a norm ``scale`` a ``weight``.  :func:`hypernetwork_from_jax` does
  the same for a hypernetwork tree.

Files: :func:`load_state_dict` reads a ``.safetensors`` file through the
native reader (``weights/native_io.py``) and a torch zip ``.ckpt``/``.pt``/
``.bin`` through the restricted unpickler (``weights/ckpt_reader.py``);
:func:`load_sd_checkpoint`, :func:`load_vae` and :func:`convert_vae` build
on it.  The loaders return CPU tensors in the file's dtype;
``build_models`` casts them to the policy's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models import unet as unet_mod
from ..models.config import SDConfig, check_ported, model_names


def _as_1x1(x):
    return x if x.dim() == 4 else x[:, :, None, None]


# kind -> source tensor -> port tensor.  Every kind but the VAE attention's
# 1x1 convs, the transformer projections stored as linears and diffusers'
# text projection is a copy; the names say what a rule's target is (the
# LoRA resolver takes the kinds of WEIGHT_KINDS).  "proj" and
# "proj_linear" read a (C, C, 1, 1) or a (C, C) tensor alike, and write
# back the conv or the linear form.
_FWD = {
    "direct": lambda x: x,
    "conv": lambda x: x,
    "linear": lambda x: x,
    "norm": lambda x: x,
    "conv1x1_linear": lambda x: x[:, :, 0, 0],
    "proj": _as_1x1,
    "proj_linear": _as_1x1,
    "linear_t": lambda x: x.t(),
}
_INV = dict(_FWD, conv1x1_linear=lambda x: x[:, :, None, None],
            proj_linear=lambda x: x[:, :, 0, 0])
#: the kinds of conv and linear weights (LoRA targets)
WEIGHT_KINDS = ("conv", "linear", "conv1x1_linear", "proj", "proj_linear", "linear_t")

# (src_key, port_key, kind); kind may be ("split3", i): part i of the three
# row blocks of a fused (3d, ...) OpenCLIP in_proj tensor
Rule = Tuple[str, str, object]


def fwd(kind, x: torch.Tensor) -> torch.Tensor:
    """A source tensor in the port's layout, by rule kind."""
    if isinstance(kind, tuple):
        d = x.shape[0] // 3
        return x[kind[1] * d:(kind[1] + 1) * d]
    return _FWD[kind](x)


def _conv(rules, src, dst, bias=True, kind="conv"):
    rules.append((f"{src}.weight", f"{dst}.weight", kind))
    if bias:
        rules.append((f"{src}.bias", f"{dst}.bias", "norm" if kind == "norm" else "direct"))


def _linear(rules, src, dst, bias=True):
    _conv(rules, src, dst, bias, kind="linear")


def _norm(rules, src, dst):
    _conv(rules, src, dst, kind="norm")


# ------------------------------------------------------------------- UNet
def _unet_res_rules(rules, src, dst, c_in, c_out):
    _norm(rules, f"{src}.in_layers.0", f"{dst}.norm1")
    _conv(rules, f"{src}.in_layers.2", f"{dst}.conv1")
    _linear(rules, f"{src}.emb_layers.1", f"{dst}.time_proj")
    _norm(rules, f"{src}.out_layers.0", f"{dst}.norm2")
    _conv(rules, f"{src}.out_layers.3", f"{dst}.conv2")
    if c_in != c_out:
        _conv(rules, f"{src}.skip_connection", f"{dst}.shortcut")


def _transformer_layer_rules(rules, tb, dst):
    """One self + cross + FFN layer ``tb`` (CompVis and diffusers name
    them alike) -> the port's ``dst`` (an AttnBlock, or one of its
    ``blocks``)."""
    _norm(rules, f"{tb}.norm1", f"{dst}.ln1")
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v")):
        _linear(rules, f"{tb}.attn1.{theirs}", f"{dst}.self_attn.{ours}", bias=False)
        _linear(rules, f"{tb}.attn2.{theirs}", f"{dst}.cross_attn.{ours}", bias=False)
    _linear(rules, f"{tb}.attn1.to_out.0", f"{dst}.self_attn.out")
    _linear(rules, f"{tb}.attn2.to_out.0", f"{dst}.cross_attn.out")
    _norm(rules, f"{tb}.norm2", f"{dst}.ln2")
    _norm(rules, f"{tb}.norm3", f"{dst}.ln3")
    _linear(rules, f"{tb}.ff.net.0.proj", f"{dst}.geglu_proj")
    _linear(rules, f"{tb}.ff.net.2", f"{dst}.geglu_out")


def attn_block_rules(rules, src, dst, depth: int, proj: str):
    """A spatial transformer of ``depth`` layers (depth 1: the flat SD-1.x
    layout; deeper: ``blocks.{j}``); ``proj`` the kind of its
    proj_in/proj_out."""
    _norm(rules, f"{src}.norm", f"{dst}.norm")
    _conv(rules, f"{src}.proj_in", f"{dst}.conv_in", kind=proj)
    if depth == 1:
        _transformer_layer_rules(rules, f"{src}.transformer_blocks.0", dst)
    else:
        for j in range(depth):
            _transformer_layer_rules(rules, f"{src}.transformer_blocks.{j}",
                                     f"{dst}.blocks.{j}")
    _conv(rules, f"{src}.proj_out", f"{dst}.conv_out", kind=proj)


def proj_kind(cfg: SDConfig) -> str:
    """How the family's published checkpoints store the transformer
    blocks' proj_in/proj_out: (C, C) linears for SD-2.x and SDXL
    (``use_linear_in_transformer``, the families with a fixed head width),
    (C, C, 1, 1) convs for SD-1.x.  Either is read; this is the one
    written."""
    return "proj_linear" if cfg.unet.head_dim is not None else "proj"


def unet_rules(cfg: SDConfig) -> List[Rule]:
    u = cfg.unet
    src = "model.diffusion_model"
    proj = proj_kind(cfg)
    rules: List[Rule] = []
    _linear(rules, f"{src}.time_embed.0", "time_embed.fc1")
    _linear(rules, f"{src}.time_embed.2", "time_embed.fc2")
    if u.time_cond_dim:
        # LCM's guidance projection; CompVis-layout LCM exports keep the
        # diffusers attribute name under time_embed
        _linear(rules, f"{src}.time_embed.cond_proj", "time_embed.cond_proj", bias=False)
    _conv(rules, f"{src}.input_blocks.0.0", "conv_in")
    for i, st in enumerate(unet_mod.encoder_plan(u)[1:]):
        blk = f"{src}.input_blocks.{i + 1}"
        dst = f"encoder.{i}"
        if st["kind"] == "down":
            _conv(rules, f"{blk}.0.op", f"{dst}.down")
        else:
            _unet_res_rules(rules, f"{blk}.0", f"{dst}.res", st["c_in"], st["c_out"])
            if st["attn"]:
                attn_block_rules(rules, f"{blk}.1", f"{dst}.attn", st["depth"], proj)
    mid_c = u.level_channels[-1]
    _unet_res_rules(rules, f"{src}.middle_block.0", "bottleneck.res1", mid_c, mid_c)
    attn_block_rules(rules, f"{src}.middle_block.1", "bottleneck.attn",
                     u.depth_for(len(u.ch_mults) - 1), proj)
    _unet_res_rules(rules, f"{src}.middle_block.2", "bottleneck.res2", mid_c, mid_c)
    for j, st in enumerate(unet_mod.decoder_plan(u)):
        blk = f"{src}.output_blocks.{j}"
        dst = f"decoder.{j}"
        _unet_res_rules(rules, f"{blk}.0", f"{dst}.res", st["c_in"], st["c_out"])
        nxt = 1
        if st["attn"]:
            attn_block_rules(rules, f"{blk}.1", f"{dst}.attn", st["depth"], proj)
            nxt = 2
        if st["upsample"]:
            _conv(rules, f"{blk}.{nxt}.conv", f"{dst}.upsample")
    if u.add_embed_dim:
        # SDXL's added-conditioning MLP (sgm: label_emb.0.{0,2})
        _linear(rules, f"{src}.label_emb.0.0", "add_embed.fc1")
        _linear(rules, f"{src}.label_emb.0.2", "add_embed.fc2")
    _norm(rules, f"{src}.out.0", "norm_out")
    _conv(rules, f"{src}.out.2", "conv_out")
    return rules


# -------------------------------------------------------------- ControlNet
def controlnet_rules(cfg: SDConfig) -> List[Rule]:
    """The CompVis ControlNet layout (``control_model.*``: standalone
    control_v11*/control_sd15* files and the control_model half of merged
    ones) -> ``models/controlnet.py``'s names: the copied encoder and
    bottleneck under the UNet's key names, ``input_hint_block`` (Sequential
    indices 0, 2, ..), ``zero_convs.{i}.0`` and ``middle_block_out.0``;
    generated from the same plans as :func:`unet_rules`."""
    from ..models import controlnet as controlnet_mod

    u = cfg.unet
    src = "control_model"
    proj = proj_kind(cfg)
    rules: List[Rule] = []
    _linear(rules, f"{src}.time_embed.0", "time_embed.fc1")
    _linear(rules, f"{src}.time_embed.2", "time_embed.fc2")
    _conv(rules, f"{src}.input_blocks.0.0", "conv_in")
    for i, st in enumerate(unet_mod.encoder_plan(u)[1:]):
        blk = f"{src}.input_blocks.{i + 1}"
        dst = f"encoder.{i}"
        if st["kind"] == "down":
            _conv(rules, f"{blk}.0.op", f"{dst}.down")
        else:
            _unet_res_rules(rules, f"{blk}.0", f"{dst}.res", st["c_in"], st["c_out"])
            if st["attn"]:
                attn_block_rules(rules, f"{blk}.1", f"{dst}.attn", st["depth"], proj)
    mid_c = u.level_channels[-1]
    _unet_res_rules(rules, f"{src}.middle_block.0", "bottleneck.res1", mid_c, mid_c)
    attn_block_rules(rules, f"{src}.middle_block.1", "bottleneck.attn",
                     u.depth_for(len(u.ch_mults) - 1), proj)
    _unet_res_rules(rules, f"{src}.middle_block.2", "bottleneck.res2", mid_c, mid_c)
    for i in range(len(unet_mod.encoder_plan(u))):
        _conv(rules, f"{src}.zero_convs.{i}.0", f"zero_convs.{i}")
    _conv(rules, f"{src}.middle_block_out.0", "mid_out")
    for j in range(len(controlnet_mod.hint_plan(u, cfg.vae.downsample_factor))):
        _conv(rules, f"{src}.input_hint_block.{2 * j}", f"hint_block.{j}")
    if u.add_embed_dim:
        _linear(rules, f"{src}.label_emb.0.0", "add_embed.fc1")
        _linear(rules, f"{src}.label_emb.0.2", "add_embed.fc2")
    return rules


def convert_controlnet(state_dict: Mapping, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    """``control_model.*`` keys -> a ControlNet state dict.  Every rule's
    source must exist and every ``control_model.*`` key be consumed (other
    keys may be a merged base model's, left for :func:`convert`)."""
    consumed: set = set()
    sd = _convert_rules(state_dict, controlnet_rules(cfg), "controlnet", _keep, consumed)
    leftover = [k for k in state_dict if k.startswith("control_model.") and k not in consumed]
    if leftover:
        raise KeyError(f"{len(leftover)} unconsumed control_model keys "
                       f"(first 10): {sorted(leftover)[:10]}")
    return sd


def deconvert_controlnet(net, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_controlnet` (a ControlNet or its state
    dict -> ``control_model.*``), in the layout of the family's files."""
    flat = net.state_dict() if isinstance(net, torch.nn.Module) else net
    try:
        return invert_rules(controlnet_rules(cfg), flat, {})
    except KeyError as e:
        raise KeyError(f"[controlnet] {e.args[0]}") from None


def load_controlnet(path: str, cfg: SDConfig, *,
                    allow_unsafe_fallback: bool = False) -> Dict[str, torch.Tensor]:
    """A ControlNet checkpoint file (.pth/.ckpt/.safetensors, standalone or
    merged) -> a ControlNet state dict (``models/controlnet.build``)."""
    sd = load_state_dict(path, allow_unsafe_fallback=allow_unsafe_fallback)
    return convert_controlnet(sd, cfg)


# -------------------------------------------------------------------- VAE
def _vae_res_rules(rules, src, dst, c_in, c_out):
    _norm(rules, f"{src}.norm1", f"{dst}.norm1")
    _conv(rules, f"{src}.conv1", f"{dst}.conv1")
    _norm(rules, f"{src}.norm2", f"{dst}.norm2")
    _conv(rules, f"{src}.conv2", f"{dst}.conv2")
    if c_in != c_out:
        _conv(rules, f"{src}.nin_shortcut", f"{dst}.shortcut")


def _vae_mid_rules(rules, src, dst, ch):
    _vae_res_rules(rules, f"{src}.block_1", f"{dst}.res1", ch, ch)
    _norm(rules, f"{src}.attn_1.norm", f"{dst}.attn.norm")
    for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"), ("out", "proj_out")):
        rules.append((f"{src}.attn_1.{theirs}.weight",
                      f"{dst}.attn.attn.{ours}.weight", "conv1x1_linear"))
        rules.append((f"{src}.attn_1.{theirs}.bias",
                      f"{dst}.attn.attn.{ours}.bias", "direct"))
    _vae_res_rules(rules, f"{src}.block_2", f"{dst}.res2", ch, ch)


def vae_encoder_rules(cfg: SDConfig) -> List[Rule]:
    chs = cfg.vae.level_channels
    src = "first_stage_model"
    rules: List[Rule] = []
    _conv(rules, f"{src}.encoder.conv_in", "conv_in")
    c_prev = chs[0]
    for lv, c in enumerate(chs):
        _vae_res_rules(rules, f"{src}.encoder.down.{lv}.block.0",
                       f"down.{lv}.res.0", c_prev, c)
        _vae_res_rules(rules, f"{src}.encoder.down.{lv}.block.1",
                       f"down.{lv}.res.1", c, c)
        c_prev = c
        if lv < len(chs) - 1:
            _conv(rules, f"{src}.encoder.down.{lv}.downsample.conv",
                  f"down.{lv}.downsample")
    _vae_mid_rules(rules, f"{src}.encoder.mid", "mid", chs[-1])
    _norm(rules, f"{src}.encoder.norm_out", "norm_out")
    _conv(rules, f"{src}.encoder.conv_out", "conv_out")
    _conv(rules, f"{src}.quant_conv", "quant_conv")
    return rules


def vae_decoder_rules(cfg: SDConfig) -> List[Rule]:
    chs = cfg.vae.level_channels
    src = "first_stage_model"
    rules: List[Rule] = []
    _conv(rules, f"{src}.post_quant_conv", "post_quant_conv")
    _conv(rules, f"{src}.decoder.conv_in", "conv_in")
    _vae_mid_rules(rules, f"{src}.decoder.mid", "mid", chs[-1])
    c_prev = chs[-1]
    # ours: processing order (top level first) = CompVis up.{L-1} .. up.0
    for k, lv in enumerate(reversed(range(len(chs)))):
        c = chs[lv]
        for b in range(3):
            _vae_res_rules(rules, f"{src}.decoder.up.{lv}.block.{b}",
                           f"up.{k}.res.{b}", c_prev if b == 0 else c, c)
        c_prev = c
        if lv > 0:
            _conv(rules, f"{src}.decoder.up.{lv}.upsample.conv", f"up.{k}.upsample")
    _norm(rules, f"{src}.decoder.norm_out", "norm_out")
    _conv(rules, f"{src}.decoder.conv_out", "conv_out")
    return rules


# ------------------------------------------------------------------- CLIP
def _hf_clip_rules(ccfg, src: str) -> List[Rule]:
    """A transformers-layout tower (SD-1.x, SDXL's CLIP-L)."""
    rules: List[Rule] = [
        (f"{src}.embeddings.token_embedding.weight", "token_embedding", "direct"),
        (f"{src}.embeddings.position_embedding.weight", "position_embedding",
         "direct"),
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
    return rules


def _open_clip_rules(ccfg, src: str) -> List[Rule]:
    """An OpenCLIP tower (SD-2.x ViT-H, SDXL bigG): a bare
    ``positional_embedding``, ``transformer.resblocks.{i}`` with
    ``ln_1``/``ln_2``, ``mlp.c_fc``/``c_proj`` and the fused
    ``attn.in_proj_weight``/``in_proj_bias`` (3d, d)/(3d,) split into q, k
    and v; bigG's ``text_projection`` (d, d) applied as ``x @ W``, kept so."""
    rules: List[Rule] = [
        (f"{src}.token_embedding.weight", "token_embedding", "direct"),
        (f"{src}.positional_embedding", "position_embedding", "direct"),
    ]
    if ccfg.text_projection:
        rules.append((f"{src}.text_projection", "text_projection", "direct"))
    for i in range(ccfg.n_layers):
        lyr = f"{src}.transformer.resblocks.{i}"
        dst = f"layers.{i}"
        _norm(rules, f"{lyr}.ln_1", f"{dst}.ln1")
        for j, ours in enumerate(("q", "k", "v")):
            rules.append((f"{lyr}.attn.in_proj_weight", f"{dst}.attn.{ours}.weight",
                          ("split3", j)))
            rules.append((f"{lyr}.attn.in_proj_bias", f"{dst}.attn.{ours}.bias",
                          ("split3", j)))
        _linear(rules, f"{lyr}.attn.out_proj", f"{dst}.attn.out")
        _norm(rules, f"{lyr}.ln_2", f"{dst}.ln2")
        _linear(rules, f"{lyr}.mlp.c_fc", f"{dst}.fc1")
        _linear(rules, f"{lyr}.mlp.c_proj", f"{dst}.fc2")
    _norm(rules, f"{src}.ln_final", "final_norm")
    return rules


def _tower_prefix(ccfg) -> str:
    if ccfg.key_prefix:
        return ccfg.key_prefix
    return "cond_stage_model.model" if ccfg.layout == "open_clip" \
        else "cond_stage_model.transformer.text_model"


def tower_rules(ccfg) -> List[Rule]:
    """The CompVis/sgm rules of one text tower, by its layout and prefix."""
    rules = _open_clip_rules if ccfg.layout == "open_clip" else _hf_clip_rules
    return rules(ccfg, _tower_prefix(ccfg))


def clip_rules(cfg: SDConfig) -> List[Rule]:
    return tower_rules(cfg.clip)


def clip2_rules(cfg: SDConfig) -> List[Rule]:
    """SDXL's second text tower."""
    return tower_rules(cfg.clip2)


# --------------------------------------------------------------- execution
RULES = {
    "clip": clip_rules,
    "clip2": clip2_rules,
    "encoder": vae_encoder_rules,
    "decoder": vae_decoder_rules,
    "diffusion": unet_rules,
}

#: source keys that exist in CompVis ckpts but carry no model weight we need
_IGNORE_PREFIXES = ("model_ema.",)
_IGNORE_EXACT = {
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "logvar",
}


def _ignored(cfg: SDConfig) -> Tuple[set, tuple]:
    """(exact keys, prefixes) a checkpoint of ``cfg``'s family may hold and
    no model consumes: the static lists, and for each text tower its
    ``position_ids`` (transformers layout), or its ``logit_scale`` and an
    unconsumed ``text_projection`` (OpenCLIP: the image-text heads)."""
    exact, prefixes = set(_IGNORE_EXACT), list(_IGNORE_PREFIXES)
    for tower in (cfg.clip, cfg.clip2):
        if tower is None:
            continue
        src = _tower_prefix(tower)
        if tower.layout == "open_clip":
            exact.add(f"{src}.logit_scale")
            if not tower.text_projection:
                exact.add(f"{src}.text_projection")
        else:
            prefixes.append(f"{src}.embeddings.position_ids")
    return exact, tuple(prefixes)


StateDicts = Dict[str, Dict[str, torch.Tensor]]


def as_tensor(x) -> torch.Tensor:
    """A torch tensor of ``x`` (a tensor as it is; an array without a copy
    where numpy allows one).  A ``uint16`` array is raw bf16 bits: the
    restricted unpickler reads BF16 storages so, and no checkpoint tensor
    type is unsigned 16-bit."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.view(torch.bfloat16) if a.dtype == np.uint16 else t


def _convert_rules(state_dict, rules, name: str, place, consumed: set,
                   what: str = "source key") -> Dict[str, torch.Tensor]:
    sd = {}
    for src_key, dst_key, kind in rules:
        if src_key not in state_dict:
            raise KeyError(f"[{name}] missing {what}: {src_key}")
        sd[dst_key] = place(name, dst_key,
                            fwd(kind, as_tensor(state_dict[src_key])).contiguous())
        consumed.add(src_key)
    return sd


def invert_rules(rules, flat, sink: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Port parameters ``flat`` -> the source tensors of ``rules``, into
    ``sink`` (the three parts of a fused in_proj concatenated back)."""
    fused: Dict[str, list] = {}
    for src_key, dst_key, kind in rules:
        if dst_key not in flat:
            raise KeyError(f"missing target parameter: {dst_key}")
        t = flat[dst_key].detach()
        if isinstance(kind, tuple):
            fused.setdefault(src_key, [None] * 3)[kind[1]] = t
        else:
            sink[src_key] = _INV[kind](t).contiguous()
    for src_key, parts in fused.items():
        sink[src_key] = torch.cat(parts, dim=0)
    return sink


def _keep(name, key, x):
    return x


def convert(state_dict: Mapping, cfg: SDConfig, *,
            place: Optional[Callable] = None) -> StateDicts:
    """CompVis flat state dict -> port state dicts (exact coverage).

    ``state_dict`` may be any Mapping, a lazy one included (the streamed
    loader's), in which case tensors are read one at a time in rule order;
    ``place(model_name, port_key, tensor) -> tensor`` then moves each one
    where it goes as it is read (by default it is kept as read)."""
    check_ported(cfg)
    place = place or _keep
    consumed = set()
    out = {name: _convert_rules(state_dict, RULES[name](cfg), name, place, consumed)
           for name in model_names(cfg)}
    exact, prefixes = _ignored(cfg)
    leftover = [k for k in state_dict
                if k not in consumed and k not in exact
                and not any(k.startswith(p) for p in prefixes)]
    if leftover:
        raise KeyError(f"{len(leftover)} unconsumed source keys (first 10): "
                       f"{sorted(leftover)[:10]}")
    return out


def deconvert(state_dicts: StateDicts, cfg: SDConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert`: port state dicts (or models) -> a CompVis
    flat state dict, on the tensors' device and in their dtype, in the
    layout of the family's published files (SD-2.x/SDXL proj_in/proj_out
    as (C, C) linears, the OpenCLIP q/k/v fused into in_proj)."""
    check_ported(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for name in model_names(cfg):
        flat = state_dicts[name]
        flat = flat.state_dict() if isinstance(flat, torch.nn.Module) else flat
        try:
            invert_rules(RULES[name](cfg), flat, sd)
        except KeyError as e:
            raise KeyError(f"[{name}] {e.args[0]}") from None
    return sd


def synthetic_state_dict(cfg: SDConfig, seed: int = 0, *,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """A CompVis-layout state dict of random weights (in
    ``cfg.policy.param_dtype``, on ``device``), for loader tests: the
    :func:`deconvert` of models built from a generator seeded with ``seed``."""
    from ..models import build_models

    g = torch.Generator(device=device).manual_seed(int(seed))
    return deconvert(build_models(cfg, device=device, generator=g), cfg)


def load_state_dict(path: str, *,
                    allow_unsafe_fallback: bool = False) -> Dict[str, torch.Tensor]:
    """Read a checkpoint file into CPU tensors, in the file's dtypes:
    ``.safetensors`` through the native reader (built with g++ at first use;
    where that build fails this raises with the compiler's message), any
    other file as a torch zip pickle (``.ckpt``, ``.pt``, ``.bin``) through
    the torch-free *restricted* unpickler (``ckpt_reader.py``), which runs no
    pickle code.

    A file the restricted reader refuses for safety reasons
    (``pickle.UnpicklingError``) is never retried through ``torch.load``:
    that would hand the exact payload the restricted reader just blocked to
    a full pickle VM.  Only genuinely pre-zip legacy containers
    (``LegacyCkptError`` / ``zipfile.BadZipFile``) may fall back, and only
    when the caller opts in with ``allow_unsafe_fallback=True`` — torch.load
    on such files executes arbitrary code from the file."""
    import zipfile

    p = str(path)
    if p.endswith(".safetensors"):
        from . import native_io

        return native_io.load_safetensors(p)
    from .ckpt_reader import LegacyCkptError, load_torch_ckpt

    try:
        return {k: as_tensor(v) for k, v in load_torch_ckpt(p).items()}
    except (LegacyCkptError, zipfile.BadZipFile) as e:
        if not allow_unsafe_fallback:
            raise ValueError(
                f"{p} is not a torch zip-format checkpoint ({e}). Loading it "
                "requires torch.load's full pickle execution, which runs "
                "arbitrary code embedded in the file; pass "
                "allow_unsafe_fallback=True only if you trust this file."
            ) from e
        ckpt = torch.load(p, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        return {k: as_tensor(v) for k, v in sd.items()
                if isinstance(v, (torch.Tensor, np.ndarray))}


def convert_vae(state_dict: Mapping, cfg: SDConfig
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Standalone VAE checkpoint -> (encoder, decoder) state dicts.

    The A1111 ``.vae.pt`` / ``.vae.safetensors`` convention (e.g.
    ``vae-ft-mse-840000``): first-stage keys WITHOUT the full checkpoint's
    ``first_stage_model.`` prefix; a prefixed (full-checkpoint) dict is
    accepted too.  Training-only ``loss.*`` / ``model_ema.*`` keys are
    ignored; every other VAE key must be consumed (exact coverage)."""
    check_ported(cfg)
    if not any(k.startswith("first_stage_model.") for k in state_dict):
        state_dict = {"first_stage_model." + k: v for k, v in state_dict.items()}
    consumed = set()
    enc = _convert_rules(state_dict, vae_encoder_rules(cfg), "vae encoder", _keep,
                         consumed)
    dec = _convert_rules(state_dict, vae_decoder_rules(cfg), "vae decoder", _keep,
                         consumed)
    skip = ("first_stage_model.loss.", "first_stage_model.model_ema.")
    leftover = [k for k in state_dict
                if k.startswith("first_stage_model.") and k not in consumed
                and not any(k.startswith(p) for p in skip)]
    if leftover:
        raise KeyError(f"{len(leftover)} unconsumed VAE keys (first 10): "
                       f"{sorted(leftover)[:10]}")
    return enc, dec


def load_vae(path: str, cfg: SDConfig, *, allow_unsafe_fallback: bool = False
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Standalone VAE file (CompVis layout ``.pt``/``.ckpt``/
    ``.safetensors``) or diffusers ``vae/`` directory -> (encoder, decoder)
    state dicts — the A1111 "SD VAE" override."""
    if os.path.isdir(path):
        from . import diffusers as dif

        for n in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
            p = os.path.join(path, n)
            if os.path.exists(p):
                return dif.convert_diffusers_vae(load_state_dict(p), cfg)
        raise FileNotFoundError(f"no VAE weight file under {path}")
    sd = load_state_dict(path, allow_unsafe_fallback=allow_unsafe_fallback)
    return convert_vae(sd, cfg)


def load_sd_checkpoint(path: str, cfg: SDConfig, *,
                       allow_unsafe_fallback: bool = False) -> StateDicts:
    """File path -> port state dicts (the ``preload_models_from_standard_
    weights`` analog, ``model_loader.py:9``)."""
    sd = load_state_dict(path, allow_unsafe_fallback=allow_unsafe_fallback)
    return convert(sd, cfg)


# ------------------------------------------------------- the JAX pytrees
def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _from_jax_leaf(path: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    head, dot, leaf = path.rpartition(".")
    if leaf == "kernel":
        x = x.T if x.ndim == 2 else np.transpose(x, (3, 2, 0, 1))  # HWIO -> OIHW
        return f"{head}{dot}weight", x
    if leaf == "scale":
        return f"{head}{dot}weight", x
    return path, x


def state_dict_from_jax_tree(tree) -> Dict[str, torch.Tensor]:
    """One JAX parameter pytree (nested dicts/lists of arrays) -> the state
    dict of the port module with the same structure."""
    return dict((k, as_tensor(v)) for k, v in
                (_from_jax_leaf(p, np.asarray(x)) for p, x in _flatten(tree)))


#: the side nets' entries of a JAX models dict (slice E)
SIDE_NETS = ("controlnet", "t2i_adapter", "ip_adapter", "clip_vision")


def _side_net_from_jax(name: str, tree) -> Dict[str, torch.Tensor]:
    sd = state_dict_from_jax_tree(tree)
    if name == "controlnet":
        # an LCM config's time MLP carries cond_proj, which no ControlNet reads
        sd = {k: v for k, v in sd.items() if not k.startswith("time_embed.cond_proj")}
    return sd


def from_jax_params(params, cfg: SDConfig) -> StateDicts:
    """JAX parameter pytrees {"clip", ["clip2",] "encoder", "decoder",
    "diffusion"} -> port state dicts.  A CLIP whose token table textual
    inversion grew converts as any other: build it with the grown
    ``cfg.clip.vocab_size``.  The side nets of a JAX models dict
    (:data:`SIDE_NETS`: ``controlnet``, one tree or a list, ``t2i_adapter``,
    one or a list, ``ip_adapter`` and ``clip_vision``) come across too,
    each a state dict (a list of them for a list), for
    ``models.build_models``."""
    check_ported(cfg)
    out = {name: state_dict_from_jax_tree(params[name]) for name in model_names(cfg)}
    for name in SIDE_NETS:
        if name in params:
            tree = params[name]
            out[name] = [_side_net_from_jax(name, t) for t in tree] \
                if isinstance(tree, (list, tuple)) else _side_net_from_jax(name, tree)
    return out


def hypernetwork_from_jax(tree):
    """The JAX package's hypernetwork tree (``{str(width): {"k"|"v": [{"kernel",
    "bias"} | {"ln_scale", "ln_bias"}, ...]}}``, (in, out) kernels) -> the
    port's :class:`~.hypernetwork.Hypernetwork` (fp32, on the CPU)."""
    from .hypernetwork import Hypernetwork

    def layers(mods):
        out = []
        for m in mods:
            if "kernel" in m:
                b = m.get("bias")
                out.append((as_tensor(np.asarray(m["kernel"], np.float32).T),
                            None if b is None else as_tensor(np.asarray(b, np.float32))))
            else:
                out.append((as_tensor(np.asarray(m["ln_scale"], np.float32)),
                            as_tensor(np.asarray(m["ln_bias"], np.float32))))
        return out

    return Hypernetwork({width: (layers(kv["k"]), layers(kv["v"]))
                         for width, kv in tree.items()})
