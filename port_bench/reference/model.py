"""The plain reference of the Stable Diffusion models: CLIP text towers
(the transformers layout of CLIP ViT-L/14, the OpenCLIP layout of ViT-bigG),
the UNet and the VAE decoder, as plain float32 PyTorch over a checkpoint
held by its published (CompVis / sgm) key names.

It imports nothing of the program under test.  Everything the program
derives from the checkpoint (fused q/k/v, folded GroupNorm affines,
channels-last copies, split OpenCLIP in_proj tensors) is worked out here
again from the raw tensors.  Attention over many tokens is computed in
blocks of query rows with an exact softmax over the whole key axis.

Departures from the published CompVis code, each kept because the program
under test defines its semantics so: every GroupNorm uses eps 1e-5 (CompVis
uses 1e-6 in the spatial transformer and in the VAE); the SDXL pooled
vector is taken at the first end-of-text token (the argmax of the ids, as
OpenCLIP does).

:func:`checkpoint_keys` lists every key of a family's checkpoint with its
shape and how the benchmark draws it; ``port_bench/weights.py`` makes the
tensors from it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

#: query rows per block of the blockwise attention: the fp32 scores of one
#: block over 65,536 keys and 8 heads of a batch of 2 are 1 GiB
SCORE_BYTES = 1 << 30
GN_EPS = 1e-5
LN_EPS = 1e-5

Key = Tuple[str, Tuple[int, ...], tuple]


# ------------------------------------------------------------ architecture
def unet_levels(u: dict):
    """(channels, has attention, transformer depth) of each UNet level."""
    mults = u["channel_mult"]
    depth = u["transformer_depth"]
    depth = list(depth) if isinstance(depth, (list, tuple)) else [depth] * len(mults)
    out = []
    for i, m in enumerate(mults):
        out.append((u["model_channels"] * m, (2 ** i) in u["attention_resolutions"], depth[i]))
    return out


def unet_heads(u: dict, channels: int) -> int:
    if u.get("num_head_channels", -1) not in (None, -1):
        return channels // u["num_head_channels"]
    return u["num_heads"]


def _encoder_plan(u: dict):
    """CompVis input_blocks after block 0: ('res', c_in, c_out, attn, depth)
    or ('down', c)."""
    levels = unet_levels(u)
    plan, c_prev = [], u["model_channels"]
    for i, (c, attn, depth) in enumerate(levels):
        for _ in range(u["num_res_blocks"]):
            plan.append(("res", c_prev, c, attn, depth))
            c_prev = c
        if i < len(levels) - 1:
            plan.append(("down", c))
    return plan


def _decoder_plan(u: dict):
    """CompVis output_blocks: (c_in, c_out, attn, depth, upsample)."""
    levels = unet_levels(u)
    skips = [u["model_channels"]]
    for st in _encoder_plan(u):
        skips.append(st[2] if st[0] == "res" else st[1])
    plan, c_prev = [], levels[-1][0]
    for i in reversed(range(len(levels))):
        c, attn, depth = levels[i]
        for j in range(u["num_res_blocks"] + 1):
            plan.append((c_prev + skips.pop(), c, attn, depth,
                         j == u["num_res_blocks"] and i > 0))
            c_prev = c
    return plan


# --------------------------------------------------------- checkpoint keys
def _lin(keys: List[Key], name: str, d_in: int, d_out: int, bias: bool = True):
    keys.append((f"{name}.weight", (d_out, d_in), ("fan", d_in)))
    if bias:
        keys.append((f"{name}.bias", (d_out,), ("fan", d_in)))


def _conv(keys: List[Key], name: str, c_in: int, c_out: int, k: int):
    keys.append((f"{name}.weight", (c_out, c_in, k, k), ("fan", c_in * k * k)))
    keys.append((f"{name}.bias", (c_out,), ("fan", c_in * k * k)))


def _norm(keys: List[Key], name: str, c: int):
    keys.append((f"{name}.weight", (c,), ("ones",)))
    keys.append((f"{name}.bias", (c,), ("zeros",)))


def _unet_res_keys(keys, p, c_in, c_out, t_dim):
    _norm(keys, f"{p}.in_layers.0", c_in)
    _conv(keys, f"{p}.in_layers.2", c_in, c_out, 3)
    _lin(keys, f"{p}.emb_layers.1", t_dim, c_out)
    _norm(keys, f"{p}.out_layers.0", c_out)
    _conv(keys, f"{p}.out_layers.3", c_out, c_out, 3)
    if c_in != c_out:
        _conv(keys, f"{p}.skip_connection", c_in, c_out, 1)


def _unet_attn_keys(keys, p, c, depth, d_ctx, linear_proj):
    _norm(keys, f"{p}.norm", c)
    for name in ("proj_in", "proj_out"):
        if linear_proj:
            _lin(keys, f"{p}.{name}", c, c)
        else:
            _conv(keys, f"{p}.{name}", c, c, 1)
    for j in range(depth):
        tb = f"{p}.transformer_blocks.{j}"
        _norm(keys, f"{tb}.norm1", c)
        _norm(keys, f"{tb}.norm2", c)
        _norm(keys, f"{tb}.norm3", c)
        for a, d_kv in (("attn1", c), ("attn2", d_ctx)):
            _lin(keys, f"{tb}.{a}.to_q", c, c, bias=False)
            _lin(keys, f"{tb}.{a}.to_k", d_kv, c, bias=False)
            _lin(keys, f"{tb}.{a}.to_v", d_kv, c, bias=False)
            _lin(keys, f"{tb}.{a}.to_out.0", c, c)
        _lin(keys, f"{tb}.ff.net.0.proj", c, 8 * c)
        _lin(keys, f"{tb}.ff.net.2", 4 * c, c)


def unet_keys(u: dict) -> List[Key]:
    p = "model.diffusion_model"
    keys: List[Key] = []
    c0 = u["model_channels"]
    t_dim = 4 * c0
    linear_proj = bool(u.get("use_linear_in_transformer"))
    _lin(keys, f"{p}.time_embed.0", c0, t_dim)
    _lin(keys, f"{p}.time_embed.2", t_dim, t_dim)
    if u.get("adm_in_channels"):
        _lin(keys, f"{p}.label_emb.0.0", u["adm_in_channels"], t_dim)
        _lin(keys, f"{p}.label_emb.0.2", t_dim, t_dim)
    _conv(keys, f"{p}.input_blocks.0.0", u["in_channels"], c0, 3)
    for i, st in enumerate(_encoder_plan(u)):
        blk = f"{p}.input_blocks.{i + 1}"
        if st[0] == "down":
            _conv(keys, f"{blk}.0.op", st[1], st[1], 3)
            continue
        _, c_in, c_out, attn, depth = st
        _unet_res_keys(keys, f"{blk}.0", c_in, c_out, t_dim)
        if attn:
            _unet_attn_keys(keys, f"{blk}.1", c_out, depth, u["context_dim"], linear_proj)
    c_mid, _, d_mid = unet_levels(u)[-1]
    _unet_res_keys(keys, f"{p}.middle_block.0", c_mid, c_mid, t_dim)
    _unet_attn_keys(keys, f"{p}.middle_block.1", c_mid, d_mid, u["context_dim"], linear_proj)
    _unet_res_keys(keys, f"{p}.middle_block.2", c_mid, c_mid, t_dim)
    for j, (c_in, c_out, attn, depth, up) in enumerate(_decoder_plan(u)):
        blk = f"{p}.output_blocks.{j}"
        _unet_res_keys(keys, f"{blk}.0", c_in, c_out, t_dim)
        if attn:
            _unet_attn_keys(keys, f"{blk}.1", c_out, depth, u["context_dim"], linear_proj)
        if up:
            _conv(keys, f"{blk}.{2 if attn else 1}.conv", c_out, c_out, 3)
    _norm(keys, f"{p}.out.0", c0)
    _conv(keys, f"{p}.out.2", c0, u["out_channels"], 3)
    return keys


def _vae_res_keys(keys, p, c_in, c_out):
    _norm(keys, f"{p}.norm1", c_in)
    _conv(keys, f"{p}.conv1", c_in, c_out, 3)
    _norm(keys, f"{p}.norm2", c_out)
    _conv(keys, f"{p}.conv2", c_out, c_out, 3)
    if c_in != c_out:
        _conv(keys, f"{p}.nin_shortcut", c_in, c_out, 1)


def _vae_mid_keys(keys, p, c):
    _vae_res_keys(keys, f"{p}.block_1", c, c)
    _norm(keys, f"{p}.attn_1.norm", c)
    for name in ("q", "k", "v", "proj_out"):
        _conv(keys, f"{p}.attn_1.{name}", c, c, 1)
    _vae_res_keys(keys, f"{p}.block_2", c, c)


def vae_keys(v: dict) -> List[Key]:
    """Encoder and decoder: a checkpoint holds both, though txt2img decodes
    only."""
    p = "first_stage_model"
    chs = [v["ch"] * m for m in v["ch_mult"]]
    z = v["z_channels"]
    keys: List[Key] = []
    _conv(keys, f"{p}.encoder.conv_in", v["in_channels"], chs[0], 3)
    c_prev = chs[0]
    for lv, c in enumerate(chs):
        for b in range(v["num_res_blocks"]):
            _vae_res_keys(keys, f"{p}.encoder.down.{lv}.block.{b}", c_prev if b == 0 else c, c)
        c_prev = c
        if lv < len(chs) - 1:
            _conv(keys, f"{p}.encoder.down.{lv}.downsample.conv", c, c, 3)
    _vae_mid_keys(keys, f"{p}.encoder.mid", chs[-1])
    _norm(keys, f"{p}.encoder.norm_out", chs[-1])
    _conv(keys, f"{p}.encoder.conv_out", chs[-1], 2 * z, 3)
    _conv(keys, f"{p}.quant_conv", 2 * v["embed_dim"], 2 * v["embed_dim"], 1)
    _conv(keys, f"{p}.post_quant_conv", v["embed_dim"], z, 1)
    _conv(keys, f"{p}.decoder.conv_in", z, chs[-1], 3)
    _vae_mid_keys(keys, f"{p}.decoder.mid", chs[-1])
    c_prev = chs[-1]
    for lv in reversed(range(len(chs))):
        c = chs[lv]
        for b in range(v["num_res_blocks"] + 1):
            _vae_res_keys(keys, f"{p}.decoder.up.{lv}.block.{b}", c_prev if b == 0 else c, c)
        c_prev = c
        if lv > 0:
            _conv(keys, f"{p}.decoder.up.{lv}.upsample.conv", c, c, 3)
    _norm(keys, f"{p}.decoder.norm_out", chs[0])
    _conv(keys, f"{p}.decoder.conv_out", chs[0], v["out_ch"], 3)
    return keys


def text_encoder_keys(te: dict) -> List[Key]:
    p, d, ff = te["key_prefix"], te["width"], te["mlp_width"]
    keys: List[Key] = []
    if te["layout"] == "open_clip":
        keys.append((f"{p}.token_embedding.weight", (te["vocab_size"], d), ("normal", 0.02)))
        keys.append((f"{p}.positional_embedding", (te["context_length"], d), ("normal", 0.01)))
        if te.get("always_return_pooled"):
            keys.append((f"{p}.text_projection", (d, d), ("normal", d ** -0.5)))
        for i in range(te["layers"]):
            r = f"{p}.transformer.resblocks.{i}"
            _norm(keys, f"{r}.ln_1", d)
            keys.append((f"{r}.attn.in_proj_weight", (3 * d, d), ("fan", d)))
            keys.append((f"{r}.attn.in_proj_bias", (3 * d,), ("fan", d)))
            _lin(keys, f"{r}.attn.out_proj", d, d)
            _norm(keys, f"{r}.ln_2", d)
            _lin(keys, f"{r}.mlp.c_fc", d, ff)
            _lin(keys, f"{r}.mlp.c_proj", ff, d)
        _norm(keys, f"{p}.ln_final", d)
        return keys
    keys.append((f"{p}.embeddings.token_embedding.weight", (te["vocab_size"], d),
                 ("normal", 0.02)))
    keys.append((f"{p}.embeddings.position_embedding.weight", (te["context_length"], d),
                 ("normal", 0.01)))
    for i in range(te["layers"]):
        r = f"{p}.encoder.layers.{i}"
        _norm(keys, f"{r}.layer_norm1", d)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(keys, f"{r}.self_attn.{name}", d, d)
        _norm(keys, f"{r}.layer_norm2", d)
        _lin(keys, f"{r}.mlp.fc1", d, ff)
        _lin(keys, f"{r}.mlp.fc2", ff, d)
    _norm(keys, f"{p}.final_layer_norm", d)
    return keys


def checkpoint_keys(model: dict) -> List[Key]:
    """Every key of the family's checkpoint: (name, shape, how it is drawn),
    in a fixed order: ("fan", n) uniform in ±1/sqrt(n), ("normal", std),
    ("ones",), ("zeros",)."""
    keys: List[Key] = []
    for te in model["text_encoders"]:
        keys += text_encoder_keys(te)
    keys += vae_keys(model["first_stage_config"])
    keys += unet_keys(model["unet_config"])
    return keys


# ------------------------------------------------------------------- layers
class Weights:
    """Checkpoint tensors by key, read as float32 on first use."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device):
        self.tensors, self.device, self._cache = tensors, device, {}

    def __call__(self, key: str) -> torch.Tensor:
        w = self._cache.get(key)
        if w is None:
            w = self._cache[key] = self.tensors[key].to(self.device, torch.float32)
        return w


def attention(q, k, v, heads: int, causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(Dh)) v over (B, S, H·Dh) tensors, exact softmax,
    computed in blocks of query rows."""
    b, sq, c = q.shape
    sk, dh = k.shape[1], c // heads
    q = q.reshape(b, sq, heads, dh).transpose(1, 2)
    k = k.reshape(b, sk, heads, dh).transpose(1, 2)
    v = v.reshape(b, sk, heads, dh).transpose(1, 2)
    rows = max(1, SCORE_BYTES // (4 * b * heads * sk))
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    for r0 in range(0, sq, rows):
        s = torch.matmul(q[:, :, r0:r0 + rows], k.transpose(-1, -2)) * scale
        if causal:
            i = torch.arange(r0, min(r0 + rows, sq), device=q.device)[:, None]
            s = s.masked_fill(torch.arange(sk, device=q.device)[None, :] > i, float("-inf"))
        out[:, :, r0:r0 + rows] = torch.matmul(torch.softmax(s, dim=-1), v)
    return out.transpose(1, 2).reshape(b, sq, c)


def group_norm(w: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, 32, w(f"{p}.weight"), w(f"{p}.bias"), GN_EPS)


def layer_norm(w: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w(f"{p}.weight"), w(f"{p}.bias"), LN_EPS)


def linear(w: Weights, p: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    return F.linear(x, w(f"{p}.weight"), w(f"{p}.bias") if bias else None)


def conv(w: Weights, p: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    weight = w(f"{p}.weight")
    return F.conv2d(x, weight, w(f"{p}.bias"), stride=stride, padding=weight.shape[-1] // 2)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) -> (N, dim): [cos, sin] of t times 10000^(-i / (dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64) / half)
    args = t.double()[:, None].cpu() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float().to(t.device)


# ----------------------------------------------------------------- text towers
def tower_stop(te: dict) -> int:
    """How many layers make the tower's hidden state: all of them
    (``layer`` "last"), all but one ("penultimate"), or ``layer_idx``
    ("hidden": the transformers ``hidden_states[layer_idx]``)."""
    layer = te["layer"]
    if layer == "last":
        return te["layers"]
    if layer == "penultimate":
        return te["layers"] - 1
    if layer == "hidden":
        return te["layer_idx"]
    raise ValueError(f"unknown text encoder layer {layer!r}")


def text_encoder(w: Weights, te: dict, tokens: torch.Tensor):
    """tokens (N, 77) -> (hidden at the configured layer, pooled vector or
    None)."""
    p = te["key_prefix"]
    heads = te["heads"]
    act = (lambda x: x * torch.sigmoid(1.702 * x)) if te["act"] == "quick_gelu" \
        else (lambda x: F.gelu(x))
    open_clip = te["layout"] == "open_clip"
    if open_clip:
        x = w(f"{p}.token_embedding.weight")[tokens] + w(f"{p}.positional_embedding")[None]
    else:
        x = w(f"{p}.embeddings.token_embedding.weight")[tokens] \
            + w(f"{p}.embeddings.position_embedding.weight")[None]
    stop = tower_stop(te)
    hidden = None
    for i in range(te["layers"]):
        if open_clip:
            r = f"{p}.transformer.resblocks.{i}"
            h = layer_norm(w, f"{r}.ln_1", x)
            q, k, v = F.linear(h, w(f"{r}.attn.in_proj_weight"),
                               w(f"{r}.attn.in_proj_bias")).chunk(3, dim=-1)
            x = x + linear(w, f"{r}.attn.out_proj", attention(q, k, v, heads, causal=True))
            h = layer_norm(w, f"{r}.ln_2", x)
            x = x + linear(w, f"{r}.mlp.c_proj", act(linear(w, f"{r}.mlp.c_fc", h)))
        else:
            r = f"{p}.encoder.layers.{i}"
            h = layer_norm(w, f"{r}.layer_norm1", x)
            q, k, v = (linear(w, f"{r}.self_attn.{n}_proj", h) for n in "qkv")
            x = x + linear(w, f"{r}.self_attn.out_proj", attention(q, k, v, heads, causal=True))
            h = layer_norm(w, f"{r}.layer_norm2", x)
            x = x + linear(w, f"{r}.mlp.fc2", act(linear(w, f"{r}.mlp.fc1", h)))
        if i + 1 == stop:
            hidden = x
            if not te.get("always_return_pooled"):
                break
    final = f"{p}.ln_final" if open_clip else f"{p}.final_layer_norm"
    if te["final_norm"]:
        hidden = layer_norm(w, final, hidden)
    pooled = None
    if te.get("always_return_pooled"):
        full = layer_norm(w, final, x)
        pooled = full[torch.arange(full.shape[0]), tokens.argmax(dim=-1)] \
            @ w(f"{p}.text_projection")
    return hidden, pooled


def encode_prompts(w: Weights, model: dict, tokens: torch.Tensor,
                   size_ids: Optional[Tuple[float, ...]]):
    """tokens (N, 77) -> (context (N, 77, d), added conditioning (N, adm)
    or None): the towers' hiddens side by side, and with an ``adm_in``
    UNet the pooled vector and the sinusoidal size ids."""
    hiddens, pooled = [], None
    for te in model["text_encoders"]:
        h, pool = text_encoder(w, te, tokens)
        hiddens.append(h)
        pooled = pool if pool is not None else pooled
    context = torch.cat(hiddens, dim=-1)
    u = model["unet_config"]
    if not u.get("adm_in_channels"):
        return context, None
    ids = torch.tensor(size_ids, dtype=torch.float32, device=tokens.device)
    size_emb = timestep_embedding(ids, u["addition_time_embed_dim"]).reshape(1, -1)
    return context, torch.cat([pooled, size_emb.expand(pooled.shape[0], -1)], dim=-1)


# ----------------------------------------------------------------------- UNet
def _unet_res(w, p, x, t_emb):
    h = conv(w, f"{p}.in_layers.2", F.silu(group_norm(w, f"{p}.in_layers.0", x)))
    h = h + linear(w, f"{p}.emb_layers.1", F.silu(t_emb))[:, :, None, None]
    h = conv(w, f"{p}.out_layers.3", F.silu(group_norm(w, f"{p}.out_layers.0", h)))
    skip = x if f"{p}.skip_connection.weight" not in w.tensors \
        else conv(w, f"{p}.skip_connection", x)
    return skip + h


def _proj(w, p, x, linear_proj):
    if linear_proj:
        return linear(w, p, x)
    return F.linear(x, w(f"{p}.weight")[:, :, 0, 0], w(f"{p}.bias"))


def _unet_attn(w, p, x, context, heads, depth, linear_proj):
    n, c, hh, ww = x.shape
    x_in = x.permute(0, 2, 3, 1).reshape(n, hh * ww, c)
    y = group_norm(w, f"{p}.norm", x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
    y = _proj(w, f"{p}.proj_in", y, linear_proj)
    for j in range(depth):
        tb = f"{p}.transformer_blocks.{j}"
        h = layer_norm(w, f"{tb}.norm1", y)
        a = attention(linear(w, f"{tb}.attn1.to_q", h, False),
                      linear(w, f"{tb}.attn1.to_k", h, False),
                      linear(w, f"{tb}.attn1.to_v", h, False), heads)
        y = y + linear(w, f"{tb}.attn1.to_out.0", a)
        h = layer_norm(w, f"{tb}.norm2", y)
        a = attention(linear(w, f"{tb}.attn2.to_q", h, False),
                      linear(w, f"{tb}.attn2.to_k", context, False),
                      linear(w, f"{tb}.attn2.to_v", context, False), heads)
        y = y + linear(w, f"{tb}.attn2.to_out.0", a)
        h = layer_norm(w, f"{tb}.norm3", y)
        val, gate = linear(w, f"{tb}.ff.net.0.proj", h).chunk(2, dim=-1)
        y = y + linear(w, f"{tb}.ff.net.2", val * F.gelu(gate))
    y = _proj(w, f"{p}.proj_out", y, linear_proj) + x_in
    return y.reshape(n, hh, ww, c).permute(0, 3, 1, 2)


def unet(w: Weights, u: dict, x: torch.Tensor, t: float, context: torch.Tensor,
         add: Optional[torch.Tensor]) -> torch.Tensor:
    """The model output (noise prediction) of latents x (N, 4, h, w) at
    training timestep t."""
    p = "model.diffusion_model"
    linear_proj = bool(u.get("use_linear_in_transformer"))
    t_emb = timestep_embedding(torch.full((x.shape[0],), float(t), device=x.device),
                               u["model_channels"])
    t_emb = linear(w, f"{p}.time_embed.2", F.silu(linear(w, f"{p}.time_embed.0", t_emb)))
    if add is not None:
        t_emb = t_emb + linear(w, f"{p}.label_emb.0.2",
                               F.silu(linear(w, f"{p}.label_emb.0.0", add)))
    h = conv(w, f"{p}.input_blocks.0.0", x)
    skips = [h]
    for i, st in enumerate(_encoder_plan(u)):
        blk = f"{p}.input_blocks.{i + 1}"
        if st[0] == "down":
            h = conv(w, f"{blk}.0.op", h, stride=2)
        else:
            _, _, c_out, attn, depth = st
            h = _unet_res(w, f"{blk}.0", h, t_emb)
            if attn:
                h = _unet_attn(w, f"{blk}.1", h, context, unet_heads(u, c_out), depth,
                               linear_proj)
        skips.append(h)
    c_mid, _, d_mid = unet_levels(u)[-1]
    h = _unet_res(w, f"{p}.middle_block.0", h, t_emb)
    h = _unet_attn(w, f"{p}.middle_block.1", h, context, unet_heads(u, c_mid), d_mid,
                   linear_proj)
    h = _unet_res(w, f"{p}.middle_block.2", h, t_emb)
    for j, (_, c_out, attn, depth, up) in enumerate(_decoder_plan(u)):
        blk = f"{p}.output_blocks.{j}"
        h = _unet_res(w, f"{blk}.0", torch.cat([h, skips.pop()], dim=1), t_emb)
        if attn:
            h = _unet_attn(w, f"{blk}.1", h, context, unet_heads(u, c_out), depth, linear_proj)
        if up:
            h = conv(w, f"{blk}.{2 if attn else 1}.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"))
    return conv(w, f"{p}.out.2", F.silu(group_norm(w, f"{p}.out.0", h)))


# ------------------------------------------------------------------------ VAE
def _vae_res(w, p, x):
    h = conv(w, f"{p}.conv1", F.silu(group_norm(w, f"{p}.norm1", x)))
    h = conv(w, f"{p}.conv2", F.silu(group_norm(w, f"{p}.norm2", h)))
    skip = x if f"{p}.nin_shortcut.weight" not in w.tensors else conv(w, f"{p}.nin_shortcut", x)
    return skip + h


def _vae_attn(w, p, x):
    n, c, hh, ww = x.shape
    y = group_norm(w, f"{p}.norm", x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
    q, k, v = (_proj(w, f"{p}.{name}", y, False) for name in "qkv")
    a = _proj(w, f"{p}.proj_out", attention(q, k, v, 1), False)
    return x + a.reshape(n, hh, ww, c).permute(0, 3, 1, 2)


def decode(w: Weights, model: dict, latents: torch.Tensor) -> torch.Tensor:
    """Latents (N, 4, h, w) -> images (N, 3, 8h, 8w), about [-1, 1]."""
    v = model["first_stage_config"]
    p = "first_stage_model"
    x = conv(w, f"{p}.post_quant_conv", latents / model["scale_factor"])
    x = conv(w, f"{p}.decoder.conv_in", x)
    x = _vae_res(w, f"{p}.decoder.mid.block_1", x)
    x = _vae_attn(w, f"{p}.decoder.mid.attn_1", x)
    x = _vae_res(w, f"{p}.decoder.mid.block_2", x)
    for lv in reversed(range(len(v["ch_mult"]))):
        for b in range(v["num_res_blocks"] + 1):
            x = _vae_res(w, f"{p}.decoder.up.{lv}.block.{b}", x)
        if lv > 0:
            x = conv(w, f"{p}.decoder.up.{lv}.upsample.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"))
    x = F.silu(group_norm(w, f"{p}.decoder.norm_out", x))
    return conv(w, f"{p}.decoder.conv_out", x)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) in [-1, 1] -> (N, H, W, 3) uint8: scaled to [0, 255],
    clamped, truncated toward zero."""
    x = ((images + 1.0) * 127.5).clamp(0.0, 255.0)
    return x.to(torch.uint8).permute(0, 2, 3, 1)
