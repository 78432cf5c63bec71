"""AnimateDiff motion-module weights (port of ``weights/animatediff.py``).

The published ``guoyww/AnimateDiff`` ``mm_sd_v15[_v2]`` state dicts hold,
per module, ``{down_blocks.{l}|up_blocks.{l}|mid_block}.motion_modules.{j}
.temporal_transformer.*``: GroupNorm ``norm``, Linear ``proj_in`` and
``proj_out``, and ``transformer_blocks.{b}`` with TWO ``attention_blocks``
(bias-free ``to_q``/``to_k``/``to_v``, biased ``to_out.0``, a fixed
``pos_encoder.pe`` buffer), paired ``norms``, the GEGLU ``ff`` and
``ff_norm``.  :func:`motion_site_plan` re-keys them onto the UNet's sites
(``enc_{stage}``, ``dec_{stage}``, ``mid``), as the JAX package does; the
port keeps torch's (out, in) Linear layout, so nothing is transposed.  The
``pe`` buffers are consumed and give the trained temporal window
(``max_len``, 32 for v2); coverage is exact both ways, with the JAX
package's ``ValueError`` messages.  A v1 file has no ``mid`` module.
``.safetensors`` files are read by the native reader, ``.ckpt`` by the
restricted unpickler.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

from ..models.config import UNetConfig
from ..models.motion import positional_encoding
from .convert import as_tensor


def motion_site_plan(cfg: UNetConfig) -> Dict[str, str]:
    """Checkpoint module prefix -> the UNet's site: down level l block j is
    encoder stage ``l * (num_res + 1) + j`` (a module after every res(+attn)
    stage), up level l block j decoder stage ``l * (num_res + 1) + j``
    (both deepest-first), and the bottleneck's."""
    plan = {}
    n_levels = len(cfg.ch_mults)
    for lvl in range(n_levels):
        start = sum(cfg.num_res_blocks + (1 if i < n_levels - 1 else 0)
                    for i in range(lvl))
        for j in range(cfg.num_res_blocks):
            plan[f"down_blocks.{lvl}.motion_modules.{j}"] = f"enc_{start + j}"
    for lvl in range(n_levels):
        start = lvl * (cfg.num_res_blocks + 1)
        for j in range(cfg.num_res_blocks + 1):
            plan[f"up_blocks.{lvl}.motion_modules.{j}"] = f"dec_{start + j}"
    plan["mid_block.motion_modules.0"] = "mid"
    return plan


def _module_rules(pref: str, site: str, n_blocks: int) -> List[Tuple[str, str]]:
    """(checkpoint key, port key) of every tensor of one module."""
    t = pref + ".temporal_transformer."
    rules = [(f"{t}{name}.{p}", f"{site}.{name}.{p}")
             for name in ("norm", "proj_in", "proj_out") for p in ("weight", "bias")]
    for b in range(n_blocks):
        tb, ob = f"{t}transformer_blocks.{b}.", f"{site}.blocks.{b}."
        for ai in (0, 1):
            a = f"{tb}attention_blocks.{ai}."
            rules += [(f"{a}to_{x}.weight", f"{ob}attn{ai + 1}.{x}.weight") for x in "qkv"]
            rules += [(f"{a}to_out.0.{p}", f"{ob}attn{ai + 1}.out.{p}") for p in ("weight", "bias")]
            rules += [(f"{tb}norms.{ai}.{p}", f"{ob}norm{ai + 1}.{p}") for p in ("weight", "bias")]
        for src, dst in (("ff.net.0.proj", "ff_proj"), ("ff.net.2", "ff_out"),
                         ("ff_norm", "ff_norm")):
            rules += [(f"{tb}{src}.{p}", f"{ob}{dst}.{p}") for p in ("weight", "bias")]
    return rules


def convert_motion_module(state: Dict, cfg: UNetConfig
                          ) -> Tuple[Dict[str, torch.Tensor], int]:
    """A published motion-module state dict -> (the port's state dict,
    float32, for ``models/motion.build``; max_len)."""
    sd = dict(state)
    max_len = 0
    for k in list(sd):
        if k.endswith("pos_encoder.pe"):
            max_len = max(max_len, int(sd.pop(k).shape[-2]))
    prefixes = sorted({m.group(1) for k in sd
                       if (m := re.match(r"(.+?\.motion_modules\.\d+)\.", k))})
    plan = motion_site_plan(cfg)
    out: Dict[str, torch.Tensor] = {}
    for pref in prefixes:
        if pref not in plan:
            raise ValueError(f"unexpected motion module {pref!r} for this "
                             "UNet topology")
        t = pref + ".temporal_transformer."
        n_blocks = 0
        while f"{t}transformer_blocks.{n_blocks}.ff_norm.weight" in sd:
            n_blocks += 1
        for src, dst in _module_rules(pref, plan[pref], n_blocks):
            if src not in sd:
                raise ValueError(f"motion module missing {src!r}")
            out[dst] = as_tensor(sd.pop(src)).float()
        if not n_blocks:
            raise ValueError(f"{pref}: no transformer_blocks found")
    if sd:
        raise ValueError(f"unconsumed motion keys: {sorted(sd)[:4]}...")
    if not out:
        raise ValueError("no motion_modules.* keys found")
    return out, (max_len or 24)


def deconvert_motion_module(modules, cfg: UNetConfig, max_len: int = 32
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_motion_module`: the port's modules (an
    ``nn.ModuleDict`` or its state dict) -> the published key schema, with
    the ``pos_encoder.pe`` buffers (1, max_len, C) in float32, on the
    tensors' device and in their dtype."""
    flat = modules.state_dict() if isinstance(modules, torch.nn.Module) else modules
    site_of = {v: k for k, v in motion_site_plan(cfg).items()}
    sd: Dict[str, torch.Tensor] = {}
    for site in sorted({k.split(".")[0] for k in flat}):
        n_blocks = len({k.split(".")[2] for k in flat if k.startswith(f"{site}.blocks.")})
        pref = site_of[site]
        for src, dst in _module_rules(pref, site, n_blocks):
            sd[src] = flat[dst].detach()
        c = flat[f"{site}.proj_in.weight"].shape[0]
        pe = torch.from_numpy(positional_encoding(max_len, c))[None].to(sd[src].device)
        for b in range(n_blocks):
            for ai in (0, 1):
                sd[f"{pref}.temporal_transformer.transformer_blocks.{b}."
                   f"attention_blocks.{ai}.pos_encoder.pe"] = pe
    return sd


def load_motion_module(path: str, cfg: UNetConfig) -> Tuple[Dict[str, torch.Tensor], int]:
    """A motion-module file -> (the port's state dict, max_len):
    ``.safetensors`` through the native reader, anything else (``.ckpt``)
    through the restricted unpickler, a ``state_dict`` nesting unwrapped."""
    if path.endswith(".safetensors"):
        from .convert import load_state_dict

        return convert_motion_module(load_state_dict(path), cfg)
    from .ckpt_reader import load_torch_object

    obj = load_torch_object(path)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return convert_motion_module(obj, cfg)
