"""LoRA adapters, merged into the weights (port of ``weights/lora.py``).

Adapters merge *offline*: the result is a new set of models whose
targeted weights hold ``W + delta`` and whose other parameters are shared
with the models merged into (``models.assemble``), so the pipeline runs
exactly as on any checkpoint.

Supported formats (auto-detected per key):

* **kohya / sd-scripts** (the common single-file ``.safetensors`` LoRA):
  ``lora_unet_{module}.lora_down.weight`` / ``.lora_up.weight`` /
  ``.alpha`` where ``{module}`` is the diffusers module path with dots
  flattened to underscores (``down_blocks_0_attentions_0_...``), plus
  ``lora_te_`` / ``lora_te1_`` for the (first) text encoder and
  ``lora_te2_`` for SDXL's bigG tower.
* **diffusers / PEFT**: dotted module paths with ``.lora_A.weight`` (down)
  / ``.lora_B.weight`` (up) under ``unet.`` / ``text_encoder.`` /
  ``text_encoder_2.`` roots,
  or with PEFT's adapter name (``.lora_A.default.weight``), which the JAX
  package's grouping refuses although its comment names the form.  PEFT
  stores no per-module alpha in the state dict; alpha defaults to the
  rank (scaling 1), the PEFT default.

Targets are the port's parameter names, reached through the diffusers
rules (``weights/diffusers.py``): every conv and linear weight of the UNet
(each layer of a stacked transformer block its own target) and of each
text tower.  Merge rule per target weight ``W``, in the torch layout
``(out, in[, kh, kw])`` the port keeps::

    W' = (fp32(W) + fp32(scale * (alpha / rank) * up @ down)).to(W.dtype)

with the product in fp32 on the models' device, the same order of
operations as the JAX package (so the bf16 rounding agrees); a
linear-factored delta on a 1x1 conv target (``proj_in`` stored as a conv)
gains the conv's two unit axes, and the text projection, kept as the
(in, out) matrix, takes the delta transposed.  Conv LoRAs
(LoCon-style 3x3 down + 1x1 up) are supported; Hadamard/Kronecker
factorizations (LoHa/LoKr) are not and raise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..models import assemble
from ..models.config import SDConfig, model_names
from . import diffusers as dif
from .convert import WEIGHT_KINDS, as_tensor


def _weight_targets(cfg: SDConfig) -> Dict[str, List[Tuple[str, str, str]]]:
    """Dotted diffusers module path (no ``.weight``) -> list of (model_name,
    port parameter, kind) for every conv and linear weight."""
    towers = [("unet.", "diffusion", dif.unet_rules(cfg)),
              ("text_encoder.", "clip", dif.clip_rules(cfg))]
    if cfg.clip2 is not None:
        towers.append(("text_encoder_2.", "clip2", dif.clip2_rules(cfg)))
    out: Dict[str, List[Tuple[str, str, str]]] = {}
    for root, model, rules in towers:
        for src, dst, kind in rules:
            if src.endswith(".weight") and kind in WEIGHT_KINDS:
                out.setdefault(root + src[:-len(".weight")], []).append((model, dst, kind))
    return out


#: kohya prefix -> dotted root it stands for
_KOHYA_ROOTS = (("lora_unet_", "unet."),
                ("lora_te1_", "text_encoder."),
                ("lora_te2_", "text_encoder_2."),
                ("lora_te_", "text_encoder."))


def _group_lora_keys(lora_sd) -> Dict[str, dict]:
    """Raw LoRA state dict -> {module_name: {down, up, alpha}} with
    module_name kept in the file's own spelling (underscored or dotted)."""
    groups: Dict[str, dict] = {}
    for key, val in lora_sd.items():
        for suffix, slot in ((".lora_down.weight", "down"),
                             (".lora_up.weight", "up"),
                             # PEFT nests an adapter name: "...to_q.lora_A.default.weight"
                             (".lora_A.default.weight", "down"),
                             (".lora_B.default.weight", "up"),
                             (".lora_A.weight", "down"),
                             (".lora_B.weight", "up"),
                             (".alpha", "alpha")):
            if key.endswith(suffix):
                name = key[:-len(suffix)]
                groups.setdefault(name, {})[slot] = as_tensor(val)
                break
        else:
            raise ValueError(f"unrecognized LoRA key: {key!r} (LoHa/LoKr "
                             "factorizations are not supported)")
    return groups


def _resolve(name: str, targets, und_index):
    """LoRA module name (kohya-underscored or PEFT-dotted) -> dotted key."""
    if name in targets:
        return name
    for prefix, root in _KOHYA_ROOTS:
        if name.startswith(prefix):
            return und_index.get((root, name[len(prefix):]))
    return None


def apply_lora(models, cfg: SDConfig, lora_sd, scale: float = 1.0, *,
               strict: bool = True):
    """Merge one LoRA state dict into ``models`` (functional: returns a new
    models dict; the merged parameters are new tensors, the others and any
    non-model entry are shared).  ``scale`` is the user strength multiplier
    (on top of the adapter's own alpha/rank scaling)."""
    targets = _weight_targets(cfg)
    und_index = {}
    for k in targets:
        root, rest = k.split(".", 1)
        und_index[(root + ".", rest.replace(".", "_"))] = k
    groups = _group_lora_keys(lora_sd)

    flats = {m: models[m].state_dict() for m in model_names(cfg)}
    changed = set()
    unmatched, matched = [], 0
    for name, g in sorted(groups.items()):
        dotted = _resolve(name, targets, und_index)
        if dotted is None:
            unmatched.append(name)
            continue
        if "down" not in g or "up" not in g:
            raise ValueError(f"LoRA module {name!r} is missing its "
                             f"{'up' if 'down' in g else 'down'} factor")
        device = flats[targets[dotted][0][0]][targets[dotted][0][1]].device
        down = g["down"].to(device=device, dtype=torch.float32)
        up = g["up"].to(device=device, dtype=torch.float32)
        rank = down.shape[0]
        if up.shape[1] != rank:
            raise ValueError(f"LoRA module {name!r}: up factor rank "
                             f"{up.shape[1]} != down rank {rank}")
        alpha = float(g["alpha"]) if "alpha" in g else float(rank)
        # (out, r[,1,1]) @ (r, in[,k,k]) in torch layout
        delta = (up.reshape(up.shape[0], rank) @ down.reshape(rank, -1)).reshape(
            (up.shape[0],) + tuple(down.shape[1:]))
        for model, dst, kind in targets[dotted]:
            dl = delta
            leaf = flats[model][dst]
            if kind == "linear_t":
                dl = dl.t()  # the text projection is kept as (in, out)
            elif leaf.dim() == 4 and dl.dim() == 2:
                dl = dl[:, :, None, None]  # linear-factored LoRA on a 1x1 conv
            d = dl * (scale * alpha / rank)
            if d.shape != leaf.shape:
                raise ValueError(
                    f"LoRA module {name!r}: delta shape {tuple(d.shape)} does not "
                    f"match target {model}/{dst} {tuple(leaf.shape)}")
            flats[model][dst] = (leaf.float() + d).to(leaf.dtype)
            changed.add(model)
            matched += 1
    if unmatched and strict:
        raise KeyError(f"{len(unmatched)} LoRA modules have no target in "
                       f"this architecture (first 10): {unmatched[:10]}")
    if matched == 0:
        raise ValueError("LoRA matched zero modules — wrong file or architecture?")
    return dict(models, **assemble(cfg, {m: flats[m] for m in sorted(changed)}))


def apply_loras(models, cfg: SDConfig, loras: List[Tuple[dict, float]], **kw):
    """Merge several (state_dict, scale) adapters in order (merges are
    additive in fp32, so order only matters for rounding)."""
    for sd, scale in loras:
        models = apply_lora(models, cfg, sd, scale, **kw)
    return models


def load_lora(path: str):
    """Read a LoRA adapter file (.safetensors through the native reader, or
    a torch zip .pt/.ckpt through the restricted unpickler)."""
    from .convert import load_state_dict

    return load_state_dict(str(path))
