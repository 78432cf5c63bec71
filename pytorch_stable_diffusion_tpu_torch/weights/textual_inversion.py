"""Textual-inversion embeddings (port of ``weights/textual_inversion.py``).

The community formats:

  * A1111 ``.pt``: ``{"string_to_param": {"*": (n, d)}, "name": str}`` —
    read through the restricted torch unpickler (no pickle execution,
    ``ckpt_reader.load_torch_object``);
  * A1111 ``.safetensors``: ``{"emb_params": (n, d)}``;
  * diffusers ``.safetensors``/``.pt``/``.bin``: ``{"<token>": (n, d)}``.

An embedding adds ``n`` new rows to CLIP's token-embedding table and
registers a trigger word with the tokenizer that expands to those ids
(``tokenizer.add_placeholder``): a weight and vocabulary transform, after
which the pipeline runs as on any model.  The SDXL dual-tower form
(``{"clip_l": ..., "clip_g": ...}``) comes with slice C2.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import assemble
from ..models.config import SDConfig
from .convert import as_tensor


def refuse_dual_tower():
    raise NotImplementedError(
        "dual-tower (SDXL) textual-inversion embeddings are not ported yet: they "
        "come with slice C2 (ROADMAP.md §1)")


def load_embedding(path: str, token: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Embedding file -> {trigger_token: (n, d) float32 tensor}.

    ``token`` overrides the trigger word (default: the file's embedded name
    or the file stem, A1111 convention)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if path.endswith(".safetensors"):
        from . import native_io

        sd = native_io.load_safetensors(path)
        if set(sd) >= {"clip_l", "clip_g"}:
            refuse_dual_tower()
        if "emb_params" in sd:  # A1111 layout
            return {token or stem: sd["emb_params"].float()}
        if len(sd) == 1:  # diffusers layout: the key IS the trigger
            (k, v), = sd.items()
            return {token or k: v.float()}
        raise ValueError(f"unrecognized embedding keys {sorted(sd)[:5]}")

    from .ckpt_reader import load_torch_object

    obj = load_torch_object(path)
    if not isinstance(obj, dict):
        raise ValueError(f"embedding root is {type(obj)}, expected dict")
    if "string_to_param" in obj:  # A1111 .pt
        params = obj["string_to_param"]
        (v,) = [as_tensor(x).float() for x in params.values()]
        name = obj.get("name") if isinstance(obj.get("name"), str) else None
        return {token or name or stem: v}
    arrays = {k: v for k, v in obj.items() if isinstance(v, np.ndarray)}
    if len(arrays) == 1:  # diffusers .pt / .bin
        (k, v), = arrays.items()
        return {token or k: as_tensor(v).float()}
    raise ValueError(f"unrecognized embedding file layout: {sorted(obj)[:5]}")


def add_embeddings(models: dict, tokenizer, cfg: SDConfig,
                   embeddings: Dict[str, torch.Tensor]) -> Tuple[dict, object, SDConfig]:
    """Extend the CLIP embedding table and tokenizer with trigger words.

    Returns (models, tokenizer, cfg) — all fresh objects; the originals are
    untouched, and the new CLIP shares every parameter but its token table
    with the old one.  ``cfg.clip.vocab_size`` grows so the pipeline's
    token-bound validation accepts the new ids."""
    if cfg.clip2 is not None:
        refuse_dual_tower()
    clip_sd = models["clip"].state_dict()
    emb = clip_sd["token_embedding"]
    d = emb.shape[1]
    tok = tokenizer.clone()
    rows = [emb]
    next_id = emb.shape[0]
    for trigger, arr in embeddings.items():
        if isinstance(arr, dict):
            refuse_dual_tower()
        arr = as_tensor(arr).to(device=emb.device, dtype=emb.dtype)
        arr = arr[None] if arr.dim() == 1 else arr
        if arr.shape[1] != d:
            raise ValueError(f"embedding '{trigger}' has dim {arr.shape[1]}, "
                             f"model expects {d}")
        n = arr.shape[0]
        rows.append(arr)
        tok.add_placeholder(trigger, list(range(next_id, next_id + n)))
        next_id += n
    new_cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, vocab_size=next_id))
    clip_sd["token_embedding"] = torch.cat(rows, dim=0)
    return dict(models, **assemble(new_cfg, {"clip": clip_sd})), tok, new_cfg
