"""Textual-inversion embeddings (port of ``weights/textual_inversion.py``).

The community formats:

  * A1111 ``.pt``: ``{"string_to_param": {"*": (n, d)}, "name": str}`` —
    read through the restricted torch unpickler (no pickle execution,
    ``ckpt_reader.load_torch_object``);
  * A1111 ``.safetensors``: ``{"emb_params": (n, d)}``;
  * diffusers ``.safetensors``/``.pt``/``.bin``: ``{"<token>": (n, d)}``;
  * SDXL dual-tower ``.safetensors``: ``{"clip_l": (n, 768), "clip_g":
    (n, 1280)}``, one trigger, a row-aligned pair of tables.

An embedding adds ``n`` new rows to CLIP's token-embedding table and
registers a trigger word with the tokenizer that expands to those ids
(``tokenizer.add_placeholder``): a weight and vocabulary transform, after
which the pipeline runs as on any model.  A dual-tower model (SDXL) feeds
the same ids to both towers, so both tables grow together, each by its
half of a dual-tower embedding; it refuses single-tower embeddings, and a
single-tower model refuses dual-tower ones, with ``ValueError`` as in the
JAX package.
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


DUAL = ("clip_l", "clip_g")


def is_dual(embedding) -> bool:
    """Whether ``embedding`` is the SDXL dual-tower form."""
    return isinstance(embedding, dict) and set(embedding) >= set(DUAL)


def load_embedding(path: str, token: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Embedding file -> {trigger_token: (n, d) float32 tensor}.

    ``token`` overrides the trigger word (default: the file's embedded name
    or the file stem, A1111 convention)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if path.endswith(".safetensors"):
        from . import native_io

        sd = native_io.load_safetensors(path)
        if is_dual(sd):
            pair = {k: sd[k].float().reshape(-1, sd[k].shape[-1]) for k in DUAL}
            if pair["clip_l"].shape[0] != pair["clip_g"].shape[0]:
                raise ValueError(
                    "dual-tower embedding has mismatched vector counts: "
                    f"clip_l {pair['clip_l'].shape[0]} vs clip_g "
                    f"{pair['clip_g'].shape[0]}")
            return {token or stem: pair}
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
                   embeddings: Dict[str, object]) -> Tuple[dict, object, SDConfig]:
    """Extend the CLIP embedding table(s) and tokenizer with trigger words.

    Returns (models, tokenizer, cfg) — all fresh objects; the originals are
    untouched, and the new towers share every parameter but their token
    tables with the old ones.  ``cfg.clip.vocab_size`` (and
    ``cfg.clip2.vocab_size``) grow so the pipeline's token-bound validation
    accepts the new ids.  A dual-tower model takes ``{"clip_l": (n, d1),
    "clip_g": (n, d2)}`` embeddings only; a single-tower one ``(n, d)``."""
    dual = cfg.clip2 is not None
    names = ("clip", "clip2") if dual else ("clip",)
    sds = {name: models[name].state_dict() for name in names}
    embs = [sds[name]["token_embedding"] for name in names]
    if dual and embs[1].shape[0] != embs[0].shape[0]:
        raise ValueError(f"tower vocab mismatch: clip {embs[0].shape[0]} vs clip2 "
                         f"{embs[1].shape[0]} — cannot share new token ids")
    tok = tokenizer.clone()
    rows = [[e] for e in embs]
    next_id = embs[0].shape[0]
    for trigger, arr in embeddings.items():
        if is_dual(arr) != dual:
            raise ValueError(
                f"embedding '{trigger}' is dual-tower (SDXL) but the model has a single "
                f"text tower" if not dual else
                f"embedding '{trigger}' is single-tower but the model is dual-tower "
                "(SDXL) — need {'clip_l': ..., 'clip_g': ...} vectors for both towers")
        parts = [arr[k] for k in DUAL] if dual else [arr]
        parts = [as_tensor(a).to(device=e.device, dtype=e.dtype) for a, e in zip(parts, embs)]
        parts = [a[None] if a.dim() == 1 else a for a in parts]
        if dual and parts[0].shape[0] != parts[1].shape[0]:
            raise ValueError(f"embedding '{trigger}': clip_l has {parts[0].shape[0]} "
                             f"vectors, clip_g {parts[1].shape[0]}")
        dims = tuple(a.shape[1] for a in parts)
        want = tuple(e.shape[1] for e in embs)
        if dims != want:
            raise ValueError(f"embedding '{trigger}' has dim {dims if dual else dims[0]}, "
                             f"model expects {want if dual else want[0]}")
        n = parts[0].shape[0]
        for r, a in zip(rows, parts):
            r.append(a)
        tok.add_placeholder(trigger, list(range(next_id, next_id + n)))
        next_id += n
    new_cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, vocab_size=next_id),
        clip2=None if not dual else dataclasses.replace(cfg.clip2, vocab_size=next_id))
    for name, r in zip(names, rows):
        sds[name]["token_embedding"] = torch.cat(r, dim=0)
    return dict(models, **assemble(new_cfg, sds)), tok, new_cfg
