"""Checkpoint saving (port of ``weights/save.py``):

  * :func:`save_safetensors` — export the models back to the CompVis key
    layout (``convert.deconvert``) as a ``.safetensors`` file, readable by
    any SD tool.  The format is written here (an 8-byte little-endian header
    length, the JSON header, then each tensor's raw bytes), because the GPU
    machine has no ``safetensors`` package; :func:`write_safetensors`
    writes any flat dict of tensors.
  * :func:`save_native` / :func:`load_native` — the port's own state dicts,
    unconverted, with ``torch.save`` and ``torch.load(weights_only=True)``
    (no pickle code runs on load), with strict coverage on load.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

from ..models import MODEL_NAMES
from ..models.config import SDConfig
from . import convert as convert_mod

#: torch dtype -> safetensors dtype name
_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
              torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
              torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, any of the format's dtypes) to
    ``path`` in the safetensors format, in name order.  The file is written
    beside ``path`` and moved into place."""
    header: Dict[str, object] = {}
    items = sorted(tensors.items())
    offset = 0
    for name, t in items:
        if t.dtype not in _ST_DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # data starts 8-byte aligned
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            t = t.detach().cpu().contiguous().reshape(-1)
            if t.numel():
                f.write((t if t.dtype == torch.bool else t.view(torch.uint8)).numpy().data)
    os.replace(tmp, path)


def save_safetensors(models, cfg: SDConfig, path: str,
                     dtype: torch.dtype = torch.float32) -> None:
    """Export the family's models (or their state dicts) to a
    CompVis/sgm-layout ``.safetensors`` file in ``dtype`` (fp32 by default,
    as the JAX package writes it), in the layout the family's published
    files use (``convert.deconvert``)."""
    sd = convert_mod.deconvert(models, cfg)
    write_safetensors({k: v.to(dtype) for k, v in sd.items()}, path)


def save_native(models, path: str) -> None:
    """The port's state dicts of the SD models (or the state dicts
    themselves; ``clip2`` with SDXL), unconverted, in one ``torch.save``
    file."""
    sds = {name: (m.state_dict() if isinstance(m, torch.nn.Module) else m)
           for name, m in models.items() if name in MODEL_NAMES}
    torch.save({name: {k: v.detach().cpu() for k, v in sd.items()}
                for name, sd in sds.items()}, path)


def load_native(template, path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Load a :func:`save_native` file, checked against ``template`` (the
    models or state dicts it must fill): the same models, the same keys
    (missing or extra ones raise ``KeyError``) and the same shapes."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    want = {name: (m.state_dict() if isinstance(m, torch.nn.Module) else m)
            for name, m in template.items() if name in MODEL_NAMES}
    if set(obj) != set(want):
        raise KeyError(f"native checkpoint holds models {sorted(obj)}, "
                       f"expected {sorted(want)}")
    for name, sd in want.items():
        missing, extra = set(sd) - set(obj[name]), set(obj[name]) - set(sd)
        if missing or extra:
            raise KeyError(f"[{name}] missing {sorted(missing)[:10]}, "
                           f"unexpected {sorted(extra)[:10]}")
        for k, v in sd.items():
            if tuple(obj[name][k].shape) != tuple(v.shape):
                raise ValueError(f"[{name}] {k}: shape {tuple(obj[name][k].shape)}, "
                                 f"expected {tuple(v.shape)}")
    return obj
