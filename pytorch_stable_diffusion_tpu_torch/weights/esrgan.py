"""ESRGAN / RealESRGAN weights (port of ``weights/esrgan.py``).

Both published namings, with exact coverage and the JAX package's
``ValueError`` messages:

* new-arch (BasicSR / RealESRGAN): ``conv_first``,
  ``body.{i}.rdb{1,2,3}.conv{1..5}``, ``conv_body``, ``conv_up1/2``,
  ``conv_hr``, ``conv_last`` — the port's own names — sometimes nested
  under ``params`` / ``params_ema``;
* old-arch (the original ESRGAN, most A1111 "ESRGAN_4x" files):
  ``model.0``, ``model.1.sub.{i}.RDB{j}.conv{k}.0``, ``model.1.sub.{N}``
  (the trunk conv), ``model.3/6/8/10``.

The architecture (features, block count, growth, scale) is read from the
tensor shapes, so any size variant loads.  The port keeps torch's OIHW conv
layout: nothing is transposed.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

from ..models.esrgan import ESRGANConfig
from .convert import as_tensor


def _scale_for_in(c_in: int) -> int:
    if c_in % 48 == 0 and c_in != 3:
        return 1
    if c_in % 12 == 0:
        return 2
    return 4


def _names(n_blocks: int, old: bool) -> Dict[str, str]:
    """port conv name -> the file's conv name."""
    if not old:
        top = {n: n for n in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr",
                              "conv_last")}
    else:
        top = {"conv_first": "model.0", "conv_body": f"model.1.sub.{n_blocks}",
               "conv_up1": "model.3", "conv_up2": "model.6", "conv_hr": "model.8",
               "conv_last": "model.10"}
    for i in range(n_blocks):
        for j in (1, 2, 3):
            for k in range(1, 6):
                top[f"body.{i}.rdb{j}.conv{k}"] = \
                    f"model.1.sub.{i}.RDB{j}.conv{k}.0" if old else f"body.{i}.rdb{j}.conv{k}"
    return top


def convert_esrgan(state: Dict) -> Tuple[Dict[str, torch.Tensor], ESRGANConfig]:
    """-> (the port's state dict, float32; the config read from the shapes)."""
    sd = dict(state)
    for nest in ("params_ema", "params"):
        if nest in sd and isinstance(sd[nest], dict):
            sd = dict(sd[nest])
            break
    if "conv_first.weight" in sd:
        old = False
        n_blocks = 1 + max(int(m.group(1)) for k in sd
                           if (m := re.match(r"body\.(\d+)\.", k)))
    elif "model.0.weight" in sd:
        old = True
        # the last sub entry is the trunk conv
        n_blocks = max(int(m.group(1)) for k in sd
                       if (m := re.match(r"model\.1\.sub\.(\d+)\.", k)))
    else:
        raise ValueError(f"unrecognized ESRGAN layout (keys like "
                         f"{sorted(sd)[:3]}...)")
    names = _names(n_blocks, old)
    nf, c_in = sd[names["conv_first"] + ".weight"].shape[:2]
    cfg = ESRGANConfig(in_channels=3, out_channels=sd[names["conv_last"] + ".weight"].shape[0],
                       features=nf, num_blocks=n_blocks,
                       growth=sd[names["body.0.rdb1.conv1"] + ".weight"].shape[0],
                       scale=_scale_for_in(c_in))
    out = {f"{ours}.{p}": as_tensor(sd.pop(f"{theirs}.{p}")).float()
           for ours, theirs in names.items() for p in ("weight", "bias")}
    if sd:
        raise ValueError(f"unconsumed ESRGAN keys: {sorted(sd)[:4]}...")
    return out, cfg


def load_esrgan(path: str) -> Tuple[Dict[str, torch.Tensor], ESRGANConfig]:
    """A weight file (``.pth`` through the restricted unpickler, or
    ``.safetensors``) -> (state dict, config)."""
    if path.endswith(".safetensors"):
        from .convert import load_state_dict

        return convert_esrgan(load_state_dict(path))
    from .ckpt_reader import load_torch_object

    return convert_esrgan(load_torch_object(path))
