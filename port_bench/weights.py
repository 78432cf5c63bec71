"""The seeded checkpoint: every tensor of a configuration's published key
schema, drawn on the card from the run's seed in the type it is served in.

All "fan" tensors come from one ``torch.rand`` call and all "normal" ones
from one ``torch.randn`` call on a generator on the device; each tensor is
a view of those buffers, scaled in place (uniform in ±1/sqrt(fan_in), as
the usual init of linear and conv layers; embeddings normal).  Each view
starts on a 512-byte boundary, as a tensor of its own would (the caching
allocator's granule): a view at an odd offset would send the program's
matrix products to cuBLAS's unaligned kernels, which no loaded checkpoint
does.  The same
seed on the same device gives the same tensors, so the reference draws
them again after the window instead of keeping a copy beside the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import checkpoint_keys


def served_dtype(config: dict) -> torch.dtype:
    """The type a configuration's weights are served in (its policy's)."""
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[config["serving"]["policy"]]


def draw_checkpoint(model: dict, seed: int, device, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    keys = checkpoint_keys(model)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    step = 512 // torch.empty((), dtype=dtype).element_size()

    def span(shape):
        return -(-math.prod(shape) // step) * step

    n_fan = sum(span(shape) for _, shape, init in keys if init[0] == "fan")
    n_normal = sum(span(shape) for _, shape, init in keys if init[0] == "normal")
    uniform = torch.rand(n_fan, generator=g, device=device, dtype=dtype)
    normal = torch.randn(n_normal, generator=g, device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    at = {"fan": 0, "normal": 0}
    for name, shape, init in keys:
        n = math.prod(shape)
        if init[0] == "fan":
            bound = 1.0 / math.sqrt(init[1])
            t = uniform[at["fan"]:at["fan"] + n].view(shape).mul_(2.0 * bound).sub_(bound)
        elif init[0] == "normal":
            t = normal[at["normal"]:at["normal"] + n].view(shape).mul_(init[1])
        elif init[0] == "ones":
            t = torch.ones(shape, device=device, dtype=dtype)
        else:
            t = torch.zeros(shape, device=device, dtype=dtype)
        if init[0] in at:
            at[init[0]] += span(shape)
        out[name] = t
    return out
