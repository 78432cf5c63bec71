"""DDIM sampler (Song et al. 2021; port of ``sampling/ddim.py``).

Shares the schedule and the timestep grids with ``ddpm.py``.  ``eta`` 0:
deterministic, ``noise`` is ignored; ``eta`` 1: DDPM's ancestral variance.
Coefficients in float32 on the host from Python-int timesteps.
"""

from __future__ import annotations

import numpy as np
import torch

from .ddpm import DDPMSchedule, _alpha_bar_prev


def step(schedule: DDPMSchedule, t: int, latents: torch.Tensor, eps: torch.Tensor,
         noise: torch.Tensor, *, eta: float, prev_t: int) -> torch.Tensor:
    """One DDIM step; noise is added iff ``eta != 0`` and prev_t >= 0."""
    t = int(t)
    one = np.float32(1.0)
    a_t = schedule.alphas_cumprod[t]
    a_prev = _alpha_bar_prev(schedule, int(prev_t))
    sigma = np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t)) \
        * np.sqrt(one - a_t / a_prev)
    c_dir = np.sqrt(max(one - a_prev - sigma * sigma, np.float32(0.0)))

    lat, eps = latents.float(), eps.float()
    x0 = (lat - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
    out = float(np.sqrt(a_prev)) * x0 + float(c_dir) * eps
    if eta != 0.0 and prev_t >= 0:
        out = out + float(sigma) * noise.float()
    return out.to(latents.dtype)
