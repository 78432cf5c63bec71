"""LMS sampler: linear multistep over the probability-flow ODE
(k-diffusion ``sample_lms``; port of ``sampling/lms.py``).

In Karras sigma-space the derivative is eps; each step integrates the
Lagrange interpolation of the last ``order`` derivatives exactly over
[sigma_i, sigma_{i+1}]:

    X_{i+1} = X_i + sum_j c_{i,j} d_{i-j}.

The integrals are exact polynomial integrals, computed once on the host in
float64 numpy for every step and every warm-up order (:func:`coeff_table`);
the warm-up order counts from ``start_step`` (img2img).  The loop takes a
row of the table and sums it against the derivative history, a list of
tensors newest first.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .ddpm import DDPMSchedule, _alpha_bar_prev, sigmas_all

ORDER = 4  # k-diffusion's default


def sigma_grid(schedule: DDPMSchedule, timesteps: np.ndarray) -> np.ndarray:
    """Karras sigmas at the inference timesteps, with the terminal 0."""
    return np.append(sigmas_all(schedule)[np.asarray(timesteps)], 0.0)


def coeff_table(schedule: DDPMSchedule, timesteps: np.ndarray,
                order: int = ORDER) -> np.ndarray:
    """(n_steps, order, order) float32: ``tab[i, o-1, j]`` is the exact
    Lagrange-basis integral of step i at current order o; entries with
    j >= o, and orders step i cannot reach, are 0."""
    s = sigma_grid(schedule, timesteps)
    n = len(s) - 1
    tab = np.zeros((n, order, order), np.float64)
    for i in range(n):
        for o in range(1, min(i + 1, order) + 1):
            nodes = [s[i - k] for k in range(o)]
            for j in range(o):
                poly = np.poly1d([1.0])
                for k in range(o):
                    if k != j:
                        poly = poly * np.poly1d([1.0, -nodes[k]]) / (nodes[j] - nodes[k])
                integ = poly.integ()
                tab[i, o - 1, j] = integ(s[i + 1]) - integ(s[i])
    return tab.astype(np.float32)


def step(schedule: DDPMSchedule, table: np.ndarray, step_i: int, start_step: int,
         t: int, latents: torch.Tensor, eps: torch.Tensor, hist: List[torch.Tensor],
         *, prev_t: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One LMS step; ``hist`` is the derivative history, newest first
    (empty at the start step)."""
    order = table.shape[1]
    hist = [eps.float()] + hist[:order - 1]
    cur = min(max(step_i - start_step + 1, 1), order)
    a_t = schedule.alphas_cumprod[int(t)]
    a_next = _alpha_bar_prev(schedule, int(prev_t))
    x = latents.float() / float(np.sqrt(a_t))
    for c, d in zip(table[step_i, cur - 1], hist):
        if c != 0:
            x = x + float(c) * d
    return (float(np.sqrt(a_next)) * x).to(latents.dtype), hist
