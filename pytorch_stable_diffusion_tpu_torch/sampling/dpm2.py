"""DPM2 and DPM2-ancestral (k-diffusion ``sample_dpm_2`` /
``sample_dpm_2_ancestral``; port of ``sampling/dpm2.py``).

Second-order midpoint method in Karras sigma-space: a half step to the
log-space midpoint sigma, a second model evaluation there, then the full
step with the midpoint derivative.  The midpoints are quantized to the
nearest training timestep on the host, once for the grid
(:func:`mid_timesteps`, float64 numpy).  The midpoint prediction and the
plain DPM2 full step are ``euler.step`` with ``prev_t`` the midpoint / the
next timestep; only the ancestral full step has code here.  On the final
step (sigma_next = 0) both fall back to the Euler step, with no midpoint
evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from .ddpm import DDPMSchedule, sigmas_all
from .euler import ancestral_split, sigmas_at


def mid_timesteps(schedule: DDPMSchedule, timesteps: np.ndarray,
                  ancestral: bool = False) -> np.ndarray:
    """(n_steps,) int32: the nearest training timestep to each step's
    log-space midpoint sigma, between sigma_i and sigma_{i+1} (DPM2) or
    sigma_i and its sigma_down (ancestral).  The final entry is unused
    (Euler fallback) and 0."""
    sig_all = sigmas_all(schedule)
    ts = np.asarray(timesteps)
    sig = sig_all[ts]
    sig_next = np.append(sig[1:], 0.0)
    if ancestral:
        var_up = sig_next**2 * (sig**2 - sig_next**2) / np.maximum(sig**2, 1e-20)
        lo = np.sqrt(np.maximum(sig_next**2 - var_up, 0.0))  # sigma_down
    else:
        lo = sig_next
    out = np.zeros(len(ts), np.int32)
    log_all = np.log(sig_all)
    for i in range(len(ts) - 1):
        s_mid = np.exp(0.5 * (np.log(sig[i]) + np.log(max(lo[i], 1e-20))))
        out[i] = int(np.abs(log_all - np.log(s_mid)).argmin())
    return out


def step_ancestral_second(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
                          eps_mid: torch.Tensor, noise: torch.Tensor, *,
                          prev_t: int) -> torch.Tensor:
    """DPM2-a full step: to sigma_down with the midpoint derivative, then
    sigma_up noise.  The caller takes the final step's Euler fallback."""
    a_t, a_next, sigma, sigma_next = sigmas_at(schedule, t, prev_t)
    sigma_up, sigma_down = ancestral_split(sigma, sigma_next)
    x = latents.float() / float(np.sqrt(a_t)) + float(sigma_down - sigma) * eps_mid.float()
    if prev_t >= 0:
        x = x + float(sigma_up) * noise.float()
    return (float(np.sqrt(a_next)) * x).to(latents.dtype)
