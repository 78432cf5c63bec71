"""Euler, Euler-ancestral and Heun steps (Karras et al. 2022; port of
``sampling/euler.py``).

The DDPM latent x_t = sqrt(abar_t) (x0 + sigma_t eps), sigma_t =
sqrt((1 - abar_t) / abar_t), maps to Karras sigma-space by X = x_t /
sqrt(abar_t), where the probability-flow derivative is eps.  One Euler
step is X' = X + (sigma_next - sigma) eps, mapped back with
sqrt(abar_next); the final step (prev_t < 0: abar_next = 1, sigma_next = 0)
lands on the predicted x0.  Euler-ancestral splits sigma_next into
sigma_down and a noise injection sigma_up (k-diffusion's
get_ancestral_step).  Coefficients in float32 on the host from Python-int
timesteps.
"""

from __future__ import annotations

import numpy as np
import torch

from .ddpm import DDPMSchedule, _alpha_bar_prev


def sigmas_at(schedule: DDPMSchedule, t: int, prev_t: int):
    """(abar_t, abar_next, sigma, sigma_next), float32 (prev_t < 0: abar 1,
    sigma 0)."""
    one = np.float32(1.0)
    a_t = schedule.alphas_cumprod[int(t)]
    a_next = _alpha_bar_prev(schedule, int(prev_t))
    return a_t, a_next, np.sqrt((one - a_t) / a_t), np.sqrt((one - a_next) / a_next)


def ancestral_split(sigma, sigma_next):
    """(sigma_up, sigma_down) of k-diffusion's get_ancestral_step (eta 1),
    float32."""
    zero = np.float32(0.0)
    var_up = sigma_next**2 * max(sigma**2 - sigma_next**2, zero) \
        / max(sigma**2, np.float32(1e-20))
    return np.sqrt(var_up), np.sqrt(max(sigma_next**2 - var_up, zero))


def step(schedule: DDPMSchedule, t: int, latents: torch.Tensor, eps: torch.Tensor, *,
         prev_t: int) -> torch.Tensor:
    """One deterministic Euler step."""
    a_t, a_next, sigma, sigma_next = sigmas_at(schedule, t, prev_t)
    x = latents.float() / float(np.sqrt(a_t)) + float(sigma_next - sigma) * eps.float()
    return (float(np.sqrt(a_next)) * x).to(latents.dtype)


def step_heun_correct(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
                      eps: torch.Tensor, eps2: torch.Tensor, *, prev_t: int) -> torch.Tensor:
    """Heun's corrector: the trapezoidal derivative (eps + eps2) / 2, where
    ``eps2`` is the model at the Euler result and the next timestep.  On
    the final step (prev_t < 0) the Euler result is kept and ``eps2`` is
    not read (may be None): the caller need not evaluate it."""
    a_t, a_next, sigma, sigma_next = sigmas_at(schedule, t, prev_t)
    d = eps.float() if prev_t < 0 else 0.5 * (eps.float() + eps2.float())
    x = latents.float() / float(np.sqrt(a_t)) + float(sigma_next - sigma) * d
    return (float(np.sqrt(a_next)) * x).to(latents.dtype)


def step_ancestral(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
                   eps: torch.Tensor, noise: torch.Tensor, *, prev_t: int) -> torch.Tensor:
    """One Euler-ancestral step; noise only before the final step."""
    a_t, a_next, sigma, sigma_next = sigmas_at(schedule, t, prev_t)
    sigma_up, sigma_down = ancestral_split(sigma, sigma_next)
    x = latents.float() / float(np.sqrt(a_t)) + float(sigma_down - sigma) * eps.float()
    if prev_t >= 0:
        x = x + float(sigma_up) * noise.float()
    return (float(np.sqrt(a_next)) * x).to(latents.dtype)
