"""LCM sampler: Latent Consistency Model multi-step sampling (Luo et al.
2023; port of ``sampling/lcm.py``).

* Timesteps live on the distillation grid: ``arange(1, original_steps+1) *
  (T // original_steps) - 1`` descending, strided down to
  ``num_inference_steps`` from the top (t = 999 first).
* Each step evaluates the consistency function f = c_skip x_t + c_out x0
  with the boundary scalings of the distillation objective (sigma_data
  0.5, timestep scaling 10), then re-noises f to the next grid point with
  fresh noise; the final step returns f.

Coefficients in float32 on the host from Python-int timesteps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ddpm

#: boundary-condition constants of the LCM distillation objective
SIGMA_DATA = 0.5
TIMESTEP_SCALING = 10.0
#: the teacher grid the public LCM / LCM-LoRA weights were distilled on
ORIGINAL_STEPS = 50


def inference_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                        original_steps: int = ORIGINAL_STEPS) -> np.ndarray:
    """Descending int32 timesteps on the LCM distillation grid."""
    if num_inference_steps > original_steps:
        raise ValueError(
            f"LCM supports at most original_steps={original_steps} inference "
            f"steps (the distillation grid), got {num_inference_steps}")
    k = num_train_timesteps // original_steps
    grid = np.arange(1, original_steps + 1, dtype=np.int64) * k - 1
    stride = len(grid) // num_inference_steps
    return grid[::-1][::stride][:num_inference_steps].astype(np.int32)


def boundary_scalings(t: int):
    """(c_skip, c_out) at timestep ``t``, float32."""
    s = np.float32(t) * np.float32(TIMESTEP_SCALING)
    sd2 = np.float32(SIGMA_DATA * SIGMA_DATA)
    return sd2 / (s * s + sd2), s / np.sqrt(s * s + sd2)


def step(schedule: ddpm.DDPMSchedule, t: int, latents: torch.Tensor,
         eps: torch.Tensor, noise: torch.Tensor, *, prev_t: int) -> torch.Tensor:
    """One LCM iteration; ``prev_t`` < 0 on the final step, which returns
    the consistency output and does not read ``noise``."""
    one = np.float32(1.0)
    abar_t = schedule.alphas_cumprod[int(t)]
    lat = latents.float()
    x0 = (lat - float(np.sqrt(one - abar_t)) * eps.float()) / float(np.sqrt(abar_t))
    c_skip, c_out = boundary_scalings(int(t))
    denoised = float(c_skip) * lat + float(c_out) * x0
    if prev_t < 0:
        return denoised.to(latents.dtype)
    abar_prev = ddpm._alpha_bar_prev(schedule, int(prev_t))
    return (float(np.sqrt(abar_prev)) * denoised
            + float(np.sqrt(one - abar_prev)) * noise.float()).to(latents.dtype)
