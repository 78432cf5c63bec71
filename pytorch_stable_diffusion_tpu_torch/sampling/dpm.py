"""DPM-Solver++ samplers (Lu et al. 2022; port of ``sampling/dpm.py``):
2M, 2M SDE, 3M SDE and the second half of 2S ancestral.

Data-prediction form: alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t),
lambda_t = log(alpha_t / sigma_t), h = lambda_next - lambda_t, and e^{-h}
formed as (alpha_t sigma_next) / (sigma_t alpha_next), so the final step
(prev_t < 0: sigma_next = 0) gives x0 without infinities and is forced to
first order.

The multistep state is a dict: the x0 history as float32 tensors on the
latents' device, the lambda steps as float32 numpy scalars and the step
count as a Python int, so every branch is taken on the host and every
coefficient is a float32 computed there from Python-int timesteps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ddpm import DDPMSchedule, _alpha_bar_prev
from .euler import ancestral_split, sigmas_at

_ONE = np.float32(1.0)
_TINY = np.float32(1e-20)


def _coeffs(schedule: DDPMSchedule, t: int, prev_t: int):
    """(alpha_t, sigma_t, alpha_n, sigma_n, lambda_n - lambda_t, e^{-h})."""
    a_t = schedule.alphas_cumprod[int(t)]
    a_n = _alpha_bar_prev(schedule, int(prev_t))
    alpha_t, sigma_t = np.sqrt(a_t), np.sqrt(_ONE - a_t)
    alpha_n, sigma_n = np.sqrt(a_n), np.sqrt(_ONE - a_n)
    lam_t = np.log(alpha_t / max(sigma_t, _TINY))
    lam_n = np.log(alpha_n / max(sigma_n, _TINY))
    exp_neg_h = (alpha_t * sigma_n) / (sigma_t * alpha_n)
    return alpha_t, sigma_t, alpha_n, sigma_n, lam_n - lam_t, exp_neg_h


def _nonzero(v):
    return v if v != 0 else _ONE


def init_state() -> Dict:
    return {"prev_x0": None, "prev_h": np.float32(0.0), "count": 0}


def _midpoint_d(x0, state, h, final):
    """The 2M multistep estimate D = x0 + (x0 - x0_prev) / (2r), r =
    h_prev / h (x0 on the first and final steps)."""
    if state["count"] == 0 or final:
        return x0
    r = state["prev_h"] / _nonzero(h)
    w = _ONE / (np.float32(2.0) * _nonzero(r))
    return x0 + float(w) * (x0 - state["prev_x0"])


def step(schedule: DDPMSchedule, t: int, latents: torch.Tensor, eps: torch.Tensor,
         state: Dict, *, prev_t: int) -> Tuple[torch.Tensor, Dict]:
    """One DPM-Solver++(2M) step."""
    alpha_t, sigma_t, alpha_n, sigma_n, h, exp_neg_h = _coeffs(schedule, t, prev_t)
    final = prev_t < 0
    x = latents.float()
    x0 = (x - float(sigma_t) * eps.float()) / float(alpha_t)
    d = _midpoint_d(x0, state, h, final)
    x_next = float(sigma_n / max(sigma_t, _TINY)) * x \
        - float(alpha_n * (exp_neg_h - _ONE)) * d
    new_state = {"prev_x0": x0, "prev_h": state["prev_h"] if final else h,
                 "count": state["count"] + 1}
    return x_next.to(latents.dtype), new_state


def step_sde(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
             eps: torch.Tensor, noise: torch.Tensor, state: Dict, *,
             prev_t: int) -> Tuple[torch.Tensor, Dict]:
    """One SDE-DPM-Solver++(2M) step (midpoint variant):

      x_next = (sigma_n/sigma_t) e^{-h} x + alpha_n (1 - e^{-2h}) D
               + sigma_n sqrt(1 - e^{-2h}) z.

    On the final step sigma_n = 0 and e^{-h} = 0: x_next = x0, no noise."""
    alpha_t, sigma_t, alpha_n, sigma_n, h, exp_neg_h = _coeffs(schedule, t, prev_t)
    exp_neg_2h = exp_neg_h * exp_neg_h
    final = prev_t < 0
    x = latents.float()
    x0 = (x - float(sigma_t) * eps.float()) / float(alpha_t)
    d = _midpoint_d(x0, state, h, final)
    x_next = float(sigma_n / max(sigma_t, _TINY) * exp_neg_h) * x \
        + float(alpha_n * (_ONE - exp_neg_2h)) * d
    c_noise = sigma_n * np.sqrt(max(_ONE - exp_neg_2h, np.float32(0.0)))
    if c_noise != 0:
        x_next = x_next + float(c_noise) * noise.float()
    new_state = {"prev_x0": x0, "prev_h": state["prev_h"] if final else h,
                 "count": state["count"] + 1}
    return x_next.to(latents.dtype), new_state


def init_state_3m() -> Dict:
    return {"x0_1": None, "x0_2": None, "h_1": np.float32(0.0),
            "h_2": np.float32(0.0), "count": 0}


def step_sde_3m(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
                eps: torch.Tensor, noise: torch.Tensor, state: Dict, *,
                prev_t: int) -> Tuple[torch.Tensor, Dict]:
    """One SDE-DPM-Solver++(3M) step (k-diffusion's "DPM++ 3M SDE", eta 1):

      base:  x' = (sigma_n/sigma_t) e^{-h} x + alpha_n (1 - e^{-2h}) x0
             + sigma_n sqrt(1 - e^{-2h}) z
      3rd:   r0 = h_1/h, r1 = h_2/h, d1_0 = (x0 - x0_1)/r0,
             d1_1 = (x0_1 - x0_2)/r1, d1 = d1_0 + (d1_0 - d1_1) r0/(r0 + r1),
             d2 = (d1_0 - d1_1)/(r0 + r1), phi_2 = (e^{-2h} - 1)/(2h) + 1,
             phi_3 = phi_2/(2h) - 1/2,  x' += alpha_n (phi_2 d1 - phi_3 d2)
      2nd (one history entry): x' += alpha_n phi_2 d1_0.

    The final step (prev_t < 0) returns x0 exactly."""
    alpha_t, sigma_t, alpha_n, sigma_n, h, exp_neg_h = _coeffs(schedule, t, prev_t)
    final = prev_t < 0
    x = latents.float()
    x0 = (x - float(sigma_t) * eps.float()) / float(alpha_t)
    new_state = {"x0_1": x0, "x0_2": state["x0_1"],
                 "h_1": state["h_1"] if final else h, "h_2": state["h_1"],
                 "count": state["count"] + 1}
    if final:
        return x0.to(latents.dtype), new_state
    exp_neg_2h = exp_neg_h * exp_neg_h
    x_next = float(sigma_n / max(sigma_t, _TINY) * exp_neg_h) * x \
        + float(alpha_n * (_ONE - exp_neg_2h)) * x0 \
        + float(sigma_n * np.sqrt(max(_ONE - exp_neg_2h, np.float32(0.0)))) * noise.float()
    if state["count"] == 0:
        return x_next.to(latents.dtype), new_state
    h2 = np.float32(2.0) * h
    phi_2 = (exp_neg_2h - _ONE) / h2 + _ONE
    r0 = state["h_1"] / h
    d1_0 = (x0 - state["x0_1"]) / float(_nonzero(r0))
    if state["count"] == 1:
        return (x_next + float(alpha_n * phi_2) * d1_0).to(latents.dtype), new_state
    phi_3 = phi_2 / h2 - np.float32(0.5)
    r1 = state["h_2"] / h
    r01 = _nonzero(r0 + r1)
    d1_1 = (state["x0_1"] - state["x0_2"]) / float(_nonzero(r1))
    d1 = d1_0 + (d1_0 - d1_1) * float(r0 / r01)
    d2 = (d1_0 - d1_1) / float(r01)
    x_next = x_next + float(alpha_n) * (float(phi_2) * d1 - float(phi_3) * d2)
    return x_next.to(latents.dtype), new_state


def step_2s_ancestral_second(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
                             pred_mid: torch.Tensor, eps_mid: torch.Tensor,
                             mid_t: int, noise: torch.Tensor, *,
                             prev_t: int) -> torch.Tensor:
    """DPM-Solver++(2S) ancestral full step (k-diffusion
    ``sample_dpmpp_2s_ancestral``): with x0_mid the model's x0 at the
    midpoint latent ``pred_mid`` (timestep ``mid_t``, from ``euler.step``),

      X' = (sigma_down / sigma) X + (1 - sigma_down / sigma) x0_mid
           + sigma_up z.

    The final step (prev_t < 0) is the caller's Euler fallback."""
    a_t, a_next, sigma, sigma_next = sigmas_at(schedule, t, prev_t)
    sigma_up, sigma_down = ancestral_split(sigma, sigma_next)
    a_mid = schedule.alphas_cumprod[int(mid_t)]
    sigma_mid = np.sqrt((_ONE - a_mid) / a_mid)
    x0_mid = pred_mid.float() / float(np.sqrt(a_mid)) - float(sigma_mid) * eps_mid.float()
    ratio = sigma_down / max(sigma, _TINY)
    x = float(ratio) * (latents.float() / float(np.sqrt(a_t))) \
        + float(_ONE - ratio) * x0_mid
    if prev_t >= 0:
        x = x + float(sigma_up) * noise.float()
    return (float(np.sqrt(a_next)) * x).to(latents.dtype)

