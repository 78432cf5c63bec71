r"""UniPC sampler (Zhao et al. 2023; port of ``sampling/unipc.py``):
unified predictor-corrector, order 2, ``bh2``, in data-prediction space.

With alpha, sigma, lambda and h as in ``dpm.py``:

* **Predictor** (uni_p): from the x0-predictions at the current point (m0)
  and the previous one (m1), u = expm1(-h) and D1 = (m1 - m0) / rk,
  rk = -h_prev / h:
    x_next = (sigma_next / sigma_t) x - alpha_next u m0
             - alpha_next u rho_p D1,   rho_p = (u / (-h) - 1) / u.
* **Corrector** (uni_c): on arriving at a predicted sample with a fresh
  evaluation m_t, the transition that produced it is solved again with m_t
  included; order 1 at the first correction (rho 1/2), then order 2 from
  the 2x2 collocation system.  The model is not evaluated again on the
  corrected sample: one evaluation a step.

The final step is first order with no further correction; e^{-h} is
formed algebraically so that sigma_next = 0 gives x_next = m exactly.
The state holds tensors for the x0 history and the last sample, float32
numpy scalars for the lambda steps and a Python int count: every branch
is taken on the host, every coefficient is a float32 computed there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ddpm import DDPMSchedule
from .dpm import _ONE, _TINY, _coeffs, _nonzero


def init_state() -> Dict:
    return {"m0": None, "m1": None, "last_sample": None,
            "h_last": np.float32(0.0), "h_prev": np.float32(0.0), "count": 0}


def _correct(state, m_t, alpha_t, sigma_t):
    """uni_c, bh2: the last transition (t0 -> t, step h_c) solved again with
    the evaluation m_t at its arrival point (rk = 1)."""
    h = state["h_last"]
    u = np.expm1(-h)
    # sigma at the departure point: lambda_t0 = lambda_t - h
    lam_t0 = np.log(alpha_t / max(sigma_t, _TINY)) - h
    sigma_t0 = _ONE / np.sqrt(_ONE + np.exp(np.float32(2.0) * lam_t0))
    rk_prev = -state["h_prev"] / _nonzero(h)
    m0 = state["m0"]
    d1_t = m_t - m0
    if state["count"] > 1:  # order 2: [[1, 1], [rk_prev, 1]] rho = [b1, b2]
        hh = -h
        h_phi_2 = u / hh - _ONE
        h_phi_3 = h_phi_2 / hh - np.float32(0.5)
        b1 = h_phi_2 / _nonzero(u)
        b2 = h_phi_3 * np.float32(2.0) / _nonzero(u)
        det = _ONE - rk_prev
        det = det if abs(det) >= 1e-12 else _ONE
        rho1, rho2 = (b1 - b2) / det, (b2 - rk_prev * b1) / det
        d1_prev = (state["m1"] - m0) / float(_nonzero(rk_prev))
        corr = float(rho1) * d1_prev + float(rho2) * d1_t
    else:  # order 1
        corr = 0.5 * d1_t
    base = float(sigma_t / max(sigma_t0, _TINY)) * state["last_sample"] \
        - float(alpha_t * u) * m0
    return base - float(alpha_t * u) * corr


def step(schedule: DDPMSchedule, t: int, latents: torch.Tensor, eps: torch.Tensor,
         state: Dict, *, prev_t: int) -> Tuple[torch.Tensor, Dict]:
    """One UniPC step: correct the arrival at ``t`` (once history exists),
    then predict the sample at the next timestep.  ``eps`` is the model at
    the uncorrected ``latents``."""
    alpha_t, sigma_t, alpha_n, sigma_n, h, exp_neg_h = _coeffs(schedule, t, prev_t)
    u = exp_neg_h - _ONE  # expm1(-h), algebraic in the schedule
    x = latents.float()
    m_t = (x - float(sigma_t) * eps.float()) / float(alpha_t)
    if state["count"] > 0:
        x = _correct(state, m_t, alpha_t, sigma_t)

    final = prev_t < 0
    x_next = float(sigma_n / max(sigma_t, _TINY)) * x - float(alpha_n * u) * m_t
    if state["count"] > 0 and not final:
        rk = -state["h_last"] / _nonzero(h)
        rho_p = (u / (-h) - _ONE) / _nonzero(u)
        d1 = (state["m0"] - m_t) / float(_nonzero(rk))
        x_next = x_next - float(alpha_n * u * rho_p) * d1
    new_state = {"m0": m_t, "m1": state["m0"], "last_sample": x,
                 "h_last": state["h_last"] if final else h,
                 "h_prev": state["h_prev"] if final else state["h_last"],
                 "count": state["count"] + 1}
    return x_next.to(latents.dtype), new_state
