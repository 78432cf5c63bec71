"""DPM adaptive (k-diffusion ``sample_dpm_adaptive`` /
``DPMSolver.dpm_solver_adaptive``; A1111's "DPM adaptive"; port of
``sampling/dpm_adaptive.py``).

An adaptive-step exponential integrator in t-space (t = -log sigma): each
iteration takes an order-2 and an order-3 step over the proposed interval
(3 model evaluations, shared), estimates the local error from their
difference, and a PID controller (k-diffusion ``PIDStepSizeController``:
P=0, I=1, D=0 with the ``1 + atan(x - 1)`` limiter) accepts or rejects the
step and rescales h.  The state rides in Karras space (X = x sqrt(1 +
sigma^2) of the VP latent); only the UNet's conditioning timestep is
quantized, to the nearest training index.  ``max_iters`` (the pipeline's
``n_inference_steps``) bounds the loop.

The JAX package runs the loop as one ``lax.while_loop``.  Here its
predicate ("not yet at sigma_min and under ``max_iters``") and the
accept/reject decision are taken on the host: each iteration reads the
error norm back from the device once (``.item()``), the one host sync of
the port's denoise loops, once per 3 UNet evaluations.  The scalars (s,
h, the controller's history, every coefficient) are float32 numpy, the
latents float32 tensors.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..core import mesh as mesh_mod

from .ddpm import DDPMSchedule, sigmas_all

_F = np.float32

#: k-diffusion ``sample_dpm_adaptive``'s defaults, as A1111 runs it: the
#: error tolerances, the first step in t, the controller's accept threshold
#: (eta 1, s_noise 1 and the PID coefficients P 0, I 1, D 0 are written
#: into :func:`sample`)
RTOL, ATOL = 0.05, 0.0078
H_INIT = _F(0.05)
ACCEPT_SAFETY = 0.81


def _interp(x, xp: np.ndarray, fp: np.ndarray):
    """``jnp.interp`` in float32 (the JAX package's arithmetic)."""
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    dx = xp[i] - xp[i - 1]
    if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
        f = fp[i - 1]
    else:
        f = fp[i - 1] + ((x - xp[i - 1]) / dx) * (fp[i] - fp[i - 1])
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    return f


def sample(schedule: DDPMSchedule, x_vp: torch.Tensor, t_entry: int, eval_eps,
           noises: torch.Tensor, *, max_iters: int) -> Tuple[torch.Tensor, List]:
    """Integrate ``x_vp`` (VP latents at training timestep ``t_entry``) down
    to sigma_min.

    ``eval_eps(x_vp, t)`` -> the model's epsilon at a Python-int training
    timestep; ``noises``: (max_iters, ...) ancestral noise, indexed by
    iteration.  Returns (VP latents at the exit sigma, the controller's
    factor of every iteration): iteration k was accepted iff
    ``factors[k] >= ACCEPT_SAFETY``, and ``len(factors)`` is the iteration
    count (3 model evaluations each)."""
    sig_all = sigmas_all(schedule)
    log_sig = np.log(sig_all).astype(np.float32)  # ascending in t
    idx_all = np.arange(len(sig_all), dtype=np.float32)
    t_end_py = float(-np.log(sig_all[0]))  # the sigma_min boundary
    t_end, t_stop = _F(t_end_py), _F(t_end_py - 1e-5)

    # the I-controller's exponent: icoeff 1 over k-diffusion's effective
    # order 1.5 of an ancestral (eta > 0) solve
    b1 = _F(1.0 / 1.5)
    one, tiny = _F(1.0), _F(1e-20)
    r1, r2 = _F(1.0 / 3.0), _F(2.0 / 3.0)

    def sigma(tt):
        return np.exp(-tt)

    def cond_idx(tt) -> int:
        c = _interp(-tt, log_sig, idx_all)
        return int(np.clip(np.round(c), 0, len(sig_all) - 1))

    def eval_at(x, tt):
        """eps at the Karras-space state ``x`` whose noise level is ``tt``."""
        sig = sigma(tt)
        return eval_eps(x / float(np.sqrt(one + sig * sig)), cond_idx(tt)).float()

    abar_e = schedule.alphas_cumprod[int(t_entry)]
    sig_e = np.sqrt((one - abar_e) / abar_e)
    s = -np.log(max(sig_e, tiny))
    x = x_vp.float() * float(np.sqrt(one + sig_e * sig_e))
    x_prev = x
    h = H_INIT
    factors = []
    while s < t_stop and len(factors) < max_iters:
        it = len(factors)
        t = min(t_end, s + h)
        sig_s, sig_t = sigma(s), sigma(t)
        # k-diffusion get_ancestral_step (eta 1), then the lowered endpoint
        var_up = sig_t**2 * max(sig_s**2 - sig_t**2, _F(0.0)) / max(sig_s**2, tiny)
        sd = np.sqrt(max(sig_t**2 - var_up, tiny))
        t_ = min(t_end, -np.log(sd))
        su = np.sqrt(max(sig_t**2 - sigma(t_) ** 2, _F(0.0)))
        h_ = max(t_ - s, _F(1e-8))
        s1, s2 = s + r1 * h_, s + r2 * h_
        e_h = np.expm1(h_)
        eps0 = eval_at(x, s)
        u1 = x - float(sigma(s1) * np.expm1(r1 * h_)) * eps0
        eps1 = eval_at(u1, s1)
        x_low = x - float(sigma(t_) * e_h) * eps0 \
            - float(sigma(t_) / (_F(2.0) * r1) * e_h) * (eps1 - eps0)
        u2 = x - float(sigma(s2) * np.expm1(r2 * h_)) * eps0 \
            - float(sigma(s2) * (r2 / r1) * (np.expm1(r2 * h_) / (r2 * h_) - one)) \
            * (eps1 - eps0)
        eps2 = eval_at(u2, s2)
        x_high = x - float(sigma(t_) * e_h) * eps0 \
            - float(sigma(t_) / r2 * (e_h / h_ - one)) * (eps2 - eps0)

        delta = torch.clamp(RTOL * torch.maximum(x_low.abs(), x_prev.abs()), min=ATOL)
        rel = (x_low - x_high) / delta
        groups = mesh_mod.batch_groups()
        if groups:  # one norm over the whole batch: the data ranks add their parts
            n_all = rel.numel() * math.prod(torch.distributed.get_world_size(g)
                                            for g in groups)
            norm = torch.sqrt(mesh_mod.all_reduce_sum(rel.float().square().sum(), groups))
        else:
            n_all, norm = rel.numel(), torch.linalg.vector_norm(rel)
        err = _F((norm / math.sqrt(n_all)).item())  # the iteration's host sync
        factor = (one / (err + _F(1e-8))) ** b1
        factor = one + np.arctan(factor - one)
        factors.append(factor)
        if factor >= ACCEPT_SAFETY:
            x = x_high + float(su) * noises[it].float()
            x_prev, s = x_low, t
        h = h * factor
    sig_fin = sigma(s)
    return x / float(np.sqrt(one + sig_fin * sig_fin)), factors
