"""Restart sampler (Xu et al. 2023, "Restart Sampling for Improving
Generative Processes"; A1111's "Restart"; port of ``sampling/restart.py``).

Deterministic Heun integration with noise "restarts": once the trajectory
reaches the restart interval's lower sigma (~0.1), noise is injected to
climb back to the upper sigma (~2.0) and a short Karras segment is
integrated again, ``restart_times`` over.  The restart segments replace
part of the main budget (A1111's accounting): the main grid gets
``n_steps - restart_steps * restart_times`` Karras steps.

:func:`build_plan` precomputes the flat op list on the host in float64
numpy (the state timestep entering each op, the op's start and end
timesteps, the sigma-space variance of the noise injected before it), so
the loop is one pass over ops of two model evaluations each (Heun's
predictor and corrector; the last op's corrector is evaluated and then
discarded, as in the JAX package).  Sigmas are quantized to the nearest
training timestep in log-sigma, like ``ddpm.karras_timesteps``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import euler
from .ddpm import (DDPMSchedule, _sigmas_to_timesteps, karras_timesteps,
                   sigmas_all as _sigma_all)

#: the paper/A1111 default restart interval (sigma space)
SIGMA_MIN_RESTART = 0.1
SIGMA_MAX_RESTART = 2.0


def _karras_between(sigmas_all, s_hi: float, s_lo: float, n: int,
                    rho: float = 7.0) -> np.ndarray:
    """n-step Karras grid from s_hi down to s_lo, quantized to training
    timesteps (descending ints)."""
    ramp = np.linspace(0.0, 1.0, n + 1)
    inv = 1.0 / rho
    sig = (s_hi**inv + ramp * (s_lo**inv - s_hi**inv)) ** rho
    return _sigmas_to_timesteps(sigmas_all, sig)


def build_plan(schedule: DDPMSchedule, n_steps: int):
    """-> dict of np arrays describing the op list:

    ``t_prev``  (n_ops,) state timestep entering the op
    ``t_start`` (n_ops,) op integrates from here ...
    ``t_end``   (n_ops,) ... to here (-1 past the schedule end)
    ``rvar``    (n_ops,) sigma-space variance of the re-noise injected
                before the op (0 for plain continuation)
    ``op_start`` (n_steps,) img2img entry: first op for a denoise that
                begins at strength-step k (proportional map onto the
                reduced main grid)
    """
    sig_all = _sigma_all(schedule)
    if n_steps >= 36:
        r_steps, r_times = n_steps // 4, 2
    elif n_steps >= 20:
        r_steps, r_times = 9, 1
    else:  # too few steps: plain Heun on the Karras grid (A1111's rule)
        r_steps, r_times = 0, 0
    m = n_steps - r_steps * r_times
    main = karras_timesteps(schedule, m)
    sig_main = sig_all[main]

    pairs = []  # (t_start, t_end)
    op_of_main = []  # op index of each main-grid step (for img2img entry)
    restart_at = None
    if r_steps:
        # the main-grid index whose sigma is nearest the restart floor
        restart_at = int(np.argmin(np.abs(sig_main - SIGMA_MIN_RESTART)))
    for i in range(m):
        t_end = int(main[i + 1]) if i + 1 < m else -1
        op_of_main.append(len(pairs))
        pairs.append((int(main[i]), t_end))
        if restart_at is not None and i + 1 == restart_at:
            s_lo = float(sig_main[restart_at])
            s_hi = min(SIGMA_MAX_RESTART, float(sig_main[0]))
            seg = _karras_between(sig_all, s_hi, s_lo, r_steps)
            for _ in range(r_times):
                for j in range(len(seg) - 1):
                    pairs.append((int(seg[j]), int(seg[j + 1])))

    n_ops = len(pairs)
    t_start = np.asarray([p[0] for p in pairs], np.int32)
    t_end = np.asarray([p[1] for p in pairs], np.int32)
    t_prev = np.empty(n_ops, np.int32)
    t_prev[0] = t_start[0]
    t_prev[1:] = t_end[:-1]
    sig_of = lambda t: np.where(t >= 0, sig_all[np.maximum(t, 0)], 0.0)
    rvar = np.maximum(sig_of(t_start) ** 2 - sig_of(t_prev) ** 2,
                      0.0).astype(np.float32)

    # img2img: strength-step k of n_steps -> proportional main-grid index
    # -> its op position (ops before it, incl. earlier restarts, skipped)
    op_start = np.asarray(
        [op_of_main[min(int(round(k * m / n_steps)), m - 1)]
         for k in range(n_steps)], np.int32)
    # the timestep the state must be noised to when ENTERING op_start[k]
    # (img2img add_noise target — the restart main grid, not the
    # pipeline's n_steps grid)
    start_t = t_prev[op_start]
    return {"t_prev": t_prev, "t_start": t_start, "t_end": t_end,
            "rvar": rvar, "op_start": op_start, "start_t": start_t,
            "n_ops": n_ops}


def run_op(schedule: DDPMSchedule, plan: dict, i: int, latents: torch.Tensor,
           noise: torch.Tensor, eval_eps) -> torch.Tensor:
    """Op ``i`` of ``plan``: inject its re-noise (variance ``rvar``, in
    sigma space), then one Heun step from ``t_start`` to ``t_end``.
    ``eval_eps(latents, t)`` is the model's epsilon at a Python-int
    timestep; it is called twice."""
    tp, ts, te = (int(plan[k][i]) for k in ("t_prev", "t_start", "t_end"))
    abar = schedule.alphas_cumprod
    x_k = latents.float() / float(np.sqrt(abar[tp])) \
        + noise.float() * float(np.sqrt(plan["rvar"][i]))
    lat = float(np.sqrt(abar[ts])) * x_k
    eps = eval_eps(lat, ts)
    pred = euler.step(schedule, ts, lat, eps, prev_t=te)
    eps2 = eval_eps(pred, max(te, 0))
    return euler.step_heun_correct(schedule, ts, lat, eps, eps2,
                                   prev_t=te)
