"""DPM fast (k-diffusion ``sample_dpm_fast`` via ``DPMSolver
.dpm_solver_fast``; A1111's "DPM fast"; port of ``sampling/dpm_fast.py``).

The solver splits the full training sigma range into ``m = n // 3 + 1``
segments, uniform in t-space (t = -log sigma), and runs one
exponential-integrator step a segment: order 3 for most, with the
remainder rule ``[3]*(m-2) + [2, 1]`` when ``n % 3 == 0`` else
``[3]*(m-1) + [n % 3]``; ancestral eta 1, as A1111 passes it.

Every boundary and interior evaluation point is quantized to the nearest
training timestep and every integrator coefficient is precomputed on the
host in float64 numpy (:func:`build_plan`), so the loop runs one uniform
body of 3 model evaluations a segment whatever its order: lower-order
segments zero the unused difference terms, and their extra evaluations
run, as in the JAX package.  The state stays in Karras space (X = x /
sqrt(abar)) within a segment.

Order-p update over a segment [t0, t1'] with h = t1' - t0:
    u1 = X - sigma(s1) expm1(r1 h) eps0                            (p>=2)
    u2 = X - sigma(s2) expm1(r2 h) eps0
           - sigma(s2) (r2/r1) (expm1(r2 h)/(r2 h) - 1) (eps1 - eps0) (p=3)
    X' = X - sigma(t1') expm1(h) eps0 - c1 (eps1 - eps0) - c2 (eps2 - eps0)
with the ancestral split lowering t1 to t1' and adding ``su``-scaled noise
after the step.
"""

from __future__ import annotations

import numpy as np

import torch

from .ddpm import DDPMSchedule, inference_timesteps, sigmas_all as _sigmas_all


def build_plan(schedule: DDPMSchedule, n: int) -> dict:
    """Host-precomputed per-segment tables (everything static).

    Returns dict of (m,)-arrays: quantized eval timesteps ``t0 s1 s2``,
    coefficients ``u1c u2c0 u2c1 e0c c1 c2``, noise scales ``su``, plus
    ``t_exit`` (the final boundary timestep, for the VP mapping back),
    and the img2img entry maps ``start_t`` / ``seg_start`` ((n,)-arrays
    over the pipeline's uniform step grid).  Ancestral eta is 1, A1111's
    (k-diffusion's signature default is 0, a pure ODE).
    """
    if n < 1:
        raise ValueError(f"dpm_fast needs n >= 1, got {n}")
    sig_all = np.asarray(_sigmas_all(schedule), np.float64)
    log_all = np.log(sig_all)
    t_all = -log_all  # k-diffusion t-space; increasing as sigma falls

    def q(t):
        """Quantize a t-space point to the nearest training timestep."""
        return int(np.abs(t_all - t).argmin())

    m = n // 3 + 1
    if n % 3 == 0:
        orders = [3] * (m - 2) + [2, 1] if m >= 2 else [min(n, 3)]
    else:
        orders = [3] * (m - 1) + [n % 3]
    ts = np.linspace(t_all[-1], t_all[0], m + 1)  # sigma_max -> sigma_min
    tq = np.asarray([q(t) for t in ts], np.int32)  # quantized boundaries

    cols = {k: np.zeros(m, np.float64) for k in
            ("u1c", "u2c0", "u2c1", "e0c", "c1", "c2", "su")}
    t0s = np.zeros(m, np.int32)
    s1s = np.zeros(m, np.int32)
    s2s = np.zeros(m, np.int32)
    for i, order in enumerate(orders):
        i0, i1 = int(tq[i]), int(tq[i + 1])
        sig0, sig1 = sig_all[i0], sig_all[i1]
        # k-diffusion get_ancestral_step (eta 1), then the lowered boundary
        var_up = sig1**2 * max(sig0**2 - sig1**2, 0.0) / max(sig0**2, 1e-20)
        sd = np.sqrt(max(sig1**2 - var_up, 1e-20))
        i1_ = max(q(-np.log(sd)), int(tq[-1]))  # clamp at the exit boundary
        su = np.sqrt(max(sig1**2 - sig_all[i1_] ** 2, 0.0))
        t0, t1_ = t_all[i0], t_all[i1_]
        h = max(t1_ - t0, 1e-8)
        r1 = 1.0 / 3.0 if order == 3 else 0.5
        r2 = 2.0 / 3.0
        s1 = q(t0 + r1 * h) if order >= 2 else i0
        s2 = q(t0 + r2 * h) if order == 3 else i0
        sig_n = sig_all[i1_]
        t0s[i], s1s[i], s2s[i] = i0, s1, s2
        c = cols
        c["su"][i] = su
        c["e0c"][i] = sig_n * np.expm1(h)
        if order >= 2:
            c["u1c"][i] = sig_all[s1] * np.expm1(r1 * h)
        if order == 2:
            c["c1"][i] = sig_n / (2.0 * r1) * np.expm1(h)
        if order == 3:
            c["u2c0"][i] = sig_all[s2] * np.expm1(r2 * h)
            # dimensionless phi-2 factor: k-diffusion's dpm_solver_3_step
            # has no trailing h here
            c["u2c1"][i] = sig_all[s2] * (r2 / r1) \
                * (np.expm1(r2 * h) / (r2 * h) - 1.0)
            c["c2"][i] = sig_n / r2 * (np.expm1(h) / h - 1.0)

    # img2img entry: map each uniform-grid start step to the segment
    # boundary with the nearest training timestep (the same grid the
    # pipeline noised the latents on)
    grid = np.asarray(inference_timesteps(n), np.int64)
    seg_start = np.asarray(
        [int(np.abs(tq[:-1].astype(np.int64) - g).argmin()) for g in grid],
        np.int32)
    start_t = tq[seg_start].astype(np.int32)
    return {
        "m": m,
        "t0": t0s, "s1": s1s, "s2": s2s,
        **{k: v.astype(np.float32) for k, v in cols.items()},
        "t_exit": int(tq[-1]),
        "seg_start": seg_start, "start_t": start_t,
    }


def run_segment(schedule: DDPMSchedule, plan: dict, i: int, latents: torch.Tensor,
                noise: torch.Tensor, eval_eps) -> torch.Tensor:
    """Segment ``i`` of ``plan``: VP latents at its ``t0`` -> VP latents at
    the next boundary.  ``eval_eps(latents, t)`` is the model's epsilon at
    a Python-int timestep; it is called three times."""
    abar = schedule.alphas_cumprod
    c = {k: float(plan[k][i]) for k in ("u1c", "u2c0", "u2c1", "e0c", "c1", "c2", "su")}
    t0, s1, s2 = int(plan["t0"][i]), int(plan["s1"][i]), int(plan["s2"][i])
    lat = latents.float()
    x_k = lat / float(np.sqrt(abar[t0]))
    eps0 = eval_eps(lat, t0).float()
    u1 = x_k - c["u1c"] * eps0
    eps1 = eval_eps(float(np.sqrt(abar[s1])) * u1, s1).float()
    u2 = x_k - c["u2c0"] * eps0 - c["u2c1"] * (eps1 - eps0)
    eps2 = eval_eps(float(np.sqrt(abar[s2])) * u2, s2).float()
    x_k = x_k - c["e0c"] * eps0 - c["c1"] * (eps1 - eps0) - c["c2"] * (eps2 - eps0)
    x_k = x_k + c["su"] * noise.float()
    t_next = int(plan["t0"][i + 1]) if i + 1 < plan["m"] else plan["t_exit"]
    return float(np.sqrt(abar[t_next])) * x_k
