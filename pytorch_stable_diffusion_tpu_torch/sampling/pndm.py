"""PLMS sampler (Liu et al. 2022, pseudo linear multistep; port of
``sampling/pndm.py``), in the CompVis convention (skip_prk_steps): an
Adams-Bashforth multistep over eps on top of the DDIM transfer formula,
with a trapezoidal warm-up of two evaluations in place of Runge-Kutta.

Evaluation schedule over the descending grid g[s..n-1] from start step s
(n + 1 - s model evaluations):

  j=0: eval at g_s, step x(g_s) -> temp x(g_{s+1}) with raw eps (x(g_s) kept)
  j=1: eval the temp at g_{s+1}, average the two eps, redo g_s -> g_{s+1}
       from the kept sample (trapezoidal corrector; this eps is not stored)
  j>=2: eval at g[s+j-1], Adams-Bashforth over the last k stored eps
       (newest first): k=2 (3, -1)/2, k=3 (23, -16, 5)/12,
       k>=4 (55, -59, 37, -9)/24.

Transfer (the PNDM phi, algebraically DDIM eta 0):
  x_prev = sqrt(a_prev/a_t) x - (a_prev - a_t) eps
           / (a_t sqrt(1 - a_prev) + sqrt(a_t (1 - a_t) a_prev)).

The eps history is a list of tensors, the branch and the coefficients
are chosen on the host.  Grid indices past the end are clamped to the
last entry, as the JAX package's gathers clamp them.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .ddpm import DDPMSchedule, _alpha_bar_prev

#: Adams-Bashforth weights, newest first; row = warm-up case
#:   0: j==1 trapezoid, 1: k==1 raw, 2: k==2, 3: k==3, 4: k>=4
_AB = np.asarray([
    [0.5, 0.5, 0.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [1.5, -0.5, 0.0, 0.0],
    [23 / 12, -16 / 12, 5 / 12, 0.0],
    [55 / 24, -59 / 24, 37 / 24, -9 / 24],
], np.float32)


def init_state() -> Dict:
    return {"ets": [], "cur_sample": None}


def combine_eps(state: Dict, eps: torch.Tensor, j: int) -> Tuple[torch.Tensor, Dict]:
    """Fold ``eps`` into the history and return this step's combined eps;
    the corrector's evaluation (j == 1) is not stored."""
    stacked = [eps.float()] + state["ets"][:3]
    ets = stacked if j != 1 else state["ets"]
    case = 0 if j == 1 else min(max(len(ets), 1), 4)
    combined = None
    for w, e in zip(_AB[case], stacked):
        if w != 0:
            combined = float(w) * e if combined is None else combined + float(w) * e
    return combined, {**state, "ets": ets}


def transfer(schedule: DDPMSchedule, t: int, prev_t: int, sample: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """Move ``sample`` from ``t`` to ``prev_t`` (< 0: to x0)."""
    one = np.float32(1.0)
    a_t = schedule.alphas_cumprod[int(t)]
    a_p = _alpha_bar_prev(schedule, int(prev_t))
    denom = a_t * np.sqrt(one - a_p) + np.sqrt(a_t * (one - a_t) * a_p)
    return float(np.sqrt(a_p / a_t)) * sample.float() \
        - float((a_p - a_t) / denom) * eps.float()


def _at(grid: Sequence[int], k: int) -> int:
    return int(grid[min(max(k, 0), len(grid) - 1)])


def step(schedule: DDPMSchedule, timesteps, prev_timesteps, i: int, start_step: int,
         latents: torch.Tensor, eps: torch.Tensor, state: Dict, *,
         n_steps: int) -> Tuple[torch.Tensor, Dict]:
    """One PLMS iteration; ``i`` runs start_step .. n_steps inclusive.  The
    model's evaluation is at grid index ``eval_index(i, start_step)``."""
    del n_steps  # the grids carry it
    j = i - start_step
    te = eval_index(i, start_step)
    eps_c, state = combine_eps(state, eps, j)
    if j == 1:  # redo g_s -> g_{s+1} from the kept sample
        out = transfer(schedule, _at(timesteps, te - 1), _at(timesteps, te),
                       state["cur_sample"], eps_c)
    else:
        out = transfer(schedule, _at(timesteps, te), _at(prev_timesteps, te),
                       latents, eps_c)
    if j == 0:
        state = {**state, "cur_sample": latents.float()}
    return out.to(latents.dtype), state


def eval_index(i: int, start_step: int) -> int:
    """Grid index of the model's evaluation in iteration ``i``: g_s,
    g_{s+1}, g_{s+1}, g_{s+2}, ... (the corrector evaluates g_{s+1} again)."""
    return i - int(i - start_step >= 2)
