"""DDPM schedule, timestep grids and sampler (port of ``sampling/ddpm.py``).

* scaled-linear betas: linspace(beta_start**0.5, beta_end**0.5, T)**2;
  alpha-bar via cumprod (float64, stored float32); ``zero_terminal_snr``
  rescales them so SNR(T) == 0 (Lin et al. 2024, alg. 1), with the
  terminal alpha-bar pinned at 2^-24.
* beta_start: the reference's default is the typo 0.000085
  (:data:`REFERENCE_BETA_START`); the default here is the CompVis value
  0.00085, and ``reference_quirks`` selects the typo.
* inference subsampling ("uniform"): (arange(n) * (T // n)).round()[::-1];
  the other ``timestep_spacing`` grids ("trailing", "karras",
  "exponential", "sgm_uniform", "kl_optimal", "ays", "beta") are built
  here too, the sigma-space ones quantized to the nearest training
  timestep in log-sigma and forced strictly descending.  The grids work in
  float64 numpy, as the JAX package's do; ``beta_timesteps`` imports
  scipy when it is called.
* ancestral step: predict x0, DDPM posterior mean, variance clamped
  >= 1e-20, no noise once prev_t < 0.
* img2img strength: start at step n - int(n * strength).

The schedule lives on the host as float32 numpy; ``step`` and
``add_noise`` take Python-int timesteps and compute their coefficients in
float32 on the host, so the denoise loop never waits on the device.
Latent math is float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: CompVis SD-1.x linear_start — the value the checkpoints were trained with.
BETA_START = 0.00085
#: The reference's typo'd default (one zero too many); reference_quirks only.
REFERENCE_BETA_START = 0.000085


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: np.ndarray           # (T,) float32
    alphas_cumprod: np.ndarray  # (T,) float32
    num_train_timesteps: int


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale a beta schedule so SNR(T) == 0 exactly: shift sqrt(alpha_bar)
    so that its terminal value is 0, rescale it so that the initial value
    is kept, recover the betas."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - aT) * (a0 / (a0 - aT))
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = BETA_START,
                  beta_end: float = 0.012,
                  zero_terminal_snr: bool = False) -> DDPMSchedule:
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    if zero_terminal_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    if zero_terminal_snr:
        # exactly 0 would blow up every eps -> x0 form at t = T-1
        alphas_cumprod[-1] = 2.0**-24
    return DDPMSchedule(betas=betas.astype(np.float32),
                        alphas_cumprod=alphas_cumprod.astype(np.float32),
                        num_train_timesteps=num_train_timesteps)


def inference_timesteps(num_inference_steps: int,
                        num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending int32 timesteps."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].copy()
    return ts.astype(np.int32)


def trailing_timesteps(num_inference_steps: int,
                       num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending int32 timesteps ending exactly at T-1 ("trailing")."""
    ratio = num_train_timesteps / num_inference_steps
    ts = np.round(np.arange(num_train_timesteps, 0, -ratio)) - 1
    return ts.astype(np.int32)


def sigmas_all(schedule: DDPMSchedule) -> np.ndarray:
    """Karras sigma at every training timestep (ascending in t), float64:
    sigma_t = sqrt((1 - abar_t) / abar_t)."""
    abar = np.asarray(schedule.alphas_cumprod, np.float64)
    return np.sqrt((1.0 - abar) / abar)


def karras_timesteps(schedule: DDPMSchedule, num_inference_steps: int,
                     rho: float = 7.0) -> np.ndarray:
    """Descending int32 timesteps on the Karras et al. 2022 sigma grid over
    the schedule's own sigma range."""
    sig_all = sigmas_all(schedule)
    s_min, s_max = sig_all[0], sig_all[-1]
    ramp = np.linspace(0.0, 1.0, num_inference_steps)
    inv = 1.0 / rho
    sigmas = (s_max**inv + ramp * (s_min**inv - s_max**inv)) ** rho
    return _sigmas_to_timesteps(sig_all, sigmas)


def exponential_timesteps(schedule: DDPMSchedule, num_inference_steps: int,
                          rho: float = 1.0) -> np.ndarray:
    """Descending int32 timesteps, log-sigma uniform from sigma_max to
    sigma_min (``rho != 1``: the polyexponential ramp)."""
    sig_all = sigmas_all(schedule)
    s_min, s_max = sig_all[0], sig_all[-1]
    ramp = np.linspace(1.0, 0.0, num_inference_steps) ** rho
    sigmas = np.exp(np.log(s_min) + ramp * (np.log(s_max) - np.log(s_min)))
    return _sigmas_to_timesteps(sig_all, sigmas)


def sgm_uniform_timesteps(num_inference_steps: int,
                          num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending int32 timesteps: ``linspace(T-1, 0, n+1)`` without its
    last point, rounded and forced strictly descending."""
    ts = np.round(np.linspace(num_train_timesteps - 1, 0.0,
                              num_inference_steps + 1))[:-1].astype(np.int64)
    for i in range(1, len(ts)):
        ts[i] = min(ts[i], ts[i - 1] - 1)
    return np.clip(ts, 0, None).astype(np.int32)


def kl_optimal_timesteps(schedule: DDPMSchedule,
                         num_inference_steps: int) -> np.ndarray:
    """Descending int32 timesteps on the KL-optimal sigma grid:
    sigma_i = tan(lerp(atan(s_max), atan(s_min)))."""
    sig_all = sigmas_all(schedule)
    s_min, s_max = sig_all[0], sig_all[-1]
    ramp = np.linspace(0.0, 1.0, num_inference_steps)
    sigmas = np.tan(ramp * np.arctan(s_min) + (1.0 - ramp) * np.arctan(s_max))
    return _sigmas_to_timesteps(sig_all, sigmas)


#: the published Align-Your-Steps 10-step sigma tables (Sabour et al. 2024)
AYS_SIGMAS_SD = (14.615, 6.475, 3.861, 2.697, 1.886,
                 1.396, 0.963, 0.652, 0.399, 0.152)
AYS_SIGMAS_SDXL = (14.615, 6.315, 3.771, 2.181, 1.342,
                   0.862, 0.555, 0.380, 0.234, 0.113)


def ays_timesteps(schedule: DDPMSchedule, num_inference_steps: int,
                  table=AYS_SIGMAS_SD) -> np.ndarray:
    """Descending int32 timesteps on the Align-Your-Steps grid: the
    10-sigma table log-linearly resampled to n steps, clipped to the
    schedule's sigma range."""
    t = np.asarray(table, np.float64)
    if num_inference_steps != len(t):
        xs = np.linspace(0.0, 1.0, len(t))
        ys = np.log(t[::-1])
        new = np.interp(np.linspace(0.0, 1.0, num_inference_steps), xs, ys)
        t = np.exp(new)[::-1].copy()
    sig_all = sigmas_all(schedule)
    sigmas = np.clip(t, sig_all[0], sig_all[-1])
    return _sigmas_to_timesteps(sig_all, sigmas)


def beta_timesteps(schedule: DDPMSchedule, num_inference_steps: int,
                   alpha: float = 0.6, beta: float = 0.6) -> np.ndarray:
    """Descending int32 timesteps with Beta-distribution spacing:
    sigma_i = s_min + ppf(1 - i/(n-1); alpha, beta) * (s_max - s_min)."""
    from scipy.stats import beta as _beta_dist

    sig_all = sigmas_all(schedule)
    s_min, s_max = sig_all[0], sig_all[-1]
    q = _beta_dist.ppf(1.0 - np.linspace(0.0, 1.0, num_inference_steps),
                       alpha, beta)
    sigmas = s_min + q * (s_max - s_min)
    return _sigmas_to_timesteps(sig_all, sigmas)


def _sigmas_to_timesteps(sigmas_all: np.ndarray,
                         sigmas: np.ndarray) -> np.ndarray:
    """Map a descending sigma grid to the nearest training timesteps in
    log-sigma, forced strictly descending (a forward pass caps each at the
    previous one - 1, a backward pass lifts the tail onto ..., 2, 1, 0)."""
    log_all = np.log(sigmas_all)
    out = [int(np.abs(log_all - np.log(s)).argmin()) for s in sigmas]
    prev = len(sigmas_all)
    for i, t in enumerate(out):
        out[i] = prev = min(t, prev - 1)
    out[-1] = max(out[-1], 0)
    for i in range(len(out) - 2, -1, -1):
        out[i] = max(out[i], out[i + 1] + 1)
    return np.asarray(out, np.int32)


def timesteps_for(schedule: DDPMSchedule, spacing: str,
                  num_inference_steps: int, *, sdxl: bool = False) -> np.ndarray:
    """The descending grid of one ``timestep_spacing`` value ("ays": the
    SDXL table for the added-conditioning families, ``sdxl``, the SD table
    for the others, as in the JAX package)."""
    n = num_inference_steps
    grids = {
        "uniform": lambda: inference_timesteps(n),
        "trailing": lambda: trailing_timesteps(n),
        "karras": lambda: karras_timesteps(schedule, n),
        "exponential": lambda: exponential_timesteps(schedule, n),
        "sgm_uniform": lambda: sgm_uniform_timesteps(n),
        "kl_optimal": lambda: kl_optimal_timesteps(schedule, n),
        "ays": lambda: ays_timesteps(schedule, n,
                                     table=AYS_SIGMAS_SDXL if sdxl else AYS_SIGMAS_SD),
        "beta": lambda: beta_timesteps(schedule, n),
    }
    if spacing not in grids:
        raise ValueError(f"unknown timestep_spacing {spacing!r}")
    return grids[spacing]()


def start_step_for_strength(num_inference_steps: int, strength: float) -> int:
    """Skip the first n*(1-strength) steps."""
    return num_inference_steps - int(num_inference_steps * strength)


def _alpha_bar_prev(schedule: DDPMSchedule, prev_t: int) -> np.float32:
    if prev_t >= 0:
        return schedule.alphas_cumprod[min(prev_t, schedule.num_train_timesteps - 1)]
    return np.float32(1.0)


def alpha_coef(schedule: DDPMSchedule, t: int):
    """(a, s) = (sqrt(abar_t), sqrt(1 - abar_t)) as host floats: the
    coefficients of :func:`to_epsilon` and of x0 = (x - s eps) / a."""
    abar = schedule.alphas_cumprod[int(t)]
    return float(np.sqrt(abar)), float(np.sqrt(np.float32(1.0) - abar))


def to_epsilon(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
               model_output: torch.Tensor, prediction_type: str = "epsilon", *, coef=None):
    """A model output as an epsilon prediction: "epsilon" passes through;
    "v" (x0 = a x - s v) gives eps = s x + a v, a = sqrt(abar_t),
    s = sqrt(1 - abar_t).  ``coef``: :func:`alpha_coef` at t, given in place
    of ``schedule`` and ``t`` (an exported program takes them as 0-d CPU
    tensors, which give the same bits)."""
    if prediction_type == "epsilon":
        return model_output
    if prediction_type != "v":
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    a, s = alpha_coef(schedule, t) if coef is None else coef
    return s * latents.float() + a * model_output.float()


def step(schedule: DDPMSchedule, t: int, latents: torch.Tensor,
         eps: torch.Tensor, noise: torch.Tensor, *, num_inference_steps: int,
         prev_t: int = None) -> torch.Tensor:
    """One ancestral DDPM step; noise is used iff prev_t >= 0."""
    t = int(t)
    if prev_t is None:  # uniform grid
        prev_t = t - schedule.num_train_timesteps // num_inference_steps
    one = np.float32(1.0)
    a_t = schedule.alphas_cumprod[t]
    a_prev = _alpha_bar_prev(schedule, int(prev_t))
    b_t = one - a_t
    b_prev = one - a_prev
    cur_alpha = a_t / a_prev
    cur_beta = one - cur_alpha
    coeff_x0 = np.sqrt(a_prev) * cur_beta / b_t
    coeff_xt = np.sqrt(cur_alpha) * b_prev / b_t
    var = max(b_prev / b_t * cur_beta, np.float32(1e-20))
    std = np.sqrt(var) if prev_t >= 0 else np.float32(0.0)

    lat = latents.float()
    x0 = (lat - float(np.sqrt(b_t)) * eps.float()) / float(np.sqrt(a_t))
    mean = float(coeff_x0) * x0 + float(coeff_xt) * lat
    if std == 0.0:
        return mean.to(latents.dtype)
    return (mean + float(std) * noise.float()).to(latents.dtype)


def add_noise(schedule: DDPMSchedule, x0: torch.Tensor, t: int,
              noise: torch.Tensor) -> torch.Tensor:
    """Forward q(x_t | x_0) at a scalar timestep."""
    a = schedule.alphas_cumprod[int(t)]
    return (float(np.sqrt(a)) * x0.float()
            + float(np.sqrt(np.float32(1.0) - a)) * noise.float()).to(x0.dtype)
