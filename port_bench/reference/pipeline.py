"""The plain reference of a request: prompts to uint8 images, in float32.

Written from the published descriptions and the program's documented
contracts, importing nothing of the program:

* the noise schedule: scaled-linear betas, alpha-bar as their cumulative
  product (float64);
* the timestep grids: "uniform", (arange(n) * (T // n)) descending;
  "karras", the Karras et al. (2022) sigma ramp (rho 7) over the
  schedule's sigma range, each sigma taken to the training timestep
  nearest in log-sigma and the grid made strictly descending;
* the samplers: the ancestral DDPM step (posterior mean from the
  predicted x0, variance clamped at 1e-20, no noise on the final step)
  and DPM-Solver++(2M) in data-prediction form (Lu et al. 2022, its
  first and final steps first order);
* classifier-free guidance eps_u + s (eps_c - eps_u);
* img2img: start at step n - int(n * strength), the latents noised to
  that step's timestep;
* the latent upscale of the hires fix: bilinear with half-pixel centres
  (for an upscale, jax.image.resize equals torch's bilinear interpolate
  without corner alignment);
* the seed-to-noise contract of the program's named streams: sample i's
  draw of stream ``name`` (at step s) comes from a CPU torch generator
  seeded with the first 8 bytes (little endian) of
  sha256(f"{seed}/{tag}/{i}/{s or -1}"), tag the first 4 bytes of
  sha256(name); 'latent_init' once a sample, 'sampler' once a sample and
  step.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref


# ---------------------------------------------------------------- the noise
def _tag(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def stream_normal(seed: int, name: str, index: int, shape: Sequence[int],
                  step: Optional[int] = None) -> torch.Tensor:
    msg = f"{int(seed)}/{_tag(name)}/{int(index)}/{-1 if step is None else int(step)}"
    g = torch.Generator(device="cpu")
    g.manual_seed(int.from_bytes(hashlib.sha256(msg.encode()).digest()[:8], "little"))
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


# ------------------------------------------------------- schedule and grids
def alphas_cumprod(model: dict) -> np.ndarray:
    betas = np.linspace(model["linear_start"] ** 0.5, model["linear_end"] ** 0.5,
                        model["timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def timesteps(abar: np.ndarray, spacing: str, n: int) -> List[int]:
    big_t = len(abar)
    if spacing == "uniform":
        return [int(t) for t in (np.arange(n) * (big_t // n)).round()[::-1]]
    if spacing != "karras":
        raise ValueError(f"the reference has no {spacing!r} grid")
    sig_all = np.sqrt((1.0 - abar) / abar)
    s_min, s_max = sig_all[0], sig_all[-1]
    ramp = np.linspace(0.0, 1.0, n)
    sigmas = (s_max ** (1 / 7) + ramp * (s_min ** (1 / 7) - s_max ** (1 / 7))) ** 7
    log_all = np.log(sig_all)
    ts = [int(np.abs(log_all - np.log(s)).argmin()) for s in sigmas]
    prev = big_t
    for i, t in enumerate(ts):  # strictly descending from the top ...
        ts[i] = prev = min(t, prev - 1)
    ts[-1] = max(ts[-1], 0)
    for i in range(len(ts) - 2, -1, -1):  # ... and lifted off the bottom
        ts[i] = max(ts[i], ts[i + 1] + 1)
    return ts


def _abar(abar: np.ndarray, t: int) -> float:
    return 1.0 if t < 0 else float(abar[t])


# ---------------------------------------------------------------- samplers
def ddpm_step(abar, t: int, prev: int, x, eps, noise):
    a_t, a_p = _abar(abar, t), _abar(abar, prev)
    beta = 1.0 - a_t / a_p
    x0 = (x - (1.0 - a_t) ** 0.5 * eps) / a_t ** 0.5
    mean = (a_p ** 0.5 * beta / (1.0 - a_t)) * x0 \
        + ((1.0 - beta) ** 0.5 * (1.0 - a_p) / (1.0 - a_t)) * x
    if prev < 0:
        return mean
    var = max((1.0 - a_p) / (1.0 - a_t) * beta, 1e-20)
    return mean + var ** 0.5 * noise


def dpmpp_2m_step(abar, t: int, prev: int, x, eps, state: Dict):
    a_t, a_p = _abar(abar, t), _abar(abar, prev)
    alpha_t, sigma_t = a_t ** 0.5, (1.0 - a_t) ** 0.5
    alpha_p, sigma_p = a_p ** 0.5, (1.0 - a_p) ** 0.5
    lam_t = np.log(alpha_t / max(sigma_t, 1e-20))
    lam_p = np.log(alpha_p / max(sigma_p, 1e-20))
    h = lam_p - lam_t
    x0 = (x - sigma_t * eps) / alpha_t
    final = prev < 0
    d = x0
    if state.get("x0") is not None and not final:
        r = state["h"] / h
        d = x0 + (1.0 / (2.0 * r)) * (x0 - state["x0"])
    exp_neg_h = (alpha_t * sigma_p) / (sigma_t * alpha_p)
    x_next = (sigma_p / max(sigma_t, 1e-20)) * x - alpha_p * (exp_neg_h - 1.0) * d
    state["x0"] = x0
    if not final:
        state["h"] = h
    return x_next


# ---------------------------------------------------------------- requests
def token_ids(vocab: Dict[str, int], prompt: str, length: int) -> List[int]:
    """sot, one id a word (every word of the benchmark's vocabulary is one
    merged token), eot, padded with eot and cut to ``length``."""
    sot, eot = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    ids = [vocab[w + "</w>"] for w in prompt.split()][:length - 2]
    return ([sot] + ids + [eot] + [eot] * length)[:length]


class Reference:
    """The models of one configuration over the benchmark's checkpoint."""

    def __init__(self, model: dict, tensors: Dict[str, torch.Tensor], vocab: Dict[str, int],
                 device):
        self.model, self.vocab, self.device = model, vocab, device
        self.w = ref.Weights(tensors, device)
        self.abar = alphas_cumprod(model)

    def _conditioning(self, prompt: str, uncond: str, height: int, width: int):
        length = self.model["text_encoders"][0]["context_length"]
        tokens = torch.tensor([token_ids(self.vocab, prompt, length),
                               token_ids(self.vocab, uncond, length)], device=self.device)
        return ref.encode_prompts(self.w, self.model, tokens,
                                  (height, width, 0, 0, height, width))

    def denoise(self, *, prompt: str, uncond: str, seed: int, index: int, height: int,
                width: int, sampler: str, steps: int, spacing: str, cfg_scale: float,
                init_latents: Optional[torch.Tensor] = None,
                strength: float = 1.0) -> torch.Tensor:
        """The final latents (1, 4, h, w) of sample ``index`` of a request."""
        u = self.model["unet_config"]
        f = 2 ** (len(self.model["first_stage_config"]["ch_mult"]) - 1)
        shape = (u["in_channels"], height // f, width // f)
        ctx, add = self._conditioning(prompt, uncond, height, width)
        grid = timesteps(self.abar, spacing, steps)
        start = steps - int(steps * strength) if init_latents is not None else 0
        noise = stream_normal(seed, "latent_init", index, shape)[None].to(self.device)
        if init_latents is None:
            x = noise
        else:
            a = float(self.abar[grid[start]])
            x = a ** 0.5 * init_latents + (1.0 - a) ** 0.5 * noise
        state: Dict = {}
        for i in range(start, steps):
            t, prev = grid[i], grid[i + 1] if i + 1 < steps else -1
            out = ref.unet(self.w, u, torch.cat([x, x]), t, ctx, add)
            eps_c, eps_u = out.chunk(2)
            eps = eps_u + cfg_scale * (eps_c - eps_u)
            if sampler == "ddpm":
                z = stream_normal(seed, "sampler", index, shape, step=i)[None].to(self.device)
                x = ddpm_step(self.abar, t, prev, x, eps, z)
            elif sampler == "dpm++":
                x = dpmpp_2m_step(self.abar, t, prev, x, eps, state)
            else:
                raise ValueError(f"the reference has no {sampler!r} sampler")
        return x

    def image(self, latents: torch.Tensor) -> torch.Tensor:
        """uint8 (H, W, 3) of latents (1, 4, h, w)."""
        return ref.to_uint8(ref.decode(self.w, self.model, latents))[0]

    def txt2img(self, **kw) -> torch.Tensor:
        return self.image(self.denoise(**kw))

    def hires_fix(self, *, height: int, width: int, base_height: int, base_width: int,
                  strength: float, **kw) -> torch.Tensor:
        lat = self.denoise(height=base_height, width=base_width, **kw)
        f = 2 ** (len(self.model["first_stage_config"]["ch_mult"]) - 1)
        up = F.interpolate(lat, size=(height // f, width // f), mode="bilinear",
                           align_corners=False)
        return self.image(self.denoise(height=height, width=width, init_latents=up,
                                       strength=strength, **kw))
