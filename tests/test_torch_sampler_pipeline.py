"""Slice B through ``generate()``: the port's one-evaluation and multistep
samplers, with the timestep spacings, ``ddim_eta`` and
``zero_terminal_snr``, against the JAX package's ``generate()`` on the
tiny config at 32x32 pixels (K1 at the UNet's 256-token first level: the
JAX package's Pallas kernel in interpret mode, the port's plain version on
the CPU), with injected noise (``fixed_noise``); restart, dpm_fast and
dpm_adaptive, which refuse it as the JAX package does, on their own seeds;
and every sampler's count of UNet evaluations, pinned from its documented
schedule by ``chip_smoke.sampler_evals``, which also gates the card's
launch counts.  Heun, the dpm2 family and img2img are held against JAX
``generate()`` in tests/test_torch_sampler_midpoint.py: each case costs a
JAX compile, and two files let two test workers share them.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import sampler_evals  # the one copy of the evaluation-count rule
from conftest import psnr, to_nchw

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu_torch import pipeline, prompt_schedule
from pytorch_stable_diffusion_tpu_torch.models import build_models
from pytorch_stable_diffusion_tpu_torch.models.config import tiny_sd_config
from pytorch_stable_diffusion_tpu_torch.sampling import (ddpm, dpm2, dpm_adaptive, dpm_fast,
                                                         restart)
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]  # conftest.tiny_tokenizer's words
STEPS = 3
HW = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors: as fast alone,
    and under parallel test workers torch's default pool (a thread a core
    in every worker) oversubscribes the cores, which made a 20-step restart
    request at 16x16 take 64 s instead of 0.6."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tiny_models):
    cfg = tiny_sd_config(attention_backend="kernel")
    models = build_models(cfg, device="cpu",
                          state_dicts=convert.from_jax_params(tiny_models, cfg))
    r = np.random.RandomState(23)
    noise = {"latent_init": r.randn(1, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 1, 16, 16, 4).astype(np.float32),
             "encoder_noise": r.randn(1, 16, 16, 4).astype(np.float32)}
    init_image = r.randint(0, 256, size=(HW, HW, 3)).astype(np.uint8)
    return cfg, models, noise, init_image, make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)


def _nchw_noise(noise):
    out = {k: to_nchw(v) for k, v in noise.items() if k != "sampler_noise"}
    out["sampler_noise"] = np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))
    return out


def _recording(fn, returned):
    """``fn``, appending each call's (args, result) to ``returned``."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        returned.append((args, out))
        return out
    return wrapper


class _UNetSpy(torch.nn.Module):
    """Wraps the UNet and records the timestep and context of every call."""

    def __init__(self, unet):
        super().__init__()
        self.inner = unet
        self.calls = []

    def forward(self, x, context, t, *args, **kwargs):
        self.calls.append((float(t), context.clone()))
        return self.inner(x, context, t, *args, **kwargs)


# ------------------------------------------------------ against the JAX package
#: the one-evaluation and multistep samplers that take ``fixed_noise``, each
#: once; ddim also carries eta 0.5 on the zero-terminal-SNR schedule and the
#: trailing grid, euler_a the AYS grid and dpm++ the beta grid
CASES = [("ddim", {"ddim_eta": 0.5, "zero_terminal_snr": True,
                   "timestep_spacing": "trailing"}),
         ("dpm++", {"timestep_spacing": "beta"}), ("dpm++_sde", {}), ("dpm++_3m_sde", {}),
         ("euler", {}), ("euler_a", {"timestep_spacing": "ays"}), ("unipc", {}),
         ("lcm", {}), ("plms", {}), ("lms", {})]


def case_ids(cases):
    return [s + "".join(f"-{k}={v}" for k, v in o.items()) for s, o in cases]


@pytest.mark.parametrize("sampler,options", CASES, ids=case_ids(CASES))
def test_sampler_matches_jax_generate(setup, tiny_models, tiny_tokenizer, sampler, options):
    """Latents > 55 dB and the uint8 image > 40 dB against JAX ``generate()``
    on the same noise, txt2img.  Measured on the CPU (these and
    tests/test_torch_sampler_midpoint.py's): latents 116.5-130.9 dB; every
    image bit-equal to the JAX package's but lms's (83.0 dB)."""
    check_against_jax(setup, tiny_models, tiny_tokenizer, sampler, options)


def check_against_jax(setup, tiny_models, tiny_tokenizer, sampler, options):
    """One request through both packages' ``generate()`` on the same
    noise: img2img where ``options`` gives a strength, else txt2img."""
    cfg, models, noise, init_image, tok = setup
    options = dict(options)
    zero_snr = options.pop("zero_terminal_snr", False)
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=HW, width=HW, return_latents=True, sampler_name=sampler, **options)
    if "strength" in options:
        kw["input_image"] = init_image
    else:
        noise = {k: v for k, v in noise.items() if k != "encoder_noise"}
    jcfg = jconfig.tiny_sd_config(attention_backend="pallas", zero_terminal_snr=zero_snr)
    ref_img, ref_lat = jpipeline.generate("a photo of a cat", models=tiny_models,
                                          tokenizer=tiny_tokenizer, config=jcfg,
                                          fixed_noise=noise, **kw)
    img, lat = pipeline.generate("a photo of a cat", models=models, tokenizer=tok,
                                 config=dataclasses.replace(cfg, zero_terminal_snr=zero_snr),
                                 fixed_noise=_nchw_noise(noise), **kw)
    assert img.dtype == np.uint8 and img.shape == (HW, HW, 3)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


REFUSALS = [
    ("lcm", {"timestep_spacing": "karras"}, "timestep_spacing"),
    ("dpm_fast", {"timestep_spacing": "karras"}, "timestep_spacing"),
    ("dpm_adaptive", {"timestep_spacing": "trailing"}, "timestep_spacing"),
    ("restart", {"fixed_noise": True}, "fixed_noise"),
    ("dpm_fast", {"fixed_noise": True}, "fixed_noise"),
    ("dpm_adaptive", {"fixed_noise": True}, "fixed_noise"),
    ("restart", {"prompt": "a [cat:dog:1] photo"}, "prompt editing"),
    ("lcm", {"n_inference_steps": 51}, "original_steps"),
]


@pytest.mark.parametrize("sampler,options,match", REFUSALS,
                         ids=[f"{s}-{next(iter(o))}" for s, o, _ in REFUSALS])
def test_sampler_refusals_match_jax(setup, tiny_models, tiny_tokenizer, sampler, options,
                                   match):
    """The JAX package's ValueErrors for these requests, raised here too."""
    cfg, models, noise, _, tok = setup
    kw = dict(prompt="a cat", height=HW, width=HW, n_inference_steps=STEPS,
              sampler_name=sampler)
    kw.update(options)
    if kw.pop("fixed_noise", False):
        kw["fixed_noise"] = noise
    with pytest.raises(ValueError, match=match):
        jpipeline.generate(models=tiny_models, tokenizer=tiny_tokenizer,
                           config=jconfig.tiny_sd_config(), **kw)
    if "fixed_noise" in kw:
        kw["fixed_noise"] = _nchw_noise(noise)
    with pytest.raises(ValueError, match=match):
        pipeline.generate(models=models, tokenizer=tok, config=cfg, **kw)


# ---------------------------------------------------------- evaluation counts
@pytest.mark.parametrize("sampler", pipeline.SAMPLERS)
def test_unet_evaluation_counts(setup, sampler):
    """Every sampler's evaluations at 4 steps (restart and dpm_fast: also at
    20, where restart runs a restart segment), txt2img and img2img at
    strength 0.6 (start step 2).  Heun and the dpm2 family make no
    evaluation on their final step."""
    cfg, models, _, init_image, tok = setup
    for n, strength in ((4, None), (4, 0.6)) + (((20, None), (20, 0.6))
                                                 if sampler in ("restart", "dpm_fast") else ()):
        spy = _UNetSpy(models["diffusion"])
        kw = dict(models=dict(models, diffusion=spy), tokenizer=tok, config=cfg, height=16,
                  width=16, n_inference_steps=n, seed=2, sampler_name=sampler)
        start = 0
        if strength is not None:
            kw.update(input_image=init_image[:16, :16], strength=strength)
            start = ddpm.start_step_for_strength(n, strength)
        runs = []
        with mock.patch.object(dpm_adaptive, "sample", _recording(dpm_adaptive.sample, runs)):
            pipeline.generate("a cat", **kw)
        factors = runs[0][1][1] if runs else None
        iterations = len(factors) if factors is not None else None
        assert len(spy.calls) == sampler_evals(sampler, n, start, iterations), (n, strength)
        if sampler == "dpm_adaptive":
            assert 0 < len(factors) <= n


def test_evaluation_timesteps_and_contexts(setup):
    """Heun's corrector evaluates the next grid timestep with the next
    step's conditioning; plms evaluates g0, g1, g1, g2; dpm2 its midpoints
    with the step's own conditioning; prompt editing ``[cat:dog:2]`` over 3
    steps switches the context from step 2 on."""
    cfg, models, _, _, tok = setup
    ts = ddpm.inference_timesteps(STEPS)
    mids = dpm2.mid_timesteps(ddpm.make_schedule(), ts)
    want = {"heun": [(0, ts[0]), (1, ts[1]), (1, ts[1]), (2, ts[2]), (2, ts[2])],
            "plms": [(0, ts[0]), (1, ts[1]), (1, ts[1]), (2, ts[2])],
            "dpm2": [(0, ts[0]), (0, mids[0]), (1, ts[1]), (1, mids[1]), (2, ts[2])]}
    prompt = "a [cat:dog:2] photo"
    contexts = []
    for step in range(1, STEPS + 1):
        texts = [prompt_schedule.realize(prompt, step, STEPS), ""]
        tokens = torch.from_numpy(pipeline._encode_tokens(tok, texts, cfg.clip.max_len))
        with torch.inference_mode():
            contexts.append(pipeline._encode_text(models["clip"], tokens, None, cfg))
    for sampler, seq in want.items():
        spy = _UNetSpy(models["diffusion"])
        pipeline.generate(prompt, models=dict(models, diffusion=spy), tokenizer=tok,
                          config=cfg, height=16, width=16, n_inference_steps=STEPS,
                          seed=1, sampler_name=sampler)
        assert [t for t, _ in spy.calls] == [float(t) for _, t in seq], sampler
        for (_, ctx), (i, _) in zip(spy.calls, seq):
            torch.testing.assert_close(ctx, contexts[i], rtol=1e-5, atol=1e-6)


# --------------------------------------- restart, dpm_fast, dpm_adaptive
@pytest.mark.parametrize("sampler", ["restart", "dpm_fast", "dpm_adaptive"])
def test_own_grid_samplers_seeds_and_batches(setup, sampler):
    """The same seed gives the same image, another seed another; sample 0
    of a batch of two is sample 0 alone (restart, dpm_fast), its noise drawn
    per sample.  dpm_adaptive's controller takes one error norm over the
    whole batch, as the JAX package's and k-diffusion's do, so its steps,
    and with them its images, depend on the batch: checked here are its
    per-sample noise and that the batch runs."""
    cfg, models, _, _, tok = setup
    kw = dict(models=models, tokenizer=tok, config=cfg, height=HW, width=HW,
              n_inference_steps=4, sampler_name=sampler)
    a = pipeline.generate("a cat", seed=5, **kw)
    np.testing.assert_array_equal(a, pipeline.generate("a cat", seed=5, **kw))
    assert np.abs(a.astype(int) - pipeline.generate("a cat", seed=6, **kw).astype(int)).max() > 0
    draws = []
    with mock.patch.object(pipeline.rng_mod, "step_normals",
                           _recording(pipeline.rng_mod.step_normals, draws)):
        batch = pipeline.generate_images(["a cat", "a dog"], seed=5, **kw)
    assert batch.shape == (2, HW, HW, 3) and batch.dtype == np.uint8
    (seed, name, n_draws, n_samples, shape), stream = draws[0]
    assert (seed, name, n_samples) == (5, sampler, 2)
    alone = pipeline.rng_mod.step_normals(5, sampler, n_draws, 1, shape)
    torch.testing.assert_close(stream[:, :1], alone, rtol=0, atol=0)
    if sampler != "dpm_adaptive":
        assert psnr(batch[0].astype(np.float32), a.astype(np.float32)) > 40.0


@pytest.mark.parametrize("sampler", ["restart", "dpm_fast", "dpm_adaptive"])
def test_own_grid_samplers_img2img_entry(setup, sampler):
    """img2img at strength 0.6 of 20 steps noises the init latents to the
    entry of the sampler's own grid (restart's and dpm_fast's ``start_t``;
    dpm_adaptive: the uniform grid's timestep) and first evaluates there."""
    cfg, models, _, init_image, tok = setup
    n, strength = 20, 0.6
    start = ddpm.start_step_for_strength(n, strength)
    sched = ddpm.make_schedule()
    spy = _UNetSpy(models["diffusion"])
    with mock.patch.object(pipeline.ddpm, "add_noise", wraps=ddpm.add_noise) as add:
        img = pipeline.generate("a cat", models=dict(models, diffusion=spy), tokenizer=tok,
                                config=cfg, height=HW, width=HW, n_inference_steps=n,
                                seed=3, sampler_name=sampler, input_image=init_image,
                                strength=strength)
    if sampler == "restart":
        plan = restart.build_plan(sched, n)
        entry, first = plan["start_t"][start], plan["t_start"][plan["op_start"][start]]
    elif sampler == "dpm_fast":
        plan = dpm_fast.build_plan(sched, n)
        entry = first = plan["start_t"][start]
        assert first == plan["t0"][plan["seg_start"][start]]
    else:
        entry = first = ddpm.inference_timesteps(n)[start]
    assert add.call_args.args[2] == entry
    assert spy.calls[0][0] == float(first)
    assert img.shape == (HW, HW, 3) and img.max() > img.min()
