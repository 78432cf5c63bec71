"""The port's DDPM sampler, random streams and the whole slice — tiny
txt2img and img2img through ``generate()`` — against the JAX package.

The slice runs at 32x32 pixels: tiny_sd_config's VAE downsamples 2x, so
the UNet's first level attends over a 16x16 = 256-token latent and both
sides take their flash kernel K1 there (the JAX package's Pallas kernel in
interpret mode, the port's plain version on the CPU).  Noise is injected
(``fixed_noise``): torch generators cannot reproduce JAX's threefry.

The long-KV slice (what K4 and K3 carry at 2048²: the UNet's level 1 over
65536 tokens, the VAE's 1-head Dh-512 mid block) runs at the same size with
the port's ``FLASH_ONLY_KV`` lowered to 256, so that level 1 takes K4's
path, and a VAE widened to a 192-channel mid block (past K1's head dims) on
``vae_attention_backend="kernel"``, so that it takes K3's.  Spies count the
plain versions the CPU runs.  The JAX side runs its materialized ("xla")
attention there, the same function (tests/test_torch_flash_long.py holds
the plain versions to the Pallas kernels themselves).
"""

import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import psnr, to_nchw
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import clip as jclip
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import vae as jvae
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu_torch import pipeline, prompt_schedule
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.models import build_models
from pytorch_stable_diffusion_tpu_torch.models.config import tiny_sd_config, with_clip_skip
from pytorch_stable_diffusion_tpu_torch.models import unet
from pytorch_stable_diffusion_tpu_torch.ops import attention
from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa
from pytorch_stable_diffusion_tpu_torch.sampling import ddpm
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]  # conftest.tiny_tokenizer's words


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("beta_start", [ddpm.BETA_START, ddpm.REFERENCE_BETA_START])
def test_schedule_matches_jax(beta_start):
    ours = ddpm.make_schedule(beta_start=beta_start)
    ref = jddpm.make_schedule(beta_start=beta_start)
    np.testing.assert_array_equal(ours.betas, np.asarray(ref.betas))
    np.testing.assert_array_equal(ours.alphas_cumprod, np.asarray(ref.alphas_cumprod))


def test_beta_start_quirk_is_the_reference_typo():
    assert ddpm.REFERENCE_BETA_START == jddpm.REFERENCE_BETA_START == 0.000085
    assert ddpm.BETA_START == jddpm.BETA_START == 0.00085


@pytest.mark.parametrize("n", [1, 3, 50])
def test_timesteps_and_strength(n):
    np.testing.assert_array_equal(ddpm.inference_timesteps(n),
                                  jddpm.inference_timesteps(n))
    for s in (0.1, 0.5, 0.8, 1.0):
        assert ddpm.start_step_for_strength(n, s) == jddpm.start_step_for_strength(n, s)


@pytest.mark.parametrize("t", [980, 500, 20, 0])
def test_step_and_add_noise_match_jax(t):
    """fp32 step, including the last one (prev_t < 0: no noise)."""
    r = np.random.RandomState(t)
    lat, eps, noise = (r.randn(2, 4, 6, 6).astype(np.float32) for _ in range(3))
    sched = ddpm.make_schedule(beta_start=ddpm.REFERENCE_BETA_START)
    jsched = jddpm.make_schedule(beta_start=jddpm.REFERENCE_BETA_START)
    ref = np.asarray(jddpm.step(jsched, t, lat, eps, noise, num_inference_steps=50))
    got = ddpm.step(sched, t, *map(torch.from_numpy, (lat, eps, noise)),
                    num_inference_steps=50)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    ref = np.asarray(jddpm.add_noise(jsched, lat, t, noise))
    got = ddpm.add_noise(sched, torch.from_numpy(lat), t, torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------- rng
def test_rng_golden_values():
    """First values of each stream for seed 1337 — frozen: changing them
    changes every user's image for a given seed."""
    assert rng.stream_seed(1337, "latent_init") == 7160930530909627460
    got = {
        "latent_init": float(rng.batch_normal(1337, "latent_init", 1, (4,))[0, 0]),
        "encoder_noise": float(rng.batch_normal(1337, "encoder_noise", 1, (4,))[0, 0]),
        "sampler_step0": float(rng.batch_normal(1337, "sampler", 1, (4,), step=0)[0, 0]),
        "batch1": float(rng.batch_normal(1337, "latent_init", 2, (4,))[1, 0]),
    }
    expect = {"latent_init": 0.37092405557632446,
              "encoder_noise": -0.24478444457054138,
              "sampler_step0": 0.035168807953596115,
              "batch1": 0.04803993180394173}
    for k, v in expect.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_rng_streams_distinct_and_batch_invariant():
    a = rng.batch_normal(7, "latent_init", 4, (4, 8, 8))
    b = rng.batch_normal(7, "latent_init", 8, (4, 8, 8))
    torch.testing.assert_close(a, b[:4], rtol=0, atol=0)
    c = rng.batch_normal(7, "encoder_noise", 4, (4, 8, 8))
    d = rng.batch_normal(7, "sampler", 4, (4, 8, 8), step=0)
    e = rng.batch_normal(7, "sampler", 4, (4, 8, 8), step=1)
    for x in (c, d, e):
        assert (x - a).abs().max() > 0.1
    assert (d - e).abs().max() > 0.1


# -------------------------------------------------------------------- slice
STEPS = 3
HW = 32


@pytest.fixture(scope="module")
def slice_setup(tiny_models):
    cfg = tiny_sd_config(attention_backend="kernel")
    models = build_models(cfg, device="cpu", state_dicts=convert.from_jax_params(tiny_models, cfg))
    r = np.random.RandomState(11)
    noise = {"latent_init": r.randn(1, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 1, 16, 16, 4).astype(np.float32),
             "encoder_noise": r.randn(1, 16, 16, 4).astype(np.float32)}
    init_image = r.randint(0, 256, size=(HW, HW, 3)).astype(np.uint8)
    return cfg, models, noise, init_image


def _nchw_noise(noise):
    out = {k: to_nchw(v) for k, v in noise.items() if k != "sampler_noise"}
    out["sampler_noise"] = np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))
    return out


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_slice_matches_jax_generate(slice_setup, tiny_models, tiny_tokenizer,
                                    img2img):
    """Measured on the CPU: latents 124.7 dB (txt2img) and 123.3 dB
    (img2img); both uint8 images bit-equal to the JAX package's."""
    cfg, models, noise, init_image = slice_setup
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=HW, width=HW, return_latents=True)
    if img2img:
        kw.update(input_image=init_image, strength=0.8)
    else:
        noise = {k: v for k, v in noise.items() if k != "encoder_noise"}
    jcfg = jconfig.tiny_sd_config(attention_backend="pallas")
    ref_img, ref_lat = jpipeline.generate(
        "a photo of a cat", models=tiny_models, tokenizer=tiny_tokenizer,
        config=jcfg, fixed_noise=noise, **kw)
    before = fa.flash_attention_bsc.launches
    img, lat = pipeline.generate(
        "a photo of a cat", models=models,
        tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
        config=cfg, fixed_noise=_nchw_noise(noise), **kw)
    assert fa.flash_attention_bsc.launches == before  # CPU: plain version
    assert img.dtype == np.uint8 and img.shape == (HW, HW, 3)
    assert lat.shape == (1, 4, 16, 16)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_kernel_fold_slice_matches_jax_generate(slice_setup, tiny_models, tiny_tokenizer):
    """conv_backend="kernel_fold": every UNet res block through K5 (its plain
    version on the CPU, counted) and the transformer blocks' norms folded,
    against JAX ``generate(conv_backend="pallas_fold")``, whose Pallas conv
    kernel engages at both latent levels (16² and 8²)."""
    cfg, models, noise, _ = slice_setup
    cfg = dataclasses.replace(cfg, conv_backend="kernel_fold")
    noise = {k: v for k, v in noise.items() if k != "encoder_noise"}
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=HW, width=HW, return_latents=True)
    jcfg = jconfig.tiny_sd_config(attention_backend="pallas", conv_backend="pallas_fold")
    ref_img, ref_lat = jpipeline.generate(
        "a photo of a cat", models=tiny_models, tokenizer=tiny_tokenizer,
        config=jcfg, fixed_noise=noise, **kw)
    res_blocks = sum(st["kind"] == "block" for st in unet.encoder_plan(cfg.unet)) \
        + 2 + len(unet.decoder_plan(cfg.unet))
    with mock.patch.object(k5, "scaled_silu_conv3x3_plain",
                           wraps=k5.scaled_silu_conv3x3_plain) as spy:
        img, lat = pipeline.generate(
            "a photo of a cat", models=models,
            tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
            config=cfg, fixed_noise=_nchw_noise(noise), **kw)
    assert spy.call_count == 2 * res_blocks * STEPS == 72
    assert k5.scaled_silu_conv3x3.launches == 0  # CPU: the plain version
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_seed_determinism_and_batching(slice_setup):
    cfg, models, _, _ = slice_setup
    tok = make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)
    kw = dict(models=models, tokenizer=tok, config=cfg, height=HW, width=HW,
              n_inference_steps=2)
    a = pipeline.generate("a cat", seed=5, **kw)
    b = pipeline.generate("a cat", seed=5, **kw)
    c = pipeline.generate("a cat", seed=6, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0
    batch = pipeline.generate_images(["a cat", "a dog"], seed=5, **kw)
    assert batch.shape == (2, HW, HW, 3) and batch.dtype == np.uint8
    # sample 0 draws the same noise at any batch size
    assert psnr(batch[0].astype(np.float32), a.astype(np.float32)) > 40.0


# ----------------------------------------------------------- long-KV slice
#: level-1 self-attentions per UNet evaluation of tiny_sd_config: 2 in the
#: encoder's level 1, 3 in the decoder's
LEVEL1_ATTN = 5


def _wide_vae(cfg):
    """``cfg`` with a 192-channel VAE mid block: 1 head of Dh 192."""
    return dataclasses.replace(cfg, vae=dataclasses.replace(cfg.vae, ch_mults=(1, 12)))


def _random_vae_params(vae_cfg, seed):
    """JAX VAE parameters drawn with numpy into the JAX initializers' shapes
    (``jax.eval_shape``; the eager init takes seconds on the CPU): kernels
    ~ N(0, 1/fan_in), norm scales near 1, small biases."""
    r = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['scale']"):
            return (1.0 + 0.05 * r.randn(*shape)).astype(np.float32)
        if len(shape) == 1:
            return (0.05 * r.randn(*shape)).astype(np.float32)
        return (r.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    return {name: jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        lambda k: init(k, vae_cfg), key))
        for name, init in (("encoder", jvae.init_encoder),
                           ("decoder", jvae.init_decoder))}


@pytest.fixture(scope="module")
def long_kv_setup(tiny_models):
    jcfg = _wide_vae(jconfig.tiny_sd_config())
    jmodels = dict(tiny_models, **_random_vae_params(jcfg.vae, seed=5))
    cfg = _wide_vae(tiny_sd_config(attention_backend="kernel",
                                   vae_attention_backend="kernel"))
    models = build_models(cfg, device="cpu",
                          state_dicts=convert.from_jax_params(jmodels, cfg))
    r = np.random.RandomState(13)
    noise = {"latent_init": r.randn(1, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 1, 16, 16, 4).astype(np.float32),
             "encoder_noise": r.randn(1, 16, 16, 4).astype(np.float32)}
    init_image = r.randint(0, 256, size=(HW, HW, 3)).astype(np.uint8)
    return jcfg, jmodels, cfg, models, noise, init_image


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img_tiled"])
def test_long_kv_slice_matches_jax_generate(long_kv_setup, tiny_tokenizer,
                                            monkeypatch, img2img):
    """The UNet's level 1 goes through K4's plain version, the VAE's mid
    block through K3's, with exact call counts.  img2img also runs the
    tiled encoder and decoder on both sides (4 tiles of 8x8 latent px)."""
    jcfg, jmodels, cfg, models, noise, init_image = long_kv_setup
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=HW, width=HW, return_latents=True)
    steps, vae_calls = STEPS, 1
    if img2img:
        kw.update(input_image=init_image, strength=0.7, encode_tile=8, decode_tile=8)
        steps -= ddpm.start_step_for_strength(STEPS, 0.7)
        vae_calls = 2
    else:
        noise = {k: v for k, v in noise.items() if k != "encoder_noise"}
    ref_img, ref_lat = jpipeline.generate(
        "a photo of a cat", models=jmodels, tokenizer=tiny_tokenizer,
        config=jcfg, fixed_noise=noise, **kw)
    monkeypatch.setattr(attention, "FLASH_ONLY_KV", 256)
    spies = {k: mock.patch.object(fa, f"flash_attention_{name}_plain",
                                  wraps=getattr(fa, f"flash_attention_{name}_plain"))
             for k, name in (("K1", "bsc"), ("K4", "streamed"), ("K3", "multipass"))}
    with spies["K1"] as k1, spies["K4"] as k4, spies["K3"] as k3:
        img, lat = pipeline.generate(
            "a photo of a cat", models=models,
            tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
            config=cfg, fixed_noise=_nchw_noise(noise), **kw)
    assert (k1.call_count, k4.call_count, k3.call_count) == \
        (0, LEVEL1_ATTN * steps, vae_calls)
    q = k4.call_args.args[0]
    assert q.shape == (2, 4, 256, 4) and q.stride(2) == 3 * 16  # CFG batch, fused q/k/v
    assert k3.call_args.args[0].shape == (1, 1, 256, 192)      # the VAE's one head
    assert fa.flash_attention_streamed.launches == 0            # CPU: plain versions
    assert fa.flash_attention_multipass.launches == 0
    assert img.dtype == np.uint8 and img.shape == (HW, HW, 3)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_exact_mode_refuses_more_than_65536_level1_tokens(slice_setup, tiny_models,
                                                          tiny_tokenizer):
    """257x257 latent px = 66049 tokens (the tiny VAE downsamples 2x): both
    packages raise ValueError before any work."""
    cfg, models, _, _ = slice_setup
    assert pipeline.MAX_VALIDATED_ATTN_TOKENS == jpipeline.MAX_VALIDATED_ATTN_TOKENS
    with pytest.raises(ValueError, match="65536"):
        jpipeline.generate("a cat", models=tiny_models, tokenizer=tiny_tokenizer,
                           config=jconfig.tiny_sd_config(), height=514, width=514)
    with pytest.raises(ValueError, match="66049-token.*65536"):
        pipeline.generate("a cat", models=models, config=cfg, height=514, width=514,
                          tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len))


@pytest.mark.parametrize("kwargs,where", [
    ({"sequence_parallel": True}, "slice H"),
    ({"progress": True}, "slice H"),
    ({"config": tiny_sd_config(quant="wide")}, "slice H"),
])
def test_unported_features_raise(slice_setup, kwargs, where):
    cfg, models, _, _ = slice_setup
    kw = dict(prompt="a cat", models=models, config=cfg, height=HW, width=HW,
              tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len))
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=where):
        pipeline.generate(**kw)


@pytest.mark.parametrize("kwargs,match", [
    ({"config": tiny_sd_config(quant="int8")}, "quant tier"),
    ({"timestep_spacing": "bogus"}, "timestep_spacing"),
    ({"sampler_name": "lcm", "timestep_spacing": "karras"}, "timestep_spacing"),
    ({"sampler_name": "dpm_fast", "timestep_spacing": "karras"}, "timestep_spacing"),
    ({"sampler_name": "restart", "fixed_noise": True}, "fixed_noise"),
])
def test_unknown_option_values_raise_value_error(slice_setup, kwargs, match):
    """Values the JAX package does not know either raise ValueError there
    (``generate()``'s quant and timestep_spacing checks), and so here; the
    JAX package's own tiers raise NotImplementedError above.  So do the
    samplers' refusals there: lcm and dpm_fast off the "uniform" spacing,
    restart with injected noise."""
    cfg, models, noise, _ = slice_setup
    kw = dict(prompt="a cat", models=models, config=cfg, height=HW, width=HW,
              tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len))
    kw.update(kwargs)
    if kw.get("fixed_noise"):
        kw["fixed_noise"] = _nchw_noise(noise)
    with pytest.raises(ValueError, match=match):
        pipeline.generate(**kw)


def test_per_sample_init_images_match_jax(slice_setup, tiny_models, tiny_tokenizer):
    """img2img with two different init images in one (2, H, W, 3) array, one
    for each prompt, as the JAX package takes them (generate_many and
    sd_upscale rely on it), against JAX ``generate`` on the same noise; a
    count of init images that is neither 1 nor the batch raises."""
    cfg, models, _, _ = slice_setup
    cfg = dataclasses.replace(cfg, attention_backend="plain")
    r = np.random.RandomState(17)
    noise = {"latent_init": r.randn(2, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 2, 16, 16, 4).astype(np.float32),
             "encoder_noise": r.randn(2, 16, 16, 4).astype(np.float32)}
    init = r.randint(0, 256, size=(2, HW, HW, 3)).astype(np.uint8)
    prompts = ["a photo of a cat", "a dog"]
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=HW, width=HW, return_latents=True, input_image=init, strength=0.8)
    _, ref_lat = jpipeline.generate(prompts, models=tiny_models, tokenizer=tiny_tokenizer,
                                    config=jconfig.tiny_sd_config(), fixed_noise=noise, **kw)
    tok = make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)
    _, lat = pipeline.generate(prompts, models=models, tokenizer=tok, config=cfg,
                               fixed_noise=_nchw_noise(noise), **kw)
    assert lat.shape == (2, 4, 16, 16)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(lat[0], lat[1]) < 40.0  # two images, two results
    with pytest.raises(ValueError, match="init images"):
        pipeline.generate_images(prompts + ["a cat"], models=models, tokenizer=tok,
                                 config=cfg, height=HW, width=HW, n_inference_steps=2,
                                 input_image=init)


def test_unknown_keyword_is_an_error(slice_setup):
    cfg, models, _, _ = slice_setup
    with pytest.raises(TypeError):
        pipeline.generate("a cat", models=models, config=cfg,
                          tokenizer=make_test_tokenizer(WORDS), no_such_option=1)


# ------------------------------------------------------- prompt features (D1)
#: cross-attentions per UNet evaluation of tiny_sd_config: 2 in the
#: encoder's level 1, the mid block's, 3 in the decoder's
CROSS_ATTN = 6
#: emphasis, a down-weighted [word], 19 windows of the tiny tokenizer's 16
#: tokens (18 of the repeated text, one after BREAK): a 304-token context
D1_PROMPT = " ".join(["a photo of a (cat:1.3) of a [dog]"] * 30) + " BREAK a cat"


def _jax_emphasize():
    """The JAX package's ``_emphasize``: a closure of ``_compiled_txt2img``
    that captures nothing, rebuilt from its code object over the JAX
    pipeline's globals."""
    def find(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                found = c if c.co_name == "_emphasize" else find(c)
                if found is not None:
                    return found
        return None

    outer = getattr(jpipeline._compiled_txt2img, "__wrapped__", jpipeline._compiled_txt2img)
    return types.FunctionType(find(outer.__code__), vars(jpipeline))


def test_emphasize_matches_jax():
    """Random hiddens and weights, with one zero-mean row (the degenerate
    guard keeps its ratio at 1); bit-exact identity at w == 1."""
    r = np.random.RandomState(21)
    h = (r.randn(5, 16, 32) + 0.3).astype(np.float32)
    h[0] -= h[0].mean()
    w = r.uniform(0.6, 1.5, (5, 16)).astype(np.float32)
    ref = np.asarray(_jax_emphasize()(jnp.asarray(h), jnp.asarray(w)))
    got = pipeline._emphasize(torch.from_numpy(h), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    for dtype in (torch.float32, torch.bfloat16):
        hd = torch.from_numpy(h).to(dtype)
        assert torch.equal(pipeline._emphasize(hd, torch.ones(5, 16)), hd)


@pytest.mark.parametrize("skip", [1, 2])
def test_clip_skip_matches_jax(slice_setup, tiny_models, skip):
    cfg, models, _, _ = slice_setup
    jcfg = jconfig.with_clip_skip(jconfig.tiny_sd_config(), skip)
    ours = with_clip_skip(cfg, skip)
    assert ours.clip == dataclasses.replace(cfg.clip, stop_at_layer=jcfg.clip.stop_at_layer)
    tokens = np.random.RandomState(skip).randint(0, cfg.clip.vocab_size, (3, 16))
    ref = np.asarray(jclip.apply(tiny_models["clip"], jnp.asarray(tokens), jcfg.clip))
    with torch.inference_mode():
        got = models["clip"](torch.from_numpy(tokens), cfg=ours.clip).numpy()
        full = models["clip"](torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (np.abs(got - full).max() > 1e-2) == (skip == 2)


def test_d1_slice_matches_jax_generate(slice_setup, tiny_models, tiny_tokenizer):
    """Long prompts with emphasis, a BREAK and CLIP skip: a 304-token
    context, so every cross-attention runs K2 (its plain version here; the
    JAX package's one-pass Pallas kernel in interpret mode)."""
    cfg, models, noise, _ = slice_setup
    noise = {k: v for k, v in noise.items() if k != "encoder_noise"}
    tok = make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)
    windows = len(tok.encode_windows_weighted(D1_PROMPT)[0])
    assert windows == 19
    kw = dict(uncond_prompt="a (dog:0.8)", cfg_scale=7.5, n_inference_steps=STEPS,
              seed=0, height=HW, width=HW, return_latents=True, long_prompts=True,
              emphasis=True, clip_skip=2)
    ref_img, ref_lat = jpipeline.generate(
        D1_PROMPT, models=tiny_models, tokenizer=tiny_tokenizer,
        config=jconfig.tiny_sd_config(attention_backend="pallas"), fixed_noise=noise,
        **kw)
    with mock.patch.object(fa, "flash_attention_onepass_plain",
                           wraps=fa.flash_attention_onepass_plain) as k2:
        img, lat = pipeline.generate(D1_PROMPT, models=models, tokenizer=tok, config=cfg,
                                     fixed_noise=_nchw_noise(noise), **kw)
    assert k2.call_count == CROSS_ATTN * STEPS
    q, k = k2.call_args.args[:2]
    assert q.shape[0] == 2 and k.shape[2] == windows * cfg.clip.max_len
    assert fa.flash_attention_onepass.launches == 0  # CPU: the plain version
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


@pytest.mark.parametrize("options", [{"long_prompts": True}, {"emphasis": True},
                                     {"long_prompts": True, "emphasis": True}],
                         ids=["long_prompts", "emphasis", "both"])
def test_prompt_options_are_identity_on_a_plain_prompt(slice_setup, options):
    """One window and every weight 1: bit-identical to the plain path."""
    cfg, models, _, _ = slice_setup
    kw = dict(models=models, tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
              config=cfg, height=HW, width=HW, n_inference_steps=2, seed=3,
              return_latents=True)
    base = pipeline.generate("a photo of a cat", **kw)
    got = pipeline.generate("a photo of a cat", **options, **kw)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)


class _ContextRecorder(torch.nn.Module):
    """Wraps the UNet and records the context of every call."""

    def __init__(self, unet_module):
        super().__init__()
        self.inner = unet_module
        self.contexts = []

    def forward(self, x, context, *args, **kwargs):
        self.contexts.append(context.clone())
        return self.inner(x, context, *args, **kwargs)


def test_prompt_editing_switches_context_per_step(slice_setup):
    """``[cat:dog:2]`` and ``[a|photo]`` over 3 steps: each step's context is
    the port's encoding of the prompts ``realize`` gives for that step."""
    cfg, models, _, _ = slice_setup
    tok = make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)
    prompt, uncond = "a [cat:dog:2] photo", "[a|photo]"
    rec = _ContextRecorder(models["diffusion"])
    pipeline.generate(prompt, uncond, models=dict(models, diffusion=rec), tokenizer=tok,
                      config=cfg, height=HW, width=HW, n_inference_steps=STEPS, seed=1)
    assert len(rec.contexts) == STEPS
    for step, ctx in enumerate(rec.contexts, start=1):
        texts = [prompt_schedule.realize(t, step, STEPS) for t in (prompt, uncond)]
        tokens = torch.from_numpy(pipeline._encode_tokens(tok, texts, cfg.clip.max_len))
        with torch.inference_mode():
            want = pipeline._encode_text(models["clip"], tokens, None, cfg)
        torch.testing.assert_close(ctx, want, rtol=1e-5, atol=1e-6)
    assert not torch.equal(rec.contexts[0], rec.contexts[1])  # the alternation
    assert not torch.equal(rec.contexts[1][:1], rec.contexts[2][:1])  # cat -> dog


def test_prompt_editing_to_itself_is_the_plain_prompt(slice_setup):
    cfg, models, noise, _ = slice_setup
    kw = dict(models=models, tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
              config=cfg, height=HW, width=HW, n_inference_steps=2, seed=4,
              return_latents=True)
    for a, b in zip(pipeline.generate("a [cat:cat:2] photo", **kw),
                    pipeline.generate("a cat photo", **kw)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fixed_noise"):
        pipeline.generate("a [cat:dog:1] photo", fixed_noise=_nchw_noise(noise), **kw)
