"""Slice F through ``generate()``: every option the JAX package takes under
``fixed_noise`` (guidance rescale, dynamic thresholding, DeepCache on
dpm++, heun, dpm2 and img2img, Hypertile, ToMe, FreeU, seamless tiling, and
tiling on the "kernel" conv tier) against JAX ``generate()`` on the same
injected noise, latents > 55 dB and images > 40 dB; the properties of the
options JAX refuses there (PAG, SAG, AND and region masks, variation seeds,
the noise multiplier; their one-evaluation compositions are in
tests/test_torch_guidance_modes.py); every JAX ``ValueError`` of these
options, message for message; the 65536-token guard where the port and the
JAX package differ; the keywords through ``StableDiffusion.txt2img``; and
``chip_smoke.expected_launches`` held to the plain versions' calls.

Tiny SD-1.5 at 32 px (a 256-token attention level), so Hypertile (tile 4)
and ToMe engage at ``min_tokens=64``.  Tolerances: > 55 dB latents and
> 40 dB images against JAX; bit-identity for the properties that are
exact; 1e-4 (FP32) where lanes are batched differently.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

from conftest import psnr, to_nchw
from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import api, pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]
HW = 32


@pytest.fixture(scope="module")
def sd():
    """(port cfg, JAX cfg, JAX params, port models) of tiny SD-1.5."""
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=51)
    return cfg, jcfg, jp, build_models(cfg, device="cpu",
                                       state_dicts=convert.from_jax_params(jp, cfg))


def _noise(steps, seed=0):
    r = np.random.RandomState(seed)
    shape = (1, HW // 2, HW // 2, 4)
    return {"latent_init": r.randn(*shape).astype(np.float32),
            "sampler_noise": r.randn(steps, *shape).astype(np.float32),
            "encoder_noise": r.randn(*shape).astype(np.float32)}


def _nchw_noise(noise):
    out = {k: to_nchw(v) for k, v in noise.items() if k != "sampler_noise"}
    out["sampler_noise"] = np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))
    return out


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (HW, HW, 3)).astype(np.uint8)


def _run(sd, prompt="a photo of a cat", *, port_config=None, **kw):
    """The port's request (seeded; no injected noise) -> (image, latents)."""
    cfg, _, _, models = sd
    kw = dict(dict(uncond_prompt="a dog", cfg_scale=5.0, n_inference_steps=2, seed=4,
                   height=HW, width=HW, return_latents=True), **kw)
    return pipeline.generate(prompt, models=models, config=port_config or cfg,
                             tokenizer=make_test_tokenizer(WORDS, max_len=16), **kw)


# ------------------------------------------------------- against JAX generate
#: case -> (generate keywords, config transform (port, JAX), port-only config fields)
GENERATE = {
    "guidance_rescale 0.7": (dict(guidance_rescale=0.7), None, {}),
    "dynamic_threshold 0.9": (dict(dynamic_threshold=0.9), None, {}),
    "deepcache 2, dpm++": (dict(deepcache=2, sampler_name="dpm++", n_inference_steps=3),
                           None, {}),
    "deepcache 2, heun (shallow corrector)": (
        dict(deepcache=2, sampler_name="heun", n_inference_steps=3), None, {}),
    "deepcache 2, dpm2 (shallow midpoint)": (
        dict(deepcache=2, sampler_name="dpm2", n_inference_steps=3), None, {}),
    "deepcache 2, img2img": (dict(deepcache=2, sampler_name="ddim", n_inference_steps=4,
                                  input_image=_image(6), strength=0.75), None, {}),
    "hypertile 4": ({}, lambda m, c: m.with_hypertile(c, 4, min_tokens=64), {}),
    "tome 0.5": ({}, lambda m, c: m.with_tome(c, 0.5, min_tokens=64), {}),
    "freeu": (dict(freeu=True), None, {}),
    "tiling": (dict(tiling=True), None, {}),
    # JAX takes its Pallas conv off the path under tiling, so its "xla"
    # program is the reference of the port's "kernel" tier (K5's plain
    # versions on the CPU) there
    "tiling, conv kernel": (dict(tiling=True), None, dict(conv_backend="kernel")),
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(sd, case):
    cfg, jcfg, jp, models = sd
    kw, transform, port_fields = GENERATE[case]
    if transform is not None:
        cfg, jcfg = transform(config, cfg), transform(jconfig, jcfg)
    kw = dict(dict(uncond_prompt="a dog", cfg_scale=5.0, n_inference_steps=2, seed=0,
                   height=HW, width=HW, return_latents=True), **kw)
    noise = _noise(kw["n_inference_steps"])
    ref_img, ref_lat = jpipeline.generate(
        "a photo of a cat", models=jp, tokenizer=jtokenizer(WORDS, max_len=16), config=jcfg,
        fixed_noise=noise, **kw)
    img, lat = pipeline.generate(
        "a photo of a cat", models=models, tokenizer=make_test_tokenizer(WORDS, max_len=16),
        config=dataclasses.replace(cfg, **port_fields), fixed_noise=_nchw_noise(noise), **kw)
    assert np.isfinite(lat).all() and img.shape == (HW, HW, 3)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0, psnr(lat, to_nchw(ref_lat))
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_modes_move_the_image(sd):
    """Each mode changes the result at this size (so the cases above test
    something): DeepCache 2 against 1, which equals off bit for bit."""
    base = _run(sd, sampler_name="dpm++", n_inference_steps=3)[1]
    assert np.array_equal(_run(sd, sampler_name="dpm++", n_inference_steps=3,
                               deepcache=1)[1], base)
    for kw in (dict(deepcache=2), dict(guidance_rescale=0.7), dict(dynamic_threshold=0.9),
               dict(freeu=True), dict(tiling=True), dict(tome_ratio=0.5),
               dict(port_config=config.with_hypertile(sd[0], 4, min_tokens=64))):
        got = _run(sd, sampler_name="dpm++", n_inference_steps=3, **kw)[1]
        if "tome_ratio" in kw:  # the default 4096 tokens: not at this size
            assert np.array_equal(got, base), kw
        else:
            assert np.abs(got - base).max() > 1e-4, kw


# --------------------------------------------- the modes JAX refuses there
def test_pag_and_sag_at_scale_zero_equal_off(sd):
    base = _run(sd)
    for kw in (dict(pag_scale=0.0), dict(sag_scale=0.0)):
        got = _run(sd, **kw)
        assert np.array_equal(got[0], base[0]) and np.array_equal(got[1], base[1]), kw
    for kw in (dict(pag_scale=3.0), dict(sag_scale=0.75), dict(pag_scale=2.0, sag_scale=0.5),
               dict(pag_scale=2.0, do_cfg=False)):
        assert np.abs(_run(sd, **kw)[1] - base[1]).max() > 1e-4, kw


def test_and_weights_one_zero_equal_plain_cfg(sd):
    """"a photo of a cat AND a photo:0" is plain CFG on the first part, within
    the FP32 bound (3 lanes batched against 2)."""
    plain = _run(sd, "a photo of a cat")[1]
    np.testing.assert_allclose(_run(sd, "a photo of a cat AND a photo:0")[1], plain,
                               rtol=1e-4, atol=1e-4)
    assert np.abs(_run(sd, "a photo of a cat AND a photo")[1] - plain).max() > 1e-4


def test_full_canvas_region_masks_equal_and_without_masks(sd):
    ones = np.ones((HW, HW), np.float32)
    prompt = "a photo of a cat AND a photo:0.7"
    got = _run(sd, prompt, region_masks=[ones, 255 * ones])
    want = _run(sd, prompt)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    half = np.zeros((HW, HW), np.float32)
    half[:HW // 2] = 1.0
    assert np.abs(_run(sd, prompt, region_masks=[half, 1 - half])[1] - want[1]).max() > 1e-4


def test_variation_ends_and_the_multiplier(sd):
    """Strength 0 is the seed's own noise; seed 1 at strength 1 towards
    variation seed 2 is seed 2's request bit for bit (dpm++ draws no
    sampler noise); the multiplier 1.0 is no multiplier."""
    kw = dict(sampler_name="dpm++", n_inference_steps=2)
    one, two = _run(sd, seed=1, **kw), _run(sd, seed=2, **kw)
    for got, want in ((_run(sd, seed=1, variation_seed=2, variation_strength=0.0, **kw), one),
                      (_run(sd, seed=1, variation_seed=2, variation_strength=1.0, **kw), two),
                      (_run(sd, seed=1, noise_multiplier=1.0, **kw), one)):
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    for more in (dict(variation_seed=2, variation_strength=0.3), dict(noise_multiplier=1.05)):
        assert np.abs(_run(sd, seed=1, **kw, **more)[1] - one[1]).max() > 1e-4, more


def test_same_seed_same_image(sd):
    kw = dict(pag_scale=2.0, sag_scale=0.5, variation_seed=5, variation_strength=0.4,
              noise_multiplier=1.02, tiling=True, freeu=True)
    a, b = _run(sd, **kw), _run(sd, **kw)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    c, d = (_run(sd, "a cat AND a photo:0.5", deepcache=2, sampler_name="heun", seed=9)
            for _ in range(2))
    assert np.array_equal(c[1], d[1])


def test_txt2img_passes_the_slice_f_keywords(sd):
    cfg, _, _, models = sd
    sdm = api.StableDiffusion(models, make_test_tokenizer(WORDS, max_len=16), cfg,
                              device="cpu")
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, n_inference_steps=2, seed=4, height=HW,
              width=HW, pag_scale=2.0, deepcache=2, freeu=True, tiling=True,
              variation_seed=3, variation_strength=0.5)
    got = sdm.txt2img("a photo of a cat AND a photo", **dict(kw, pag_scale=0.0))
    want = _run(sd, "a photo of a cat AND a photo", **dict(kw, pag_scale=0.0,
                                                            return_latents=False))
    assert np.array_equal(got, want)
    assert np.array_equal(sdm.txt2img("a photo of a cat", **kw),
                          _run(sd, **dict(kw, return_latents=False)))
    assert api.fast_preset is config.fast_preset


# ------------------------------------------------------------------ errors
_IP2P = dict(edit_image=_image(2))
ERRORS = {
    "AND with prompt editing": ("a [cat:dog:1] AND a dog", {}),
    "AND without CFG": ("a cat AND a dog", dict(do_cfg=False)),
    "AND part counts": (["a cat AND a dog", "a cat"], {}),
    "AND with ControlNet": ("a cat AND a dog", dict(control_image=_image(1))),
    "AND with PAG": ("a cat AND a dog", dict(pag_scale=1.0)),
    "AND with SAG": ("a cat AND a dog", dict(sag_scale=1.0)),
    "AND with guidance_rescale": ("a cat AND a dog", dict(guidance_rescale=0.5)),
    "AND with fixed_noise": ("a cat AND a dog", dict(fixed_noise=True)),
    "region masks without AND": ("a cat", dict(region_masks=[np.ones((HW, HW))])),
    "region mask count": ("a cat AND a dog", dict(region_masks=[np.ones((HW, HW))] * 3)),
    "variation strength": ("a cat", dict(variation_seed=1, variation_strength=1.5)),
    "variation with fixed_noise": ("a cat", dict(variation_seed=1, variation_strength=0.5,
                                                 fixed_noise=True)),
    "PAG with fixed_noise": ("a cat", dict(pag_scale=1.0, fixed_noise=True)),
    "SAG with fixed_noise": ("a cat", dict(sag_scale=1.0, fixed_noise=True)),
    "SAG with deepcache": ("a cat", dict(sag_scale=1.0, deepcache=2)),
    "noise_multiplier with fixed_noise": ("a cat", dict(noise_multiplier=1.1,
                                                        fixed_noise=True)),
    "dynamic_threshold 0": ("a cat", dict(dynamic_threshold=0.0)),
    "dynamic_threshold 1.5": ("a cat", dict(dynamic_threshold=1.5)),
    "deepcache 0": ("a cat", dict(deepcache=0)),
    "restart with deepcache": ("a cat", dict(sampler_name="restart", deepcache=2)),
    "tome ratio 1": ("a cat", dict(tome_ratio=1.0)),
    "freeu of 3 values": ("a cat", dict(freeu=(1.0, 1.0, 1.0))),
    "InstructPix2Pix with guidance_rescale": ("a cat", dict(_IP2P, guidance_rescale=0.5)),
    "InstructPix2Pix with mask and guidance_rescale": (
        "a cat", dict(_IP2P, mask_image=np.ones((HW, HW)), guidance_rescale=0.5)),
    "InstructPix2Pix with PAG": ("a cat", dict(_IP2P, pag_scale=1.0)),
    "InstructPix2Pix with AND": ("a cat AND a dog", _IP2P),
    "reference with PAG": ("a cat", dict(reference_image=_image(3), pag_scale=1.0)),
    "reference with AND": ("a cat AND a dog", dict(reference_image=_image(3))),
    "reference with deepcache": ("a cat", dict(reference_image=_image(3), deepcache=2)),
    "reference with ToMe": ("a cat", dict(reference_image=_image(3), tome_ratio=0.5)),
    "reference with hypertile": ("a cat", dict(reference_image=_image(3), hypertile=True)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(sd, case):
    """The JAX package's ValueError for each refused value or composition,
    with its message, raised before any work."""
    cfg, jcfg, jp, models = sd
    prompt, kw = ERRORS[case]
    kw = dict(kw)
    if kw.pop("hypertile", False):
        cfg, jcfg = config.with_hypertile(cfg, 4), jconfig.with_hypertile(jcfg, 4)
    if "edit_image" in kw:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, in_channels=8))
        jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, in_channels=8))
    jkw = dict(kw)
    if kw.get("fixed_noise"):
        jkw["fixed_noise"], kw["fixed_noise"] = _noise(2), _nchw_noise(_noise(2))
    common = dict(height=HW, width=HW, n_inference_steps=2)
    with pytest.raises(ValueError) as want:
        jpipeline.generate(prompt, models=jp, tokenizer=jtokenizer(WORDS, max_len=16),
                           config=jcfg, **common, **jkw)
    with pytest.raises(ValueError) as got:
        pipeline.generate(prompt, models=models, config=cfg,
                          tokenizer=make_test_tokenizer(WORDS, max_len=16), **common, **kw)
    assert str(got.value) == str(want.value)


class _PastTheGuard(Exception):
    pass


@pytest.mark.parametrize("size,tile,min_tokens", [(514, 4, 16), (516, 4, 100000)],
                         ids=["prime level-1 side", "min_tokens above level 1"])
def test_guard_waived_only_where_hypertile_tiles_level1(sd, monkeypatch, size, tile,
                                                        min_tokens):
    """Above 65536 level-1 tokens the JAX package waives its guard for any
    hypertile config (ROADMAP §3); the port only where the plan tiles
    level 1.  A 257-token (prime) side, or ``min_tokens`` above the level,
    leaves it untiled: JAX goes on (its compile is replaced by a sentinel
    here), the port raises.  Where the plan tiles level 1 (258 = 3 · 86),
    the port goes on too (to the next check of the request)."""
    cfg, jcfg, jp, models = sd
    monkeypatch.setattr(jpipeline, "_compiled_txt2img",
                        mock.Mock(side_effect=_PastTheGuard))
    common = dict(height=size, width=size, n_inference_steps=2)
    with pytest.raises(_PastTheGuard):
        jpipeline.generate("a cat", models=jp, tokenizer=jtokenizer(WORDS, max_len=16),
                           config=jconfig.with_hypertile(jcfg, tile, min_tokens=min_tokens),
                           **common)
    tok = make_test_tokenizer(WORDS, max_len=16)
    with pytest.raises(ValueError, match="global self-attention.*leaves level 1 untiled"):
        pipeline.generate("a cat", models=models, tokenizer=tok, **common,
                          config=config.with_hypertile(cfg, tile, min_tokens=min_tokens))
    with pytest.raises(ValueError, match="dynamic_threshold"):
        pipeline.generate("a cat", models=models, tokenizer=tok, dynamic_threshold=2.0,
                          config=config.with_hypertile(cfg, 4, min_tokens=16),
                          **dict(common, height=516, width=516))


# ------------------------------------------------------------ launch counts
@pytest.mark.parametrize("case", ["pag", "sag", "and", "deepcache heun", "hypertile", "tome",
                                  "tiling"])
def test_launch_rule_counts_slice_f(sd, monkeypatch, case):
    """``chip_smoke.expected_launches`` (the one copy of the launch rule the
    card's requests are held to) against the plain versions' calls on the
    CPU: PAG's and SAG's extra evaluations (SAG's mid block materialized),
    DeepCache's shallow evaluations, Hypertile's tile batches and ToMe's
    merged tokens on K1, tiling's K5-free res blocks."""
    import chip_smoke
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as cconv
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    cfg = dataclasses.replace(sd[0], attention_backend="kernel", conv_backend="kernel")
    monkeypatch.setattr(chip_smoke, "K1_DH", (4, 8))  # the tiny head widths, on the CPU
    kw = dict(sampler_name="ddim", n_inference_steps=2)
    plan = {}
    prompt = "a cat"
    if case == "pag":
        kw.update(pag_scale=1.0)
        plan.update(pag=True)
    elif case == "sag":
        kw.update(sag_scale=1.0)
        plan.update(sag=True)
    elif case == "and":
        prompt = "a cat AND a dog AND a photo"
    elif case == "deepcache heun":
        kw.update(deepcache=2, sampler_name="heun", n_inference_steps=3)
        plan.update(shallow=chip_smoke.deepcache_evals("heun", 3, 0, 2)[1])
        assert plan["shallow"] == 3  # step 1's main and both correctors
    elif case == "hypertile":
        cfg = config.with_hypertile(cfg, 16, min_tokens=64)
    elif case == "tome":
        cfg = config.with_tome(cfg, 0.5, min_tokens=64)
    else:
        kw.update(tiling=True)
        plan.update(tiling=True)
    steps = chip_smoke.sampler_evals(kw["sampler_name"], kw["n_inference_steps"], 0)
    want = chip_smoke.expected_launches(cfg, 64, 64, steps=steps, img2img=False, context=16,
                                        **plan)
    with mock.patch.object(fa, "flash_attention_bsc_plain",
                           wraps=fa.flash_attention_bsc_plain) as k1, \
            mock.patch.object(cconv, "scaled_silu_conv3x3_plain",
                              wraps=cconv.scaled_silu_conv3x3_plain) as k5:
        pipeline.generate(prompt, models=sd[3], config=cfg, height=64, width=64,
                          tokenizer=make_test_tokenizer(WORDS, max_len=16), **kw)
    assert (want["K1"], want["K5"]) == (k1.call_count, k5.call_count), want
    if case in ("hypertile", "tome"):  # the folded tiles, the merged tokens
        shapes = {tuple(c.args[0].shape) for c in k1.call_args_list}
        assert shapes == {key[:3] for key in chip_smoke.plan_shapes(cfg, 64, 64, 2, 16)["K1"]}
        assert shapes == ({(8, 256, 16), (2, 256, 32)} if case == "hypertile"
                          else {(2, 512, 16)})
