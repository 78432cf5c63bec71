"""Slice C3 of the port against the JAX package: inpainting (the 9-channel
UNet and the latent blend, full-res, fill, outpaint, mask blur), colour
correction, InstructPix2Pix, LCM's embedded guidance and ``hires_fix``.

The models are tiny SD-1.5 topologies with the C3 changes (a 9- or
8-channel ``conv_in``, LCM's ``cond_proj``); the JAX parameters are drawn
with numpy into the JAX initializers' shapes (``test_torch_families``'s
``jax_params``) and carried into the port by ``convert.from_jax_params``.
Requests run at 32x32 pixels (16x16 latents) with injected noise
(``fixed_noise``), on the plain attention backend, and are held to
``test_torch_families.compare_generate``'s bar: latents > 55 dB and
images > 40 dB against JAX ``generate()``.  The API methods that call
``generate()`` more than once or at their own sizes (``hires_fix``,
``inpaint(full_res=True)``, ``outpaint``) get the same injected noise per
call from a wrapper of each package's ``generate`` that picks it by the
call's size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import psnr, to_nchw
from test_torch_families import jax_params, to_jax

from pytorch_stable_diffusion_tpu import api as japi
from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.weights import convert as jconvert
from pytorch_stable_diffusion_tpu.weights import diffusers as jdiffusers
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import api, pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.models import unet as punet
from pytorch_stable_diffusion_tpu_torch.utils import image as pimage
from pytorch_stable_diffusion_tpu_torch.weights import convert, diffusers
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]
HW = 32  # pixels; the tiny VAE downsamples 2x
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny tensors (parallel test workers
    oversubscribe the cores with torch's default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**unet):
    cfg = config.tiny_sd_config()
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **unet))


TINY = {"base": _tiny(), "inpaint": _tiny(in_channels=9), "ip2p": _tiny(in_channels=8),
        "lcm": _tiny(time_cond_dim=16)}


@pytest.fixture(scope="module")
def fam():
    """name -> (port config, JAX config, JAX params, port models on the CPU)."""
    out = {}
    for i, (name, cfg) in enumerate(TINY.items()):
        jcfg = to_jax(cfg)
        jp = jax_params(jcfg, seed=40 + i)
        out[name] = (cfg, jcfg, jp, build_models(cfg, device="cpu",
                                                 state_dicts=convert.from_jax_params(jp, cfg)))
    return out


def _image(seed, h=HW, w=HW):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _mask(h=HW, w=HW):
    m = np.zeros((h, w), np.float32)
    m[h // 4:3 * h // 4, w // 4:w // 2 + 4] = 1.0
    return m


def noise_for(height, width, steps=STEPS, seed=0):
    """Every stream a C3 request may read, NHWC as the JAX package takes
    them, drawn from a seed and the size."""
    r = np.random.RandomState(seed + 7 * height + width)
    shape = (1, height // 2, width // 2, 4)
    return {"latent_init": r.randn(*shape).astype(np.float32),
            "sampler_noise": r.randn(steps, *shape).astype(np.float32),
            "encoder_noise": r.randn(*shape).astype(np.float32),
            "mask_encoder_noise": r.randn(*shape).astype(np.float32)}


def nchw_noise(noise):
    out = {k: to_nchw(v) for k, v in noise.items() if k != "sampler_noise"}
    out["sampler_noise"] = np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))
    return out


def _kw(**more):
    return dict(dict(uncond_prompt="", cfg_scale=5.0, n_inference_steps=STEPS, seed=0,
                     height=HW, width=HW), **more)


def compare(fam, name, prompt="a photo of a cat", **kw):
    """JAX ``generate()`` and the port's on the same injected noise; ->
    (latents PSNR in dB, image PSNR in dB, the port's image)."""
    cfg, jcfg, jp, models = fam[name]
    kw = dict(_kw(**kw), return_latents=True)
    noise = noise_for(kw["height"], kw["width"], kw["n_inference_steps"])
    ref_img, ref_lat = jpipeline.generate(prompt, models=jp, config=jcfg,
                                          tokenizer=jtokenizer(WORDS, max_len=16),
                                          fixed_noise=noise, **kw)
    img, lat = pipeline.generate(prompt, models=models, config=cfg,
                                 tokenizer=make_test_tokenizer(WORDS, max_len=16),
                                 fixed_noise=nchw_noise(noise), **kw)
    assert img.dtype == np.uint8 and img.shape == ref_img.shape
    assert np.isfinite(lat).all()
    return (psnr(lat, to_nchw(ref_lat)),
            psnr(img.astype(np.float32), ref_img.astype(np.float32)), img)


# ----------------------------------------------------------- host helpers
MASKS = {"unit float": lambda r: r.rand(HW, HW).astype(np.float32),
         "uint8": lambda r: r.randint(0, 256, (HW, HW)).astype(np.uint8),
         "3-D": lambda r: r.rand(HW, HW, 3).astype(np.float32),
         "binary": lambda r: (r.rand(HW, HW) > 0.5).astype(np.float32)}


@pytest.mark.parametrize("kind", list(MASKS))
def test_prepare_mask_matches_jax(kind):
    m = MASKS[kind](np.random.RandomState(3))
    np.testing.assert_array_equal(pipeline._prepare_mask(m, HW, HW),
                                  jpipeline._prepare_mask(m, HW, HW))


def test_prepare_mask_takes_pil_and_refuses_a_wrong_size():
    from PIL import Image

    m = Image.fromarray(MASKS["uint8"](np.random.RandomState(4)))
    np.testing.assert_array_equal(pipeline._prepare_mask(m, 16, 24),
                                  jpipeline._prepare_mask(m, 16, 24))
    with pytest.raises(ValueError, match="mask must be 16x16"):
        pipeline._prepare_mask(np.zeros((HW, HW)), 16, 16)


@pytest.mark.parametrize("kind", ["binary", "unit float"])
@pytest.mark.parametrize("fn", ["mask_to_latent_nearest", "mask_to_latent_area"])
@pytest.mark.parametrize("factor", [2, 8])
def test_masks_to_latent_match_jax(kind, fn, factor):
    m = np.stack([MASKS[kind](np.random.RandomState(s)) for s in (5, 6)])[..., None]
    np.testing.assert_array_equal(getattr(pipeline, fn)(m, factor),
                                  getattr(jpipeline, fn)(m, factor))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_histograms_matches_jax(seed):
    r = np.random.RandomState(seed)
    src = r.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    ref = (r.beta(2, 5, (24, 20, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pipeline.match_histograms(src, ref),
                                  jpipeline.match_histograms(src, ref))


RESIZES = {"up": ((7, 9, 3), (13, 20, 3)), "down": ((20, 17, 3), (7, 9, 3)),
           "odd, both ways": ((11, 13), (25, 6)), "latents 2x": ((1, 4, 8, 8), (1, 4, 16, 16))}


@pytest.mark.parametrize("case", list(RESIZES))
@pytest.mark.parametrize("method", pimage.METHODS)
def test_resize_matches_jax(method, case):
    """Within 1e-5 of ``jax.image.resize`` (fp32; values of unit scale):
    half-pixel centres, antialiased downscales, Keys' cubic, lanczos3;
    "nearest" exactly."""
    src, dst = RESIZES[case]
    x = np.random.RandomState(7).randn(*src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
    got = pimage.resize(x, dst, method)
    assert got.dtype == np.float32 and got.shape == ref.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, ref)
    assert np.abs(got - ref).max() <= 1e-5
    t = pimage.resize(torch.from_numpy(x), dst, method)
    assert isinstance(t, torch.Tensor) and torch.equal(t, torch.from_numpy(got))


def test_resize_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="Unknown resize method"):
        pimage.resize(np.zeros((4, 4)), (8, 8), "esrgan")


@pytest.mark.parametrize("dim", [256, 16, 17])
@pytest.mark.parametrize("w", [0.0, 6.5, np.array([1.0, 3.0, 7.0], np.float32)])
def test_guidance_scale_embedding_matches_jax(dim, w):
    """Within 1e-6 where the arguments are small; the frequency ladders of
    XLA's and torch's float32 ``exp`` differ by one ulp at some entries (16
    of 128 at dim 256), which moves an argument w·1000·f by up to one ulp
    of w·1000, so the bound grows by 2^-22·w·1000 (1.5e-3 at w = 6.5, an
    LCM request's cfg_scale 7.5)."""
    ref = np.asarray(junet.guidance_scale_embedding(w, dim))
    got = punet.guidance_scale_embedding(torch.as_tensor(w), dim).numpy()
    assert got.shape == ref.shape == (np.size(w), dim)
    assert np.abs(got - ref).max() <= 1e-6 + 2.0 ** -22 * 1000.0 * np.max(w)
    if dim % 2:
        assert not got[:, -1].any()
    assert np.abs(got[:, :dim // 2]).max() <= 1.0  # [sin, cos]: sin(0) = 0 first
    assert (got[:, dim // 2] == 1.0).all() if np.max(w) == 0 else True


@pytest.mark.parametrize("name", ["inpaint", "ip2p", "lcm"])
def test_unet_matches_jax(fam, name):
    """The 9- and 8-channel ``conv_in`` and LCM's ``t_cond`` against JAX
    ``unet.apply``, at test_torch_models.py's UNet tolerance."""
    cfg, jcfg, jp, models = fam[name]
    r = np.random.RandomState(8)
    lat = r.randn(2, 8, 8, cfg.unet.in_channels).astype(np.float32)
    ctx = r.randn(2, 16, cfg.unet.d_context).astype(np.float32)
    t_cond = None
    if cfg.unet.time_cond_dim:
        t_cond = np.asarray(junet.guidance_scale_embedding(4.0, cfg.unet.time_cond_dim))
    ref = np.asarray(junet.apply(jp["diffusion"], lat, ctx, 500, jcfg.unet,
                                 t_cond=None if t_cond is None else jnp.asarray(t_cond)))
    with torch.inference_mode():
        got = models["diffusion"](torch.as_tensor(to_nchw(lat)), torch.as_tensor(ctx), 500,
                                  t_cond=None if t_cond is None else torch.as_tensor(t_cond))
        if t_cond is not None:  # the guidance embedding reaches the output
            other = models["diffusion"](torch.as_tensor(to_nchw(lat)), torch.as_tensor(ctx),
                                        500, t_cond=torch.as_tensor(t_cond * 0.5))
            assert (other - got).abs().max() > 1e-4
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- converter
@pytest.mark.parametrize("schema", ["compvis", "diffusers"])
@pytest.mark.parametrize("name", ["inpaint", "ip2p", "lcm"])
def test_converter_round_trips(fam, name, schema):
    """``cond_proj`` and the 9-/8-channel ``conv_in`` through deconvert ->
    convert in both schemas, bit for bit, and equal to the JAX package's
    state dicts."""
    cfg, jcfg, jp, models = fam[name]
    if schema == "compvis":
        sd = convert.deconvert(models, cfg)
        ref = jconvert.deconvert(jp, jcfg)
        back = convert.convert(sd, cfg)
        unet_sd = {k: v for k, v in sd.items() if "diffusion_model" in k}
        prefix = "model.diffusion_model."
    else:
        parts = diffusers.deconvert_diffusers(models, cfg)
        unet_sd = parts[0]
        ref = jdiffusers.deconvert_diffusers(jp, jcfg)[0]
        back = diffusers.convert_diffusers(*parts, cfg)
        prefix = ""
    conv_in = prefix + ("input_blocks.0.0.weight" if schema == "compvis" else "conv_in.weight")
    assert unet_sd[conv_in].shape[1] == cfg.unet.in_channels
    cond = prefix + ("time_embed.cond_proj.weight" if schema == "compvis"
                     else "time_embedding.cond_proj.weight")
    assert (cond in unet_sd) == (name == "lcm")
    for k, v in unet_sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    for k, v in models["diffusion"].state_dict().items():
        assert torch.equal(back["diffusion"][k], v), k


# ------------------------------------------------ port-only properties
def test_blend_keeps_the_original_latents(fam):
    """Where the latent (area-mean) mask is 0 the final latents are the
    encoded init image's, exactly: the final projection."""
    cfg, _, _, models = fam["base"]
    noise = nchw_noise(noise_for(HW, HW))
    img = _image(3)
    _, lat = pipeline.generate("a cat", models=models, config=cfg, fixed_noise=noise,
                               tokenizer=make_test_tokenizer(WORDS, max_len=16),
                               input_image=img, mask_image=_mask(), strength=0.75,
                               return_latents=True, **_kw())
    pixels = torch.as_tensor(pipeline._prepare_image(img, HW, HW))
    with torch.inference_mode():
        lat0 = pipeline.encode_image(models, pixels, torch.as_tensor(noise["encoder_noise"]),
                                     cfg).float().numpy()
    keep = pipeline.mask_to_latent_area(_mask()[None, ..., None], 2)[..., 0] == 0
    assert keep.sum() > 100
    np.testing.assert_array_equal(lat[:, :, keep[0]], lat0[:, :, keep[0]])


def test_color_correction_pins_the_palette(fam):
    """The corrected image is the histogram match of the uncorrected one."""
    cfg, _, _, models = fam["base"]
    kw = dict(_kw(), models=models, config=cfg, input_image=_image(6), strength=0.6,
              tokenizer=make_test_tokenizer(WORDS, max_len=16),
              fixed_noise=nchw_noise(noise_for(HW, HW)))
    plain = pipeline.generate("a cat", **kw)
    fixed = pipeline.generate("a cat", color_correction=True, **kw)
    # the init image as the pipeline holds it, in [-1, 1], back in 0..255
    ref = np.clip(pipeline.rescale(pipeline._prepare_image(_image(6), HW, HW)[0], (-1.0, 1.0),
                                   (0.0, 255.0)), 0, 255).astype(np.uint8).transpose(1, 2, 0)
    np.testing.assert_array_equal(fixed, pipeline.match_histograms(plain, ref))
    assert not np.array_equal(fixed, plain)


@pytest.mark.parametrize("name,kw,encodes", [
    ("inpaint", dict(input_image=_image(1), mask_image=_mask()), 2),
    ("inpaint", {}, 1),  # from text: the masked (all-zero) image only
    ("base", dict(input_image=_image(1), mask_image=_mask(), strength=0.5), 1),
    ("ip2p", dict(edit_image=_image(1)), 1),
    ("lcm", dict(do_cfg=False, sampler_name="lcm"), 0),
])
def test_launch_rule_counts_the_vae_encodes(fam, name, kw, encodes):
    """``chip_smoke.expected_launches(encodes=...)`` (the launch rule the
    card's C3 requests are held to) counts every VAE pass: the tiny VAE's
    mid block (256 tokens, Dh 32) takes K1's path on the kernel backend,
    once a decode and once an encode."""
    from unittest import mock

    import chip_smoke
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    cfg = dataclasses.replace(fam[name][0], vae_attention_backend="kernel")
    want = chip_smoke.expected_launches(cfg, HW, HW, steps=STEPS, img2img=False,
                                        encodes=encodes)
    with mock.patch.object(fa, "flash_attention_bsc_plain",
                           wraps=fa.flash_attention_bsc_plain) as k1:
        pipeline.generate("a cat", models=fam[name][3], config=cfg,
                          tokenizer=make_test_tokenizer(WORDS, max_len=16), **_kw(**kw))
    assert want["K1"] == k1.call_count == 1 + encodes


# ------------------------------------------------------------------ errors
ERRORS = {
    "mask without an image": ("base", dict(mask_image=_mask())),
    "unet9, an image but no mask": ("inpaint", dict(input_image=_image(1))),
    "init_latents with a mask": ("base", dict(init_latents=np.zeros((1, 16, 16, 4), np.float32),
                                              mask_image=_mask())),
    "init_latents on unet9": ("inpaint", dict(init_latents=np.zeros((1, 16, 16, 4),
                                                                    np.float32))),
    "ip2p with img2img": ("ip2p", dict(edit_image=_image(1), input_image=_image(2))),
    "ip2p with a mask": ("ip2p", dict(edit_image=_image(1), mask_image=_mask())),
    "ip2p without CFG": ("ip2p", dict(edit_image=_image(1), do_cfg=False)),
    "ip2p on a 4-channel UNet": ("base", dict(edit_image=_image(1))),
    "ip2p with prompt editing": ("ip2p", dict(edit_image=_image(1),
                                              prompt="a [cat:dog:1] photo")),
    "restart with inpaint": ("base", dict(sampler_name="restart", input_image=_image(1),
                                          mask_image=_mask())),
    "dpm_adaptive with unet9": ("inpaint", dict(sampler_name="dpm_adaptive")),
}


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", list(ERRORS))
def test_refusals_match_jax(fam, case):
    """Each ValueError the JAX package raises for these options, with the
    same message, before any work."""
    name, kw = ERRORS[case]
    cfg, jcfg, jp, models = fam[name]
    kw = dict(dict(_kw(), prompt="a cat"), **kw)
    jkw = dict(kw)
    if "init_latents" in kw:
        jkw["init_latents"] = np.zeros((1, 16, 16, 4), np.float32)
        kw["init_latents"] = np.zeros((1, 4, 16, 16), np.float32)
    ref = _message(lambda: jpipeline.generate(models=jp, config=jcfg,
                                              tokenizer=jtokenizer(WORDS, max_len=16), **jkw))
    got = _message(lambda: pipeline.generate(models=models, config=cfg,
                                             tokenizer=make_test_tokenizer(WORDS, max_len=16),
                                             **kw))
    assert got == ref


def test_color_correction_needs_an_image(fam):
    """The JAX package's message; it raises after the request has run (a
    compile), the port before any work."""
    cfg, _, _, models = fam["base"]
    with pytest.raises(ValueError, match="^color_correction requires input_image$"):
        pipeline.generate("a cat", models=models, config=cfg, color_correction=True,
                          tokenizer=make_test_tokenizer(WORDS, max_len=16), **_kw())


@pytest.mark.parametrize("method,kw,match", [
    ("hires_fix", dict(upscale_method="area"), "unknown upscale_method"),
    ("inpaint", dict(masked_content="latent nothing"), "unknown masked_content"),
])
def test_api_refusals_match_jax(fam, method, kw, match):
    cfg, jcfg, jp, models = fam["base"]
    args = () if method == "hires_fix" else (_image(1), _mask())
    jsd = japi.StableDiffusion(jp, jtokenizer(WORDS, max_len=16), jcfg)
    psd = api.StableDiffusion(models, make_test_tokenizer(WORDS, max_len=16), cfg,
                              device="cpu")
    if method == "hires_fix":  # the JAX package checks after its first pass
        ref = f"unknown upscale_method {kw['upscale_method']!r}"
    else:
        ref = _message(lambda: getattr(jsd, method)("a cat", *args, **kw))
    got = _message(lambda: getattr(psd, method)("a cat", *args, **kw))
    assert got == ref and match in got


def test_generate_many_refuses_color_correction(fam):
    cfg, _, _, models = fam["base"]
    with pytest.raises(ValueError, match="async generate_many path"):
        pipeline.generate_many(["a cat"], models=models, config=cfg, input_image=_image(1),
                               tokenizer=make_test_tokenizer(WORDS, max_len=16),
                               color_correction=True,
                               **{k: v for k, v in _kw().items() if k != "uncond_prompt"})


def test_new_streams_golden_values():
    """First values of the two streams slice C3 adds, for seed 1337 —
    frozen: changing them changes every inpainted image of a seed."""
    from pytorch_stable_diffusion_tpu_torch.core import rng

    got = {"mask_encoder_noise": float(rng.batch_normal(1337, "mask_encoder_noise", 1,
                                                        (4,))[0, 0]),
           "inpaint": float(rng.step_normals(1337, "inpaint", 2, 1, (4,))[1, 0, 0])}
    expect = {"mask_encoder_noise": -0.10541841387748718, "inpaint": 3.5107173919677734}
    for k, v in expect.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
