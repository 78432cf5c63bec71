"""Slice C3 through ``generate()`` and the API methods, against the JAX
package: the 9-channel inpainting UNet, the latent blend on one sampler of
each loop family the pipeline's grid runs (ddpm, dpm++ 2M, heun),
InstructPix2Pix, LCM's embedded guidance,
colour correction, ``hires_fix`` (the four latent methods),
``inpaint(full_res=True)``, ``masked_content="fill"``, ``outpaint`` and
``edit``.  The models, the injected noise and the bar (latents > 55 dB,
images > 40 dB) are tests/test_torch_edit_families.py's; each case costs a
JAX compile (the cases share them where their static arguments agree:
strength, the mask and the method of a resize are traced or host-side),
and two files let two test workers share them.
"""

import numpy as np
import pytest

from conftest import psnr, to_nchw
from test_torch_edit_families import (HW, STEPS, WORDS, _image, _mask, compare, fam,  # noqa: F401
                                      nchw_noise, noise_for, one_torch_thread)

from pytorch_stable_diffusion_tpu import api as japi
from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import api, pipeline
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer


# ------------------------------------------------------------ generate()
GENERATE = {
    "unet9 inpaint": ("inpaint", dict(input_image=_image(1), mask_image=_mask(),
                                      strength=1.0)),
    "unet9 from text (no image)": ("inpaint", dict(sampler_name="euler")),
    "unet9 mask_blur, strength 0.7": ("inpaint", dict(
        input_image=_image(2), mask_image=_mask(), mask_blur=2, strength=0.7)),
    "blend ddpm": ("base", dict(input_image=_image(3), mask_image=_mask(), strength=0.75)),
    "blend dpm++ 2M": ("base", dict(input_image=_image(3), mask_image=_mask(), strength=0.75,
                                    sampler_name="dpm++", mask_blur=3)),
    "blend heun": ("base", dict(input_image=_image(3), mask_image=_mask(), strength=0.9,
                                sampler_name="heun")),
    "InstructPix2Pix": ("ip2p", dict(edit_image=_image(5), image_guidance_scale=1.7,
                                     sampler_name="euler_a")),
    "LCM, no CFG": ("lcm", dict(do_cfg=False, sampler_name="lcm", cfg_scale=8.0)),
    "LCM with CFG": ("lcm", dict(sampler_name="lcm", cfg_scale=3.0)),
    "color_correction": ("base", dict(input_image=_image(6), strength=0.6,
                                      color_correction=True)),
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(fam, case):
    name, kw = GENERATE[case]
    lat_db, img_db, _ = compare(fam, name, **kw)
    assert lat_db > 55.0, lat_db
    assert img_db > 40.0, img_db


# ------------------------------------------------------------- API methods
def _sized(monkeypatch, mod, to_layout, steps, record):
    """Replace ``mod.generate`` by a wrapper that injects :func:`noise_for`
    at each call's size and records its latents."""
    gen = mod.generate

    def wrapper(prompt, uncond_prompt="", **kw):
        want = kw.pop("return_latents", False)
        noise = to_layout(noise_for(kw.get("height", 512), kw.get("width", 512),
                                    kw.get("n_inference_steps", steps)))
        img, lat = gen(prompt, uncond_prompt, fixed_noise=noise, return_latents=True, **kw)
        record.append(lat)
        return (img, lat) if want else img

    monkeypatch.setattr(mod, "generate", wrapper)


def _bundles(fam, name, monkeypatch):
    cfg, jcfg, jp, models = fam[name]
    jrec, prec = [], []
    _sized(monkeypatch, jpipeline, lambda n: n, STEPS, jrec)
    _sized(monkeypatch, pipeline, nchw_noise, STEPS, prec)
    return (japi.StableDiffusion(jp, jtokenizer(WORDS, max_len=16), jcfg),
            api.StableDiffusion(models, make_test_tokenizer(WORDS, max_len=16), cfg,
                                device="cpu"), jrec, prec)


def _small_mask(h, w):
    m = np.zeros((h, w), np.float32)
    m[20:28, 10:18] = 1.0
    return m


API = {
    "hires_fix bilinear": ("base", "hires_fix", (), dict(height=48, width=40,
                                                        upscale_method="bilinear")),
    "hires_fix lanczos3": ("base", "hires_fix", (), dict(height=48, width=40,
                                                        upscale_method="lanczos3")),
    "hires_fix cubic, base size given": ("base", "hires_fix", (), dict(
        height=48, width=40, base_height=24, base_width=20, upscale_method="cubic")),
    "hires_fix nearest": ("base", "hires_fix", (), dict(height=48, width=40,
                                                       upscale_method="nearest")),
    "inpaint full_res (unet9)": ("inpaint", "inpaint", (_image(7, 48, 40), _small_mask(48, 40)),
                                 dict(full_res=True, full_res_padding=4)),
    "inpaint full_res (blend)": ("base", "inpaint", (_image(7, 48, 40), _small_mask(48, 40)),
                                 dict(full_res=True, full_res_padding=2, strength=0.8)),
    "inpaint masked_content=fill": ("base", "inpaint", (_image(8), _mask()),
                                    dict(masked_content="fill", strength=0.7)),
    "outpaint left and right": ("inpaint", "outpaint", (_image(9, 32, 24),),
                                dict(pixels=4, directions=("left", "right"))),
    "outpaint all four (blend)": ("base", "outpaint", (_image(9, 24, 24),), dict(pixels=4)),
    "edit": ("ip2p", "edit", (_image(10),), dict(image_guidance_scale=1.2,
                                                 sampler_name="euler_a")),
}


@pytest.mark.parametrize("case", list(API))
def test_api_methods_match_jax(fam, monkeypatch, case):
    """``hires_fix`` (the four latent methods), ``inpaint`` (full_res,
    fill), ``outpaint`` and ``edit`` against the JAX package's methods: the
    final latents > 55 dB, the returned images > 40 dB.  full_res returns
    the original's size, and the pixels outside its crop are the input's."""
    name, method, args, kw = API[case]
    jsd, psd, jrec, prec = _bundles(fam, name, monkeypatch)
    kw = dict(dict(cfg_scale=5.0, n_inference_steps=STEPS, seed=0), **kw)
    if method not in ("hires_fix", "outpaint"):
        kw.update(height=HW, width=HW)
    ref = getattr(jsd, method)("a photo of a cat", *args, **kw)
    got = getattr(psd, method)("a photo of a cat", *args, **kw)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert len(prec) == len(jrec) == (2 if method == "hires_fix" else 1)
    assert psnr(prec[-1], to_nchw(np.asarray(jrec[-1]))) > 55.0
    assert psnr(got.astype(np.float32), ref.astype(np.float32)) > 40.0
    if kw.get("full_res"):
        image, mask = args
        ys, xs = np.nonzero(mask > 0.5)
        outside = np.ones(mask.shape, bool)
        outside[max(ys.min() - 8, 0):ys.max() + 9, :] = False  # the crop's rows at most
        assert got.shape == image.shape
        np.testing.assert_array_equal(got[outside], image[outside])
    if method == "outpaint":
        assert got.shape[1] == args[0].shape[1] + 2 * kw["pixels"]
