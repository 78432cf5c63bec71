"""The port at full SD-1.5 width against the EXECUTED reference goldens.

* tests/goldens/reference_pipeline.npz (tests/record_reference_pipeline.py,
  the reference's own ``generate``): the whole pipeline, FP32,
  ``reference_quirks=True``, the recorded noise injected with
  ``fixed_noise``, 128x128 pixels, 5 DDPM steps with CFG.  Bars: final
  latents PSNR > 55 dB and uint8 image PSNR > 40 dB, as for the JAX package.
* tests/goldens/reference_fullsize.npz (tests/record_reference_goldens.py):
  the CLIP, UNet and VAE forwards one by one, PSNR > 55 dB, and the
  corrected default mode diverging where the reference's bugs live — the
  bars of tests/test_reference_goldens.py.

Both were recorded with the same weights, rebuilt here as the JAX tests do
(fullsize_utils -> the JAX package's ``deconvert``) and loaded through the
port's CompVis converter.
"""

import os

import numpy as np
import pytest
import torch

import fullsize_utils
from conftest import psnr

from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.weights import convert as jconvert
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models
from pytorch_stable_diffusion_tpu_torch.models.config import sd15_config
from pytorch_stable_diffusion_tpu_torch.models.unet import timestep_embedding
from pytorch_stable_diffusion_tpu_torch.weights import convert

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PROMPT = "a photograph of an astronaut riding a horse"
IMG_HW = fullsize_utils.IMG_HW


class _TableTokenizer:
    """Replays the exact token ids the reference run saw."""

    def __init__(self, table):
        self.table = table

    def batch_encode(self, prompts):
        return [list(self.table[p]) for p in prompts]


@pytest.fixture(scope="module")
def bits():
    g = dict(np.load(os.path.join(GOLDENS, "reference_pipeline.npz")).items())
    mods = dict(np.load(os.path.join(GOLDENS, "reference_fullsize.npz")).items())
    jcfg = jconfig.sd15_config(reference_quirks=True)
    params = fullsize_utils.init_fullsize_params(jcfg)
    sd = jconvert.deconvert(params, jcfg)
    for golden in (g, mods):
        for k, v in fullsize_utils.fingerprint(sd).items():
            np.testing.assert_allclose(v, golden[f"fp_{k}"], rtol=1e-6,
                                       err_msg=f"weight fingerprint drift at {k}")
    state = convert.convert(sd, sd15_config(reference_quirks=True))
    del params, sd  # free the JAX weights before the port's copy is built
    models = build_models(sd15_config(reference_quirks=True), device="cpu",
                          state_dicts=state)
    del state
    tok = _TableTokenizer({PROMPT: g["cond_tokens"][0], "": g["uncond_tokens"][0]})
    return g, models, tok, mods


def _nchw(x):
    return np.moveaxis(np.asarray(x), -1, -3)  # (..., H, W, C) -> (..., C, H, W)


def _run(g, models, tok, quirks=True, img2img=False):
    pre = "i2i" if img2img else "t2i"
    noise = {"latent_init": _nchw(g[f"{pre}_latent_init"]),
             "sampler_noise": _nchw(g[f"{pre}_sampler_noise"])}
    kw = {}
    if img2img:
        noise["encoder_noise"] = _nchw(g["i2i_encoder_noise"])
        kw = dict(input_image=g["i2i_input_image"], strength=float(g["strength"]))
    with torch.inference_mode():
        return pipeline.generate(
            PROMPT, uncond_prompt="", do_cfg=True, cfg_scale=float(g["cfg_scale"]),
            sampler_name="ddpm", n_inference_steps=int(g["n_steps"]),
            models=models, seed=1337, tokenizer=tok,
            config=sd15_config(reference_quirks=quirks), height=IMG_HW,
            width=IMG_HW, fixed_noise=noise, return_latents=True, **kw)


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_end_to_end_matches_executed_reference(bits, img2img):
    g, models, tok, _ = bits
    pre = "i2i" if img2img else "t2i"
    image, latents = _run(g, models, tok, img2img=img2img)
    lat_db = psnr(latents, g[f"{pre}_latents"])
    assert lat_db > 55.0, f"{pre} final-latent PSNR {lat_db:.1f} dB"
    assert image.dtype == np.uint8 and image.shape == (IMG_HW, IMG_HW, 3)
    img_db = psnr(image.astype(np.float32), g[f"{pre}_image"].astype(np.float32))
    assert img_db > 40.0, f"{pre} image PSNR {img_db:.1f} dB"


def test_default_mode_diverges_from_reference(bits):
    """The corrected default (gated GeGLU, real VAE un-transpose, CompVis
    beta_start) must NOT match the reference's goldens."""
    g, models, tok, _ = bits
    _, latents = _run(g, models, tok, quirks=False)
    assert psnr(latents, g["t2i_latents"]) < 30


# ------------------------------------------------------ module by module
def test_time_embedding_matches_reference_helper(bits):
    mods = bits[3]
    ours = timestep_embedding(int(mods["in_timestep"]), 320).numpy()
    np.testing.assert_allclose(ours, mods["out_time_embedding"], rtol=1e-5, atol=1e-6)


def test_clip_fullsize_vs_reference(bits):
    _, models, _, mods = bits
    with torch.inference_mode():
        ours = models["clip"](torch.from_numpy(mods["in_tokens"])).numpy()
    assert psnr(ours, mods["out_clip_out"]) > 55.0


@pytest.mark.parametrize("quirks", [True, False])
def test_unet_fullsize_vs_reference(bits, quirks):
    _, models, _, mods = bits
    ctx = torch.from_numpy(mods["out_clip_out"][:1])
    with torch.inference_mode():
        ours = models["diffusion"](torch.from_numpy(mods["in_latent"]), ctx,
                                   int(mods["in_timestep"]),
                                   reference_quirks=quirks).numpy()
    score = psnr(ours, mods["out_diffusion_out"])
    if quirks:
        assert score > 55.0, f"UNet PSNR {score:.1f} dB"
    else:  # the corrected default (gated GeGLU) genuinely diverges
        assert score < 30, f"UNet default mode PSNR {score:.1f} dB"


def test_vae_encoder_fullsize_vs_reference(bits):
    _, models, _, mods = bits
    with torch.inference_mode():
        ours = models["encoder"](torch.from_numpy(mods["in_image"]),
                                 torch.from_numpy(mods["in_enc_noise"]),
                                 reference_quirks=True).numpy()
    assert psnr(ours, mods["out_encoder_out"]) > 55.0


@pytest.mark.parametrize("quirks", [True, False])
def test_vae_decoder_fullsize_vs_reference(bits, quirks):
    _, models, _, mods = bits
    with torch.inference_mode():
        ours = models["decoder"](torch.from_numpy(mods["in_latent"]),
                                 reference_quirks=quirks).numpy()
    score = psnr(ours, mods["out_decoder_out"])
    if quirks:
        assert score > 55.0, f"VAE-dec PSNR {score:.1f} dB"
    else:  # the real un-transpose + applied GN genuinely diverge
        assert score < 45, f"VAE-dec default mode PSNR {score:.1f} dB"
