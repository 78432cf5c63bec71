"""The rest of the JAX package's public surface on the port, against the JAX
package: the ``MIXED`` policy, the top-level loaders (the JAX quick start),
``get_time_embedding`` and ``rescale``, and the two user scripts
``examples/torch_inference_demo.py`` and ``examples/torch_aot_serve.py``.

One tiny checkpoint carries the weights across: the port draws them (the
JAX init's distributions, ``build_models``), writes them with its own
``save_safetensors``, and each package reads the file with its own
``load_models``.  Noise is injected (``fixed_noise``) where the two
packages are compared.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from conftest import psnr, to_nchw
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

import pytorch_stable_diffusion_tpu as jsdt
from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jax_tokenizer
import pytorch_stable_diffusion_tpu_torch as sdt
from pytorch_stable_diffusion_tpu_torch.weights import diffusers, save
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "cat", "dog", "photo", "of"]
PROMPT = "a photo of a cat"
STEPS, HW = 3, 32
KERNELS = dict(attention_backend="kernel", conv_backend="kernel",
               vae_attention_backend="kernel")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny checkpoint in fp32 and in bf16, its diffusers directory and
    the test tokenizer's vocab.json / merges.txt."""
    d = tmp_path_factory.mktemp("surface")
    cfg = sdt.tiny_sd_config()
    models = sdt.build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    out = {"ckpt": str(d / "tiny.safetensors"), "ckpt16": str(d / "tiny_bf16.safetensors"),
           "diffusers": str(d / "diffusers")}
    save.save_safetensors(models, cfg, out["ckpt"])
    save.save_safetensors(models, cfg, out["ckpt16"], dtype=torch.bfloat16)
    unet_sd, vae_sd, te_sd = diffusers.deconvert_diffusers(models, cfg)
    for sub, sd, name in (("unet", unet_sd, "diffusion_pytorch_model.safetensors"),
                          ("vae", vae_sd, "diffusion_pytorch_model.safetensors"),
                          ("text_encoder", te_sd, "model.safetensors")):
        os.makedirs(os.path.join(out["diffusers"], sub))
        save.write_safetensors(sd, os.path.join(out["diffusers"], sub, name))
    out["vocab"], out["merges"] = chip_smoke._tokenizer_files(
        make_test_tokenizer(WORDS, max_len=cfg.clip.max_len), str(d))
    return out


def _noise():
    """Injected noise, NHWC for the JAX package and NCHW for the port."""
    r = np.random.RandomState(11)
    noise = {"latent_init": r.randn(1, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 1, 16, 16, 4).astype(np.float32)}
    ours = {"latent_init": to_nchw(noise["latent_init"]),
            "sampler_noise": np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))}
    return noise, ours


KW = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0, height=HW,
          width=HW, return_latents=True)


def _against_jax(files, jcfg, cfg):
    """(port latents, JAX latents, port image, JAX image) of one injected-
    noise request, each package on its own ``load_models`` of the file."""
    noise, ours = _noise()
    ref_img, ref_lat = jpipeline.generate(
        PROMPT, models=jsdt.load_models(files["ckpt"], jcfg), config=jcfg,
        tokenizer=jax_tokenizer(WORDS, max_len=16), fixed_noise=noise, **KW)
    models = sdt.load_models(files["ckpt"], cfg, device="cpu")
    assert {p.dtype for m in models.values() for p in m.parameters()} \
        == {cfg.policy.param_dtype}
    img, lat = sdt.generate(PROMPT, models=models, config=cfg, fixed_noise=ours,
                            tokenizer=make_test_tokenizer(WORDS, max_len=16), **KW)
    return lat, to_nchw(ref_lat), img, ref_img


# --------------------------------------------------------------- helpers
@pytest.mark.parametrize("t", [0, 1, 500, 999])
def test_get_time_embedding_matches_jax(t):
    got = sdt.get_time_embedding(t, device="cpu")
    ref = np.asarray(jsdt.get_time_embedding(t))
    assert got.shape == ref.shape == (1, 320) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("clamp", [False, True])
def test_rescale_matches_jax(clamp):
    x = np.linspace(-3.0, 4.0, 29, dtype=np.float32)
    ref = np.asarray(jsdt.rescale(x, (-1, 1), (0, 255), clamp=clamp))
    np.testing.assert_allclose(sdt.rescale(x, (-1, 1), (0, 255), clamp=clamp), ref,
                               rtol=0, atol=1e-6)
    got = sdt.rescale(torch.from_numpy(x), (-1, 1), (0, 255), clamp=clamp)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------- quick start
def test_quick_start_matches_jax(files):
    """The JAX quick start's calls on both packages (FP32, default
    backends), the same file read by each package's ``load_models``."""
    lat, ref_lat, img, ref_img = _against_jax(files, jconfig.tiny_sd_config(),
                                              sdt.tiny_sd_config())
    assert psnr(lat, ref_lat) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


@pytest.mark.parametrize("loader", ["diffusers", "streamed"])
def test_loaders_give_what_generate_takes(files, loader):
    """Each top-level loader returns the models ``generate(models=)``
    takes: the same weights as ``load_models`` and the same image."""
    cfg = sdt.tiny_sd_config()
    want = sdt.load_models(files["ckpt"], cfg, device="cpu")
    got = sdt.load_diffusers_models(files["diffusers"], cfg, device="cpu") \
        if loader == "diffusers" else sdt.load_models_streamed(files["ckpt"], cfg, device="cpu")
    assert set(got) == set(want)
    for name, m in want.items():
        assert isinstance(got[name], torch.nn.Module)
        for k, v in m.state_dict().items():
            assert torch.equal(got[name].state_dict()[k], v), f"{name}.{k}"
    kw = dict(tokenizer=make_test_tokenizer(WORDS, max_len=16), config=cfg, seed=5,
              n_inference_steps=2, height=HW, width=HW)
    np.testing.assert_array_equal(sdt.generate(PROMPT, models=got, **kw),
                                  sdt.generate(PROMPT, models=want, **kw))


# ----------------------------------------------------------------- MIXED
def test_mixed_matches_jax_mixed(files):
    """MIXED against the JAX package's MIXED, fp32 weights on both sides.
    Measured on the CPU: latents 39.92 dB, the images at most 7 uint8
    levels apart (BF16 against BF16 gives the same; with the attention on
    the Pallas kernel in interpret mode and K1's plain version, 39.84 dB)."""
    lat, ref_lat, img, ref_img = _against_jax(
        files, jconfig.tiny_sd_config(policy=jsdt.MIXED), sdt.tiny_sd_config(policy=sdt.MIXED))
    assert psnr(lat, ref_lat) > 35.0


_INIT = np.random.RandomState(0).randint(0, 256, (HW, HW, 3)).astype(np.uint8)
ENTRY_POINTS = {
    "generate": lambda c, m, tok: sdt.generate(
        PROMPT, models=m, config=c, tokenizer=tok, seed=3, n_inference_steps=STEPS,
        height=HW, width=HW, return_latents=True),
    "img2img": lambda c, m, tok: sdt.generate(
        PROMPT, models=m, config=c, tokenizer=tok, seed=3, n_inference_steps=STEPS,
        height=HW, width=HW, input_image=_INIT, strength=0.6, return_latents=True),
    "generate_images": lambda c, m, tok: sdt.generate_images(
        [PROMPT, "a dog"], models=m, config=c, tokenizer=tok, seed=3,
        n_inference_steps=STEPS, height=HW, width=HW),
    "generate_many": lambda c, m, tok: sdt.generate_many(
        [PROMPT, "a dog", "a cat"], models=m, config=c, tokenizer=tok, seed=3,
        batch_size=2, n_inference_steps=STEPS, height=HW, width=HW),
    "StableDiffusion": lambda c, m, tok: sdt.StableDiffusion(m, tok, c, device="cpu").txt2img(
        PROMPT, seed=3, n_inference_steps=STEPS, height=HW, width=HW),
    "quant w8": lambda c, m, tok: sdt.generate(
        PROMPT, models=m, config=dataclasses.replace(c, quant="w8"), tokenizer=tok, seed=3,
        n_inference_steps=STEPS, height=HW, width=HW, return_latents=True),
    "quant conv": lambda c, m, tok: sdt.generate(
        PROMPT, models=m, config=dataclasses.replace(c, quant="conv"), tokenizer=tok, seed=3,
        n_inference_steps=STEPS, height=HW, width=HW, return_latents=True),
}


def _load16(files, cfg, dtype=None):
    models = sdt.load_models(files["ckpt16"], cfg, dtype, device="cpu")
    assert {p.dtype for m in models.values() for p in m.parameters()} \
        == {dtype or cfg.policy.param_dtype}
    return models


def _assert_same(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_mixed_is_bf16_from_bf16_valued_weights(files, entry):
    """From a bf16 file, MIXED holds the weights in fp32 (the same values)
    and casts each at use: every entry point gives BF16's images and
    latents bit for bit, on the kernel backends (their plain versions
    here)."""
    bf16 = sdt.tiny_sd_config(policy=sdt.BF16, **KERNELS)
    mixed = dataclasses.replace(bf16, policy=sdt.MIXED)
    tok = make_test_tokenizer(WORDS, max_len=16)
    _assert_same(ENTRY_POINTS[entry](mixed, _load16(files, mixed), tok),
                 ENTRY_POINTS[entry](bf16, _load16(files, bf16), tok))


def test_load_models_dtype(files):
    """``dtype`` stores the weights in another dtype than the policy's: a
    BF16 request on fp32 weights of bf16 values is BF16's, bit for bit."""
    bf16 = sdt.tiny_sd_config(policy=sdt.BF16, **KERNELS)
    tok = make_test_tokenizer(WORDS, max_len=16)
    _assert_same(ENTRY_POINTS["generate"](bf16, _load16(files, bf16, torch.float32), tok),
                 ENTRY_POINTS["generate"](bf16, _load16(files, bf16), tok))


# --------------------------------------------------------------- scripts
def test_aot_serve_selftest():
    """``torch_aot_serve.py --selftest --device cpu``: each of its two
    requests through :func:`serve_request` (an artifact exported under
    MIXED) is bit-identical to eager ``generate`` with the same seed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _script("torch_aot_serve").main(["--selftest", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0, text
    for i in (0, 1):
        assert f"bit-identical to eager generate(seed={i}): True" in text, text
    assert "[selftest] ok" in text


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_inference_demo_writes_generates_image(files, tmp_path, img2img):
    """``torch_inference_demo.py`` on the tiny checkpoint and tokenizer
    files writes the PNG of ``generate``'s image."""
    out = str(tmp_path / "out.png")
    argv = ["--ckpt", files["ckpt"], "--vocab", files["vocab"], "--merges", files["merges"],
            "--prompt", PROMPT, "--steps", "2", "--seed", "7", "--out", out, "--device", "cpu",
            "--config-preset", "tiny", "--height", str(HW), "--width", str(HW)]
    kw = {}
    if img2img:
        Image.fromarray(_INIT).save(tmp_path / "init.png")
        argv += ["--image", str(tmp_path / "init.png"), "--strength", "0.6"]
        kw = dict(input_image=Image.open(tmp_path / "init.png"), strength=0.6)
    with contextlib.redirect_stdout(io.StringIO()):
        assert _script("torch_inference_demo").main(argv) == 0
    cfg = sdt.tiny_sd_config(policy=sdt.BF16, **KERNELS)
    want = sdt.generate(PROMPT, models=sdt.load_models(files["ckpt"], cfg, device="cpu"),
                        tokenizer=sdt.CLIPTokenizer.from_files(files["vocab"], files["merges"],
                                                               max_len=cfg.clip.max_len),
                        config=cfg, cfg_scale=5.0, n_inference_steps=2, seed=7, height=HW,
                        width=HW, **kw)
    with Image.open(out) as im:
        assert "parameters" in im.info
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
