"""Slice E's T2I-Adapter (SD-1.5 and SDXL) and IP-Adapter (standard and
plus) through ``generate()`` against the JAX package, at
``compare_generate``'s bar (latents > 55 dB, images > 40 dB), and
reference-only.

Reference-only refuses ``fixed_noise`` in both packages, so one reference
evaluation of the port's pipeline (re-noise, capture, read) is held to the
same composition of the JAX ``vae.apply_encoder``, ``ddpm.add_noise`` and
``unet.apply`` on the noise the port drew, and the pipeline by its
properties.  Fixture and helpers: tests/test_torch_side_net_pipelines.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_families import exact_gelu  # noqa: F401
from test_torch_side_net_pipelines import (HW, IP, STEPS, TOL, WORDS, _canny_hint,  # noqa: F401
                                           _image, check_generate, compare, fam,
                                           one_torch_thread)

from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.models import vae as jvae
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

GENERATE = {
    "t2i-adapter": dict(adapter_image=_canny_hint(4), adapter_scale=0.8),
    "ip-adapter": IP,
    "ip-adapter plus": dict(IP, ip="plus"),
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(fam, case):
    check_generate(fam, case, GENERATE)


def test_sdxl_t2i_adapter_matches_jax(fam, exact_gelu):  # noqa: F811
    """full_adapter_xl: three features, the last after the bottleneck."""
    lat_db, img_db = compare(fam, "xl", adapter_image=_canny_hint(6), adapter_scale=1.2)
    assert lat_db > 55.0, lat_db
    assert img_db > 40.0, img_db


# -------------------------------------------------------------- reference-only
def _spy(monkeypatch, unet):
    """Record every call of ``unet`` (args, kwargs, output)."""
    calls = []
    forward = unet.forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(unet, "forward", recording)
    return calls


def _port(fam, **kw):
    cfg, _, _, models = fam["sd"]
    kw = dict(dict(uncond_prompt="a dog", cfg_scale=5.0, n_inference_steps=STEPS, seed=3,
                   height=HW, width=HW, reference_image=_image(8)), **kw)
    return pipeline.generate("a photo of a cat", models=models, config=cfg,
                             tokenizer=make_test_tokenizer(WORDS, max_len=16),
                             return_latents=True, **kw)


def test_reference_evaluation_matches_jax(fam, monkeypatch, mode="adain+attn"):
    """One evaluation (ddim, one step) of a reference request in the mode
    that reads both banks: the capture pass's input is the reference
    encoded on the 'ref_encoder' draw and re-noised by the 'ref_noise' draw
    of step 0 (JAX encoder and ddpm.add_noise on those draws); the main
    pass's output is JAX unet.apply's read of the banks its capture of that
    input fills.  (Each mode alone: test_torch_side_nets.py.)"""
    cfg, jcfg, jp, models = fam["sd"]
    calls = _spy(monkeypatch, models["diffusion"])
    _port(fam, sampler_name="ddim", n_inference_steps=1, reference_mode=mode,
          reference_fidelity=0.4)
    (cap_args, cap_kw, cap_out), (main_args, main_kw, main_out) = calls
    assert cap_out is None and not cap_kw["head"]
    t = int(cap_args[2])
    lat_shape = (4, HW // 2, HW // 2)
    nhwc = lambda a: jnp.asarray(np.transpose(np.asarray(a), (0, 2, 3, 1)))  # noqa: E731
    px = pipeline._prepare_image(_image(8), HW, HW)
    attn, adain = "attn" in mode, "adain" in mode

    def composition(p, x, enc_noise, noise, main_in, ctx):
        """The JAX encoder, ddpm.add_noise, the capture and the read, in one
        program (the banks are filled and read while it is traced)."""
        ref_lat0 = jvae.apply_encoder(p["encoder"], x, enc_noise, jcfg.vae)
        rn = jddpm.add_noise(jddpm.make_schedule(), ref_lat0, t, noise)
        bank, abank = {}, {}
        junet.apply(p["diffusion"], jnp.concatenate([rn, rn]), ctx, t, jcfg.unet,
                    ref=("capture", bank) if attn else None,
                    ref_adain=("capture", abank) if adain else None)
        read = (jnp.float32(0.4), jnp.asarray([0.0, 1.0], jnp.float32))
        return rn, junet.apply(p["diffusion"], main_in, ctx, t, jcfg.unet,
                               ref=("read", bank, *read) if attn else None,
                               ref_adain=("read", abank, *read) if adain else None)

    rn, ref = jax.jit(composition)(
        {k: jp[k] for k in ("encoder", "diffusion")}, nhwc(px),
        nhwc(rng.batch_normal(3, "ref_encoder", 1, lat_shape)),
        nhwc(rng.step_normals(3, "ref_noise", 1, 1, lat_shape)[0]), nhwc(main_args[0]),
        jnp.asarray(cap_args[1].numpy()))
    np.testing.assert_allclose(cap_args[0].numpy(), to_nchw(jnp.concatenate([rn, rn])), **TOL)
    np.testing.assert_allclose(main_out.numpy(), to_nchw(ref), **TOL)


def test_reference_fidelity_one_gives_the_uncond_lanes_plain_attention(fam, monkeypatch):
    """At fidelity 1 the uncond lane's read is plain self-attention: its
    output equals a UNet call without the reference, bit for bit; the cond
    lane's differs."""
    calls = _spy(monkeypatch, fam["sd"][3]["diffusion"])
    _port(fam, sampler_name="ddim", n_inference_steps=1, reference_fidelity=1.0)
    (_, _, _), (args, kw, out) = calls
    unet = fam["sd"][3]["diffusion"]
    plain_kw = {k: v for k, v in kw.items() if k not in ("ref", "ref_adain")}
    with torch.inference_mode():
        plain = unet(*args, **plain_kw)
    assert torch.equal(out[1:], plain[1:])
    assert not torch.equal(out[:1], plain[:1])


def test_reference_is_deterministic_and_each_mode_moves_the_image(fam):
    a = _port(fam, sampler_name="dpm++")
    b = _port(fam, sampler_name="dpm++")
    np.testing.assert_array_equal(a[1], b[1])
    none = _port(fam, sampler_name="dpm++", reference_image=None)
    for mode in ("attn", "adain", "attn+adain"):
        lat = _port(fam, sampler_name="dpm++", reference_mode=mode)[1]
        assert np.abs(lat - none[1]).max() > 1e-3, mode
    assert np.abs(_port(fam, sampler_name="dpm++", seed=4)[1] - a[1]).max() > 1e-3
