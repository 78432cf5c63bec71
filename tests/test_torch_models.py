"""The port's CLIP, UNet and VAE against the JAX forwards at tiny_sd_config,
with the JAX weights loaded through weights.convert.from_jax_params, under
the FP32 policy and in both reference_quirks modes; the tiled VAE encode
and decode; converter coverage; the SD-1.5 parameter counts.

Tolerance 1e-4 abs/rel: fp32 throughout, but a few dozen convs, norms and
matmuls deep, each summing in another order than XLA (conv sums of up to
9·64 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw

from pytorch_stable_diffusion_tpu.models import clip as jclip
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.models import vae as jvae
from pytorch_stable_diffusion_tpu_torch.models import (build_models, construct,
                                                       param_count)
from pytorch_stable_diffusion_tpu_torch.models import vae
from pytorch_stable_diffusion_tpu_torch.models.config import (sd15_config,
                                                              tiny_sd_config)
from pytorch_stable_diffusion_tpu_torch.weights import convert

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def port_models(tiny_models):
    cfg = tiny_sd_config()
    return build_models(cfg, device="cpu", state_dicts=convert.from_jax_params(tiny_models, cfg))


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_clip(tiny_cfg, tiny_models, port_models):
    tokens = np.random.RandomState(0).randint(0, tiny_cfg.clip.vocab_size,
                                              size=(2, tiny_cfg.clip.max_len))
    ref = jax.jit(lambda p, t: jclip.apply(p, t, tiny_cfg.clip))(
        tiny_models["clip"], jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        got = port_models["clip"](torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("quirks", [False, True])
def test_unet(tiny_cfg, tiny_models, port_models, quirks):
    lat = _rand(1, 2, 8, 8, 4)
    ctx = _rand(2, 2, tiny_cfg.clip.max_len, tiny_cfg.unet.d_context)
    ref = jax.jit(lambda p, x, c: junet.apply(
        p, x, c, 981, tiny_cfg.unet, reference_quirks=quirks))(
        tiny_models["diffusion"], jnp.asarray(lat), jnp.asarray(ctx))
    with torch.inference_mode():
        got = port_models["diffusion"](torch.from_numpy(to_nchw(lat)),
                                       torch.from_numpy(ctx), 981,
                                       reference_quirks=quirks)
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


@pytest.mark.parametrize("quirks", [False, True])
def test_vae_encoder(tiny_cfg, tiny_models, port_models, quirks):
    img = np.tanh(_rand(3, 1, 16, 16, 3))
    noise = _rand(4, 1, 8, 8, 4)
    ref = jax.jit(lambda p, x, n: jvae.apply_encoder(
        p, x, n, tiny_cfg.vae, reference_quirks=quirks))(
        tiny_models["encoder"], jnp.asarray(img), jnp.asarray(noise))
    with torch.inference_mode():
        got = port_models["encoder"](torch.from_numpy(to_nchw(img)),
                                     torch.from_numpy(to_nchw(noise)),
                                     reference_quirks=quirks)
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


@pytest.mark.parametrize("quirks", [False, True])
def test_vae_decoder(tiny_cfg, tiny_models, port_models, quirks):
    # 8x6 latents: non-square, so the quirk's (n, h·w, c) -> (n, c, h, w)
    # reinterpretation is checked against a transposition of the right axes
    lat = _rand(5, 1, 8, 6, 4)
    ref = jax.jit(lambda p, x: jvae.apply_decoder(
        p, x, tiny_cfg.vae, reference_quirks=quirks))(
        tiny_models["decoder"], jnp.asarray(lat))
    with torch.inference_mode():
        got = port_models["decoder"](torch.from_numpy(to_nchw(lat)),
                                     reference_quirks=quirks)
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_tiled_vae_matches_jax(tiny_cfg, tiny_models, port_models, part):
    """32x48-pixel image (16x24 latent px) in 8-px tiles, against JAX
    ``apply_encoder_tiled``/``apply_decoder_tiled``: clamped border windows,
    halos cut to fit, per-window GroupNorm statistics."""
    if part == "encoder":
        img = np.tanh(_rand(21, 1, 32, 48, 3))
        noise = _rand(22, 1, 16, 24, 4)
        ref = jax.jit(lambda p, x, n: jvae.apply_encoder_tiled(
            p, x, n, tiny_cfg.vae, tile=8))(tiny_models["encoder"], img, noise)
        with torch.inference_mode():
            got = vae.apply_encoder_tiled(port_models["encoder"],
                                          torch.from_numpy(to_nchw(img)),
                                          torch.from_numpy(to_nchw(noise)), tile=8)
    else:
        lat = _rand(23, 1, 16, 24, 4)
        ref = jax.jit(lambda p, x: jvae.apply_decoder_tiled(
            p, x, tiny_cfg.vae, tile=8))(tiny_models["decoder"], lat)
        with torch.inference_mode():
            got = vae.apply_decoder_tiled(port_models["decoder"],
                                          torch.from_numpy(to_nchw(lat)), tile=8)
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


def test_halos_match_jax(tiny_cfg):
    sd15 = sd15_config().vae
    for cfg, jcfg in ((sd15, jconfig.sd15_config().vae),
                      (tiny_sd_config().vae, tiny_cfg.vae)):
        assert vae.down_receptive_halo(cfg) == jvae.down_receptive_halo(jcfg)
        assert vae.tail_receptive_halo(cfg) == jvae.tail_receptive_halo(jcfg)
    assert (vae.down_receptive_halo(sd15), vae.tail_receptive_halo(sd15)) == (9, 13)


def test_quirk_modes_differ(tiny_cfg, port_models):
    lat = torch.from_numpy(to_nchw(_rand(6, 1, 8, 8, 4)))
    with torch.inference_mode():
        a = port_models["decoder"](lat, reference_quirks=False)
        b = port_models["decoder"](lat, reference_quirks=True)
    assert (a - b).abs().max() > 1e-3


def test_convert_of_deconvert_equals_from_jax_params(tiny_cfg, tiny_models,
                                                     tiny_state_dict):
    cfg = tiny_sd_config()
    via_compvis = convert.convert(tiny_state_dict, cfg)
    direct = convert.from_jax_params(tiny_models, cfg)
    models = construct(cfg)
    for name, sd in direct.items():
        assert set(via_compvis[name]) == set(sd) == set(models[name].state_dict())
        for k, v in sd.items():
            torch.testing.assert_close(via_compvis[name][k], v, rtol=0, atol=0,
                                       msg=f"{name}.{k}")


def test_convert_coverage_both_ways(tiny_state_dict):
    cfg = tiny_sd_config()
    sd = dict(tiny_state_dict)
    sd["model.diffusion_model.stray.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        convert.convert(sd, cfg)
    sd = dict(tiny_state_dict)
    sd.pop("first_stage_model.decoder.mid.attn_1.q.weight")
    with pytest.raises(KeyError, match="missing source key"):
        convert.convert(sd, cfg)


SD15_COUNTS = {"diffusion": 859_520_964, "clip": 123_060_480,
               "encoder": 34_163_664, "decoder": 49_490_199}


def test_sd15_param_counts():
    models = construct(sd15_config())  # meta device: allocates nothing
    assert {k: param_count(m) for k, m in models.items()} == SD15_COUNTS


def test_sd15_param_counts_match_jax_package():
    cfg = jconfig.sd15_config()
    key = jax.random.PRNGKey(0)
    inits = {"clip": lambda: jclip.init(key, cfg.clip),
             "encoder": lambda: jvae.init_encoder(key, cfg.vae),
             "decoder": lambda: jvae.init_decoder(key, cfg.vae),
             "diffusion": lambda: junet.init(key, cfg.unet)}
    for name, fn in inits.items():
        shapes = jax.eval_shape(fn)
        n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
        assert n == SD15_COUNTS[name], name
