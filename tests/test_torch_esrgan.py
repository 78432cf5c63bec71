"""Slice G's ESRGAN upscaler against the JAX package: RRDBNet (new- and
old-arch files, a ``params_ema`` nesting, and RealESRGAN's x2 with its
pixel-unshuffled input), the config read from the tensor shapes, the whole
and tiled ``upscale_image`` in uint8, the batched rank, and the
``with_upscaler`` / ``upscale`` refusals.

A tiny RRDBNet (8 features, 2 RRDBs, growth 4), the published-schema
weights drawn with numpy and converted by each package.  Tolerances: FP32
``TOL`` (1e-4 relative and absolute) for the net; exact (``==``) for the
configs, the uint8 images and the error messages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

import pytorch_stable_diffusion_tpu as jsdt
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import esrgan as jesrgan
from pytorch_stable_diffusion_tpu.weights import esrgan as jweights
from pytorch_stable_diffusion_tpu_torch import api
from pytorch_stable_diffusion_tpu_torch.models import config, esrgan
from pytorch_stable_diffusion_tpu_torch.weights import esrgan as weights

TOL = dict(rtol=1e-4, atol=1e-4)


def new_arch_state(nf=8, n_blocks=2, gc=4, c_in=3, seed=0):
    """A new-arch (BasicSR) RRDBNet state dict drawn with numpy: conv
    weights ~ N(0, 1/fan_in) (scaled down in the trunk, so the residual
    stack stays near unit gain), small biases."""
    r = np.random.RandomState(seed)
    out = {}

    def conv(key, cin, cout, gain=1.0):
        out[key + ".weight"] = (gain * r.randn(cout, cin, 3, 3)
                                / np.sqrt(9 * cin)).astype(np.float32)
        out[key + ".bias"] = (0.02 * r.randn(cout)).astype(np.float32)

    conv("conv_first", c_in, nf)
    for i in range(n_blocks):
        for j in (1, 2, 3):
            for k in range(1, 6):
                conv(f"body.{i}.rdb{j}.conv{k}", nf + (k - 1) * gc if k < 5 else nf + 4 * gc,
                     gc if k < 5 else nf, gain=0.5)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf)
    conv("conv_last", nf, 3)
    return out


def old_arch(state, n_blocks=2):
    """The same tensors under the original ESRGAN's ``model.*`` names."""
    names = {"conv_first": "model.0", "conv_body": f"model.1.sub.{n_blocks}",
             "conv_up1": "model.3", "conv_up2": "model.6", "conv_hr": "model.8",
             "conv_last": "model.10"}
    out = {}
    for k, v in state.items():
        stem, p = k.rsplit(".", 1)
        if stem in names:
            out[f"{names[stem]}.{p}"] = v
        else:
            i, rdb, conv = stem.split(".")[1:]
            out[f"model.1.sub.{i}.RDB{rdb[3:]}.{conv}.0.{p}"] = v
    return out


STATES = {
    "new-arch x4": lambda: new_arch_state(seed=1),
    "old-arch x4": lambda: old_arch(new_arch_state(seed=2)),
    "params_ema x4": lambda: {"params_ema": new_arch_state(seed=3)},
    "new-arch x2 (pixel-unshuffled)": lambda: new_arch_state(c_in=12, seed=4),
}


def _both(case):
    state = STATES[case]()
    jp, jcfg = jweights.convert_esrgan(state)
    sd, cfg = weights.convert_esrgan(state)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jp, jcfg, esrgan.build(cfg, state_dict=sd, device="cpu")


def _image(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("case", list(STATES))
def test_rrdbnet_matches_jax(case):
    jp, jcfg, net = _both(case)
    x = np.random.RandomState(5).rand(2, 12, 8, 3).astype(np.float32)
    want = np.asarray(jesrgan.apply(jp, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = net(torch.from_numpy(to_nchw(x)))
    assert got.shape == (2, 3, 12 * jcfg.scale, 8 * jcfg.scale)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)


@pytest.mark.parametrize("tile", [None, 8], ids=["whole", "tiled 8, pad 2, 3 lanes"])
def test_upscale_image_matches_jax(tile):
    """uint8 out, equal to JAX's ``upscale_image``: whole, and over padded
    tiles (interior, edge and corner patch shapes, a chunk of 3 lanes
    zero-padded); tiled is not whole (the pad is under the receptive
    field)."""
    jp, jcfg, net = _both("new-arch x4")
    img = _image(6, 20, 28, 3)
    kw = dict(tile=tile, tile_pad=2, tile_lanes=3)
    want = jesrgan.upscale_image(jp, img, jcfg, **kw)
    got = esrgan.upscale_image(net, img, **kw)
    assert got.dtype == np.uint8 and got.shape == (80, 112, 3)
    np.testing.assert_array_equal(got, want)
    if tile is not None:
        assert not np.array_equal(got, esrgan.upscale_image(net, img))


def test_upscale_keeps_the_batched_rank():
    """A (B, H, W, 3) batch gives (B, 4H, 4W, 3), each image its own
    upscale; a float image in [0, 1] is taken as such."""
    _, _, net = _both("new-arch x4")
    imgs = _image(7, 2, 10, 12, 3)
    out = esrgan.upscale_image(net, imgs, tile=6, tile_pad=2)
    assert out.shape == (2, 40, 48, 3)
    for i in range(2):
        np.testing.assert_array_equal(out[i], esrgan.upscale_image(net, imgs[i], tile=6,
                                                                   tile_pad=2))
    np.testing.assert_array_equal(esrgan.upscale_image(net, imgs[0] / 255.0),
                                  esrgan.upscale_image(net, imgs[0]))


@pytest.mark.parametrize("case", ["not a pair", "a (path, strength) guess", "wrong config"])
def test_with_upscaler_refusals_match_jax(case):
    state = new_arch_state()
    jparams, jcfg = jweights.convert_esrgan(state)
    params, cfg = weights.convert_esrgan(state)
    arg, jarg = {"not a pair": (3, 3),
                 "a (path, strength) guess": (("x.pth", 0.5), ("x.pth", 0.5)),
                 "wrong config": ((params, {}), (jparams, {}))}[case]
    jsd = jsdt.StableDiffusion({}, None, jconfig.tiny_sd_config())
    sd = api.StableDiffusion({}, None, config.tiny_sd_config(), device="cpu")
    with pytest.raises(ValueError) as want:
        jsd.with_upscaler(jarg)
    with pytest.raises(ValueError) as got:
        sd.with_upscaler(arg)
    assert str(got.value) == str(want.value)
    for fn in (lambda s: s.upscale(np.zeros((4, 4, 3), np.uint8)),
               lambda s: s.hires_fix("a cat", upscale_method="esrgan")):
        with pytest.raises(ValueError) as want:
            fn(jsd)
        with pytest.raises(ValueError) as got:
            fn(sd)
        assert str(got.value) == str(want.value)
    up = sd.with_upscaler((params, cfg))
    assert sd._upscaler is None and up.upscale(_image(8, 4, 4, 3)).shape == (16, 16, 3)
