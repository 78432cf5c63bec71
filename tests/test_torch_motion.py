"""Slice G's AnimateDiff modules against the JAX package: the positional
encoding, one motion module (both group counts), the UNet with motion
modules (the v2 topology with a ``mid`` module, and v1 without), the site
plan, and the weight converter (a published-schema state dict drawn with
numpy through both converters, the inverse, the refusals).

Tiny SD-1.5 (16- and 32-channel levels: GroupNorm of c // 4 and of 32
groups), the JAX parameters drawn with numpy (``test_torch_families``);
the motion modules' published-schema weights drawn with numpy and
converted by each package.  Tolerances: exact (``==``) for the encoding,
the plans and the converted tensors; FP32 ``TOL`` (1e-4 relative and
absolute) for every forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import motion as jmotion
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.weights import animatediff as janimatediff
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.models import motion
from pytorch_stable_diffusion_tpu_torch.weights import animatediff, convert
from pytorch_stable_diffusion_tpu_torch.weights.convert import state_dict_from_jax_tree

TOL = dict(rtol=1e-4, atol=1e-4)


def published_state(ucfg, seed, *, mid=True, max_len=32, n_blocks=1):
    """A motion-module state dict in the published ``mm_sd_v15_v2`` key
    schema for ``ucfg``'s topology, drawn with numpy: weights ~ N(0,
    1/fan_in), norm scales near 1, small biases, the sinusoidal ``pe``
    buffers (1, max_len, C)."""
    r = np.random.RandomState(seed)
    widths = motion.site_channels(ucfg)
    out = {}

    def lin(key, d_out, d_in, bias=True):
        out[key + ".weight"] = (r.randn(d_out, d_in) / np.sqrt(d_in)).astype(np.float32)
        if bias:
            out[key + ".bias"] = (0.05 * r.randn(d_out)).astype(np.float32)

    def nrm(key, c):
        out[key + ".weight"] = (1.0 + 0.05 * r.randn(c)).astype(np.float32)
        out[key + ".bias"] = (0.05 * r.randn(c)).astype(np.float32)

    for pref, site in janimatediff.motion_site_plan(to_jax_unet(ucfg)).items():
        if site == "mid" and not mid:
            continue
        c, t = widths[site], pref + ".temporal_transformer."
        nrm(t + "norm", c)
        lin(t + "proj_in", c, c)
        for b in range(n_blocks):
            tb = f"{t}transformer_blocks.{b}."
            for ai in (0, 1):
                a = f"{tb}attention_blocks.{ai}."
                for x in "qkv":
                    lin(f"{a}to_{x}", c, c, bias=False)
                lin(a + "to_out.0", c, c)
                out[a + "pos_encoder.pe"] = jmotion.positional_encoding(max_len, c)[None]
                nrm(f"{tb}norms.{ai}", c)
            lin(tb + "ff.net.0.proj", 8 * c, c)
            lin(tb + "ff.net.2", c, 4 * c)
            nrm(tb + "ff_norm", c)
        lin(t + "proj_out", c, c)
    return out


def to_jax_unet(ucfg):
    return jconfig.UNetConfig(**dataclasses.asdict(ucfg))


@pytest.fixture(scope="module")
def sd():
    """(port cfg, JAX cfg, JAX params with the v2 motion tree, port models
    with the motion modules built from it)."""
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=60)
    jp["motion"], _ = janimatediff.convert_motion_module(published_state(cfg.unet, 61),
                                                         jcfg.unet)
    return cfg, jcfg, jp, build_models(cfg, device="cpu",
                                       state_dicts=convert.from_jax_params(jp, cfg))


def test_positional_encoding_matches_jax():
    for length, channels in ((16, 320), (32, 1280), (7, 16)):
        got = motion.positional_encoding(length, channels)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jmotion.positional_encoding(length, channels))


@pytest.mark.parametrize("c", [16, 64], ids=["c//4 groups", "32 groups"])
def test_motion_module_matches_jax(c):
    """One module over 2 lane groups of 4 frames on a 3x5 grid: the frame
    axis attended per position and per group, as JAX's (G·hw, F, C)
    rearrangement makes it."""
    ucfg = config.UNetConfig(model_channels=c, ch_mults=(1,), attn_levels=(False,),
                             n_heads=4, d_context=8, groups=4)
    tree, _ = janimatediff.convert_motion_module(published_state(ucfg, 3, mid=False),
                                                 to_jax_unet(ucfg))
    x = np.random.RandomState(4).randn(8, 3, 5, c).astype(np.float32)
    want = np.asarray(jax.jit(jmotion.apply_motion, static_argnums=2)(
        tree["enc_0"], jnp.asarray(x), 4))
    mods = motion.build(ucfg, state_dict=state_dict_from_jax_tree(tree), device="cpu")
    with torch.inference_mode():
        got = mods["enc_0"](torch.from_numpy(to_nchw(x)), 4)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)


_JAPPLY = jax.jit(junet.apply, static_argnames=("cfg", "frames"))


@pytest.mark.parametrize("mid", [True, False], ids=["v2 with mid", "v1 without mid"])
def test_unet_with_motion_matches_jax(sd, mid):
    """The UNet over 2 CFG groups of 3 frames with the motion modules at
    every site (the bottleneck's too for v2), against JAX ``unet.apply(
    motion=, frames=)``; the motion modules change the output."""
    cfg, jcfg, jp, models = sd
    tree = jp["motion"] if mid else {k: v for k, v in jp["motion"].items() if k != "mid"}
    mods = models["motion"] if mid else motion.build(
        cfg.unet, state_dict=state_dict_from_jax_tree(tree), device="cpu")
    assert ("mid" in mods) == mid and len(mods) == 11 - (not mid)
    r = np.random.RandomState(5)
    x = r.randn(6, 16, 16, 4).astype(np.float32)
    ctx = r.randn(6, 16, cfg.unet.d_context).astype(np.float32)
    want = np.asarray(_JAPPLY(jp["diffusion"], jnp.asarray(x), jnp.asarray(ctx), 700,
                              cfg=jcfg.unet, motion=tree, frames=3))
    unet = models["diffusion"]
    with torch.inference_mode():
        args = (torch.from_numpy(to_nchw(x)), torch.from_numpy(ctx), torch.tensor(700.0))
        got = unet(*args, motion=mods, frames=3)
        plain = unet(*args)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)
    assert (got - plain).abs().max() > 1e-2


@pytest.mark.parametrize("preset", ["sd15_config", "tiny_sd_config", "sdxl_config"])
def test_site_plan_matches_jax(preset):
    ucfg = getattr(config, preset)().unet
    plan = animatediff.motion_site_plan(ucfg)
    assert plan == janimatediff.motion_site_plan(to_jax_unet(ucfg))
    assert set(plan.values()) == set(motion.site_channels(ucfg))
    if preset == "sd15_config":  # mm_sd_v15_v2: 8 down + 12 up + 1 mid
        assert len(plan) == 21
        assert sum(v.startswith("enc") for v in plan.values()) == 8
        assert plan["down_blocks.1.motion_modules.0"] == "enc_3"
        assert plan["up_blocks.0.motion_modules.2"] == "dec_2"


@pytest.mark.parametrize("mid", [True, False], ids=["v2", "v1"])
def test_converter_matches_jax(mid):
    """A published-schema state dict through both converters: the same
    tensors (the JAX tree's (in, out) kernels transposed), the same
    ``max_len``; the port's inverse gives the file back exactly."""
    ucfg = config.tiny_sd_config().unet
    state = published_state(ucfg, 7, mid=mid, max_len=24)
    got, max_len = animatediff.convert_motion_module(state, ucfg)
    tree, jmax = janimatediff.convert_motion_module(state, to_jax_unet(ucfg))
    assert max_len == jmax == 24
    want = state_dict_from_jax_tree(tree)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = animatediff.deconvert_motion_module(got, ucfg, max_len=24)
    assert back.keys() == state.keys()
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), state[k])


@pytest.mark.parametrize("case", ["unconsumed", "unexpected module", "missing key",
                                  "no blocks", "empty"])
def test_converter_refusals_match_jax(case):
    ucfg = config.tiny_sd_config().unet
    state = published_state(ucfg, 8)
    if case == "unconsumed":
        state["mid_block.motion_modules.0.temporal_transformer.extra"] = np.zeros(2)
    elif case == "unexpected module":
        state["down_blocks.7.motion_modules.0.temporal_transformer.norm.weight"] = \
            np.zeros(2)
    elif case == "missing key":
        del state["mid_block.motion_modules.0.temporal_transformer.proj_out.bias"]
    elif case == "no blocks":
        state = {k: v for k, v in state.items()
                 if not (k.startswith("mid_block") and "transformer_blocks" in k)}
    else:
        state = {}
    with pytest.raises(ValueError) as want:
        janimatediff.convert_motion_module(dict(state), to_jax_unet(ucfg))
    with pytest.raises(ValueError) as got:
        animatediff.convert_motion_module(dict(state), ucfg)
    assert str(got.value) == str(want.value)


def test_load_motion_module_from_files(tmp_path):
    """The published schema written as .safetensors (the port's writer) and
    as a .ckpt with a ``state_dict`` nesting (torch.save): both load to the
    converter's tensors."""
    from pytorch_stable_diffusion_tpu_torch.weights.save import write_safetensors

    ucfg = config.tiny_sd_config().unet
    state = published_state(ucfg, 9)
    want, _ = animatediff.convert_motion_module(state, ucfg)
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    write_safetensors(tensors, str(tmp_path / "mm.safetensors"))
    torch.save({"state_dict": tensors}, str(tmp_path / "mm.ckpt"))
    for name in ("mm.safetensors", "mm.ckpt"):
        got, max_len = animatediff.load_motion_module(str(tmp_path / name), ucfg)
        assert max_len == 32 and got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
