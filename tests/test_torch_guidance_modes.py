"""Slice F's modules against the JAX package: the config helpers (ToMe,
Hypertile, FreeU, the fast preset), ``ops/tome.py``, the Hypertile fold,
the circular conv, ``apply_identity`` and ``return_probs``, the UNet's PAG,
SAG, FreeU, ToMe, Hypertile and DeepCache passes, the FreeU low-pass, SAG's
blur, the variation slerp and the ``AND`` parser; then one evaluation of
each guidance mode that JAX refuses under ``fixed_noise`` (AND with region
masks, PAG, SAG, the variation seed with the noise multiplier), held
through a spy on the UNet to the same composition of JAX ``unet.apply``,
the combine and the DDIM step on the noise the port drew.

Tiny SD-1.5 (32 px, a 16x16 latent of 256 tokens at the attention level),
JAX parameters drawn with numpy and carried across with
``convert.from_jax_params``.  Tolerances: exact (``==``) for plans,
selections, folds, the parser and the slerp's ends; FP32 ``TOL`` (1e-4
relative and absolute) for every computed value.  The generate() cases
are in tests/test_torch_guidance_pipelines.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_families import jax_params, to_jax

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu import prompt_schedule as jschedule
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.ops import attention as jattn
from pytorch_stable_diffusion_tpu.ops import conv as jconv
from pytorch_stable_diffusion_tpu.ops import tome as jtome
from pytorch_stable_diffusion_tpu.sampling import ddim as jddim
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu_torch import pipeline, prompt_schedule
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.models import unet as punet
from pytorch_stable_diffusion_tpu_torch.ops import attention, conv, tome
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights.convert import state_dict_from_jax_tree
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
WORDS = ["a", "cat", "dog", "photo", "of"]
HW = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny tensors (parallel test workers
    oversubscribe the cores with torch's default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sd():
    """(port cfg, JAX cfg, JAX params, port models) of tiny SD-1.5."""
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=50)
    return cfg, jcfg, jp, build_models(cfg, device="cpu",
                                       state_dicts=convert.from_jax_params(jp, cfg))


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


#: JAX ``unet.apply``, one program a (config, mode, shape): a compile costs
#: less than the first eager run of a new shape's ops
_JAPPLY = jax.jit(junet.apply, static_argnames=("cfg", "pag", "return_mid_attn",
                                                "return_cache"))


# ------------------------------------------------------------------ configs
CONFIG_CASES = {
    "tome 0.5": (lambda m, c: m.with_tome(c, 0.5)),
    "tome 0.3, 1x2 stride, 1024 tokens": (
        lambda m, c: m.with_tome(c, 0.3, sx=1, sy=2, min_tokens=1024)),
    "tome 0": (lambda m, c: m.with_tome(m.with_tome(c, 0.5), 0.0)),
    "hypertile 32": (lambda m, c: m.with_hypertile(c, 32)),
    "hypertile 16, 1024 tokens": (lambda m, c: m.with_hypertile(c, 16, min_tokens=1024)),
    "hypertile off": (lambda m, c: m.with_hypertile(m.with_hypertile(c, 32), 0)),
    "freeu defaults": (lambda m, c: m.with_freeu(c, True)),
    "freeu tuple": (lambda m, c: m.with_freeu(c, (1.1, 1.2, 0.9, 0.2))),
    "freeu off": (lambda m, c: m.with_freeu(c, False)),
    "fast preset": (lambda m, c: m.fast_preset(c)),
}


@pytest.mark.parametrize("preset", ["sd15_config", "sdxl_config"])
@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_helpers_match_jax(case, preset):
    """Field for field, on SD-1.5 and SDXL (FreeU's defaults by family);
    the fast preset's keywords too."""
    make = CONFIG_CASES[case]
    got, want = make(config, getattr(config, preset)()), \
        make(jconfig, getattr(jconfig, preset)())
    if case == "fast preset":
        assert got[1] == want[1] == {"deepcache": 3}
        got, want = got[0], want[0]
    assert to_jax(got) == want
    assert config.FREEU_DEFAULTS_SD == jconfig.FREEU_DEFAULTS_SD
    assert config.FREEU_DEFAULTS_SDXL == jconfig.FREEU_DEFAULTS_SDXL


@pytest.mark.parametrize("call", [
    lambda m: m.with_tome(m.sd15_config(), 1.0),
    lambda m: m.with_tome(m.sd15_config(), -0.1),
    lambda m: m.with_hypertile(m.sd15_config(), -2),
    lambda m: m.with_freeu(m.sd15_config(), (1.0, 1.0, 1.0)),
], ids=["tome 1.0", "tome -0.1", "hypertile -2", "freeu 3 values"])
def test_config_helper_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jconfig)
    with pytest.raises(ValueError, match=None) as got:
        call(config)
    assert str(got.value) == str(want.value)


def test_check_ported_takes_the_approximate_modes():
    cfg = config.fast_preset(config.with_freeu(config.with_tome(config.sd15_config())))[0]
    config.check_ported(cfg)


# --------------------------------------------------------------------- ToMe
@pytest.mark.parametrize("h,w,sx,sy,ratio", [(16, 16, 2, 2, 0.5), (8, 12, 2, 2, 0.3),
                                             (6, 4, 1, 2, 0.9), (64, 64, 2, 2, 0.5)])
def test_tome_plan_matches_jax(h, w, sx, sy, ratio):
    for got, want in zip(tome.plan(h, w, sx, sy, ratio), jtome.plan(h, w, sx, sy, ratio)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not divisible by the ToMe stride"):
        tome.plan(7, 8)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_tome_merge_unmerge_match_jax(ratio):
    """The same tokens merged: the kept and merged selections and their
    destinations equal; the merged values and the unmerged outputs within
    fp32 rounding (the sums add in another order)."""
    h = w = 8
    dst_i, src_i, r = tome.plan(h, w, 2, 2, ratio)
    x = _rand(3, 2, h * w, 12)
    x[:, 7] = x[:, 0]  # an exact duplicate: a tie in the scores
    jout, jinfo = jtome.merge(jnp.asarray(x), dst_i, src_i, r)
    out, info = tome.merge(_t(x), dst_i, src_i, r)
    for key in ("merged_sel", "kept_sel", "m_dst"):
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(jinfo[key]), err_msg=key)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    y = _rand(4, 2, h * w - r, 12)
    np.testing.assert_array_equal(tome.unmerge(_t(y), info).numpy(),
                                  np.asarray(jtome.unmerge(jnp.asarray(y), jinfo)))


def test_tome_merge_is_deterministic():
    dst_i, src_i, r = tome.plan(16, 16, 2, 2, 0.5)
    x = _t(_rand(5, 2, 256, 16))
    a, b = tome.merge(x, dst_i, src_i, r)[0], tome.merge(x, dst_i, src_i, r)[0]
    assert torch.equal(a, b)


# ---------------------------------------------------------------- Hypertile
@pytest.mark.parametrize("h,w,tile", [(64, 64, 32), (96, 64, 32), (40, 64, 32), (16, 16, 32),
                                      (32, 32, 32), (61, 64, 32), (61, 53, 32), (4, 4, 1),
                                      (320, 320, 32), (80, 80, 32), (257, 257, 4)])
def test_hypertile_sides_match_jax(h, w, tile):
    assert punet.hypertile_sides(h, w, tile) == junet.hypertile_sides(h, w, tile)


def test_hypertile_fold_unfold_match_jax():
    h, w, th, tw = 6, 8, 3, 4
    t = _rand(6, 2, h * w, 5)
    got = punet.hypertile_fold(_t(t), h, w, th, tw)
    want = np.asarray(junet.hypertile_fold(jnp.asarray(t), h, w, th, tw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(punet.hypertile_unfold(got, h, w, th, tw).numpy(), t)


# ---------------------------------------------------------- ops and helpers
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, "asym"), (2, 1)])
def test_circular_conv_matches_jax(stride, padding):
    jp = jconv.init(jax.random.PRNGKey(3), 6, 10, 3)
    x = _rand(8, 2, 9, 8, 6)
    jpad, pad = (jconv.ASYM_DOWN, conv.ASYM_DOWN) if padding == "asym" else (padding, padding)
    with jconv.circular_padding():
        ref = np.asarray(jconv.apply(jp, jnp.asarray(x), stride=stride, padding=jpad))
    mod = conv.Conv(6, 10, 3).requires_grad_(False)
    mod.load_state_dict(state_dict_from_jax_tree(jp))
    with conv.circular_padding():
        assert conv.circular_padding_active()
        got = conv.apply(mod, _t(to_nchw(x)), stride=stride, padding=pad).numpy()
    assert not conv.circular_padding_active()
    np.testing.assert_allclose(got, to_nchw(ref), **TOL)


def test_circular_padding_clears_on_an_exception():
    with pytest.raises(RuntimeError):
        with conv.circular_padding():
            raise RuntimeError
    assert not conv.circular_padding_active()


def test_apply_identity_and_return_probs_match_jax():
    d, heads = 32, 4
    jp = jattn.init(jax.random.PRNGKey(4), heads, d)
    x = _rand(10, 2, 20, d)
    mod = attention.Attention(d).requires_grad_(False)
    mod.load_state_dict(state_dict_from_jax_tree(jp))
    np.testing.assert_allclose(
        attention.apply_identity(mod, _t(x)).numpy(),
        np.asarray(jattn.apply_identity(jp, jnp.asarray(x))), **TOL)
    jout, jprobs = jattn.apply(jp, jnp.asarray(x), n_heads=heads, backend="pallas",
                               return_probs=True)
    out, probs = attention.apply(mod, _t(x), n_heads=heads, backend="kernel",
                                 return_probs=True)
    assert probs.dtype == torch.float32 and probs.shape == (2, heads, 20, 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)


def test_fourier_lowpass_scale_matches_jax():
    x = _rand(11, 2, 12, 10, 6)
    for scale in (0.2, 0.9):
        want = np.asarray(junet._fourier_lowpass_scale(jnp.asarray(x), scale))
        got = punet._fourier_lowpass_scale(_t(to_nchw(x)), scale).numpy()
        np.testing.assert_allclose(got, to_nchw(want), **TOL)


def test_gaussian_blur_matches_jax():
    x = _rand(12, 2, 16, 16, 4)
    np.testing.assert_allclose(pipeline.gaussian_blur(_t(to_nchw(x))).numpy(),
                               to_nchw(jpipeline.gaussian_blur(jnp.asarray(x))), **TOL)


def test_slerp_noise():
    """Exact (bitwise) at t = 0 and t = 1, within fp32 of JAX's at 0.3."""
    lo, hi = _rand(13, 2, 4, 8, 8), _rand(14, 2, 4, 8, 8)
    assert torch.equal(pipeline.slerp_noise(0.0, _t(lo), _t(hi)), _t(lo))
    assert torch.equal(pipeline.slerp_noise(1.0, _t(lo), _t(hi)), _t(hi))
    np.testing.assert_allclose(
        pipeline.slerp_noise(torch.tensor(0.3), _t(lo), _t(hi)).numpy(),
        np.asarray(jpipeline.slerp_noise(jnp.float32(0.3), jnp.asarray(lo),
                                         jnp.asarray(hi))), rtol=1e-5, atol=1e-5)


def test_variation_stream_golden_values():
    """The variation noise is the 'latent_init' stream of the variation
    seed — frozen with the other streams (tests/test_torch_pipeline.py)."""
    v = rng.variation_normal(1337, 2, (4,))
    np.testing.assert_allclose(float(v[0, 0]), 0.37092405557632446, rtol=1e-6)
    np.testing.assert_allclose(float(v[1, 0]), 0.04803993180394173, rtol=1e-6)
    assert torch.equal(v, rng.batch_normal(1337, "latent_init", 2, (4,)))


@pytest.mark.parametrize("text", ["a cat AND a dog:1.2", "a (cat:1.3) AND [dog]:0.5 AND a fox",
                                  "a cat", "a cat AND a dog:x", "a AND b:-0.5"])
def test_split_composable_matches_jax(text):
    assert prompt_schedule.split_composable(text) == jschedule.split_composable(text)
    assert prompt_schedule.has_composable(text) == jschedule.has_composable(text)


# --------------------------------------------------------------------- UNet
UNET_CASES = {
    "pag": dict(pag=True),
    "return_mid_attn": dict(return_mid_attn=True),
    "freeu": dict(freeu=(1.1, 1.2, 0.9, 0.2)),
    "tome": dict(tome=(0.5, 2, 2, 64)),
    "hypertile": dict(hypertile=(4, 64)),
}


def _unet_io(sd, batch=2):
    cfg = sd[0]
    x = _rand(15, batch, 16, 16, cfg.unet.in_channels)
    ctx = _rand(16, batch, cfg.clip.max_len, cfg.unet.d_context)
    return x, ctx


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_modes_match_jax(sd, case):
    """One forward of the tiny UNet (a 256-token attention level) in each
    mode, against JAX ``unet.apply`` with the same config fields."""
    cfg, jcfg, jp, models = sd
    kw = dict(UNET_CASES[case])
    fields = {k: kw.pop(k) for k in ("freeu", "tome", "hypertile") if k in kw}
    ucfg = dataclasses.replace(cfg.unet, **fields)
    x, ctx = _unet_io(sd)
    want = _JAPPLY(jp["diffusion"], jnp.asarray(x), jnp.asarray(ctx), 421,
                   cfg=dataclasses.replace(jcfg.unet, **fields), **kw)
    with torch.inference_mode():
        got = models["diffusion"](_t(to_nchw(x)), _t(ctx), torch.tensor(421.0), modes=ucfg,
                                  **kw)
    if case == "return_mid_attn":
        (got, probs), (want, jprobs) = got, want
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)


def test_block_plans_and_the_exact_cases(sd):
    """ToMe wins where both modes would engage, as in the JAX package;
    below ``min_tokens``, or on a grid that fits one tile, the forward is
    bit-identical to the plain one; FreeU at (1, 1, 1, 1) too."""
    tome_plan, ht = punet.block_plans((0.3, 2, 2, 64), (4, 64), 16, 16)
    assert ht is None and tome_plan[2] == int(256 * 0.3)
    assert punet.block_plans(None, (4, 64), 16, 16)[1] == (4, 4)
    assert punet.block_plans((0.3, 2, 2, 512), (4, 512), 16, 16) == (None, None)
    cfg, _, _, models = sd
    x, ctx = (_t(a) for a in _unet_io(sd))
    x = x.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        plain = models["diffusion"](x, ctx, torch.tensor(421.0))
        for fields in (dict(hypertile=(16, 64)), dict(hypertile=(4, 512)),
                       dict(tome=(0.5, 2, 2, 512)), dict(freeu=(1.0, 1.0, 1.0, 1.0))):
            got = models["diffusion"](x, ctx, torch.tensor(421.0),
                                      modes=dataclasses.replace(cfg.unet, **fields))
            assert torch.equal(got, plain), fields


def test_unet_deepcache_pair_matches_jax(sd):
    """The full pass returns the feature entering the shallowest decoder
    level; the shallow pass on it equals the full output bit for bit, and
    each equals JAX's."""
    cfg, jcfg, jp, models = sd
    x, ctx = _unet_io(sd)
    want, jcache = _JAPPLY(jp["diffusion"], jnp.asarray(x), jnp.asarray(ctx), 421,
                           cfg=jcfg.unet, return_cache=True)
    unet = models["diffusion"]
    with torch.inference_mode():
        got, cache = unet(_t(to_nchw(x)), _t(ctx), torch.tensor(421.0), return_cache=True)
        shallow = unet(_t(to_nchw(x)), _t(ctx), torch.tensor(421.0), cache=cache)
    assert cache.shape == punet.deepcache_shape(cfg.unet, 2, 16, 16)
    np.testing.assert_allclose(cache.numpy(), to_nchw(jcache), **TOL)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)
    assert torch.equal(shallow, got)
    with pytest.raises(ValueError, match="incompatible with DeepCache"):
        unet(_t(to_nchw(x)), _t(ctx), torch.tensor(421.0), return_mid_attn=True, cache=cache)
    with pytest.raises(ValueError, match=">= 2 levels"):
        punet.deepcache_shape(dataclasses.replace(cfg.unet, ch_mults=(1,)), 1, 8, 8)


def test_unet_roll_equivariant_under_tiling(sd):
    """Under seamless tiling a roll of the latents by a multiple of the
    deepest level's stride rolls the output: every conv wraps (as
    tests/test_tiling_mode.py shows for JAX); the kernel tier runs its
    plain convs there."""
    cfg, _, _, models = sd
    x, ctx = _unet_io(sd, batch=1)
    x = _t(to_nchw(x))
    with torch.inference_mode(), conv.circular_padding():
        base = models["diffusion"](x, _t(ctx), torch.tensor(300.0), conv_backend="kernel")
        rolled = models["diffusion"](torch.roll(x, (4, 6), (2, 3)), _t(ctx),
                                     torch.tensor(300.0), conv_backend="kernel")
    np.testing.assert_allclose(rolled.numpy(), torch.roll(base, (4, 6), (2, 3)).numpy(),
                               **TOL)


# ------------------------------------------ one evaluation of the JAX-refused modes
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


def _one_ddim_step(sd, monkeypatch, prompt="a photo of a cat", **kw):
    """One DDIM step of the port at seed 3: -> (UNet calls, final latents,
    the step's timestep)."""
    cfg, _, _, models = sd
    calls = _spy(monkeypatch, models["diffusion"])
    _, lat = pipeline.generate(prompt, uncond_prompt="a dog", models=models, config=cfg,
                               tokenizer=make_test_tokenizer(WORDS, max_len=16), seed=3,
                               height=HW, width=HW, sampler_name="ddim", n_inference_steps=1,
                               cfg_scale=5.0, return_latents=True, **kw)
    t = int(jddpm.inference_timesteps(1)[0])
    return calls, lat, t


def _jax_step(t, lat, eps):
    """JAX's DDIM step (eta 0) to the end of a one-step grid."""
    return np.asarray(jddim.step(jddpm.make_schedule(), t, jnp.asarray(lat), eps,
                                 jnp.zeros_like(eps), num_inference_steps=1, prev_t=-1))


def _japply(sd, x, ctx, t, **kw):
    return _JAPPLY(sd[2]["diffusion"], _nhwc(x), jnp.asarray(np.asarray(ctx)), t,
                   cfg=sd[1].unet, **kw)


def test_and_with_regions_evaluation_matches_jax(sd, monkeypatch):
    """"a cat AND a dog:0.8" with a left and a right half mask: one UNet call
    of 3 lanes (part-major, uncond last), combined as eps_u + cfg Σ w_i m_i
    (eps_i - eps_u)."""
    left = np.zeros((HW, HW), np.float32)
    left[:, :HW // 2] = 1.0
    calls, lat, t = _one_ddim_step(sd, monkeypatch, "a cat AND a dog:0.8",
                                   region_masks=[left, 1.0 - left])
    ((args, _, out),) = calls
    assert args[0].shape[0] == 3
    parts = np.split(np.asarray(_japply(sd, args[0], args[1], t)), 3)
    masks = [np.asarray(jpipeline.mask_to_latent_area(
        jpipeline._prepare_mask(m, HW, HW), 2))[0] for m in (left, 1.0 - left)]
    np.testing.assert_allclose(out.numpy(), to_nchw(np.concatenate(parts)), **TOL)
    eps = parts[2] + sum(5.0 * w * m * (p - parts[2])
                         for w, m, p in zip((1.0, 0.8), masks, parts[:2]))
    np.testing.assert_allclose(lat, to_nchw(_jax_step(t, _nhwc(args[0][:1].float()), eps)),
                               **TOL)


def test_pag_evaluation_matches_jax(sd, monkeypatch):
    """PAG 3.0: the main call (2 lanes) and the perturbed one (the cond
    lane, pag=True), combined as CFG + s (eps_cond - eps_ptb)."""
    calls, lat, t = _one_ddim_step(sd, monkeypatch, pag_scale=3.0)
    (main, _, _), (ptb, ptb_kw, _) = calls
    assert ptb_kw["pag"] and ptb[0].shape[0] == 1
    np.testing.assert_array_equal(ptb[0].numpy(), main[0][:1].numpy())
    np.testing.assert_array_equal(ptb[1].numpy(), main[1][:1].numpy())
    cond, uncond = np.split(np.asarray(_japply(sd, main[0], main[1], t)), 2)
    e_ptb = np.asarray(_japply(sd, ptb[0], ptb[1], t, pag=True))
    eps = uncond + 5.0 * (cond - uncond) + 3.0 * (cond - e_ptb)
    np.testing.assert_allclose(lat, to_nchw(_jax_step(t, _nhwc(main[0][:1].float()), eps)),
                               **TOL)


def test_sag_evaluation_matches_jax(sd, monkeypatch):
    """SAG 0.75: the main call returns the mid block's map; the uncond
    lane's x0 is blurred where a key's mass exceeds 1 (the mask held to
    JAX's, with no key within 1e-3 of the threshold), re-noised and
    evaluated; combined as CFG + s (eps_base - eps_deg)."""
    calls, lat, t = _one_ddim_step(sd, monkeypatch, sag_scale=0.75)
    (main, main_kw, (_, probs)), (deg, _, _) = calls
    assert main_kw["return_mid_attn"] and deg[0].shape[0] == 1
    jout, jprobs = _japply(sd, main[0], main[1], t, return_mid_attn=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    mass = np.asarray(jprobs)[1:].mean(axis=1).sum(axis=1)
    assert np.abs(mass - 1.0).min() > 1e-3 and (mass > 1.0).any() and (mass < 1.0).any()
    cond, uncond = np.split(np.asarray(jout), 2)
    lat32 = _nhwc(main[0][:1].float())
    a_t = jddpm.make_schedule().alphas_cumprod[t]
    x0 = (lat32 - jnp.sqrt(1.0 - a_t) * uncond) / jnp.sqrt(a_t)
    mask = jax.image.resize((jnp.asarray(mass) > 1.0).astype(jnp.float32).reshape(1, 8, 8, 1),
                            (1, 16, 16, 1), "nearest")
    lat_deg = jnp.sqrt(a_t) * (jpipeline.gaussian_blur(x0) * mask + x0 * (1.0 - mask)) \
        + jnp.sqrt(1.0 - a_t) * uncond
    np.testing.assert_allclose(deg[0].numpy(), to_nchw(lat_deg), **TOL)
    e_deg = np.asarray(_japply(sd, deg[0], deg[1], t))
    eps = uncond + 5.0 * (cond - uncond) + 0.75 * (uncond - e_deg)
    np.testing.assert_allclose(lat, to_nchw(_jax_step(t, lat32, eps)), **TOL)


def test_variation_and_multiplier_initial_noise_matches_jax(sd, monkeypatch):
    """A variation seed at strength 0.3 with the multiplier 1.05: the
    latents of the first evaluation are JAX's slerp of the seed's and the
    variation seed's 'latent_init' draws, times the multiplier."""
    calls, _, _ = _one_ddim_step(sd, monkeypatch, variation_seed=9, variation_strength=0.3,
                                 noise_multiplier=1.05)
    base = _nhwc(rng.batch_normal(3, "latent_init", 1, (4, 16, 16)))
    var = _nhwc(rng.variation_normal(9, 1, (4, 16, 16)))
    want = jpipeline.slerp_noise(jnp.float32(0.3), base, var) * jnp.float32(1.05)
    np.testing.assert_allclose(calls[0][0][0][:1].numpy(), to_nchw(want), rtol=1e-5, atol=1e-5)
