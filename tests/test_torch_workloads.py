"""Slice G's workloads through ``generate()`` and the API against the JAX
package: one DDIM step of AnimateDiff (``n_frames``), of its frame windows
(``motion_window``) and of a panorama, each held through a spy on the
UNet to JAX ``unet.apply(motion=, frames=)`` and JAX's window accumulation
on the noise the port drew (JAX refuses ``fixed_noise`` for both); the
lane order of the CFG groups; a single-window panorama bit-identical to
the plain request; ``sd_upscale``'s stitch with an identity model;
``hires_fix(upscale_method="esrgan")``'s flow; ``animate``'s automatic
frame windows; every slice G ``ValueError``, message for message; the
65536-token guard, which the port applies to a panorama's window and the
JAX package to its canvas; and ``chip_smoke.expected_launches`` held to
the plain versions' calls.

Tiny SD-1.5 (32 px: a 16x16 latent), the JAX parameters drawn with numpy
(``test_torch_families``), the motion modules' published-schema weights
with numpy (``test_torch_motion``).  Tolerances: FP32 ``TOL`` (1e-4
relative and absolute) for every computed value; exact for the lane and
window inputs, the bit-identities and the messages.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_esrgan import new_arch_state
from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401
from test_torch_motion import published_state

from pytorch_stable_diffusion_tpu import api as japi
from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import clip as jclip
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.sampling import ddim as jddim
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu.weights import animatediff as janimatediff
from pytorch_stable_diffusion_tpu.weights import esrgan as jweights
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import api, pipeline
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.utils.image import resize
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights import esrgan as weights
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
WORDS = ["a", "cat", "dog", "photo", "of"]
HW = 32
COND, UNCOND = "a photo of a cat", "a dog"


@pytest.fixture(scope="module")
def sd():
    """(port cfg, JAX cfg, JAX params with the motion tree, port models with
    the motion modules) of tiny SD-1.5."""
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=70)
    jp["motion"], _ = janimatediff.convert_motion_module(published_state(cfg.unet, 71),
                                                         jcfg.unet)
    return cfg, jcfg, jp, build_models(cfg, device="cpu",
                                       state_dicts=convert.from_jax_params(jp, cfg))


def _tok():
    return make_test_tokenizer(WORDS, max_len=16)


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


def _one_ddim_step(sd, monkeypatch, **kw):
    """One DDIM step of the port at seed 3, CFG 5: -> (UNet calls, final
    latents, the step's timestep)."""
    cfg, _, _, models = sd
    calls = _spy(monkeypatch, models["diffusion"])
    kw = dict(dict(height=HW, width=HW), **kw)
    _, lat = pipeline.generate(COND, uncond_prompt=UNCOND, models=models, config=cfg,
                               tokenizer=_tok(), seed=3, sampler_name="ddim",
                               n_inference_steps=1, cfg_scale=5.0, return_latents=True, **kw)
    return calls, lat, int(jddpm.inference_timesteps(1)[0])


_JAPPLY = jax.jit(junet.apply, static_argnames=("cfg", "frames"))


def _japply(sd, x, ctx, t, **kw):
    return np.asarray(_JAPPLY(sd[2]["diffusion"], jnp.asarray(np.transpose(
        np.asarray(x), (0, 2, 3, 1))), jnp.asarray(np.asarray(ctx)), t, cfg=sd[1].unet, **kw))


def _jax_step(t, lat, eps):
    """JAX's CFG combine (scale 5) and DDIM step (eta 0) to the end of a
    one-step grid, on NHWC latents and (2B, ...) eps -> NCHW."""
    cond, uncond = np.split(np.asarray(eps, np.float32), 2)
    eps = jnp.asarray(uncond + 5.0 * (cond - uncond))
    lat = jnp.asarray(np.transpose(np.asarray(lat, np.float32), (0, 2, 3, 1)))
    return to_nchw(jddim.step(jddpm.make_schedule(), t, lat, eps, jnp.zeros_like(eps),
                              num_inference_steps=1, prev_t=-1))


def _latent_init(frames, h=HW // 2, w=HW // 2):
    return rng.batch_normal(3, "latent_init", frames, (4, h, w)).numpy()


def _jax_context(sd, prompts):
    tokens = jnp.asarray(jtokenizer(WORDS, max_len=16).batch_encode(prompts))
    return np.asarray(jclip.apply(sd[2]["clip"], tokens, sd[1].clip))


def test_animate_evaluation_matches_jax(sd, monkeypatch):
    """n_frames 3: one UNet call of 6 lanes, the cond prompt's 3 frames then
    the uncond's (each frame its own noise), the motion modules over groups
    of 3; against JAX ``unet.apply(motion=, frames=3)``, the CFG combine
    and the DDIM step."""
    calls, lat, t = _one_ddim_step(sd, monkeypatch, n_frames=3)
    ((args, kw, out),) = calls
    x, ctx = args[0].numpy(), args[1].numpy()
    assert kw["frames"] == 3 and kw["motion"] is sd[3]["motion"]
    np.testing.assert_array_equal(x, np.concatenate([_latent_init(3)] * 2))
    assert not np.array_equal(x[0], x[1])
    np.testing.assert_allclose(ctx, _jax_context(sd, [COND] * 3 + [UNCOND] * 3), **TOL)
    eps = _japply(sd, x, ctx, t, motion=sd[2]["motion"], frames=3)
    np.testing.assert_allclose(out.numpy(), to_nchw(eps), **TOL)
    np.testing.assert_allclose(lat, _jax_step(t, x[:3], eps), **TOL)


def test_motion_window_evaluation_matches_jax(sd, monkeypatch):
    """5 frames through windows of 3 at stride 2 (starts 0 and 2; frame 2 in
    both): one UNet call a window, each CFG group's frames sliced alike;
    each frame's eps the fp32 average over its windows, as JAX's
    ``f_body`` accumulates it."""
    calls, lat, t = _one_ddim_step(sd, monkeypatch, n_frames=5, motion_window=3,
                                   motion_stride=2)
    assert len(calls) == 2
    full = np.concatenate([_latent_init(5)] * 2)
    ctx = _jax_context(sd, [COND] * 5 + [UNCOND] * 5)
    acc = np.zeros((2, 5, HW // 2, HW // 2, 4), np.float32)
    cnt = np.zeros((1, 5, 1, 1, 1), np.float32)
    for (args, kw, out), f0 in zip(calls, (0, 2)):
        frames = np.r_[f0:f0 + 3, 5 + f0:5 + f0 + 3]
        np.testing.assert_array_equal(args[0].numpy(), full[frames])
        np.testing.assert_allclose(args[1].numpy(), ctx[frames], **TOL)
        assert kw["frames"] == 3
        eps_w = _japply(sd, args[0], args[1], t, motion=sd[2]["motion"], frames=3)
        np.testing.assert_allclose(out.numpy(), to_nchw(eps_w), **TOL)
        acc[:, f0:f0 + 3] += eps_w.reshape(2, 3, *eps_w.shape[1:])
        cnt[:, f0:f0 + 3] += 1.0
    eps = (acc / np.maximum(cnt, 1.0)).reshape(10, HW // 2, HW // 2, 4)
    np.testing.assert_allclose(lat, _jax_step(t, full[:5], eps), **TOL)


def test_panorama_evaluation_matches_jax(sd, monkeypatch):
    """A 32x64 canvas, window 32 at stride 16: three UNet calls on the
    windows in row-major order, every latent pixel's eps the fp32 average
    over its windows (JAX's ``w_body``), one DDIM step of the whole
    canvas."""
    calls, lat, t = _one_ddim_step(sd, monkeypatch, width=2 * HW, panorama=True,
                                   panorama_window=HW, panorama_stride=HW // 2)
    assert len(calls) == 3
    full = np.concatenate([_latent_init(1, w=HW)] * 2)
    acc = np.zeros((2, HW // 2, HW, 4), np.float32)
    cnt = np.zeros((1, HW // 2, HW, 1), np.float32)
    for (args, _, out), x0 in zip(calls, (0, 8, 16)):
        np.testing.assert_array_equal(args[0].numpy(), full[..., x0:x0 + 16])
        eps_w = _japply(sd, args[0], args[1], t)
        np.testing.assert_allclose(out.numpy(), to_nchw(eps_w), **TOL)
        acc[:, :, x0:x0 + 16] += eps_w
        cnt[:, :, x0:x0 + 16] += 1.0
    np.testing.assert_allclose(lat, _jax_step(t, full[:1], acc / np.maximum(cnt, 1.0)),
                               **TOL)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_single_window_panorama_is_the_plain_request(sd, sampler):
    """A canvas of one window: the sweep's one window and its count of 1
    give the plain request's eps, bit for bit."""
    cfg, _, _, models = sd
    kw = dict(models=models, config=cfg, tokenizer=_tok(), seed=5, height=HW, width=HW,
              sampler_name=sampler, n_inference_steps=2, return_latents=True)
    img, lat = pipeline.generate(COND, **kw)
    p_img, p_lat = pipeline.generate(COND, panorama=True, panorama_window=HW, **kw)
    np.testing.assert_array_equal(p_lat, lat)
    np.testing.assert_array_equal(p_img, img)


# -------------------------------------------------------------------- the API
def test_sd_upscale_stitch_is_exact_with_an_identity_model(sd, monkeypatch):
    """With the tiles returned unchanged, the two-sided feathered stitch
    gives back the lanczos3 upscale (its uint8 tiles) exactly: 9
    overlapping 32² tiles of an 80² upscale, one init image each, through
    ``generate_many`` in chunks of 4 at the request's strength; the
    upscale within one level of JAX's."""
    cfg, jcfg, jp, models = sd
    img = np.random.RandomState(2).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    got = {}

    def identity(self, prompts, uncond, **kw):
        got.update(kw, n=len(prompts))
        return np.asarray(kw["input_image"])

    kw = dict(scale=2.0, strength=0.4, overlap=8, height=HW, width=HW)
    monkeypatch.setattr(api.StableDiffusion, "generate_many", identity)
    out = api.StableDiffusion(models, _tok(), cfg, device="cpu").sd_upscale("a cat", img, **kw)
    assert got["n"] == 9 and got["batch_size"] == 4 and got["strength"] == 0.4
    assert got["input_image"].shape == (9, HW, HW, 3)
    up = np.clip(resize(img.astype(np.float32), (80, 80, 3), "lanczos3"), 0, 255)
    np.testing.assert_array_equal(out, up.astype(np.uint8))
    monkeypatch.setattr(japi.StableDiffusion, "generate_many", identity)
    want = japi.StableDiffusion(jp, jtokenizer(WORDS, max_len=16), jcfg).sd_upscale(
        "a cat", img, **kw)
    assert np.abs(out.astype(np.int32) - want).max() <= 1


def test_hires_fix_esrgan_flow_matches_jax(sd, monkeypatch):
    """The base pass at half the target, its image through the ESRGAN (x4:
    16² -> 64²), lanczos3 down to the 32² target, then img2img there at the
    request's strength: the second pass's init image equal to JAX's."""
    cfg, jcfg, jp, models = sd
    state = new_arch_state(seed=9)
    base = np.random.RandomState(4).randint(0, 256, (16, 16, 3)).astype(np.uint8)
    passes = {"port": [], "jax": []}

    def fake(record):
        def generate(prompt, uncond_prompt="", **kw):
            record.append(kw)
            return base if "input_image" not in kw else kw["input_image"]
        return generate

    monkeypatch.setattr(pipeline, "generate", fake(passes["port"]))
    monkeypatch.setattr(jpipeline, "generate", fake(passes["jax"]))
    port = api.StableDiffusion(models, _tok(), cfg, device="cpu").with_upscaler(
        weights.convert_esrgan(state))
    jsd = japi.StableDiffusion(jp, jtokenizer(WORDS, max_len=16), jcfg).with_upscaler(
        jweights.convert_esrgan(state))
    out = port.hires_fix("a cat", height=HW, width=HW, strength=0.55, upscale_method="esrgan")
    want = jsd.hires_fix("a cat", height=HW, width=HW, strength=0.55, upscale_method="esrgan")
    assert out.shape == (HW, HW, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, want)
    for p, j in zip(passes["port"], passes["jax"]):
        assert (p["height"], p["width"]) == (j["height"], j["width"])
        assert p.get("strength") == j.get("strength")
    assert [p["height"] for p in passes["port"]] == [16, HW]


def test_animate_windows_past_the_trained_length(sd, monkeypatch):
    """``with_motion((modules, max_len))``: a clip longer than ``max_len``
    sweeps windows of ``max_len`` unless ``motion_window`` is given, as in
    the JAX package."""
    cfg, jcfg, jp, models = sd
    rec = {"port": [], "jax": []}
    for mod, key in ((pipeline, "port"), (jpipeline, "jax")):
        monkeypatch.setattr(mod, "generate_images",
                            lambda p, u, _r=rec[key], **kw: _r.append(kw))
    mods = {k: v for k, v in models.items() if k != "motion"}
    port = api.StableDiffusion(mods, _tok(), cfg, device="cpu").with_motion(
        (models["motion"].state_dict(), 4))
    jsd = japi.StableDiffusion({k: v for k, v in jp.items() if k != "motion"},
                               jtokenizer(WORDS, max_len=16), jcfg).with_motion(
        (jp["motion"], 4))
    for n, more in ((4, {}), (6, {}), (6, {"motion_window": 3})):
        port.animate("a cat", n_frames=n, **more)
        jsd.animate("a cat", n_frames=n, **more)
    for p, j in zip(rec["port"], rec["jax"]):
        assert (p["n_frames"], p.get("motion_window")) == (j["n_frames"],
                                                           j.get("motion_window"))
    assert [p.get("motion_window") for p in rec["port"]] == [None, 4, 3]
    for k, v in models["motion"].state_dict().items():
        assert torch.equal(port.models["motion"].state_dict()[k], v)


# ---------------------------------------------------------------- refusals
#: case -> (prompt, generate keywords); "models" names the JAX models
#: without the motion modules
ERRORS = {
    "n_frames without motion modules": (COND, dict(n_frames=4, models="no motion")),
    "n_frames with two prompts": ([COND, UNCOND], dict(n_frames=4)),
    "n_frames 1": (COND, dict(n_frames=1)),
    "n_frames with PAG": (COND, dict(n_frames=4, pag_scale=2.0)),
    "n_frames with AND": ("a cat AND a dog", dict(n_frames=4)),
    "n_frames with panorama": (COND, dict(n_frames=4, panorama=True, panorama_window=HW)),
    "n_frames with deepcache": (COND, dict(n_frames=4, deepcache=2)),
    "n_frames under fixed_noise": (COND, dict(n_frames=4, fixed_noise=True)),
    "motion_window without n_frames": (COND, dict(motion_window=3)),
    "motion_window of n_frames": (COND, dict(n_frames=4, motion_window=4)),
    "motion_window 1": (COND, dict(n_frames=4, motion_window=1)),
    "panorama with PAG": (COND, dict(panorama=True, panorama_window=HW, pag_scale=2.0)),
    "panorama with deepcache": (COND, dict(panorama=True, panorama_window=HW, deepcache=2)),
    "panorama under fixed_noise": (COND, dict(panorama=True, panorama_window=HW,
                                              fixed_noise=True)),
    "panorama window not a multiple": (COND, dict(panorama=True, panorama_window=HW + 1)),
    "panorama stride not a multiple": (COND, dict(panorama=True, panorama_window=HW,
                                                  panorama_stride=3)),
    "canvas smaller than the window": (COND, dict(panorama=True, panorama_window=2 * HW)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(sd, case):
    """The JAX package's ValueError for each refused value or composition,
    with its message, raised before any work."""
    cfg, jcfg, jp, models = sd
    prompt, kw = ERRORS[case]
    kw = dict(kw)
    jmodels = jp
    if kw.pop("models", None):
        jmodels = {k: v for k, v in jp.items() if k != "motion"}
        models = {k: v for k, v in models.items() if k != "motion"}
    jkw = dict(kw)
    if kw.get("fixed_noise"):
        r = np.random.RandomState(0)
        shape = (1, HW // 2, HW // 2, 4)
        jkw["fixed_noise"] = {"latent_init": r.randn(*shape).astype(np.float32),
                              "sampler_noise": r.randn(2, *shape).astype(np.float32)}
        kw["fixed_noise"] = {"latent_init": to_nchw(jkw["fixed_noise"]["latent_init"]),
                             "sampler_noise": np.transpose(jkw["fixed_noise"]["sampler_noise"],
                                                           (0, 1, 4, 2, 3))}
    common = dict(height=HW, width=HW, n_inference_steps=2)
    with pytest.raises(ValueError) as want:
        jpipeline.generate(prompt, models=jmodels, tokenizer=jtokenizer(WORDS, max_len=16),
                           config=jcfg, **common, **jkw)
    with pytest.raises(ValueError) as got:
        pipeline.generate(prompt, models=models, config=cfg, tokenizer=_tok(), **common, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["animate without motion", "sd_upscale fits one tile",
                                  "sd_upscale smaller than a tile", "sd_upscale overlap"])
def test_api_errors_match_jax(sd, case):
    cfg, jcfg, jp, models = sd
    img = np.zeros((24, 24, 3), np.uint8)
    call = {"animate without motion": lambda s: s.animate("a cat", n_frames=4),
            "sd_upscale fits one tile": lambda s: s.sd_upscale("a cat", img, scale=1.25,
                                                                height=HW, width=HW),
            "sd_upscale smaller than a tile": lambda s: s.sd_upscale(
                "a cat", img, scale=2.0, height=HW, width=64),
            "sd_upscale overlap": lambda s: s.sd_upscale("a cat", img, scale=2.0, overlap=HW,
                                                         height=HW, width=HW)}[case]
    jsd = japi.StableDiffusion({k: v for k, v in jp.items() if k != "motion"},
                               jtokenizer(WORDS, max_len=16), jcfg)
    port = api.StableDiffusion({k: v for k, v in models.items() if k != "motion"}, _tok(),
                               cfg, device="cpu")
    with pytest.raises(ValueError) as want:
        call(jsd)
    with pytest.raises(ValueError) as got:
        call(port)
    assert str(got.value) == str(want.value)


def test_guard_counts_a_panorama_window_not_the_canvas(sd, monkeypatch):
    """The 65536-token guard (ADVICE.md, medium; ROADMAP §3), lowered here to
    256 level-1 tokens in both packages: a 32x64 panorama (512 canvas
    tokens, 256 a window) is refused by the JAX package, which counts the
    canvas, and runs on the port, whose UNet never sees more than a
    window; a window above the limit is refused by both."""
    cfg, jcfg, jp, models = sd
    assert pipeline.MAX_VALIDATED_ATTN_TOKENS == jpipeline.MAX_VALIDATED_ATTN_TOKENS == 65536
    monkeypatch.setattr(jpipeline, "MAX_VALIDATED_ATTN_TOKENS", 256)
    monkeypatch.setattr(pipeline, "MAX_VALIDATED_ATTN_TOKENS", 256)
    kw = dict(height=HW, width=2 * HW, n_inference_steps=1, panorama=True,
              panorama_window=HW)
    with pytest.raises(ValueError, match="512-token global self-attention"):
        jpipeline.generate(COND, models=jp, tokenizer=jtokenizer(WORDS, max_len=16),
                           config=jcfg, **kw)
    img = pipeline.generate(COND, models=models, config=cfg, tokenizer=_tok(), **kw)
    assert img.shape == (HW, 2 * HW, 3) and img.max() > img.min()
    with pytest.raises(ValueError, match="1024-token global self-attention"):
        pipeline.generate(COND, models=models, config=cfg, tokenizer=_tok(),
                          **dict(kw, height=2 * HW, panorama_window=2 * HW))


# ------------------------------------------------------------ launch counts
@pytest.mark.parametrize("case", ["animate", "motion_window", "panorama"])
def test_launch_rule_counts_slice_g(sd, monkeypatch, case):
    """``chip_smoke.expected_launches`` against the plain versions' calls on
    the CPU, the kernel backends on (K1 at the 256-token level and in the
    VAE's mid block, whose 32 channels are a K1 head dim on the CPU; K5 at
    every res block): AnimateDiff's lanes add none (one launch serves a
    lane group), frame windows and panorama windows multiply the
    evaluation's, and a panorama's VAE runs over the canvas."""
    import chip_smoke
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as cconv
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    cfg = dataclasses.replace(sd[0], attention_backend="kernel", conv_backend="kernel",
                              vae_attention_backend="kernel")
    monkeypatch.setattr(chip_smoke, "K1_DH", (4, 8, 32))  # the tiny head widths
    size, windows, kw, canvas = HW, 1, {}, None
    if case == "animate":
        kw.update(n_frames=3)
    elif case == "motion_window":
        kw.update(n_frames=5, motion_window=3, motion_stride=2)
        windows = 2
    else:
        kw.update(width=2 * size, panorama=True, panorama_window=size)
        windows, canvas = 3, (size, 2 * size)
    want = chip_smoke.expected_launches(cfg, size, size, steps=2 * windows, img2img=False,
                                        context=16, canvas=canvas)
    with mock.patch.object(fa, "flash_attention_bsc_plain",
                           wraps=fa.flash_attention_bsc_plain) as k1, \
            mock.patch.object(cconv, "scaled_silu_conv3x3_plain",
                              wraps=cconv.scaled_silu_conv3x3_plain) as k5:
        pipeline.generate(COND, models=sd[3], config=cfg, tokenizer=_tok(),
                          **dict(dict(height=size, width=size, sampler_name="ddim",
                                      n_inference_steps=2), **kw))
    assert (want["K1"], want["K5"]) == (k1.call_count, k5.call_count), want
    # 5 self-attentions an evaluation at the 256-token level (the mid
    # block's 64 are materialized), and the VAE's
    assert want["K1"] == 2 * windows * 5 + 1 and want["K5"] == 2 * windows * 24
    # the VAE's mid block over the whole canvas
    assert k1.call_args.args[0].shape[1] == (512 if case == "panorama" else 256)
