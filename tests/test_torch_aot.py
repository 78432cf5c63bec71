"""The port's exported program (``utils/aot.py`` on ``torch.export``) on the
CPU at the tiny configs, mirroring the JAX package's ``tests/test_aot.py``.

Every artifact is held to the port's own eager ``generate()`` at the same
seed, bit for bit (image and latents), as the JAX package holds its
artifact to its eager ``generate``; txt2img and img2img are also held to
the JAX package's ``generate()`` through injected noise (``fixed_noise``),
at ``test_torch_pipeline.py``'s bars (latents > 55 dB, image > 40 dB).

The SD artifacts run the attention, the res blocks and the VAE on the
kernel backends, so the programs hold the custom ops (their plain versions
run here); a test reads the ops in the exported graphs.  txt2img and
img2img run the JAX package's tiny models; the other artifacts a UNet of
one res block a level (``SMALL``), whose graphs export, save and load in
less time, with weights drawn from seeds.  Exports are shared: every
artifact is exported once per module (``ARTIFACTS``), and
``export_pipeline`` itself shares the programs of artifacts that differ
only in the host loop (sampler, steps, tile, micro-conditioning), as
``load_pipeline`` shares their loads.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import psnr, to_nchw
from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401
from test_torch_pipeline import _nchw_noise

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.utils import aot as jaot
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models, clip_vision, config
from pytorch_stable_diffusion_tpu_torch.models import controlnet, motion, t2i_adapter
from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa
from pytorch_stable_diffusion_tpu_torch.sampling import ddpm
from pytorch_stable_diffusion_tpu_torch.utils import aot
from pytorch_stable_diffusion_tpu_torch.weights import convert, hypernetwork, ip_adapter
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]  # conftest.tiny_tokenizer's words
STEPS = 3
HW = 32
PROMPT = "a photo of a cat"
#: the SD artifacts' config: the three kernel backends
CFG = config.tiny_sd_config(attention_backend="kernel", conv_backend="kernel",
                            vae_attention_backend="kernel")
#: the other SD artifacts': one res block a level
SMALL = dataclasses.replace(CFG, unet=dataclasses.replace(CFG.unet, num_res_blocks=1))
VIS = clip_vision.tiny_vision_config()
OPS = ("flash_attention_bsc", "flash_attention_onepass", "flash_attention_multipass",
       "flash_attention_streamed", "scaled_silu_conv3x3")


def _tok(cfg=CFG):
    return make_test_tokenizer(WORDS, max_len=cfg.clip.max_len)


def _image(seed, size=HW):
    return np.random.RandomState(seed).randint(0, 256, (size, size, 3)).astype(np.uint8)


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _hyper_net(d, seed=3):
    """An A1111 hypernetwork (1-2-1, relu) for context width ``d``."""
    r = np.random.RandomState(seed)

    def net():  # Linear, the activation's index, Linear
        return {f"linear.{i}.{k}": torch.from_numpy(
            (r.randn(*shape) * 0.3).astype(np.float32))
            for i, (o, n) in ((0, (2 * d, d)), (2, (d, 2 * d)))
            for k, shape in (("weight", (o, n)), ("bias", (o,)))}

    obj = {d: (net(), net()), "name": "hn", "activation_func": "relu",
           "activate_output": False, "add_layer_norm": False, "layer_structure": [1, 2, 1]}
    return hypernetwork.load_hypernetwork(obj)


@pytest.fixture(scope="module")
def sd():
    """The tiny SD models (JAX parameter trees drawn with numpy, for the JAX
    package, and converted) and a second model of another seed; ``SMALL``'s
    models with every side net the artifacts take, each drawn from a seed;
    the 9-channel inpainting UNet's models; tiny SDXL's (one res block a
    level)."""
    jp = jax_params(to_jax(config.tiny_sd_config()), 42)
    jax_models = build_models(CFG, device="cpu", state_dicts=convert.from_jax_params(jp, CFG))
    other = build_models(CFG, device="cpu", generator=_g(1))
    models = build_models(SMALL, device="cpu", generator=_g(4))
    models["controlnet"] = [controlnet.build(SMALL, device="cpu", generator=_g(10 + k))
                            for k in range(2)]
    models["t2i_adapter"] = t2i_adapter.build(SMALL, device="cpu", generator=_g(12))
    models["clip_vision"] = clip_vision.build_clip_vision(VIS, device="cpu", generator=_g(13))
    models["ip_adapter"] = clip_vision.build_ip_adapter(ip_adapter.convert_ip_adapter(
        ip_adapter.synthetic_ip_state(SMALL.unet, embed_dim=VIS.proj_dim, seed=14),
        SMALL.unet), device="cpu")
    models["motion"] = motion.build(SMALL.unet, generator=_g(15), device="cpu")
    models["hypernetwork"], hyper_meta = _hyper_net(SMALL.unet.d_context)
    cfg9 = dataclasses.replace(SMALL, unet=dataclasses.replace(SMALL.unet, in_channels=9))
    unet9 = build_models(cfg9, device="cpu", generator=_g(2))
    cfg8 = dataclasses.replace(SMALL, unet=dataclasses.replace(SMALL.unet, in_channels=8))
    ip2p = build_models(cfg8, device="cpu", generator=_g(5))
    xl_cfg = config.tiny_sdxl_config(attention_backend="kernel")
    xl_cfg = dataclasses.replace(xl_cfg, unet=dataclasses.replace(xl_cfg.unet,
                                                                  num_res_blocks=1))
    xl = build_models(xl_cfg, device="cpu", generator=_g(3))
    return dict(jax_params=jp, jax=jax_models, other=other, models=models, hyper=hyper_meta,
                cfg9=cfg9, unet9=unet9, cfg8=cfg8, ip2p=ip2p, xl_cfg=xl_cfg, xl=xl)


def _plain(models):
    return {k: models[k] for k in ("clip", "encoder", "decoder", "diffusion")}


#: artifact name -> (export keywords, models (a key of ``sd``), the side
#: nets taken from sd["models"])
ARTIFACTS = {
    "txt2img": (dict(), "jax", ()),
    "img2img": (dict(img2img=True), "jax", ()),
    "small": (dict(), "models", ()),
    "ddim eta": (dict(sampler="ddim", ddim_eta=0.5), "models", ()),
    "dpm++": (dict(sampler="dpm++"), "models", ()),
    "heun": (dict(sampler="heun"), "models", ()),
    "restart": (dict(sampler="restart"), "models", ()),
    "decode_tile": (dict(decode_tile=8), "models", ()),
    "blend": (dict(img2img=True, inpaint="blend"), "models", ()),
    "unet9": (dict(img2img=True, inpaint="unet9"), "unet9", ()),
    "ip2p": (dict(ip2p=True, sampler="euler_a"), "ip2p", ()),
    "controlnet": (dict(use_control=True), "models", ("controlnet1",)),
    "two controlnets": (dict(use_control=True), "models", ("controlnet",)),
    "t2i_adapter": (dict(use_adapter=True), "models", ("t2i_adapter",)),
    "emphasis": (dict(emphasis=True), "models", ()),
    "rescale, spacing": (dict(guidance_rescale=0.7, timestep_spacing="trailing",
                              sampler="euler"), "models", ()),
    "pag, sag, variation": (dict(pag=True, sag=True, variation=True), "models", ()),
    "hypernetwork": (dict(hypernetwork=True), "models", ("hypernetwork",)),
    "ip_adapter": (dict(ip_adapter=True, ip_vision=VIS), "models",
                   ("ip_adapter", "clip_vision")),
    "animatediff": (dict(n_frames=2, batch=2), "models", ("motion",)),
    "sdxl": (dict(sampler="euler"), "xl", ()),
    "sdxl micro": (dict(original_size=(64, 48), crop_coords=(4, 8), target_size=(32, 32)),
                   "xl", ()),
    "sdxl latent": (dict(img2img="latent"), "xl", ()),
}


def _models_of(sd, name):
    kw, base, side = ARTIFACTS[name]
    models = _plain(sd[base]) if base != "xl" else dict(sd["xl"])
    for s in side:
        models[s.rstrip("1")] = sd["models"]["controlnet"][0] if s == "controlnet1" \
            else sd["models"][s]
    return models


def _cfg_of(sd, name):
    base = ARTIFACTS[name][1]
    return {"jax": CFG, "models": SMALL, "unet9": sd["cfg9"], "ip2p": sd["cfg8"],
            "xl": sd["xl_cfg"]}[base]


@pytest.fixture(scope="module")
def artifacts(sd):
    """name -> (blob, loaded pipeline), exported and loaded at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = dict(ARTIFACTS[name][0])
            if kw.get("hypernetwork"):
                kw["hypernetwork"] = sd["hyper"]
            blob = aot.export_pipeline(_cfg_of(sd, name), _models_of(sd, name),
                                       n_steps=STEPS, height=HW, width=HW, **kw)
            cache[name] = (blob, aot.load_pipeline(blob))
        return cache[name]
    return get


def _tokens(cfg, prompt, n=1):
    tok = _tok(cfg)
    return (np.asarray(tok.batch_encode([prompt] * n), np.int64),
            np.asarray(tok.batch_encode([""] * n), np.int64))


def _eager(sd, name, prompt=PROMPT, **kw):
    """The port's eager ``generate()`` of the artifact's configuration."""
    export_kw = ARTIFACTS[name][0]
    cfg = _cfg_of(sd, name)
    args = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=5, height=HW,
                width=HW, return_latents=True, config=cfg, tokenizer=_tok(cfg),
                models=_models_of(sd, name),
                sampler_name=export_kw.get("sampler", "ddpm"),
                ddim_eta=export_kw.get("ddim_eta", 0.0),
                decode_tile=export_kw.get("decode_tile"),
                guidance_rescale=export_kw.get("guidance_rescale", 0.0),
                timestep_spacing=export_kw.get("timestep_spacing", "uniform"))
    args.update(kw)
    return pipeline.generate(prompt, **args)


def _same(got, want):
    images, latents = got
    np.testing.assert_array_equal(images[0], want[0])
    np.testing.assert_array_equal(latents, want[1])


def _unit(image):
    """A uint8 image as the artifact takes it: (1, H, W, 3) in [-1, 1]."""
    return (image.astype(np.float32) / 255.0 * 2.0 - 1.0)[None]


# ------------------------------------------------------------------ txt2img
def test_txt2img_round_trip_equals_eager(sd, artifacts):
    blob, loaded = artifacts("txt2img")
    assert isinstance(blob, bytes) and blob.startswith(aot.MAGIC)
    # the graphs, no weight: the UNet alone holds more bytes than the blob
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in sd["jax"]["diffusion"].parameters())
    assert len(blob) < weight_bytes
    assert loaded.platforms == ("cpu",)
    assert loaded.image_shape == (1, HW, HW, 3)
    assert loaded.token_shape == (1, CFG.clip.max_len)
    assert loaded.aux_keys == ["latent_init"]
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_models_of(sd, "txt2img"), cond, uncond, 5, 7.5)
    assert got[0].dtype == np.uint8 and got[0].shape == (1, HW, HW, 3)
    _same(got, _eager(sd, "txt2img"))


def test_programs_hold_the_kernel_ops(sd, artifacts):
    """The exported graphs call the custom ops (their CPU implementations,
    the plain versions, ran above), not a traced plain version: K1 at the
    UNet's 256-token level, K5 at every res block, the VAE's attention."""
    _, loaded = artifacts("img2img")

    def ops(name):
        found = {}
        for node in loaded._programs[name].gm.graph.nodes:
            target = str(node.target)
            if node.op == "call_function" and target.startswith("sdt_torch."):
                key = target.split(".")[1]
                found[key] = found.get(key, 0) + 1
        return found

    eps = ops("eps")
    assert eps.get("flash_attention_bsc", 0) >= 1
    assert eps.get("scaled_silu_conv3x3", 0) >= 2 * (2 * 2 + 2 + 3 * 2)
    for name in ("prepare", "decode"):
        assert sum(ops(name).values()) >= 1, name


def test_exporting_runs_no_kernel_and_no_plain_version(sd):
    """Tracing runs the ops' fake implementations only: no launch counter
    moves and no plain version is called (a fresh size, so that no program
    comes from the module's earlier exports)."""
    before = {w: w.launches for w in (fa.flash_attention_bsc, fa.flash_attention_onepass,
                                      fa.flash_attention_multipass,
                                      fa.flash_attention_streamed, k5.scaled_silu_conv3x3)}
    with mock.patch.object(fa, "flash_attention_bsc_plain") as bsc, \
            mock.patch.object(k5, "scaled_silu_conv3x3_plain") as conv:
        aot.export_pipeline(SMALL, _plain(sd["models"]), n_steps=2, height=24, width=24)
    assert bsc.call_count == conv.call_count == 0
    assert {w: w.launches for w in before} == before


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_artifact_matches_jax_generate(sd, artifacts, tiny_tokenizer, img2img):
    """The JAX package's ``generate()`` and the artifact on the same weights
    and injected noise."""
    r = np.random.RandomState(11)
    noise = {"latent_init": r.randn(1, 16, 16, 4).astype(np.float32),
             "sampler_noise": r.randn(STEPS, 1, 16, 16, 4).astype(np.float32),
             "encoder_noise": r.randn(1, 16, 16, 4).astype(np.float32)}
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0, height=HW,
              width=HW, return_latents=True)
    image = _image(3)
    start = 0
    if img2img:
        kw.update(input_image=image, strength=0.8)
        start = ddpm.start_step_for_strength(STEPS, 0.8)
    else:
        noise.pop("encoder_noise")
    ref_img, ref_lat = jpipeline.generate(
        PROMPT, models=sd["jax_params"], tokenizer=tiny_tokenizer,
        config=jconfig.tiny_sd_config(attention_backend="pallas"), fixed_noise=noise, **kw)
    _, loaded = artifacts("img2img" if img2img else "txt2img")
    cond, uncond = _tokens(CFG, PROMPT)
    img, lat = loaded(_models_of(sd, "txt2img"), cond, uncond, 0, 7.5, start_step=start,
                      input_image=_unit(image), fixed_noise=_nchw_noise(noise))
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img[0].astype(np.float32), ref_img.astype(np.float32)) > 40.0


# ------------------------------------------------------------------ img2img
@pytest.mark.parametrize("strength", [0.8, 0.5])
def test_img2img_one_artifact_two_strengths(sd, artifacts, strength):
    _, loaded = artifacts("img2img")
    image = _image(3)
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_models_of(sd, "img2img"), cond, uncond, 5, 7.5,
                 start_step=ddpm.start_step_for_strength(STEPS, strength),
                 input_image=_unit(image))
    _same(got, _eager(sd, "img2img", input_image=image, strength=strength))


# ----------------------------------------------------- samplers and decoding
@pytest.mark.parametrize("name", ["small", "ddim eta", "dpm++", "heun", "restart",
                                  "decode_tile", "rescale, spacing"])
def test_host_loop_variants_equal_eager(sd, artifacts, name):
    """One sampler of each loop family (DDPM, and one evaluation a step with
    eta's noise, multistep, two evaluations, restart's own grid) through one
    set of programs, the tiled decode, guidance rescale on the trailing
    grid."""
    _, loaded = artifacts(name)
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_plain(sd["models"]), cond, uncond, 5, 7.5)
    _same(got, _eager(sd, name))


# ------------------------------------------------------------------ inpaint
@pytest.mark.parametrize("mode", ["blend", "unet9"])
def test_inpaint_equals_eager(sd, artifacts, mode):
    _, loaded = artifacts(mode)
    assert "mask" in loaded.aux_keys
    image = _image(3)
    mask = np.zeros((HW, HW), np.float32)
    mask[8:24, 4:20] = 1.0
    cond, uncond = _tokens(CFG, PROMPT)
    strength = 0.8
    got = loaded(_models_of(sd, mode), cond, uncond, 5, 7.5,
                 start_step=ddpm.start_step_for_strength(STEPS, strength),
                 input_image=_unit(image), mask=mask[None, ..., None])
    _same(got, _eager(sd, mode, input_image=image, mask_image=mask, strength=strength))


def test_instruct_pix2pix_equals_eager(sd, artifacts):
    """The 8-channel UNet's three lanes; the image input carries the edit
    image, the image guidance scale is a call-time input."""
    _, loaded = artifacts("ip2p")
    assert "image_cfg_scale" in loaded.aux_keys
    image = _image(24)
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_models_of(sd, "ip2p"), cond, uncond, 5, 7.5, input_image=_unit(image),
                 image_cfg_scale=1.3)
    _same(got, _eager(sd, "ip2p", edit_image=image, image_guidance_scale=1.3))


# --------------------------------------------------------------- side nets
@pytest.mark.parametrize("name", ["controlnet", "two controlnets"])
def test_controlnet_equals_eager(sd, artifacts, name):
    _, loaded = artifacts(name)
    n = 1 if name == "controlnet" else 2
    images = [_image(20 + k) for k in range(n)]
    scales = [0.8, 0.5][:n]
    hints = pipeline._hints(images, HW, HW, 1).transpose(0, 1, 3, 4, 2)
    cond, uncond = _tokens(CFG, PROMPT)
    models = _models_of(sd, name)
    got = loaded(models, cond, uncond, 5, 7.5, control_hint=hints, control_scale=scales)
    _same(got, _eager(sd, name, control_image=images if n > 1 else images[0],
                      controlnet_scale=scales if n > 1 else scales[0]))
    with pytest.raises(ValueError, match="control_hint"):
        loaded(models, cond, uncond, 5, 7.5)


def test_t2i_adapter_equals_eager(sd, artifacts):
    _, loaded = artifacts("t2i_adapter")
    image = _image(22)
    hint = pipeline._hints([image], HW, HW, 1).transpose(0, 1, 3, 4, 2)
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_models_of(sd, "t2i_adapter"), cond, uncond, 5, 7.5, adapter_hint=hint,
                 adapter_scale=0.7)
    _same(got, _eager(sd, "t2i_adapter", adapter_image=image, adapter_scale=0.7))


def test_ip_adapter_equals_eager(sd, artifacts):
    _, loaded = artifacts("ip_adapter")
    assert {"ip_image", "ip_scale"} <= set(loaded.aux_keys)
    image = _image(23, VIS.image_size)
    cond, uncond = _tokens(CFG, PROMPT)
    models = _models_of(sd, "ip_adapter")
    got = loaded(models, cond, uncond, 5, 7.5, ip_image=clip_vision.preprocess(image, VIS),
                 ip_scale=0.8)
    _same(got, _eager(sd, "ip_adapter", ip_adapter_image=image, ip_adapter_scale=0.8,
                      clip_vision_config=VIS))
    with pytest.raises(ValueError, match="ip_image"):
        loaded(models, cond, uncond, 5, 7.5)


def test_hypernetwork_equals_eager(sd, artifacts):
    _, loaded = artifacts("hypernetwork")
    assert "hyper_strength" in loaded.aux_keys
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_models_of(sd, "hypernetwork"), cond, uncond, 5, 7.5,
                 hypernetwork_strength=0.7)
    _same(got, _eager(sd, "hypernetwork", hypernetwork=sd["hyper"],
                      hypernetwork_strength=0.7))


# -------------------------------------------------------- prompts, guidance
def test_emphasis_equals_eager(sd, artifacts):
    _, loaded = artifacts("emphasis")
    prompt = "a (photo:1.3) of a [cat]"
    tok = _tok()
    (cond, cw), (uncond, uw) = tok.encode_weighted(prompt), tok.encode_weighted("")
    got = loaded(_plain(sd["models"]), [cond], [uncond], 5, 7.5, cond_weights=[cw],
                 uncond_weights=[uw])
    _same(got, _eager(sd, "emphasis", prompt=prompt, emphasis=True))


@pytest.mark.parametrize("scales", [(0.75, 0.0, 0.0), (0.0, 0.5, 0.0), (1.5, 0.75, 0.3)],
                         ids=["pag", "sag", "all three"])
def test_pag_sag_variation_equal_eager(sd, artifacts, scales):
    """One artifact with PAG's and SAG's passes and variation seeds; a zero
    scale turns each off at call time, as in eager."""
    _, loaded = artifacts("pag, sag, variation")
    assert {"pag_scale", "sag_scale", "variation_seed",
            "variation_strength"} <= set(loaded.aux_keys)
    pag, sag, strength = scales
    kw = dict(pag_scale=pag, sag_scale=sag, variation_seed=9, variation_strength=strength)
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(_plain(sd["models"]), cond, uncond, 5, 7.5, **kw)
    _same(got, _eager(sd, "pag, sag, variation", **kw))


def test_animatediff_equals_eager(sd, artifacts):
    _, loaded = artifacts("animatediff")
    cond, uncond = _tokens(CFG, PROMPT, n=2)
    images, latents = loaded(_models_of(sd, "animatediff"), cond, uncond, 5, 7.5)
    want_img, want_lat = _eager(sd, "animatediff", n_frames=2)
    assert images.shape == (2, HW, HW, 3)
    np.testing.assert_array_equal(images[0], want_img)  # generate returns frame 0
    np.testing.assert_array_equal(latents, want_lat)


# --------------------------------------------------------------------- SDXL
@pytest.mark.parametrize("name", ["sdxl", "sdxl micro"])
def test_sdxl_equals_eager(sd, artifacts, name):
    _, loaded = artifacts(name)
    cond, uncond = _tokens(sd["xl_cfg"], PROMPT)
    kw = {k: v for k, v in ARTIFACTS[name][0].items()
          if k in ("original_size", "crop_coords", "target_size")}
    got = loaded(sd["xl"], cond, uncond, 5, 7.5)
    _same(got, _eager(sd, name, **kw))


def test_latent_img2img_handoff_equals_eager(sd, artifacts):
    """img2img="latent" (the base -> refiner handoff): ready latents of the
    base artifact, re-noised at a call-time start step."""
    cond, uncond = _tokens(sd["xl_cfg"], PROMPT)
    _, base = artifacts("sdxl")
    _, lat = base(sd["xl"], cond, uncond, 5, 7.5)
    _, loaded = artifacts("sdxl latent")
    assert loaded.image_shape == (1, 4, HW // 2, HW // 2)
    start = ddpm.start_step_for_strength(STEPS, 0.5)
    got = loaded(sd["xl"], cond, uncond, 6, 7.5, start_step=start, input_image=lat)
    _same(got, _eager(sd, "sdxl latent", seed=6, init_latents=lat, strength=0.5))


# ---------------------------------------------- weights at call time, prime
def test_weights_at_call_time(sd, artifacts):
    """Another seed's weights through the same artifact give that model's
    eager image, not the first model's."""
    _, loaded = artifacts("txt2img")
    cond, uncond = _tokens(CFG, PROMPT)
    got = loaded(sd["other"], cond, uncond, 5, 7.5)
    _same(got, _eager(sd, "txt2img", models=sd["other"]))
    first = _eager(sd, "txt2img")
    assert not np.array_equal(got[0][0], first[0])
    with pytest.raises(ValueError, match="do not fit"):
        loaded(sd["xl"], cond, uncond, 5, 7.5)


def test_prime_pipeline_equals_load_pipeline(sd, artifacts):
    blob, loaded = artifacts("txt2img")
    models = _models_of(sd, "txt2img")
    primed = aot.prime_pipeline(blob, models)
    cond, uncond = _tokens(CFG, PROMPT)
    for got, want in zip(primed(models, cond, uncond, 5, 7.5),
                         loaded(models, cond, uncond, 5, 7.5)):
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- refusals
def _refusals():
    xl = jconfig.tiny_sdxl_config()
    return {  # case -> (export keywords, models without, JAX config or None)
        "size": (dict(height=17), (), None),
        "sampler": (dict(sampler="nope"), (), None),
        "blend without img2img": (dict(inpaint="blend"), (), None),
        "inpaint on latents": (dict(img2img="latent", inpaint="unet9"), (), None),
        "control without a controlnet": (dict(use_control=True), ("controlnet",), None),
        "adapter without an adapter": (dict(use_adapter=True), ("t2i_adapter",), None),
        "ip2p with img2img": (dict(ip2p=True, img2img=True), (), None),
        "ip2p without cfg": (dict(ip2p=True, do_cfg=False), (), None),
        "hypernetwork without nets": (dict(hypernetwork=("relu", False)), ("hypernetwork",),
                                      None),
        "ip without a tower": (dict(ip_adapter=True), ("clip_vision",), None),
        "frames without motion": (dict(n_frames=2, batch=2), ("motion",), None),
        "frames and batch": (dict(n_frames=2, batch=1), (), None),
        "micro-conditioning off SDXL": (dict(original_size=(64, 64)), (), None),
        "refiner target_size": (dict(target_size=(32, 32)), (),
                                dataclasses.replace(xl, unet=dataclasses.replace(
                                    xl.unet, add_time_ids=5))),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(sd, case):
    """The JAX ``export_pipeline``'s ValueErrors, raised before any work,
    with its messages."""
    kw, drop, jcfg = REFUSALS[case]
    kw = dict(dict(n_steps=STEPS, height=HW, width=HW), **kw)
    xl = config.tiny_sdxl_config()
    pcfg = SMALL if jcfg is None else dataclasses.replace(
        xl, unet=dataclasses.replace(xl.unet, add_time_ids=5))
    jcfg = jcfg or jconfig.tiny_sd_config()
    names = ("clip", "encoder", "decoder", "diffusion", "controlnet", "t2i_adapter",
             "ip_adapter", "clip_vision", "motion", "hypernetwork")
    msgs = []
    for export, models, c in ((jaot.export_pipeline, dict.fromkeys(names), jcfg),
                              (aot.export_pipeline, sd["models"], pcfg)):
        with pytest.raises(ValueError) as err:
            export(c, {k: v for k, v in models.items() if k not in drop}, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------------- the ops
def _op_args(name):
    g = _g(7)
    if name == "flash_attention_bsc":
        q, k, v = torch.randn(2, 40, 3 * 32, generator=g).split(32, -1)
        return (q, k, v, 4)
    if name == "scaled_silu_conv3x3":
        return (torch.randn(2, 8, 5, 6, generator=g), torch.randn(2, 8, generator=g),
                torch.randn(2, 8, generator=g), torch.randn(16, 8, 3, 3, generator=g),
                torch.randn(16, generator=g))
    q, k, v = (torch.randn(2, 3, 24, 16, generator=g) for _ in range(3))
    return (q, k, v) if name == "flash_attention_streamed" else (q, k, v, True)


@pytest.mark.parametrize("name", OPS)
def test_ops_registration(name):
    """Each kernel is a custom op in the sdt_torch namespace whose schema
    and fake implementation agree with its CPU implementation (the plain
    version) on strided views, shapes, dtypes and strides."""
    op = getattr(torch.ops.sdt_torch, name).default
    result = torch.library.opcheck(op, _op_args(name),
                                   test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}


def test_k5_op_fake_follows_a_channels_last_input():
    args = list(_op_args("scaled_silu_conv3x3"))
    args[0] = args[0].contiguous(memory_format=torch.channels_last)
    result = torch.library.opcheck(torch.ops.sdt_torch.scaled_silu_conv3x3.default,
                                   tuple(args), test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}

