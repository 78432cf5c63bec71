"""Slice E's ControlNet through ``generate()``, against the JAX package:
on dpm++, on heun, with img2img, two of them, and with an IP-Adapter,
through ``fixed_noise`` at ``compare_generate``'s bar (latents > 55 dB,
images > 40 dB).  Also: the own-grid samplers with a ControlNet, the JAX
package's ``ValueError``s for every slice E option, the 9-channel UNet
with a ControlNet, and the API's ``with_controlnet`` /
``with_t2i_adapter`` / ``with_ip_adapter`` on files.  The T2I-Adapter,
IP-Adapter and reference-only requests are in
tests/test_torch_side_net_adapters.py (two files, so that two test
workers share the JAX compiles), with this file's fixture and helpers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import psnr, to_nchw
from test_torch_edit_families import nchw_noise, noise_for
from test_torch_families import to_jax
from test_torch_side_nets import (HW, TOL, one_torch_thread, plus_state,  # noqa: F401
                                  port_models, side_jax_params)

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import clip_vision as jcv
from pytorch_stable_diffusion_tpu.weights import ip_adapter as jip
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import api, pipeline
from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv
from pytorch_stable_diffusion_tpu_torch.models import config, state_dicts
from pytorch_stable_diffusion_tpu_torch.utils import annotators
from pytorch_stable_diffusion_tpu_torch.weights import convert, diffusers, ip_adapter, save
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]
STEPS = 2
VIS, JVIS = cv.tiny_vision_config(), jcv.tiny_vision_config()


@pytest.fixture(scope="module")
def fam():
    """name -> (port cfg, JAX cfg, JAX models dict, port models dict): tiny
    SD-1.5 with two ControlNets, a T2I-Adapter, a vision tower and a
    standard and a "plus" IP-Adapter; tiny SDXL with a T2I-Adapter."""
    out = {}
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = side_jax_params(cfg, jcfg, 70, vis_cfg=JVIS, n_nets=2)
    models = port_models(cfg, jp, VIS)
    state = plus_state(cfg.unet, VIS, seed=9)
    jp["ip_plus"] = jip.convert_ip_adapter(state, jcfg.unet)
    models["ip_plus"] = cv.build_ip_adapter(ip_adapter.convert_ip_adapter(state, cfg.unet),
                                            device="cpu")
    out["sd"] = (cfg, jcfg, jp, models)
    cfg = config.tiny_sdxl_config()
    jcfg = to_jax(cfg)
    jp = side_jax_params(cfg, jcfg, 71)
    out["xl"] = (cfg, jcfg, jp, port_models(cfg, jp))
    return out


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (HW, HW, 3)).astype(np.uint8)


def _canny_hint(seed):
    """A ControlNet hint as users make one: Canny edges of an image."""
    return annotators.hint_rgb(annotators.canny(_image(seed), low=0.05, high=0.15))


def _pick(d, nets, ip):
    """The models dict of a request: one ControlNet or both, the standard
    or the plus IP-Adapter."""
    out = {k: v for k, v in d.items() if k not in ("controlnet", "ip_plus", "ip_adapter")}
    nets_all = d["controlnet"]
    out["controlnet"] = nets_all[0] if nets == 1 and isinstance(nets_all, list) else nets_all
    if "ip_adapter" in d:
        out["ip_adapter"] = d["ip_plus"] if ip == "plus" else d["ip_adapter"]
    return out


def compare(fam, name, *, nets=1, ip="standard", jax_kw=None, port_kw=None, **kw):
    cfg, jcfg, jp, models = fam[name]
    kw = dict(dict(uncond_prompt="a dog", cfg_scale=5.0, n_inference_steps=STEPS, seed=0,
                   height=HW, width=HW, return_latents=True), **kw)
    noise = noise_for(HW, HW, kw["n_inference_steps"])
    ref_img, ref_lat = jpipeline.generate(
        "a photo of a cat", models=_pick(jp, nets, ip), config=jcfg,
        tokenizer=jtokenizer(WORDS, max_len=16), fixed_noise=noise, **kw, **(jax_kw or {}))
    img, lat = pipeline.generate(
        "a photo of a cat", models=_pick(models, nets, ip), config=cfg,
        tokenizer=make_test_tokenizer(WORDS, max_len=16), fixed_noise=nchw_noise(noise),
        **kw, **(port_kw or {}))
    assert np.isfinite(lat).all() and img.shape == ref_img.shape
    return psnr(lat, to_nchw(ref_lat)), psnr(img.astype(np.float32),
                                             ref_img.astype(np.float32))


#: the image prompt, at the tiny tower's 16x16
IP_IMAGE = np.random.RandomState(5).randint(0, 256, (16, 16, 3)).astype(np.uint8)
IP = dict(ip_adapter_image=IP_IMAGE, ip_adapter_scale=0.7)
GENERATE = {
    "controlnet, dpm++": dict(control_image=_canny_hint(1), controlnet_scale=0.8,
                              sampler_name="dpm++"),
    "controlnet, heun": dict(control_image=_canny_hint(1), sampler_name="heun"),
    "controlnet, img2img": dict(control_image=_canny_hint(2), input_image=_image(3),
                                strength=0.7),
    "two controlnets": dict(nets=2, control_image=[_canny_hint(1), _canny_hint(2)],
                            controlnet_scale=[1.0, 0.5]),
    "controlnet + ip-adapter": dict(IP, control_image=_canny_hint(1), sampler_name="euler_a"),
}


def check_generate(fam, case, cases):
    kw = dict(cases[case])
    if "ip_adapter_image" in kw:
        kw.update(jax_kw=dict(clip_vision_config=JVIS), port_kw=dict(clip_vision_config=VIS))
    lat_db, img_db = compare(fam, "sd", **kw)
    assert lat_db > 55.0, lat_db
    assert img_db > 40.0, img_db


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(fam, case):
    check_generate(fam, case, GENERATE)


# ------------------------------------------------------- own-grid samplers
@pytest.mark.parametrize("sampler", ["restart", "dpm_fast", "dpm_adaptive"])
def test_own_grid_samplers_carry_the_controlnet(fam, sampler):
    """They run with a ControlNet, and at scale 0 give the request without
    one, bit for bit."""
    cfg, _, _, models = fam["sd"]
    kw = dict(uncond_prompt="", cfg_scale=5.0, n_inference_steps=3, seed=1, height=HW,
              width=HW, sampler_name=sampler, config=cfg, return_latents=True,
              tokenizer=make_test_tokenizer(WORDS, max_len=16))
    m = _pick(models, 1, "standard")
    _, plain = pipeline.generate("a cat", models=m, **kw)
    _, zero = pipeline.generate("a cat", models=m, control_image=_canny_hint(1),
                                controlnet_scale=0.0, **kw)
    _, ctrl = pipeline.generate("a cat", models=m, control_image=_canny_hint(1), **kw)
    np.testing.assert_array_equal(zero, plain)
    assert np.isfinite(ctrl).all() and np.abs(ctrl - plain).max() > 1e-3


# ---------------------------------------------------------------- refusals
def _tiny(in_channels):
    cfg = config.tiny_sd_config()
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, in_channels=in_channels))


def _refusals():
    ip2p, unet9 = _tiny(8), _tiny(9)
    img = _image(1)
    return {
        "control without a controlnet": (dict(control_image=img), ("controlnet",)),
        "control image count": (dict(control_image=[img, img]), ()),
        "control scale count": (dict(control_image=img, controlnet_scale=[1.0, 2.0]), ()),
        "adapter without an adapter": (dict(adapter_image=img), ("t2i_adapter",)),
        "adapter image count": (dict(adapter_image=[img, img]), ()),
        "adapter scale count": (dict(adapter_image=img, adapter_scale=[1.0, 2.0]), ()),
        "ip without an adapter": (dict(ip_adapter_image=img), ("ip_adapter",)),
        "ip without a tower": (dict(ip_adapter_image=img), ("clip_vision",)),
        "ip with InstructPix2Pix": (dict(ip_adapter_image=img, edit_image=img, config=ip2p), ()),
        "InstructPix2Pix with control and adapter": (
            dict(edit_image=img, control_image=img, adapter_image=img, config=ip2p), ()),
        "reference with prompt editing": (dict(reference_image=img, prompt="a [cat:dog:1]"),
                                          ()),
        "reference with InstructPix2Pix": (dict(reference_image=img, edit_image=img,
                                                config=ip2p), ()),
        "reference on a 9-channel UNet": (dict(reference_image=img, config=unet9), ()),
        "reference under fixed_noise": (dict(reference_image=img, fixed_noise={}), ()),
        "reference fidelity": (dict(reference_image=img, reference_fidelity=1.5), ()),
        "reference mode": (dict(reference_image=img, reference_mode="style"), ()),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(fam, case):
    """Each ValueError of these options, raised before any work with the
    JAX package's message."""
    kw, drop = REFUSALS[case]
    cfg, jcfg, jp, models = fam["sd"]
    kw = dict(kw)
    prompt = kw.pop("prompt", "a cat")
    pcfg = kw.pop("config", cfg)
    base = dict(uncond_prompt="", n_inference_steps=STEPS, height=HW, width=HW, seed=0)
    msgs = []
    for gen, m, c, tok in ((jpipeline.generate, jp, to_jax(pcfg), jtokenizer(WORDS, max_len=16)),
                           (pipeline.generate, models, pcfg,
                            make_test_tokenizer(WORDS, max_len=16))):
        m = {k: v for k, v in _pick(m, 1, "standard").items() if k not in drop}
        with pytest.raises(ValueError) as err:
            gen(prompt, models=m, config=c, tokenizer=tok, **base, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_controlnet_over_a_9_channel_unet(fam):
    """The ControlNet takes the 4-channel latents, also beside a 9-channel
    inpainting UNet.  The port builds its conv_in for them and runs; the
    JAX package's ``controlnet.init`` on the inpainting config builds a
    9-channel conv_in that its pipeline then feeds the 4-channel latents,
    and fails (ROADMAP.md §3)."""
    from pytorch_stable_diffusion_tpu.models import controlnet as jcontrolnet

    from test_torch_families import draw_tree, jax_params

    cfg = _tiny(9)
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, 72)
    r = np.random.RandomState(3)
    jp["controlnet"] = draw_tree(lambda k: jcontrolnet.init(k, jcfg.unet, 2), r)
    kw = dict(uncond_prompt="", n_inference_steps=STEPS, height=HW, width=HW, seed=0,
              input_image=_image(1), mask_image=np.ones((HW, HW), np.float32), strength=1.0,
              control_image=_canny_hint(1), return_latents=True)
    with pytest.raises(ValueError, match="4 // 1 != 9"):
        jpipeline.generate("a cat", models=jp, config=jcfg,
                           tokenizer=jtokenizer(WORDS, max_len=16), **kw)
    models = fam["sd"][3]
    pm = dict(port_models(cfg, {k: v for k, v in jp.items() if k != "controlnet"}),
              controlnet=models["controlnet"][0])
    _, lat = pipeline.generate("a cat", models=pm, config=cfg,
                               tokenizer=make_test_tokenizer(WORDS, max_len=16), **kw)
    assert np.isfinite(lat).all()


# --------------------------------------------------------------------- API
def test_api_loads_side_nets_from_files(fam, tmp_path):
    """with_controlnet from a CompVis .safetensors file, a diffusers
    directory and a list of both; with_t2i_adapter from a diffusers
    directory; with_ip_adapter from .bin and .safetensors files.  Each
    request equals the one on the in-memory modules, bit for bit."""
    cfg, _, _, models = fam["sd"]
    net0, net1 = models["controlnet"]
    ckpt = str(tmp_path / "control.safetensors")
    save.write_safetensors(convert.deconvert_controlnet(net0, cfg), ckpt)
    cn_dir = tmp_path / "cn"
    cn_dir.mkdir()
    save.write_safetensors(diffusers.deconvert_controlnet_diffusers(net1, cfg),
                           str(cn_dir / "diffusion_pytorch_model.safetensors"))
    ad_dir = tmp_path / "ad"
    ad_dir.mkdir()
    save.write_safetensors(diffusers.deconvert_t2i_adapter_diffusers(models["t2i_adapter"], cfg),
                           str(ad_dir / "diffusion_pytorch_model.safetensors"))
    ip_file = str(tmp_path / "ip.bin")
    torch.save({"image_proj": {k[len("image_proj."):]: v for k, v in
                               models["ip_adapter"].state_dict().items()
                               if k.startswith("image_proj.")},
                "ip_adapter": _ip_layers(models["ip_adapter"], cfg)}, ip_file)
    vis_file = str(tmp_path / "vision.safetensors")
    save.write_safetensors(_hf_vision(models["clip_vision"]), vis_file)

    base = {k: models[k] for k in ("clip", "encoder", "decoder", "diffusion")}
    sd = api.StableDiffusion(base, make_test_tokenizer(WORDS, max_len=16), cfg, device="cpu")
    kw = dict(seed=2, height=HW, width=HW, n_inference_steps=STEPS, sampler_name="euler")
    hint = _canny_hint(1)
    for loaded, want in (
            (sd.with_controlnet(ckpt), dict(base, controlnet=net0)),
            (sd.with_controlnet(str(cn_dir)), dict(base, controlnet=net1)),
            (sd.with_controlnet([ckpt, str(cn_dir)]), dict(base, controlnet=[net0, net1]))):
        n = len(loaded.models["controlnet"]) if isinstance(loaded.models["controlnet"], list) \
            else 1
        extra = dict(control_image=[hint] * n if n > 1 else hint)
        np.testing.assert_array_equal(
            loaded.txt2img("a cat", **kw, **extra),
            pipeline.generate("a cat", models=want, config=cfg, tokenizer=sd.tokenizer,
                              device="cpu", **kw, **extra))
    loaded = sd.with_t2i_adapter(str(ad_dir))
    np.testing.assert_array_equal(
        loaded.txt2img("a cat", adapter_image=hint, **kw),
        pipeline.generate("a cat", models=dict(base, t2i_adapter=models["t2i_adapter"]),
                          config=cfg, tokenizer=sd.tokenizer, adapter_image=hint, **kw))
    loaded = sd.with_ip_adapter(ip_file, vis_file, vision_config=VIS)
    assert loaded.models["clip_vision"].cfg == VIS and "ip_adapter" not in sd.models
    np.testing.assert_array_equal(
        loaded.txt2img("a cat", ip_adapter_image=IP_IMAGE, **kw),
        pipeline.generate("a cat", models=dict(base, ip_adapter=models["ip_adapter"],
                                               clip_vision=models["clip_vision"]),
                          config=cfg, tokenizer=sd.tokenizer, ip_adapter_image=IP_IMAGE,
                          clip_vision_config=VIS, **kw))
    # the side nets stay attached through the other with_* methods
    assert loaded.with_vae((state_dicts(base)["encoder"], state_dicts(base)["decoder"])
                           ).models["ip_adapter"] is loaded.models["ip_adapter"]


def _ip_layers(ipa, cfg):
    """The published ``ip_adapter`` dict (keys 2 j + 1) of a port adapter."""
    out = {}
    for j, key in enumerate(ip_adapter.ip_layer_plan(cfg.unet)):
        out[f"{2 * j + 1}.to_k_ip.weight"] = ipa.layers[key].k.weight.detach().clone()
        out[f"{2 * j + 1}.to_v_ip.weight"] = ipa.layers[key].v.weight.detach().clone()
    return out


def _hf_vision(tower):
    """The HF CLIPVisionModelWithProjection state dict of a port tower."""
    sd = tower.state_dict()
    v = "vision_model."
    out = {v + "embeddings.class_embedding": sd["class_embedding"],
           v + "embeddings.patch_embedding.weight": sd["patch_embedding.weight"],
           v + "embeddings.position_embedding.weight": sd["position_embedding"],
           "visual_projection.weight": sd["projection"].t().contiguous()}
    names = {"pre_ln": "pre_layrnorm", "post_ln": "post_layernorm", "ln1": "layer_norm1",
             "ln2": "layer_norm2", "attn.q": "self_attn.q_proj", "attn.k": "self_attn.k_proj",
             "attn.v": "self_attn.v_proj", "attn.out": "self_attn.out_proj", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    for k, x in sd.items():
        head, _, leaf = k.rpartition(".")
        if head in names:
            out[f"{v}{names[head]}.{leaf}"] = x
        elif head.startswith("layers."):
            i, rest = head[len("layers."):].split(".", 1)
            out[f"{v}encoder.layers.{i}.{names[rest]}.{leaf}"] = x
    return {k: x.contiguous() for k, x in out.items()}


@pytest.mark.parametrize("do_cfg", [True, False])
def test_launch_rule_counts_side_nets(fam, monkeypatch, do_cfg):
    """``chip_smoke.expected_launches`` (the one copy of the launch rule the
    card's requests are held to) with a ControlNet and reference attn: at
    64² the tiny SD-1.5's level 0 (1024 tokens) and its bottleneck (256)
    take K1's path in the UNet, the capture pass and the ControlNet, and
    the read's [own, banked] attention K2's; without CFG the read replaces
    the plain self-attention."""
    import chip_smoke
    from unittest import mock

    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    cfg, _, _, models = fam["sd"]
    cfg = dataclasses.replace(cfg, attention_backend="kernel")
    monkeypatch.setattr(chip_smoke, "K1_DH", (4, 8))  # the tiny head widths, on the CPU
    monkeypatch.setattr(chip_smoke, "K2_DH", (4, 8))
    want = chip_smoke.expected_launches(cfg, 64, 64, steps=2, img2img=False, context=16,
                                        controlnets=1, reference="attn", cfg_lanes=do_cfg)
    with mock.patch.object(fa, "flash_attention_bsc_plain",
                           wraps=fa.flash_attention_bsc_plain) as k1, \
            mock.patch.object(fa, "flash_attention_onepass_plain",
                              wraps=fa.flash_attention_onepass_plain) as k2:
        pipeline.generate("a cat", models=_pick(models, 1, "standard"), config=cfg,
                          height=64, width=64, n_inference_steps=2, sampler_name="ddim",
                          do_cfg=do_cfg, control_image=np.zeros((64, 64, 3), np.uint8),
                          reference_image=np.zeros((64, 64, 3), np.uint8),
                          tokenizer=make_test_tokenizer(WORDS, max_len=16))
    # an evaluation: UNet 2 + 1 + 3 self-attentions, its capture pass as many,
    # the ControlNet 2 + 1; the read's K2 at all 6 layers
    assert want["K1"] == k1.call_count == 2 * ((6 if do_cfg else 0) + 6 + 3)
    assert want["K2"] == k2.call_count == 2 * 6
