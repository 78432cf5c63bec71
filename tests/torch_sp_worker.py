"""The ranks of ``tests/test_torch_sequence_parallel.py``: a helper, not a
test file.

``torch.multiprocessing.spawn`` starts :func:`run` in fresh processes, one
a rank of a four-rank gloo process group on a loopback port, so that they
import neither JAX nor the test module.  Every rank builds the same tiny
models from a seed and runs every scenario under sequence parallelism, on
a (1, 4) mesh (the model axis splits the latent rows four ways) or a (2, 2)
one (DP x SP); rank 0 also runs each request on one process without a
mesh (the reference).  Every rank also runs the :data:`JAX_CASES` with
the tiny models the JAX package drew, which the test module saves in the
output directory (``jax_weights.pt``), on injected noise (:func:`jax_case_noise`),
for the test module to hold against the JAX package's own sequence
parallelism on the same inputs.  Spies record the rows each UNet and ControlNet
evaluation took and the attention kernels' plain versions called, and the
refusals are caught as messages.  Each rank saves what it got with
``torch.save``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from torch_dist_worker import MID, PROMPTS, _request

WORLD = 4
#: the requests held against the JAX package's ``generate(mesh=,
#: sequence_parallel=True)``: name -> (prompts, (data, model) mesh, height,
#: width); the second's deeper level leaves a rank empty
JAX_CASES = {"sp": (PROMPTS[:1], (1, 4), 32, 32),
             "sp uneven empty": (PROMPTS[:1], (1, 4), 24, 40),
             "dp x sp": (PROMPTS, (2, 2), 32, 32)}
JAX_STEPS = 3


def jax_case_noise(name):
    """The injected noise of a :data:`JAX_CASES` request, NHWC as the JAX
    package takes it (the tiny VAE's factor is 2)."""
    prompts, _, h, w = JAX_CASES[name]
    r = np.random.RandomState(11)
    shape = (len(prompts), h // 2, w // 2, 4)
    return {"latent_init": r.randn(*shape).astype(np.float32),
            "sampler_noise": r.randn(JAX_STEPS, *shape).astype(np.float32)}


def _nchw(noise):
    return {"latent_init": np.transpose(noise["latent_init"], (0, 3, 1, 2)),
            "sampler_noise": np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))}


def _jax_cases(cfg, state_dicts):
    """Each :data:`JAX_CASES` request under sequence parallelism, with the
    models built from ``state_dicts``: name -> the images."""
    from pytorch_stable_diffusion_tpu_torch import pipeline
    from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
    from pytorch_stable_diffusion_tpu_torch.models import build_models

    models = build_models(cfg, device="cpu", state_dicts=state_dicts)
    got = {}
    for name, (prompts, (data, model), h, w) in JAX_CASES.items():
        kw = _request(cfg, models, height=h, width=w, n_inference_steps=JAX_STEPS,
                      fixed_noise=_nchw(jax_case_noise(name)))
        got[name] = np.asarray(pipeline.generate_images(
            prompts, mesh=mesh_mod.make_mesh(data=data, model=model),
            sequence_parallel=True, **kw))
    return got


def _setup(kind):
    from pytorch_stable_diffusion_tpu_torch.models import build_models, config

    base = config.tiny_sd_config()
    if kind == "bf16":
        from pytorch_stable_diffusion_tpu_torch.core.dtypes import BF16

        cfg = config.tiny_sd_config(policy=BF16)
    elif kind == "sdxl":
        cfg = config.tiny_sdxl_config()
    elif kind == "mid":
        cfg = dataclasses.replace(base, unet=config.UNetConfig(**MID),
                                  clip=dataclasses.replace(base.clip, d_model=64, d_ff=128))
    elif kind in ("ip2p", "unet9"):  # InstructPix2Pix's 8 input channels, inpainting's 9
        cfg = dataclasses.replace(base, unet=dataclasses.replace(
            base.unet, in_channels=8 if kind == "ip2p" else 9))
    else:
        cfg = base
    return cfg, build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(5))


def _rows_spy(net, seen, name):
    """Record the rows of the latents each call of ``net`` takes."""
    return net.register_forward_pre_hook(
        lambda _m, args: seen.setdefault(name, []).append(int(args[0].shape[2])))


def _attention_spy(seen):
    """Wrap the attention paths ``ops/attention`` dispatches to: each call's
    (path, Sq, Sk).  -> a function that removes the wrappers."""
    from pytorch_stable_diffusion_tpu_torch.ops import attention

    names = ("flash_attention_bsc", "flash_attention_onepass", "materialized_attention")
    real = {n: getattr(attention, n) for n in names}

    def wrap(n):
        def spy(q, k, *args, **kw):
            seen.append((n, q.shape[-2 if n != "flash_attention_bsc" else 1],
                         k.shape[-2 if n != "flash_attention_bsc" else 1]))
            return real[n](q, k, *args, **kw)
        return spy
    for n in names:
        setattr(attention, n, wrap(n))

    def undo():
        for n in names:
            setattr(attention, n, real[n])
    return undo


def _refusals(rank_mesh, dp_mesh, cfg, models):
    """The ValueError of each request the JAX package refuses under
    sequence parallelism, as a message."""
    from pytorch_stable_diffusion_tpu_torch import pipeline
    from pytorch_stable_diffusion_tpu_torch.models import config

    kw = _request(cfg, dict(models, motion=None), sequence_parallel=True)
    cases = {"model axis 1": dict(mesh=dp_mesh),
             "height": dict(mesh=rank_mesh, height=20),
             "tome": dict(mesh=rank_mesh, tome_ratio=0.5),
             "hypertile": dict(mesh=rank_mesh, config=config.with_hypertile(cfg, 8)),
             "n_frames": dict(mesh=rank_mesh, n_frames=4),
             "panorama": dict(mesh=rank_mesh, panorama=True, width=64)}
    got = {}
    try:  # the port's own: a UNet split by tensor parallelism
        from pytorch_stable_diffusion_tpu_torch.parallel import tp

        pipeline.generate_images(["a cat"], **dict(
            kw, mesh=rank_mesh, models=tp.shard_models(models, rank_mesh)))
        got["tp models"] = None
    except ValueError as err:
        got["tp models"] = str(err)
    for name, extra in cases.items():
        prompts = ["a cat"] * (WORLD if extra["mesh"] is dp_mesh else 1)
        try:
            pipeline.generate_images(prompts, **dict(kw, **extra))
            got[name] = None
        except ValueError as err:
            got[name] = str(err)
    return got


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        from pytorch_stable_diffusion_tpu_torch import pipeline
        from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
        from pytorch_stable_diffusion_tpu_torch.models import clip_vision, controlnet, t2i_adapter
        from pytorch_stable_diffusion_tpu_torch.parallel import sp
        from pytorch_stable_diffusion_tpu_torch.weights import ip_adapter

        sp_mesh = mesh_mod.make_mesh(data=1, model=world)
        dpsp_mesh = mesh_mod.make_mesh(data=2, model=2)
        dp_mesh = mesh_mod.make_mesh()
        out = {"rows": {}, "spy": {}}

        def pair(name, kw, prompts=PROMPTS[:1], mesh=sp_mesh):
            """The request under sequence parallelism on every rank, and on
            one process on rank 0; the spies watch the first."""
            seen, calls = {}, []
            hooks = [_rows_spy(kw["models"]["diffusion"], seen, "unet")]
            if "controlnet" in kw["models"]:
                hooks.append(_rows_spy(kw["models"]["controlnet"], seen, "controlnet"))
            undo = _attention_spy(calls)
            try:
                if len(prompts) == 1:
                    got = sp.generate_spatial(prompts[0], mesh=mesh, **kw)[None]
                else:
                    got = pipeline.generate_images(prompts, mesh=mesh, sequence_parallel=True,
                                                   **kw)
            finally:
                undo()
                for h in hooks:
                    h.remove()
            out["rows"][name], out["spy"][name] = seen, calls
            want = pipeline.generate_images(prompts, **kw) if rank == 0 else None
            out[name] = (np.asarray(got), want)

        cfg, models = _setup("sd")
        kw = _request(cfg, models)
        pair("sp", kw)
        image = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
        pair("sp img2img", dict(kw, input_image=image, strength=0.7))
        pair("sp kernel", dict(kw, config=dataclasses.replace(cfg, attention_backend="kernel")))
        # latent 20 rows: 5 a rank, the deeper level's 10 in blocks of 3, 3, 3, 1
        pair("sp uneven", dict(kw, height=40))
        # latent 12 rows: 3 a rank, the deeper level's 6 in blocks of 2, 2, 2, 0
        pair("sp uneven empty", dict(kw, height=24, width=40))
        pair("dp x sp", kw, prompts=PROMPTS, mesh=dpsp_mesh)
        net = controlnet.build(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
        pair("sp controlnet", dict(kw, models=dict(models, controlnet=net), control_image=image,
                                   controlnet_scale=0.8))
        pair("sp pag sag", dict(kw, pag_scale=2.0, sag_scale=0.75))
        pair("sp freeu", dict(kw, freeu=True))
        pair("sp tiling", dict(kw, tiling=True))
        pair("sp reference", dict(kw, reference_image=image, reference_mode="attn+adain"))
        pair("sp deepcache", dict(kw, deepcache=2, n_inference_steps=4))
        adapter = t2i_adapter.build(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
        pair("sp t2i adapter", dict(kw, models=dict(models, t2i_adapter=adapter),
                                    adapter_image=image))
        vis = clip_vision.tiny_vision_config()
        ip_models = dict(models, clip_vision=clip_vision.build_clip_vision(
            vis, device="cpu", generator=torch.Generator().manual_seed(8)),
            ip_adapter=clip_vision.build_ip_adapter(ip_adapter.convert_ip_adapter(
                ip_adapter.synthetic_ip_state(cfg.unet, embed_dim=vis.proj_dim, seed=9),
                cfg.unet), device="cpu"))
        pair("sp ip adapter", dict(kw, models=ip_models, ip_adapter_image=image[:16, :16]))
        mask = np.zeros((32, 32), np.uint8)
        mask[:, 16:] = 255
        pair("sp inpaint blend", dict(kw, input_image=image, mask_image=mask, strength=0.9))
        pair("sp and regions", dict(kw, region_masks=[mask, 255 - mask]),
             prompts=["a cat AND a dog:0.8"])
        pair("sp dpm_adaptive", dict(kw, sampler_name="dpm_adaptive"))
        pair("sp long prompt", dict(kw, sampler_name="euler_a", emphasis=True),
             prompts=["a (cat:1.2) BREAK a dog"])
        out["refusals"] = _refusals(sp_mesh, dp_mesh, cfg, models)
        out["jax"] = _jax_cases(cfg, torch.load(os.path.join(out_dir, "jax_weights.pt"),
                                                weights_only=False))

        # bf16 crosses gloo as bytes
        cfg, models = _setup("bf16")
        pair("sp bf16", _request(cfg, models))
        cfg, models = _setup("ip2p")
        pair("sp ip2p", _request(cfg, models, edit_image=image))
        cfg, models = _setup("unet9")
        pair("sp inpaint unet9", _request(cfg, models, input_image=image, mask_image=mask,
                                          strength=1.0))
        cfg, models = _setup("sdxl")
        pair("sp sdxl", _request(cfg, models))
        cfg, models = _setup("mid")
        for tier in ("w8", "wide", "conv"):
            pair(f"sp {tier} 160", _request(dataclasses.replace(cfg, quant=tier), models))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
