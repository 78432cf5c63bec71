"""The ranks of ``tests/test_torch_parallel.py``: a helper, not a test file.

``torch.multiprocessing.spawn`` starts :func:`run` in fresh processes, one
a rank of a gloo process group on a loopback port, so that they import
neither JAX nor the test module.  Every rank builds the same tiny models
from a seed and runs every scenario: the data-parallel and the
tensor-parallel requests, and the same request on one process without a
mesh (the reference); each rank saves what it got with ``torch.save``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

PROMPTS = ["a photo of a cat", "a dog"]
WORDS = ["a", "cat", "dog", "photo", "of"]
#: the JAX package's width-160 UNet (3x3 K = 1440: the "conv" tier takes
#: every 3x3 conv; the bottleneck's GeGLU down-projection has K = 1280)
MID = dict(model_channels=160, ch_mults=(1, 2), attn_levels=(True, False), n_heads=4,
           d_context=64, groups=16)


def _setup(kind):
    from pytorch_stable_diffusion_tpu_torch.models import build_models, config

    if kind == "sdxl":
        cfg = config.tiny_sdxl_config()
    elif kind == "ip2p":
        base = config.tiny_sd_config()
        cfg = dataclasses.replace(base, unet=dataclasses.replace(base.unet, in_channels=8))
    elif kind == "mid":
        base = config.tiny_sd_config()
        cfg = dataclasses.replace(base, unet=config.UNetConfig(**MID),
                                  clip=dataclasses.replace(base.clip, d_model=64, d_ff=128),
                                  quant="conv")
    else:
        cfg = config.tiny_sd_config()
    models = build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    return cfg, models


def _request(cfg, models, **kw):
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    out = dict(models=models, config=cfg, seed=3, n_inference_steps=3, sampler_name="ddim",
               height=32, width=32, device="cpu",
               tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len))
    out.update(kw)
    return out


def _errors(mesh_mod, mesh):
    """The ValueErrors of make_mesh and local_batch, as messages."""
    got = []
    for call in (lambda: mesh_mod.make_mesh(data=3), lambda: mesh_mod.make_mesh(model=3),
                 lambda: mesh_mod.local_batch(3, mesh)):
        try:
            call()
            got.append(None)
        except ValueError as err:
            got.append(str(err))
    return got


def _stream_slices(tmp, rank, mesh):
    """Streamed TP load of a saved tiny checkpoint: this rank's tensors, and
    whether each equals its ``parallel/tp`` slice of the eager load."""
    from pytorch_stable_diffusion_tpu_torch.models import state_dicts
    from pytorch_stable_diffusion_tpu_torch.parallel import tp
    from pytorch_stable_diffusion_tpu_torch.weights import convert, save, stream

    cfg, models = _setup("sd")
    path = os.path.join(tmp, f"tiny_{rank}.safetensors")
    save.save_safetensors(state_dicts(models), cfg, path)
    eager = convert.load_sd_checkpoint(path, cfg)
    got = stream.load_sd_checkpoint_streamed(path, cfg, device="cpu", mesh=mesh, tp=True)
    report = {"sliced": 0, "whole": 0, "equal": True}
    cfgs = {"diffusion": cfg.unet, "clip": cfg.clip}
    for name, sd in eager.items():
        for key, full in sd.items():
            spec = tp.model_spec(name, cfgs[name], key, full.shape, 2) \
                if name in cfgs else None
            want = full if spec is None else tp.take(spec, full, rank, 2)
            report["sliced" if spec else "whole"] += 1
            report["equal"] &= torch.equal(got[name][key], want)
    sharded = tp.assemble(cfg, got, mesh)
    report["assembled"] = sharded["diffusion"].bottleneck.attn.self_attn.q.weight.shape[0]
    return report


def _row_parallel_int8(mesh):
    """w8a8 and w8 of a row-parallel linear (K split over the model group)
    against the whole product on one process: (int8 max |diff|, w8 max
    |diff|, w8 max |output|)."""
    from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
    from pytorch_stable_diffusion_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(7)
    x, w, b = torch.randn(2, 9, 1280, generator=g), torch.randn(40, 1280, generator=g), \
        torch.randn(40, generator=g)
    group, r = mesh_mod.axis_group(mesh, "model"), mesh_mod.axis_rank(mesh, "model")
    xs, ws = x.chunk(2, -1)[r], w.chunk(2, -1)[r]
    full = quant.int8_linear(x, w, b)
    split = quant.int8_linear(xs, ws, b, k_group=group)
    w8_full = quant.w8_linear(x, w, b, torch.float32)
    w8_split = quant.w8_linear(xs, ws, b, torch.float32, k_group=group)
    return [float((full - split).abs().max()), float((w8_full - w8_split).abs().max()),
            float(w8_full.abs().max())]


def _int8_sites(fn):
    """``fn()`` with a spy on ``quant.int8_linear``: its result and, for
    each call, the weight's (out, whole K, whether K is split over a model
    group) -- the w8a8 linears the request ran."""
    from pytorch_stable_diffusion_tpu_torch.ops import quant

    real, seen = quant.int8_linear, []

    def spy(x, weight, bias=None, *, k_group=None):
        n = 1 if k_group is None else dist.get_world_size(k_group)
        seen.append((weight.shape[0], weight.shape[1] * n, k_group is not None))
        return real(x, weight, bias, k_group=k_group)
    quant.int8_linear = spy
    try:
        return np.asarray(fn()), seen
    finally:
        quant.int8_linear = real


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        from pytorch_stable_diffusion_tpu_torch import api, pipeline
        from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
        from pytorch_stable_diffusion_tpu_torch.models import clip_vision, controlnet
        from pytorch_stable_diffusion_tpu_torch.parallel import dp, tp
        from pytorch_stable_diffusion_tpu_torch.weights import ip_adapter

        dp_mesh = mesh_mod.make_mesh()
        tp_mesh = mesh_mod.make_mesh(data=1, model=2)
        out = {"errors": _errors(mesh_mod, dp_mesh),
               "axes": [mesh_mod.axis_size(dp_mesh, "data"), mesh_mod.axis_size(tp_mesh, "model"),
                        mesh_mod.axis_rank(tp_mesh, "model")]}

        def pair(name, mesh_run, want):
            """``want``: the images on one process, or the call that makes them."""
            out[name] = (np.asarray(mesh_run()), np.asarray(want() if callable(want) else want))

        cfg, models = _setup("sd")
        kw = _request(cfg, models)
        ref = lambda **extra: pipeline.generate_images(PROMPTS, **dict(kw, **extra))  # noqa: E731
        one = ref()  # the reference of the plain request's four scenarios
        pair("dp", lambda: dp.generate_images_dp(PROMPTS, mesh=dp_mesh, **kw), one)
        hint = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
        net = controlnet.build(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
        ckw = dict(kw, models=dict(models, controlnet=net), control_image=hint,
                   controlnet_scale=0.8)
        pair("dp controlnet", lambda: dp.generate_images_dp(PROMPTS, mesh=dp_mesh, **ckw),
             lambda: pipeline.generate_images(PROMPTS, **ckw))
        # a data rank decides long prompts and the window count from the
        # whole batch: sample 1 alone has one window and no BREAK
        long = ["a (cat:1.3) BREAK a dog", "a dog"]
        lkw = dict(kw, emphasis=True)
        pair("dp long mixed", lambda: dp.generate_images_dp(long, mesh=dp_mesh, **lkw),
             lambda: pipeline.generate_images(long, **lkw))
        # one IP-Adapter image a prompt, split over the data ranks
        vis = clip_vision.tiny_vision_config()
        ip_models = dict(models, clip_vision=clip_vision.build_clip_vision(
            vis, device="cpu", generator=torch.Generator().manual_seed(8)),
            ip_adapter=clip_vision.build_ip_adapter(ip_adapter.convert_ip_adapter(
                ip_adapter.synthetic_ip_state(cfg.unet, embed_dim=vis.proj_dim, seed=9),
                cfg.unet), device="cpu"))
        ikw = dict(kw, models=ip_models, ip_adapter_scale=0.7,
                   ip_adapter_image=np.random.RandomState(2).randint(
                       0, 256, (2, 16, 16, 3)).astype(np.uint8))
        pair("dp ip a prompt", lambda: dp.generate_images_dp(PROMPTS, mesh=dp_mesh, **ikw),
             lambda: pipeline.generate_images(PROMPTS, **ikw))
        pair("tp sd", lambda: tp.generate_images_tp(PROMPTS, mesh=tp_mesh, **kw), one)
        gkw = dict(pag_scale=2.0, sag_scale=0.75)
        pair("tp pag sag", lambda: tp.generate_images_tp(PROMPTS, mesh=tp_mesh, **kw, **gkw),
             lambda: ref(**gkw))
        tok = kw["tokenizer"]
        sd_dp = api.StableDiffusion(models, tok, cfg, mesh=dp_mesh, device="cpu")
        sd_tp = api.StableDiffusion(models, tok, cfg, mesh=tp_mesh, device="cpu")
        akw = dict(seed=3, n_inference_steps=3, sampler_name="ddim", height=32, width=32)
        pair("api dp", lambda: sd_dp.generate_batch(PROMPTS, **akw), one)
        pair("api tp", lambda: sd_tp.generate_batch(PROMPTS, **akw), one)
        out["api tp sharded"] = sd_tp._placed["diffusion"].bottleneck.attn.self_attn.q \
            .weight.shape[0]

        cfg, models = _setup("ip2p")
        kw = _request(cfg, models)
        # one edit image for each prompt, split over the data ranks
        edits = np.random.RandomState(1).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        pair("dp ip2p", lambda: dp.generate_images_dp(PROMPTS, mesh=dp_mesh, edit_image=edits,
                                                      **kw),
             lambda: pipeline.generate_images(PROMPTS, edit_image=edits, **kw))

        cfg, models = _setup("sdxl")
        kw = _request(cfg, models)
        pair("tp sdxl", lambda: tp.generate_images_tp(PROMPTS, mesh=tp_mesh, **kw),
             lambda: pipeline.generate_images(PROMPTS, **kw))

        cfg, models = _setup("mid")
        kw = _request(cfg, models)
        # prompts whose rank-local activation absmax differs from the whole batch's
        mid_prompts = ["a cat", "a photo of a dog of a cat"]
        for tier in ("conv", "wide"):
            # "wide" at width 160 takes w8a8 at the bottleneck's GeGLU
            # down-projection alone (K = 1280), a row-parallel layer under TP
            tkw = dict(kw, config=dataclasses.replace(cfg, quant=tier))
            want, one_sites = _int8_sites(lambda: pipeline.generate_images(mid_prompts, **tkw))
            if tier == "conv":
                pair("dp conv 160",
                     lambda: dp.generate_images_dp(mid_prompts, mesh=dp_mesh, **tkw), want)
            got, tp_sites = _int8_sites(
                lambda: tp.generate_images_tp(mid_prompts, mesh=tp_mesh, **tkw))
            out[f"tp {tier} 160"] = (got, want)
            out[f"tp {tier} 160 int8 sites"] = (tp_sites, one_sites)
        kw = dict(kw, config=dataclasses.replace(cfg, quant="w8"))
        pair("tp w8 160", lambda: tp.generate_images_tp(mid_prompts, mesh=tp_mesh, **kw),
             lambda: pipeline.generate_images(mid_prompts, **kw))
        kw = dict(kw, config=dataclasses.replace(cfg, quant="none"))
        pair("tp none 160", lambda: tp.generate_images_tp(mid_prompts, mesh=tp_mesh, **kw),
             lambda: pipeline.generate_images(mid_prompts, **kw))
        out["tp int8 row"] = _row_parallel_int8(tp_mesh)
        out["stream"] = _stream_slices(out_dir, mesh_mod.axis_rank(tp_mesh, "model"), tp_mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_cards(rank: int, world: int, port: int, out_dir: str, device_type: str = "cuda") -> None:
    """One rank of ``tests/test_torch_cuda.py::test_dp_and_tp_over_nccl``:
    SD-1.5 at full width (BF16, kernel attention) on one card a rank over
    NCCL, the same seeded models on every card; a 4-prompt, 8-step
    dpm++ Karras request on the rank's card alone (the reference), each of
    its samples alone at its index in the batch, the request over a
    data-parallel mesh of every rank and over a (world / 2, 2) DP x TP
    mesh, and under sequence parallelism over a (1, world) mesh and a
    (world / 2, 2) DP x SP one; then one prompt on one card, over two cards
    (a DP x SP group of two, two prompts: a group a prompt) and over every
    card, at 512² (8 steps) and at 2048² (2 steps).  ``device_type="cpu"`` runs the same code on gloo with the tiny
    config (a rehearsal).  Saves the images, the host times (the second of
    two calls each) and the K1 and K2 launches of the TP and SP
    requests."""
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        import time

        import pytorch_stable_diffusion_tpu_torch as sdt
        from pytorch_stable_diffusion_tpu_torch import pipeline
        from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
        from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa
        from pytorch_stable_diffusion_tpu_torch.parallel import dp, sp, tp
        from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

        dev = f"cuda:{rank}" if cuda else "cpu"
        cfg = sdt.sd15_config(policy=sdt.BF16, attention_backend="kernel") if cuda \
            else sdt.tiny_sd_config()
        size = 512 if cuda else 32
        models = sdt.build_models(cfg, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(0))
        prompts = ["a photograph of an astronaut riding a horse", "a dog", "a photo of a cat",
                   "a painting of a fox"]
        words = sorted({w for p in prompts for w in p.split()})
        kw = dict(models=models, config=cfg, seed=1337, n_inference_steps=8,
                  sampler_name="dpm++", timestep_spacing="karras", height=size, width=size,
                  device=dev, tokenizer=make_test_tokenizer(words, max_len=cfg.clip.max_len))
        dp_mesh = mesh_mod.make_mesh()
        tp_mesh = mesh_mod.make_mesh(data=world // 2, model=2)

        def twice(fn):
            fn()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            return np.asarray(out), time.perf_counter() - t0

        out = {"world": world}
        out["one"], out["t_one"] = twice(lambda: sdt.generate_images(prompts, **kw))
        # each sample alone on this card, at its index in the batch: what a
        # data rank of batch one computes
        out["each"] = np.concatenate([
            pipeline._generate_local(prompts[i:i + 1], _sample_offset=i, **kw)[0]
            for i in range(len(prompts))])
        out["dp"], out["t_dp"] = twice(lambda: dp.generate_images_dp(prompts, mesh=dp_mesh,
                                                                     **kw))
        before = fa.flash_attention_bsc.launches
        out["tp"], out["t_tp"] = twice(lambda: tp.generate_images_tp(prompts, mesh=tp_mesh,
                                                                     **kw))
        out["k1_tp"] = (fa.flash_attention_bsc.launches - before) // 2
        sp_mesh = mesh_mod.make_mesh(data=1, model=world)
        dpsp_mesh = mesh_mod.make_mesh(data=world // 2, model=2)
        before = (fa.flash_attention_bsc.launches, fa.flash_attention_onepass.launches)
        out["sp"], out["t_sp"] = twice(lambda: pipeline.generate_images(
            prompts, mesh=sp_mesh, sequence_parallel=True, **kw))
        out["k1_sp"], out["k2_sp"] = ((fa.flash_attention_bsc.launches - before[0]) // 2,
                                      (fa.flash_attention_onepass.launches - before[1]) // 2)
        out["dpsp"], out["t_dpsp"] = twice(lambda: pipeline.generate_images(
            prompts, mesh=dpsp_mesh, sequence_parallel=True, **kw))
        # one prompt: on one card, over two (each DP x SP group of two takes
        # a prompt) and over every card
        out["t_b1"] = {1: twice(lambda: sdt.generate(prompts[0], **kw))[1]}
        if world > 2:
            out["t_b1"][2] = twice(lambda: pipeline.generate_images(
                prompts[:world // 2], mesh=dpsp_mesh, sequence_parallel=True, **kw))[1]
        out["t_b1"][world] = twice(lambda: sp.generate_spatial(prompts[0], mesh=sp_mesh,
                                                               **kw))[1]
        # the same at 4x the side, 2 steps: a device-bound evaluation
        big = dict(kw, height=4 * size, width=4 * size, n_inference_steps=2)
        out["t_b1_big"] = {1: twice(lambda: sdt.generate(prompts[0], **big))[1]}
        if world > 2:
            out["t_b1_big"][2] = twice(lambda: pipeline.generate_images(
                prompts[:world // 2], mesh=dpsp_mesh, sequence_parallel=True, **big))[1]
        out["t_b1_big"][world] = twice(lambda: sp.generate_spatial(prompts[0], mesh=sp_mesh,
                                                                   **big))[1]
        torch.save(out, os.path.join(out_dir, f"cards{rank}.pt"))
    finally:
        dist.destroy_process_group()
