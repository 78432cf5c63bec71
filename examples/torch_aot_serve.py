"""A serving loop on an exported program, on the PyTorch port
(``pytorch_stable_diffusion_tpu_torch.utils.aot``): the counterpart of
``examples/aot_serve.py``, the deployment pattern.

  1. OFFLINE (once per serving configuration): ``aot.export_pipeline``
     exports what a request runs on the device to an artifact (a JSON
     header and three ``torch.export`` programs; no weight in it).
  2. AT PROCESS START: load the artifact (no model code is traced) and
     the checkpoint onto the card, once.
  3. PER REQUEST (:func:`serve_request`): tokenize, one call of the loaded
     program, uint8 images out, written as PNGs.  The weights are a
     call-time argument, so one artifact serves any checkpoint of its
     family (fine-tunes, LoRA merges).

Request ``i`` takes seed ``i``, where the JAX script takes ``PRNGKey(i)``:
the port's artifact takes an int seed, the root of its named noise streams.
Everything runs on the CUDA card unless ``--device cpu`` is given, with the
hand-written kernels for the UNet's attention and res blocks and the VAE's
attention (their plain versions on the CPU).

Usage:
  # offline export
  python examples/torch_aot_serve.py --ckpt sd15.safetensors --vocab vocab.json \\
      --merges merges.txt --export artifact.sdt --steps 30

  # serve: one prompt per stdin line, PNGs written to --outdir
  python examples/torch_aot_serve.py --ckpt sd15.safetensors --vocab vocab.json \\
      --merges merges.txt --artifact artifact.sdt --outdir out/ < prompts.txt

  # self-test without weight files (the tiny config under MIXED: fp32
  # weights, bf16 compute): export, then two requests, each held bit for
  # bit to eager generate() with its seed
  python examples/torch_aot_serve.py --selftest [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def serve_request(served, models, tokenizer, prompt: str, seed: int,
                  cfg_scale: float = 7.5, uncond_prompt: str = "") -> np.ndarray:
    """One request: tokenize ``prompt`` and ``uncond_prompt``, one call of
    the loaded program ``served`` on ``models`` -> (1, H, W, 3) uint8
    images."""
    ids = np.asarray([tokenizer.encode(prompt)], np.int64)
    un = np.asarray([tokenizer.encode(uncond_prompt)], np.int64)
    images, _ = served(models, ids, un, seed, cfg_scale)
    return images


def kernel_config(make, policy):
    """The serving configuration: the UNet's attention and res blocks and
    the VAE's attention on the hand-written kernels."""
    return make(policy=policy, attention_backend="kernel", conv_backend="kernel",
                vae_attention_backend="kernel")


def selftest(args, device) -> int:
    import torch

    import pytorch_stable_diffusion_tpu_torch as sdt
    from pytorch_stable_diffusion_tpu_torch.utils import aot
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    cfg = kernel_config(sdt.tiny_sd_config, sdt.MIXED)
    models = sdt.build_models(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(0))
    tok = make_test_tokenizer(["a", "cat", "dog"], max_len=cfg.clip.max_len)
    blob = aot.export_pipeline(cfg, models, n_steps=2, batch=1, height=16, width=16,
                               sampler=args.sampler)
    served = aot.load_pipeline(blob)
    print(f"[selftest] artifact {len(blob) / 1e3:.0f} kB platforms={served.platforms}",
          flush=True)
    for i, prompt in enumerate(["a cat", "a dog"]):
        t0 = time.time()
        imgs = serve_request(served, models, tok, prompt, seed=i, cfg_scale=7.5)
        dt = time.time() - t0
        eager = sdt.generate(prompt, models=models, tokenizer=tok, config=cfg, seed=i,
                             cfg_scale=7.5, sampler_name=args.sampler, n_inference_steps=2,
                             height=16, width=16)
        same = bool(np.array_equal(imgs[0], eager))
        print(f"[selftest] request {i}: {imgs.shape} {imgs.dtype} {dt:.2f}s "
              f"bit-identical to eager generate(seed={i}): {same}", flush=True)
        if not same:
            return 1
    print("[selftest] ok", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt"), ap.add_argument("--vocab"), ap.add_argument("--merges")
    ap.add_argument("--artifact", help="serialized artifact to serve from")
    ap.add_argument("--export", help="write a fresh artifact here and exit")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--sampler", default="dpm++")
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--selftest", action="store_true",
                    help="tiny-config end-to-end check, no weight files")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_aot_serve.py: no CUDA device; pass --device cpu to run on the CPU")
    if args.selftest:
        return selftest(args, device)

    if not (args.ckpt and args.vocab and args.merges):
        ap.error("--ckpt/--vocab/--merges required (or --selftest)")
    from pytorch_stable_diffusion_tpu_torch import BF16, StableDiffusion, sd15_config
    from pytorch_stable_diffusion_tpu_torch.utils import aot

    cfg = kernel_config(sd15_config, BF16)
    t0 = time.time()
    sd = StableDiffusion.from_checkpoint(args.ckpt, args.vocab, args.merges, config=cfg,
                                         device=device)
    print(f"[serve] weights -> {device} in {time.time() - t0:.1f}s", flush=True)

    if args.export:
        blob = aot.export_pipeline(cfg, sd.models, n_steps=args.steps, batch=1,
                                   height=args.size, width=args.size, sampler=args.sampler)
        with open(args.export, "wb") as f:
            f.write(blob)
        print(f"[serve] exported {len(blob) / 1e6:.1f} MB -> {args.export}", flush=True)
        return 0

    if not args.artifact:
        ap.error("--artifact (or --export) required")
    t0 = time.time()
    with open(args.artifact, "rb") as f:
        served = aot.load_pipeline(f.read())
    print(f"[serve] artifact loaded in {time.time() - t0:.1f}s "
          f"(platforms={served.platforms}); reading prompts from stdin", flush=True)

    from PIL import Image

    for i, line in enumerate(sys.stdin):
        prompt = line.strip()
        if not prompt:
            continue
        t0 = time.time()
        imgs = serve_request(served, sd.models, sd.tokenizer, prompt, seed=i,
                             cfg_scale=args.cfg_scale)
        path = os.path.join(args.outdir, f"serve_{i:04d}.png")
        Image.fromarray(imgs[0]).save(path)
        print(f"[serve] {time.time() - t0:.2f}s {path!r} <- {prompt!r}", flush=True)
    return 0


if __name__ == "__main__":
    # the repository's root, where the package is, when run as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
