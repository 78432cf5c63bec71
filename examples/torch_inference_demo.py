"""The reference demo notebook as a script, on the PyTorch port
(``pytorch_stable_diffusion_tpu_torch``): the counterpart of
``examples/inference_demo.py``, through the port's top-level
``load_models``, ``CLIPTokenizer`` and ``generate``.

Files (not in the repository):
  * SD-1.5 weights: v1-5-pruned-emaonly.ckpt (or .safetensors) from
    huggingface.co/stable-diffusion-v1-5/stable-diffusion-v1-5
  * tokenizer files: vocab.json + merges.txt from the same repository's
    ``tokenizer/`` directory

Runs on the CUDA card unless ``--device cpu`` is given, with the
hand-written kernels for the UNet's attention and res blocks and the VAE's
attention (on the CPU their plain versions run).  ``--config-preset tiny``
takes the scaled-down test topology, for a checkpoint of that shape.

Usage:
  python examples/torch_inference_demo.py --ckpt v1-5-pruned-emaonly.safetensors \\
      --vocab data/vocab.json --merges data/merges.txt \\
      [--image images/dog.jpg --strength 0.9] [--out output.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--merges", required=True)
    ap.add_argument("--prompt", default=(
        "A highly detailed photograph of a golden retriever playing in a "
        "sunlit meadow"))
    ap.add_argument("--uncond-prompt", default="")
    ap.add_argument("--image", default=None, help="init image for img2img")
    ap.add_argument("--strength", type=float, default=0.9)
    ap.add_argument("--cfg-scale", type=float, default=5.0)   # notebook cell 3
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", default="ddpm",
                    help="ddpm|ddim|dpm++|euler|euler_a|heun|unipc")
    ap.add_argument("--seed", type=int, default=1337)          # notebook cell 5
    ap.add_argument("--out", default="output.png")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config-preset", default="sd15", choices=["sd15", "tiny"])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    import pytorch_stable_diffusion_tpu_torch as sdt
    from pytorch_stable_diffusion_tpu_torch.__main__ import save_image

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_inference_demo.py: no CUDA device; pass --device cpu to run on the CPU")
    print(f"Using device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    policy = sdt.BF16 if args.bf16 else sdt.FP32
    make = {"sd15": sdt.sd15_config, "tiny": sdt.tiny_sd_config}[args.config_preset]
    cfg = make(policy=policy, attention_backend="kernel", conv_backend="kernel",
               vae_attention_backend="kernel")

    tokenizer = sdt.CLIPTokenizer.from_files(args.vocab, args.merges, max_len=cfg.clip.max_len)
    t0 = time.time()
    models = sdt.load_models(args.ckpt, cfg, device=device)
    print(f"Loaded checkpoint in {time.time() - t0:.1f}s")

    input_image = None
    if args.image:
        from PIL import Image

        input_image = Image.open(args.image)

    t0 = time.time()
    image = sdt.generate(
        prompt=args.prompt,
        uncond_prompt=args.uncond_prompt,
        input_image=input_image,
        strength=args.strength,
        do_cfg=True,
        cfg_scale=args.cfg_scale,
        sampler_name=args.sampler,
        n_inference_steps=args.steps,
        models=models,
        seed=args.seed,
        tokenizer=tokenizer,
        config=cfg,
        height=args.height,
        width=args.width,
    )
    print(f"Generated in {time.time() - t0:.1f}s (includes the kernels' build on first run)")

    save_image(image, args)
    print(f"Saved {args.out}")
    return 0


if __name__ == "__main__":
    # the repository's root, where the package is, when run as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
