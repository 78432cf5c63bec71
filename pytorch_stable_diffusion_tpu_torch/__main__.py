"""Command-line entry point: ``python -m pytorch_stable_diffusion_tpu_torch``
(port of the JAX package's ``__main__.py``).

Loads a checkpoint and the CLIP tokenizer's files, runs txt2img, img2img,
inpainting, InstructPix2Pix, the hires fix or an AnimateDiff clip with
the ``with_*`` attachments the flags name, and writes the image with the
A1111 "parameters" infotext in its PNG:

    python -m pytorch_stable_diffusion_tpu_torch \
        --ckpt v1-5-pruned-emaonly.safetensors \
        --vocab vocab.json --merges merges.txt \
        --prompt "a photograph of a dog" --seed 1337 --bf16 --out dog.png

    # img2img
    ... --image dog.jpg --strength 0.9

Every flag and default of the JAX package's parser, with three
differences: ``--backend`` takes the port's attention backends ("plain",
"kernel"; default "kernel"), ``--device`` (default "cuda") names the
device (``cpu`` runs the plain versions of the kernels), and there is no
compilation cache (TPU-only).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_stable_diffusion_tpu_torch",
        description="Stable Diffusion txt2img / img2img in PyTorch on the card")
    p.add_argument("--ckpt", required=True,
                   help=".ckpt / .safetensors checkpoint, or a diffusers dir")
    p.add_argument("--vocab", required=True, help="CLIP vocab.json")
    p.add_argument("--merges", required=True, help="CLIP merges.txt")
    p.add_argument("--prompt", required=True)
    p.add_argument("--uncond-prompt", default="")
    p.add_argument("--image", default=None,
                   help="init image file for img2img")
    p.add_argument("--edit-image", default=None,
                   help="InstructPix2Pix edit image (needs an 8-channel "
                        "ip2p checkpoint, --config-preset sd15_ip2p); the "
                        "prompt is the edit instruction")
    p.add_argument("--image-guidance", type=float, default=1.5,
                   help="InstructPix2Pix image guidance scale s_I "
                        "(faithfulness to the edit image)")
    p.add_argument("--inpaint-full-res", action="store_true",
                   help="A1111 'inpaint at full resolution': crop the mask "
                        "region, inpaint at full processing res, paste back")
    p.add_argument("--inpaint-full-res-padding", type=int, default=32)
    p.add_argument("--mask", default=None,
                   help="inpainting mask image (white = repaint); with a "
                        "9-channel inpaint checkpoint it conditions the "
                        "UNet, else latent-blend masking is used")
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--color-correction", action="store_true",
                   help="img2img: histogram-match the output to the init "
                        "image (A1111 'apply color correction')")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--variation-seed", type=int, default=None,
                   help="A1111 subseed: slerp this seed's init noise into "
                        "--seed's at --variation-strength")
    p.add_argument("--variation-strength", type=float, default=0.0)
    p.add_argument("--cfg-scale", type=float, default=7.5)
    p.add_argument("--no-cfg", action="store_true")
    p.add_argument("--pag-scale", type=float, default=0.0,
                   help="Perturbed-Attention Guidance scale (0 = off); one "
                        "extra cond-lane UNet eval per step")
    p.add_argument("--sag-scale", type=float, default=0.0,
                   help="Self-Attention Guidance scale (0 = off); blurs "
                        "attention-salient regions and adds one extra UNet "
                        "eval per step")
    p.add_argument("--guidance-rescale", type=float, default=0.0,
                   help="CFG std-rescale factor (0.7 recommended for "
                        "SD-2.1-v checkpoints; 0 = off)")
    p.add_argument("--sampler", default="ddpm")
    p.add_argument("--spacing", default="uniform",
                   choices=["uniform", "karras", "exponential", "trailing",
                            "sgm_uniform", "kl_optimal", "ays", "beta"],
                   help="timestep grid: uniform (reference parity), the "
                        "Karras sigma schedule (denser low-sigma steps — "
                        "the community 'Karras' sampler variants), "
                        "trailing (grid ends at the terminal timestep — "
                        "zero-SNR recipe, SDXL-Turbo), sgm_uniform / "
                        "kl_optimal / ays (Align Your Steps, per-family "
                        "table) / beta — the A1111 1.9/1.10 scheduler "
                        "dropdown")
    p.add_argument("--zero-snr", action="store_true",
                   help="rescale betas to zero terminal SNR (v-prediction "
                        "checkpoints fine-tuned with the Lin et al. 2024 "
                        "recipe; combine with --spacing trailing and "
                        "--guidance-rescale 0.7)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--encode-tile", type=int, default=None,
                   help="tiled VAE encode for hi-res img2img/inpaint "
                        "(latent px per tile)")
    p.add_argument("--decode-tile", type=int, default=None,
                   help="tiled VAE decode (hi-res memory bound)")
    p.add_argument("--embedding", action="append", default=[],
                   metavar="PATH[:TOKEN]",
                   help="textual-inversion embedding (.pt/.safetensors); "
                        "repeatable; optional :token overrides the trigger")
    p.add_argument("--controlnet", action="append", default=[],
                   help="ControlNet checkpoint (control_model.* layout or "
                        "diffusers dir); repeatable for multi-ControlNet "
                        "(residuals sum; pair each with a --control-image)")
    p.add_argument("--control-image", action="append", default=[],
                   help="conditioning image for --controlnet; repeatable")
    p.add_argument("--control-preprocess", default=None,
                   choices=["canny", "lineart", "scribble", "blur",
                            "invert"],
                   help="derive the ControlNet hint from --control-image "
                        "with a built-in annotator (utils/annotators.py)")
    p.add_argument("--controlnet-scale", type=float, action="append",
                   default=[], help="per-net scale (default 1.0); repeatable")
    p.add_argument("--t2i-adapter", action="append", default=[],
                   help="T2I-Adapter weights (diffusers T2IAdapter dir or "
                        "file); repeatable for multi-adapter (features sum; "
                        "pair each with an --adapter-image)")
    p.add_argument("--adapter-image", action="append", default=[],
                   help="conditioning image for --t2i-adapter; repeatable")
    p.add_argument("--adapter-scale", type=float, action="append",
                   default=[],
                   help="per-adapter scale (default 1.0); repeatable")
    p.add_argument("--ip-adapter", default=None, metavar="PATH",
                   help="IP-Adapter weights (.bin/.safetensors, h94 "
                        "layout); image prompting via --ip-adapter-image")
    p.add_argument("--ip-image-encoder", default=None, metavar="PATH",
                   help="CLIP vision encoder weights for --ip-adapter "
                        "(HF CLIPVisionModelWithProjection layout)")
    p.add_argument("--ip-adapter-image", default=None, metavar="PATH",
                   help="the image prompt for --ip-adapter")
    p.add_argument("--ip-adapter-scale", type=float, default=1.0)
    p.add_argument("--ip-vision", default="vit_h14",
                   choices=["vit_h14", "vit_bigg14", "vit_l14"],
                   help="image-encoder architecture (vit_h14 = SD-1.x "
                        "adapters, vit_bigg14 = SDXL adapters)")
    p.add_argument("--clip-skip", type=int, default=None,
                   help="A1111 CLIP-skip: 1 = family default; each "
                        "increment conditions one text-encoder layer "
                        "earlier (2 = penultimate on SD-1.x)")
    p.add_argument("--region-mask", action="append", default=[],
                   metavar="PATH",
                   help="regional prompting (Latent Couple): one mask per "
                        "AND segment of the prompt; each sub-prompt "
                        "steers only inside its mask")
    p.add_argument("--panorama", action="store_true",
                   help="MultiDiffusion: denoise a canvas larger than the "
                        "model's native size by averaging overlapping "
                        "window predictions per step (e.g. --width 2048)")
    p.add_argument("--panorama-window", type=int, default=512,
                   help="window size in pixels (the model's native size)")
    p.add_argument("--panorama-stride", type=int, default=None,
                   help="window stride in pixels (default window/2)")
    p.add_argument("--reference-image", default=None, metavar="PATH",
                   help="reference-only guidance (the A1111 ControlNet "
                        "'reference' preprocessor, no weights needed): "
                        "self-attention attends over this image's "
                        "features")
    p.add_argument("--reference-mode", default="attn",
                   choices=["attn", "adain", "adain+attn"],
                   help="which reference statistics steer the sample: "
                        "self-attention banking (reference_attn), feature "
                        "mean/var AdaIN (reference_adain), or both")
    p.add_argument("--reference-fidelity", type=float, default=0.5,
                   help="style fidelity (0 = reference everywhere, 1 = "
                        "uncond lane stays plain; A1111 default 0.5)")
    p.add_argument("--tome-ratio", type=float, default=None,
                   help="ToMe token merging ratio (A1111 'Token merging "
                        "ratio'; ~0.5 typical — approximate speedup, "
                        "merges redundant self-attention tokens)")
    p.add_argument("--deepcache", type=int, default=None, metavar="N",
                   help="DeepCache interval: full UNet every N-th step, "
                        "shallow cached steps between (opt-in speed/quality "
                        "trade; 1 = exact)")
    p.add_argument("--fast", action="store_true",
                   help="apply the measured fast preset (models/config."
                        "fast_preset): hypertile 32 + DeepCache 3 (an "
                        "approximate mode; PERF.md has its time on the "
                        "card).  Explicit --deepcache wins")
    p.add_argument("--freeu", nargs="*", type=float, default=None,
                   metavar="B1 B2 S1 S2",
                   help="FreeU decoder re-weighting: bare --freeu uses the "
                        "published family defaults, or pass b1 b2 s1 s2")
    p.add_argument("--emphasis", action="store_true",
                   help="parse A1111 emphasis syntax in prompts: (word:1.3) "
                        "up-weights, [word] down-weights, \\( escapes")
    p.add_argument("--hires-fix", action="store_true",
                   help="two-pass hires fix: base pass at half size, "
                        "bilinear latent upscale, second denoise at the "
                        "target size (strength from --strength)")
    p.add_argument("--long-prompts", action="store_true",
                   help=">77-token prompts via window-concat context "
                        "instead of truncation")
    p.add_argument("--dynamic-threshold", type=float, default=None,
                   metavar="RATIO",
                   help="Imagen/diffusers dynamic thresholding quantile "
                        "(e.g. 0.995); clips/rescales predicted x0")
    p.add_argument("--tiling", action="store_true",
                   help="seamless-texture mode: circular conv padding "
                        "everywhere (A1111 --tiling)")
    p.add_argument("--motion", default=None, metavar="PATH",
                   help="AnimateDiff motion modules (mm_sd_v15[_v2] "
                        ".ckpt/.safetensors): text-to-video; pair with "
                        "--frames and a .gif --out")
    p.add_argument("--frames", type=int, default=16,
                   help="frame count for --motion")
    p.add_argument("--fps", type=int, default=8,
                   help="GIF playback rate for --motion output")
    p.add_argument("--upscaler", default=None, metavar="PATH",
                   help="ESRGAN/RealESRGAN weights (.pth/.safetensors); "
                        "with --hires-fix the second pass starts from the "
                        "ESRGAN-upscaled pixels (A1111 upscaler modes)")
    p.add_argument("--vae", default=None, metavar="PATH",
                   help="standalone VAE override (A1111 .vae.pt / "
                        ".safetensors or diffusers vae/ dir)")
    p.add_argument("--hypernetwork", default=None, metavar="PATH[:STRENGTH]",
                   help="A1111 hypernetwork .pt (cross-attention k/v "
                        "context MLPs)")
    p.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                   help="merge a LoRA adapter (kohya or PEFT .safetensors); "
                        "repeatable; optional :scale suffix (default 1.0)")
    p.add_argument("--out", default="out.png")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 policy (default fp32 parity numerics)")
    p.add_argument("--backend", default="kernel", choices=["plain", "kernel"],
                   help="attention backend: kernel (the hand-written flash "
                        "kernels) or plain (materialized scores)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default the card; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--sd2", action="store_true",
                   help="SD-2.x architecture (sd21_config)")
    p.add_argument("--config-preset", default=None,
                   choices=["sd15", "sd15_inpaint", "sd15_ip2p",
                            "sd15_lcm", "sd21", "sd2_inpaint", "sdxl",
                            "sdxl_lcm", "sdxl_refiner", "tiny"],
                   help="explicit architecture preset (tiny = the scaled-"
                        "down test topology; overrides --sd2)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from . import StableDiffusion
    from .core.dtypes import BF16, FP32
    from .models.config import (sd15_config, sd15_inpaint_config,
                                sd15_ip2p_config, sd15_lcm_config,
                                sd2_inpaint_config, sd21_config,
                                sdxl_config, sdxl_lcm_config,
                                sdxl_refiner_config, tiny_sd_config)

    policy = BF16 if args.bf16 else FP32
    backend = args.backend
    preset = args.config_preset or ("sd21" if args.sd2 else "sd15")
    make = {"sd15": sd15_config, "sd15_inpaint": sd15_inpaint_config,
            "sd15_lcm": sd15_lcm_config, "sd15_ip2p": sd15_ip2p_config,
            "sd21": sd21_config, "sd2_inpaint": sd2_inpaint_config,
            "sdxl": sdxl_config, "sdxl_lcm": sdxl_lcm_config,
            "sdxl_refiner": sdxl_refiner_config,
            "tiny": tiny_sd_config}[preset]
    cfg = make(policy=policy, attention_backend=backend)
    if args.zero_snr:
        import dataclasses

        cfg = dataclasses.replace(cfg, zero_terminal_snr=True)
    if args.fast:
        from .models.config import fast_preset

        cfg, fast_kw = fast_preset(cfg)
        if args.deepcache is None:
            args.deepcache = fast_kw["deepcache"]
        print(f"[cli] fast preset: hypertile {cfg.unet.hypertile[0]} + "
              f"deepcache {args.deepcache}", flush=True)

    print(f"[cli] device={args.device} attention={backend} "
          f"policy={'bf16' if args.bf16 else 'fp32'}", flush=True)
    t0 = time.time()
    loras = []
    for spec in args.lora:
        path, _, s = spec.rpartition(":")
        try:
            loras.append((path, float(s)) if path else (spec, 1.0))
        except ValueError:  # ":" was part of the path, not a scale
            loras.append((spec, 1.0))
    sd = StableDiffusion.from_checkpoint(args.ckpt, args.vocab, args.merges,
                                         config=cfg, loras=loras or None,
                                         device=args.device)
    print(f"[cli] loaded {args.ckpt}"
          + "".join(f" + lora {p}x{s:g}" for p, s in loras)
          + f" in {time.time()-t0:.1f}s", flush=True)

    for spec in args.embedding:
        path, _, tok_name = spec.rpartition(":")
        # ":token" suffix only counts when what precedes it is a weight file
        if not path.endswith((".pt", ".safetensors")):
            path, tok_name = spec, ""
        sd = sd.with_textual_inversion(path, tok_name or None)
        print(f"[cli] installed embedding {path}"
              + (f" as {tok_name}" if tok_name else ""), flush=True)

    if args.controlnet:
        nets = args.controlnet if len(args.controlnet) > 1 \
            else args.controlnet[0]
        sd = sd.with_controlnet(nets)
        print(f"[cli] attached controlnet {args.controlnet}", flush=True)

    if args.t2i_adapter:
        ads = args.t2i_adapter if len(args.t2i_adapter) > 1 \
            else args.t2i_adapter[0]
        sd = sd.with_t2i_adapter(ads)
        print(f"[cli] attached t2i-adapter {args.t2i_adapter}", flush=True)

    if args.ip_adapter:
        from .models import clip_vision as cv_mod

        if not args.ip_image_encoder:
            raise SystemExit("--ip-adapter requires --ip-image-encoder")
        vis_cfg = {"vit_h14": cv_mod.vit_h14, "vit_bigg14": cv_mod.vit_bigg14,
                   "vit_l14": cv_mod.vit_l14}[args.ip_vision]()
        sd = sd.with_ip_adapter(args.ip_adapter, args.ip_image_encoder,
                                vision_config=vis_cfg)
        print(f"[cli] attached ip-adapter {args.ip_adapter}", flush=True)

    if args.upscaler:
        sd = sd.with_upscaler(args.upscaler)
        print(f"[cli] attached upscaler {args.upscaler}", flush=True)

    if args.motion:
        sd = sd.with_motion(args.motion)
        print(f"[cli] attached motion modules {args.motion}", flush=True)

    if args.vae:
        sd = sd.with_vae(args.vae)
        print(f"[cli] swapped VAE {args.vae}", flush=True)

    if args.hypernetwork:
        path, _, s = args.hypernetwork.rpartition(":")
        if not path or not path.endswith(".pt"):
            path, s = args.hypernetwork, ""
        sd = sd.with_hypernetwork(path, float(s) if s else 1.0)
        print(f"[cli] attached hypernetwork {path}", flush=True)

    kw = dict(seed=args.seed, n_inference_steps=args.steps,
              cfg_scale=args.cfg_scale, do_cfg=not args.no_cfg,
              sampler_name=args.sampler, height=args.height,
              width=args.width, decode_tile=args.decode_tile,
              encode_tile=args.encode_tile,
              guidance_rescale=args.guidance_rescale,
              long_prompts=args.long_prompts, emphasis=args.emphasis,
              clip_skip=args.clip_skip, timestep_spacing=args.spacing,
              deepcache=args.deepcache, tome_ratio=args.tome_ratio,
              variation_seed=args.variation_seed,
              variation_strength=args.variation_strength,
              pag_scale=args.pag_scale,
              sag_scale=args.sag_scale,
              tiling=args.tiling,
              panorama=args.panorama,
              panorama_window=args.panorama_window,
              panorama_stride=args.panorama_stride,
              dynamic_threshold=args.dynamic_threshold,
              freeu=None if args.freeu is None
              else (True if not args.freeu else args.freeu))
    if args.control_image:
        from PIL import Image

        if not args.controlnet:
            raise SystemExit("--control-image requires --controlnet")
        if len(args.control_image) != len(args.controlnet):
            raise SystemExit(f"{len(args.control_image)} --control-image for "
                             f"{len(args.controlnet)} --controlnet")
        imgs = [Image.open(p).convert("RGB") for p in args.control_image]
        if args.control_preprocess:
            import numpy as np

            from .utils import annotators as an

            fn = getattr(an, args.control_preprocess)
            imgs = [an.hint_rgb(fn(np.asarray(im))) for im in imgs]
            print(f"[cli] preprocessed hints with {args.control_preprocess}",
                  flush=True)
        scales = args.controlnet_scale or [1.0] * len(imgs)
        if len(scales) != len(imgs):
            raise SystemExit(f"{len(scales)} --controlnet-scale for "
                             f"{len(imgs)} --controlnet")
        kw["control_image"] = imgs if len(imgs) > 1 else imgs[0]
        kw["controlnet_scale"] = scales if len(scales) > 1 else scales[0]
    if args.adapter_image:
        from PIL import Image

        if not args.t2i_adapter:
            raise SystemExit("--adapter-image requires --t2i-adapter")
        if len(args.adapter_image) != len(args.t2i_adapter):
            raise SystemExit(f"{len(args.adapter_image)} --adapter-image "
                             f"for {len(args.t2i_adapter)} --t2i-adapter")
        a_imgs = [Image.open(p).convert("RGB") for p in args.adapter_image]
        a_scales = args.adapter_scale or [1.0] * len(a_imgs)
        if len(a_scales) != len(a_imgs):
            raise SystemExit(f"{len(a_scales)} --adapter-scale for "
                             f"{len(a_imgs)} --t2i-adapter")
        kw["adapter_image"] = a_imgs if len(a_imgs) > 1 else a_imgs[0]
        kw["adapter_scale"] = a_scales if len(a_scales) > 1 else a_scales[0]
    if args.reference_image:
        from PIL import Image

        kw["reference_image"] = Image.open(args.reference_image) \
            .convert("RGB")
        kw["reference_fidelity"] = args.reference_fidelity
        kw["reference_mode"] = args.reference_mode
    elif args.reference_mode != "attn" or args.reference_fidelity != 0.5:
        raise SystemExit("--reference-mode/--reference-fidelity have no "
                         "effect without --reference-image")
    if args.region_mask:
        from PIL import Image

        kw["region_masks"] = [Image.open(p).convert("L")
                              for p in args.region_mask]
    if args.ip_adapter_image:
        from PIL import Image

        if not args.ip_adapter:
            raise SystemExit("--ip-adapter-image requires --ip-adapter")
        kw["ip_adapter_image"] = Image.open(args.ip_adapter_image) \
            .convert("RGB")
        kw["ip_adapter_scale"] = args.ip_adapter_scale
    if args.edit_image:
        from PIL import Image

        if args.image or args.mask:
            raise SystemExit("--edit-image replaces --image/--mask "
                             "(InstructPix2Pix denoises from pure noise)")
        kw["edit_image"] = Image.open(args.edit_image).convert("RGB")
        kw["image_guidance_scale"] = args.image_guidance
    t0 = time.time()
    if args.motion:
        from PIL import Image

        kw_anim = {k: v for k, v in kw.items()}
        if args.image:
            kw_anim["input_image"] = Image.open(args.image).convert("RGB")
            kw_anim["strength"] = args.strength
        frames = sd.animate(args.prompt, n_frames=args.frames,
                            uncond_prompt=args.uncond_prompt, **kw_anim)
        print(f"[cli] generated {len(frames)} frames in "
              f"{time.time()-t0:.1f}s (incl. kernel builds)", flush=True)
        pils = [Image.fromarray(f) for f in frames]
        pils[0].save(args.out, save_all=True, append_images=pils[1:],
                     duration=int(1000 / args.fps), loop=0)
        print(f"[cli] wrote {args.out} ({args.frames} frames)", flush=True)
        return 0
    if args.mask:
        from PIL import Image

        if not args.image:
            raise SystemExit("--mask requires --image")
        init = Image.open(args.image).convert("RGB")
        mask = Image.open(args.mask)
        img = sd.inpaint(args.prompt, init, mask, strength=args.strength,
                         full_res=args.inpaint_full_res,
                         full_res_padding=args.inpaint_full_res_padding,
                         uncond_prompt=args.uncond_prompt, **kw)
    elif args.image:
        from PIL import Image

        init = Image.open(args.image).convert("RGB")
        img = sd.img2img(args.prompt, init, strength=args.strength,
                         color_correction=args.color_correction,
                         uncond_prompt=args.uncond_prompt, **kw)
    elif args.hires_fix:
        img = sd.hires_fix(args.prompt, uncond_prompt=args.uncond_prompt,
                           strength=args.strength,
                           upscale_method="esrgan" if args.upscaler
                           else "bilinear",
                           **{k: v for k, v in kw.items()
                              if k not in ("height", "width")},
                           height=args.height, width=args.width)
    else:
        img = sd.txt2img(args.prompt, uncond_prompt=args.uncond_prompt, **kw)
    print(f"[cli] generated in {time.time()-t0:.1f}s (incl. kernel builds)",
          flush=True)

    save_image(img, args)
    print(f"[cli] wrote {args.out} ({img.shape[1]}x{img.shape[0]})",
          flush=True)
    return 0


def save_image(img, args) -> None:
    """Write the uint8 (H, W, 3) ``img`` to ``args.out``; a PNG carries the
    request's parameters (``args``: prompt, uncond_prompt, steps, sampler,
    cfg_scale, seed, width, height, strength, ckpt)."""
    from PIL import Image

    pil = Image.fromarray(img)
    if args.out.lower().endswith(".png"):
        # A1111 infotext convention: generation parameters in the PNG
        # "parameters" tEXt chunk, so images are reproducible from file
        from PIL.PngImagePlugin import PngInfo

        info = PngInfo()
        neg = f"\nNegative prompt: {args.uncond_prompt}" \
            if args.uncond_prompt else ""
        info.add_text(
            "parameters",
            f"{args.prompt}{neg}\n"
            f"Steps: {args.steps}, Sampler: {args.sampler}, "
            f"CFG scale: {args.cfg_scale}, Seed: {args.seed}, "
            f"Size: {args.width}x{args.height}, "
            f"Denoising strength: {args.strength}, "
            f"Model: {args.ckpt}")
        pil.save(args.out, pnginfo=info)
    else:
        pil.save(args.out)


if __name__ == "__main__":
    sys.exit(main())
