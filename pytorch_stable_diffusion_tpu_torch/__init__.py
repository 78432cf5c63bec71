"""Stable Diffusion in PyTorch for NVIDIA Hopper — the port of
``pytorch_stable_diffusion_tpu`` (JAX/TPU), which stays the reference.

The port runs SD-1.5, SD-2.1 (the OpenCLIP ViT-H tower, v-prediction),
SDXL base and the SDXL refiner (two text towers, pooled and size
conditioning, stacked transformer depth; base -> refiner through
``init_latents``), txt2img and img2img with CFG and the JAX package's 18
samplers and timestep grids, up to 2048² (65536-token attention), with
the tiled VAE for high resolutions; it loads CompVis checkpoints
(``.safetensors`` through a native reader, ``.ckpt`` through a restricted
unpickler) and diffusers directories, and applies LoRA, textual inversion,
hypernetworks, VAE overrides and merges (``weights/``); it inpaints
(9-channel checkpoints or latent blending, full-resolution, fill,
outpaint), edits with InstructPix2Pix, runs LCM's embedded guidance and the
two-pass hires fix; it takes ControlNets, T2I-Adapters, IP-Adapters and
reference images, and the guidance and approximate modes (guidance
rescale, dynamic thresholding, PAG, SAG, composable and regional prompts,
variation seeds, DeepCache, Hypertile, ToMe, FreeU, seamless tiling,
``fast_preset``), behind the ``StableDiffusion`` object of ``api.py`` and
the command line (``python -m pytorch_stable_diffusion_tpu_torch``); the
UNet's int8 tiers (``UNetConfig.quant``: "wide", "conv", "w8";
``ops/quant.py``) and data and tensor parallelism over ``torch.distributed``
(``core/mesh.py``, ``parallel/``; one process a card under ``torchrun``).  Module paths mirror the JAX
package (``core/``, ``ops/``, ``models/``, ``sampling/``, ``weights/``,
``pipeline.py``, ``api.py``); the TPU's Pallas kernels are hand-written
CUDA kernels in ``csrc/``: K1 ``flash_attention_bsc.cu``, K2
``flash_attention_onepass.cu``, K4 ``flash_attention_streamed.cu``, K3
``flash_attention_multipass.cu`` and K5 ``scaled_silu_conv3x3.cu``.  The
package imports torch and numpy (and scipy for the "beta" grid), never
jax.

Quick start, the JAX package's with the package name changed::

    from pytorch_stable_diffusion_tpu_torch import generate, load_models, CLIPTokenizer

    tokenizer = CLIPTokenizer.from_files("vocab.json", "merges.txt")
    models = load_models("v1-5-pruned-emaonly.ckpt")   # or .safetensors
    image = generate("a photo of a dog", models=models, tokenizer=tokenizer,
                     seed=1337, cfg_scale=7.5, n_inference_steps=50)

or through the bundle object, on the kernels::

    from pytorch_stable_diffusion_tpu_torch import BF16, StableDiffusion, sd15_config

    sd = StableDiffusion.from_checkpoint(
        "v1-5-pruned-emaonly.safetensors", "vocab.json", "merges.txt",
        config=sd15_config(policy=BF16, attention_backend="kernel"))
    image = sd.txt2img("a photo of a dog", seed=1337, sampler_name="dpm++",
                       timestep_spacing="karras", n_inference_steps=20)
    images = sd.with_lora("style.safetensors", 0.8).generate_many(
        ["a dog", "a cat", "a fox"], batch_size=2, seed=0)

Everything runs on the card unless ``device=`` names another device.
"""

from .core.dtypes import BF16, FP32, MIXED, Policy
from .models import build_models
from .models.config import (CLIPConfig, SDConfig, UNetConfig, VAEConfig, fast_preset,
                            sd2_inpaint_config, sd15_config, sd15_inpaint_config,
                            sd15_ip2p_config, sd15_lcm_config, sd21_config, sdxl_config,
                            sdxl_inpaint_config, sdxl_lcm_config, sdxl_refiner_config,
                            tiny_sd_config, tiny_sdxl_config, with_clip_skip, with_freeu,
                            with_hypertile, with_tome)
from .pipeline import generate, generate_images, generate_many, get_time_embedding, rescale
from .api import StableDiffusion, load_diffusers_models, load_models, load_models_streamed
from .weights.tokenizer import CLIPTokenizer

__version__ = "0.1.0"

__all__ = ["BF16", "FP32", "MIXED", "Policy", "build_models", "CLIPConfig", "SDConfig",
           "UNetConfig", "VAEConfig", "sd15_config", "sd21_config", "sdxl_config",
           "sdxl_refiner_config", "sd15_inpaint_config", "sd15_ip2p_config",
           "sd15_lcm_config", "sd2_inpaint_config", "sdxl_inpaint_config", "sdxl_lcm_config",
           "tiny_sd_config", "tiny_sdxl_config", "with_clip_skip", "with_freeu",
           "with_hypertile", "with_tome", "fast_preset",
           "generate", "generate_images", "generate_many", "StableDiffusion",
           "load_models", "load_diffusers_models", "load_models_streamed", "CLIPTokenizer",
           "get_time_embedding", "rescale"]
