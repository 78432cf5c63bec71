"""Stable Diffusion in PyTorch for NVIDIA Hopper — the port of
``pytorch_stable_diffusion_tpu`` (JAX/TPU), which stays the reference.

The port runs SD-1.5 txt2img and img2img with CFG and the JAX package's
18 samplers and timestep grids, up to 2048² (65536-token attention), with
the tiled VAE for high resolutions.  Module paths mirror the JAX package
(``core/``, ``ops/``, ``models/``, ``sampling/``, ``weights/``,
``pipeline.py``); the TPU's Pallas kernels are hand-written CUDA kernels
in ``csrc/``: K1 ``flash_attention_bsc.cu``, K2
``flash_attention_onepass.cu``, K4 ``flash_attention_streamed.cu``, K3
``flash_attention_multipass.cu`` and K5 ``scaled_silu_conv3x3.cu``.  The
package imports torch and numpy (and scipy for the "beta" grid), never
jax.

Quick start (random weights; checkpoint loading comes in a later slice)::

    import torch
    from pytorch_stable_diffusion_tpu_torch import BF16, build_models, generate, sd15_config
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    cfg = sd15_config(policy=BF16, attention_backend="kernel")
    models = build_models(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    image = generate("a photo", models=models, tokenizer=make_test_tokenizer(["a", "photo"], 77),
                     config=cfg, seed=1337)
"""

from .core.dtypes import BF16, FP32, Policy
from .models import build_models
from .models.config import (CLIPConfig, SDConfig, UNetConfig, VAEConfig,
                            sd15_config, tiny_sd_config)
from .pipeline import generate, generate_images

__all__ = ["BF16", "FP32", "Policy", "build_models", "CLIPConfig", "SDConfig",
           "UNetConfig", "VAEConfig", "sd15_config", "tiny_sd_config",
           "generate", "generate_images"]
