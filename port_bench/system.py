"""The system under test: the PyTorch/CUDA port, ``pytorch_stable_diffusion_tpu_torch``.

The only module of the benchmark that imports the program.  It turns a
configuration file into the program's config, loads the benchmark's
checkpoint through the program's converter, builds the program's tokenizer
from the benchmark's vocabulary, and hands the program to the entry that a
traffic mix names.  The reference (``reference/``) never imports this module.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference.model import tower_stop

#: the program's default key prefix of a transformers-layout tower
_HF_PREFIX = "cond_stage_model.transformer.text_model"


def _tower(te: dict):
    from pytorch_stable_diffusion_tpu_torch.models.config import CLIPConfig

    open_clip = te["layout"] == "open_clip"
    return CLIPConfig(
        vocab_size=te["vocab_size"], d_model=te["width"], max_len=te["context_length"],
        n_layers=te["layers"], n_heads=te["heads"], d_ff=te["mlp_width"],
        hidden_act=te["act"],
        stop_at_layer=None if te["layer"] == "last" else tower_stop(te),
        penultimate_norm=te["final_norm"],
        text_projection=bool(te.get("always_return_pooled")),
        layout="open_clip" if open_clip else "clip",
        key_prefix=None if te["key_prefix"] == _HF_PREFIX else te["key_prefix"])


def port_config(cfg: dict, *, quant: str = "none"):
    """The program's ``SDConfig`` for a configuration file: its published
    sizes and the serving settings under ``serving``.  ``quant``: one of the
    program's int8 tiers (the control of the correctness check)."""
    from pytorch_stable_diffusion_tpu_torch import BF16, FP32
    from pytorch_stable_diffusion_tpu_torch.models.config import SDConfig, UNetConfig, VAEConfig
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    m, serving = cfg["model"], cfg["serving"]
    if (m["linear_start"], m["linear_end"], m["timesteps"]) != (ddpm.BETA_START, 0.012, 1000):
        raise ValueError("the program's schedule is scaled-linear 0.00085..0.012 over 1000 "
                         f"steps; the configuration states {m['linear_start']}.."
                         f"{m['linear_end']} over {m['timesteps']}")
    u, v = m["unet_config"], m["first_stage_config"]
    depth = u["transformer_depth"]
    head_ch = u.get("num_head_channels", -1)
    unet = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        model_channels=u["model_channels"], ch_mults=tuple(u["channel_mult"]),
        attn_levels=tuple(2 ** i in u["attention_resolutions"]
                          for i in range(len(u["channel_mult"]))),
        num_res_blocks=u["num_res_blocks"], n_heads=u.get("num_heads", 8),
        head_dim=None if head_ch in (None, -1) else head_ch, d_context=u["context_dim"],
        transformer_depth=tuple(depth) if isinstance(depth, list) else None,
        add_embed_dim=u.get("adm_in_channels"))
    vae = VAEConfig(in_channels=v["in_channels"], base_channels=v["ch"],
                    ch_mults=tuple(v["ch_mult"]), latent_channels=v["z_channels"],
                    scale_factor=m["scale_factor"])
    towers = [_tower(te) for te in m["text_encoders"]]
    return SDConfig(
        clip=towers[0], clip2=towers[1] if len(towers) > 1 else None, vae=vae, unet=unet,
        policy={"bf16": BF16, "fp32": FP32}[serving["policy"]],
        attention_backend=serving["attention_backend"],
        vae_attention_backend=serving["vae_attention_backend"],
        conv_backend=serving["conv_backend"],
        prediction_type={"eps": "epsilon", "v": "v"}[m["parameterization"]], quant=quant)


def load_models(config, tensors: Dict[str, object]):
    """The program's models over the checkpoint tensors, through its
    converter and its no-copy assembly (the path of its checkpoint
    loaders once a file is read)."""
    from pytorch_stable_diffusion_tpu_torch.models import assemble
    from pytorch_stable_diffusion_tpu_torch.weights import convert

    return assemble(config, convert.convert(tensors, config))


def tokenizer(vocab: Dict[str, int], merges: List[tuple], max_len: int):
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import CLIPTokenizer

    return CLIPTokenizer(vocab, merges, max_len)


def import_program() -> None:
    """Import the program (its import is part of set-up)."""
    import pytorch_stable_diffusion_tpu_torch  # noqa: F401


def load_kernels() -> None:
    """Build (first run in a checkout) or load the five hand-written kernels."""
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import build

    build.load_all(["flash_attention_bsc", "flash_attention_onepass",
                    "flash_attention_streamed", "flash_attention_multipass",
                    "scaled_silu_conv3x3"])


class Server:
    """The program loaded for one cell: its models, tokenizer and config,
    and the call of the entry a traffic mix names (``entries/<entry>.py``,
    whose ``serve`` takes this server)."""

    def __init__(self, entry, models, tok, config, device):
        import pytorch_stable_diffusion_tpu_torch as port

        self.port, self.models, self.tok, self.config, self.device = \
            port, models, tok, config, device
        self.call = entry.serve(self)

    def __call__(self, request: dict) -> np.ndarray:
        """One request: uint8 images (B, H, W, 3) on the host."""
        return self.call(request)


def models_of(models) -> Dict[str, object]:
    """The modules the benchmark's spans hook: the UNet and the VAE decoder."""
    return {"unet": models["diffusion"], "vae_decode": models["decoder"]}
