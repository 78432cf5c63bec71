"""Tiny configurations and mixes of the benchmark's families, for the CPU
tests: the topology of SD-1.5 and SDXL at small widths."""

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def _tower(prefix, width, layers, heads, *, act="quick_gelu", layout="hf_clip", layer="last",
           final_norm=True, **kw):
    return dict(layout=layout, key_prefix=prefix, vocab_size=49408, width=width, layers=layers,
                heads=heads, mlp_width=2 * width, context_length=16, act=act, layer=layer,
                final_norm=final_norm, **kw)


def _model(unet, towers, scale):
    return {"linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000,
            "scale_factor": scale, "parameterization": "eps", "unet_config": unet,
            "first_stage_config": {"embed_dim": 4, "z_channels": 4, "in_channels": 3,
                                   "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                                   "num_res_blocks": 2},
            "text_encoders": towers}


def sd(policy="fp32"):
    unet = {"in_channels": 4, "out_channels": 4, "model_channels": 32,
            "attention_resolutions": [1], "num_res_blocks": 2, "channel_mult": [1, 2],
            "num_heads": 2, "transformer_depth": 1, "context_dim": 32,
            "use_linear_in_transformer": False}
    towers = [_tower("cond_stage_model.transformer.text_model", 32, 2, 2)]
    return {"name": "tiny_sd", "model": _model(unet, towers, 0.18215),
            "serving": {"policy": policy, "attention_backend": "kernel",
                        "vae_attention_backend": "kernel", "conv_backend": "kernel"}}


def sdxl(policy="fp32"):
    unet = {"in_channels": 4, "out_channels": 4, "model_channels": 32,
            "attention_resolutions": [2], "num_res_blocks": 2, "channel_mult": [1, 2],
            "num_head_channels": 16, "transformer_depth": [1, 2], "context_dim": 48,
            "use_linear_in_transformer": True, "adm_in_channels": 32 + 6 * 8,
            "addition_time_embed_dim": 8}
    towers = [_tower("conditioner.embedders.0.transformer.text_model", 16, 2, 2,
                     layer="hidden", layer_idx=1, final_norm=False),
              _tower("conditioner.embedders.1.model", 32, 3, 2, act="gelu",
                     layout="open_clip", layer="penultimate", final_norm=False,
                     always_return_pooled=True)]
    return {"name": "tiny_sdxl", "model": _model(unet, towers, 0.13025),
            "serving": {"policy": policy, "attention_backend": "kernel",
                        "vae_attention_backend": "kernel", "conv_backend": "plain"}}


def mix(entry="generate_images", sampler="ddpm", spacing="uniform", batch=2):
    m = {"entry": entry, "loop": "closed", "clients": 1, "batch": batch, "height": 64,
         "width": 64, "sampler": sampler, "steps": 4, "spacing": spacing, "cfg_scale": 7.5,
         "prompt_words": 10, "uncond_prompt": "", "warmup_steps": 2, "trace_requests": 1}
    if entry == "hires_fix":
        m.update(batch=1, base_height=32, base_width=32, strength=0.6,
                 upscale_method="bilinear", warmup_steps=3)
    return m


def cell(config, traffic, limit=1.0, images=2):
    from port_bench import harness

    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return harness.Cell(name="tiny", chips=1, config=copy.deepcopy(config), mix=traffic,
                        checks={"images": images,
                                "limits": {"pct_off3": {"limit": limit}}},
                        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
