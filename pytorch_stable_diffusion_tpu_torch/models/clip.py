"""CLIP ViT-L/14 text encoder (port of ``models/clip.py``).

Token embedding + learned positional parameter; 12 pre-norm blocks
(LN -> causal self-attention -> residual; LN -> fc1 -> QuickGELU -> fc2 ->
residual); final LayerNorm.  Output: (B, 77, 768) last hidden state.
The 77-token attention always takes the materialized path.  A config with
``stop_at_layer`` (CLIP skip, ``config.with_clip_skip``) runs only that many
layers, then the final LayerNorm unless ``penultimate_norm`` is false.

Parameter names follow the JAX pytree paths (``layers.3.attn.q.weight``
for ``layers/3/attn/q/kernel``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, linear, norm
from ..ops.act import quick_gelu
from .config import CLIPConfig


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        self.ln1 = norm.Norm(cfg.d_model, **kw)
        self.attn = attention.Attention(cfg.d_model, **kw)
        self.ln2 = norm.Norm(cfg.d_model, **kw)
        self.fc1 = linear.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.fc2 = linear.Linear(cfg.d_ff, cfg.d_model, **kw)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_len, cfg.d_model, **kw))
        self.layers = nn.ModuleList(CLIPLayer(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = norm.Norm(cfg.d_model, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 0.02) token embedding, zero positions, as the JAX init."""
        self.token_embedding.data.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.data.zero_()

    def forward(self, tokens: torch.Tensor, policy: Policy = FP32, *,
                fuse_qkv: bool = True,
                cfg: Optional[CLIPConfig] = None) -> torch.Tensor:
        """tokens: (B, max_len) int -> (B, max_len, d_model).

        ``cfg`` is the request's tower config (the JAX ``apply``'s), by
        default the one the module was built from; its ``stop_at_layer``
        and ``penultimate_norm`` choose where the stack ends."""
        cfg = cfg or self.cfg
        n_run = cfg.n_layers if cfg.stop_at_layer is None else cfg.stop_at_layer
        x = self.token_embedding[tokens] + self.position_embedding[None]
        x = x.to(policy.compute_dtype)
        for lp in self.layers[:n_run]:
            h = norm.layer_norm(lp.ln1, x, policy=policy)
            x = x + attention.apply(lp.attn, h, n_heads=cfg.n_heads,
                                    causal=True, backend="plain",
                                    policy=policy, fuse=fuse_qkv)
            h = norm.layer_norm(lp.ln2, x, policy=policy)
            h = linear.apply(lp.fc2, quick_gelu(linear.apply(lp.fc1, h, policy)),
                             policy)
            x = x + h
        if cfg.stop_at_layer is not None and not cfg.penultimate_norm:
            return x  # the truncated hidden without the final LayerNorm
        return norm.layer_norm(self.final_norm, x, policy=policy)
