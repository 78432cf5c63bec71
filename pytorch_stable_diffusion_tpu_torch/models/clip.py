"""CLIP text encoders (port of ``models/clip.py``): ViT-L/14 (SD-1.x,
SDXL's first tower), OpenCLIP ViT-H (SD-2.x) and bigG (SDXL).

Token embedding + learned positional parameter; pre-norm blocks (LN ->
causal self-attention -> residual; LN -> fc1 -> activation -> fc2 ->
residual); final LayerNorm.  Output: (B, 77, d) hidden state.  The
activation is QuickGELU for ``hidden_act="quick_gelu"`` and the exact
(erf) GELU for ``"gelu"``, OpenCLIP's: the JAX package's ``jax.nn.gelu``
defaults to the tanh approximation there (ROADMAP.md §3).  The 77-token
attention always takes the materialized path.  A config with
``stop_at_layer`` (the SD-2.x/SDXL penultimate layer, CLIP skip) runs only
that many layers, then the final LayerNorm unless ``penultimate_norm`` is
false.  :meth:`CLIP.forward_with_pooled` also returns the pooled vector of
the full stack (SDXL's added conditioning): the final-normed EOT row
(``argmax`` of the ids) times ``text_projection``.

Parameter names follow the JAX pytree paths (``layers.3.attn.q.weight``
for ``layers/3/attn/q/kernel``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops import attention, linear, norm
from ..ops.act import gelu, quick_gelu
from .config import CLIPConfig


class CLIPLayer(nn.Module):
    """One pre-norm transformer layer (the text towers' and the vision
    tower's, ``models/clip_vision.py``)."""

    def __init__(self, d_model: int, d_ff: int, **kw):
        super().__init__()
        self.ln1 = norm.Norm(d_model, **kw)
        self.attn = attention.Attention(d_model, **kw)
        self.ln2 = norm.Norm(d_model, **kw)
        self.fc1 = linear.Linear(d_model, d_ff, **kw)
        self.fc2 = linear.Linear(d_ff, d_model, **kw)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_len, cfg.d_model, **kw))
        self.layers = nn.ModuleList(CLIPLayer(cfg.d_model, cfg.d_ff, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = norm.Norm(cfg.d_model, **kw)
        if cfg.text_projection:
            # (in, out): the pooled vector is ``x @ text_projection``
            self.text_projection = nn.Parameter(
                torch.empty(cfg.d_model, cfg.d_model, **kw))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 0.02) token embedding, zero positions, N(0, 1/d) projection,
        as the JAX init."""
        self.token_embedding.data.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.data.zero_()
        if self.cfg.text_projection:
            self.text_projection.data.normal_(0.0, self.cfg.d_model ** -0.5,
                                              generator=generator)

    def forward(self, tokens: torch.Tensor, policy: Policy = FP32, *,
                fuse_qkv: bool = True,
                cfg: Optional[CLIPConfig] = None) -> torch.Tensor:
        """tokens: (B, max_len) int -> (B, max_len, d_model).

        ``cfg`` is the request's tower config (the JAX ``apply``'s), by
        default the one the module was built from; its ``stop_at_layer``
        and ``penultimate_norm`` choose where the stack ends."""
        return self._run(tokens, policy, fuse_qkv, cfg or self.cfg, pooled=False)[0]

    def forward_with_pooled(self, tokens: torch.Tensor, policy: Policy = FP32, *,
                            fuse_qkv: bool = True, cfg: Optional[CLIPConfig] = None):
        """-> (hidden, pooled): ``hidden`` as :meth:`forward` gives it, and
        ``pooled`` (B, d) from the FULL stack: final LayerNorm, the EOT row
        (``argmax`` of the ids), ``@ text_projection`` where the tower has
        one.  One pass: the hidden state is kept on the way at
        ``stop_at_layer`` (the JAX ``apply_with_pooled`` runs the stack
        twice; the results are equal)."""
        return self._run(tokens, policy, fuse_qkv, cfg or self.cfg, pooled=True)

    def _run(self, tokens, policy, fuse_qkv, cfg, pooled):
        act = quick_gelu if cfg.hidden_act == "quick_gelu" else gelu
        n_hidden = cfg.n_layers if cfg.stop_at_layer is None else cfg.stop_at_layer
        n_run = cfg.n_layers if pooled else n_hidden
        x = self.token_embedding[tokens] + self.position_embedding[None]
        x = x.to(policy.compute_dtype)
        hidden = None
        for i, lp in enumerate(self.layers[:n_run]):
            h = norm.layer_norm(lp.ln1, x, policy=policy)
            x = x + attention.apply(lp.attn, h, n_heads=cfg.n_heads,
                                    causal=True, backend="plain",
                                    policy=policy, fuse=fuse_qkv)
            h = norm.layer_norm(lp.ln2, x, policy=policy)
            h = linear.apply(lp.fc2, act(linear.apply(lp.fc1, h, policy)), policy)
            x = x + h
            if i + 1 == n_hidden:
                hidden = x
        if cfg.stop_at_layer is None or cfg.penultimate_norm:
            hidden = norm.layer_norm(self.final_norm, hidden, policy=policy)
        # else: the truncated hidden without the final LayerNorm (SDXL)
        if not pooled:
            return hidden, None
        full = norm.layer_norm(self.final_norm, x, policy=policy)
        eot = tokens.argmax(dim=-1)
        pool = full[torch.arange(full.shape[0], device=full.device), eot]
        if cfg.text_projection:
            pool = pool @ self.text_projection.to(pool.dtype)
        return hidden, pool
