"""Multi-head attention, self and cross (port of ``ops/attention.py``).

Semantics: scores = q kᵀ / √Dh, optional causal mask, fp32 softmax, @ v.
Cross-attention attends to the tokenizer padding with no mask, as the
reference does.

Dispatch (:func:`route`) follows the JAX package, with its VMEM model
replaced by the JAX package's own KV thresholds (and without the
CFG-batch cliff of ``bsc_fits``).  A kernel is chosen only where its
wrapper takes the head dim (``takes_head_dim``: on the card K1 takes Dh
32/40/64/80/160, K4 16/40/64/128, K2 16/40/64/80/128/160, K3 every
multiple of 8 up to 512; on the CPU each plain version takes every Dh up
to its kernel's largest):

* KV >= :data:`FLASH_ONLY_KV` (40960), on either backend, as the JAX
  package forces flash there: K4 (``flash_attention_streamed``) when
  non-causal at a head dim K4 takes, otherwise K3
  (``flash_attention_multipass``); a head dim K3 does not take either
  raises ``ValueError`` (materialized scores do not fit there).
* ``"kernel"`` backend, KV >= 256:
  - non-causal self-attention: K1 (``flash_attention_bsc``, heads packed
    in channels) where it takes the head dim, else K3 (the VAE's 1-head
    Dh 512).  This includes the 9216-token self-attention of 768², where
    the JAX package runs its one-pass kernel: the port keeps K1 there;
  - causal or cross-attention over a padded KV past 9216: as at
    FLASH_ONLY_KV, but materialized where no kernel takes the head dim;
  - causal or cross-attention over 256..9216 KV tokens (padded to 128):
    the one-pass kernel K2 (``flash_attention_onepass``), as in the JAX
    package, whose ``_pick_chunk`` fits every such case; else K3.
    Through ``generate()`` this is the cross-attention over a long-prompt
    context of 4+ windows (308+ tokens).
  - a head dim no kernel takes: materialized scores.
* KV < 256 (CLIP, every 77-token cross-attention, the UNet's 64-token mid
  block at 512²) and the ``"plain"`` backend below 40960: materialized
  scores.

Slice E's reference read (``models/unet.py``) passes ``[own, banked]``
tokens as the context of a self-attention's projections, so it takes the
cross path over 2·S KV tokens: K2 at 512² and SDXL 1024² (KV 8192, 2048,
512), K4 past 9216 padded KV tokens (768²: 9216 q rows over 18432), and
materialized scores at the 64-token mid block (KV 128).  The IP-Adapter's
decoupled attention (``ip``) is always materialized: its KV is 4 or 16
image tokens.

``quant`` (the UNet's int8 tiers, ``ops/quant.py``) reaches every
projection through ``linear.apply``, except the fused ones
(:func:`_fused_proj`), which take w8a8 only: the JAX package's
``_fused_proj`` has no w8 branch, so under "w8" the fused q/k/v (and the
fused k/v of cross-attention) stay exact, as there.

Under tensor parallelism (``parallel/tp.py`` sets the module's
``tp_group``) q, k and v hold the rank's heads (column-parallel) and
``out`` its input slice (row-parallel, summed over the group): the
attention runs at the local head count, the IP-Adapter's replicated k/v
projections are sliced to the local heads' columns, and SAG's map is
gathered over the heads.

Under sequence parallelism (a row split, ``core/mesh.split_rows``) x holds
the rank's rows of the token grid (``grid_width`` tokens a row): a
self-attention projects its own q, k and v, all-gathers k and v over the
model group, and attends its q rows over the whole KV, as the JAX
package's ``_sp_self_attention`` does.  :func:`route` then sees Sq != Sk,
as for cross-attention: K2 where the padded KV fits its one pass, else K4
or K3, never K1 (whose grid assumes Sq = Sk); below 256 KV tokens
materialized scores on the local rows.  SAG's map (``return_probs``) is
gathered over the q rows, since SAG's mask reads it whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core import mesh as mesh_mod
from ..core.dtypes import FP32, Policy
from . import linear
from .cuda.flash_attention import (MULTIPASS_MAX_DH, ONEPASS_MAX_KV, flash_attention_bsc,
                                   flash_attention_multipass, flash_attention_onepass,
                                   flash_attention_streamed, takes_head_dim)

#: shortest KV the kernel backend sends to a flash kernel
KERNEL_MIN_KV = 256
#: KV length from which the JAX package always runs flash (materialized
#: scores stop fitting).  Read at call time, so tests may lower it.
FLASH_ONLY_KV = 40960


class Attention(nn.Module):
    """q/k/v/out projections.  Cross-attention when ``d_cross`` is given.

    UNet blocks use in_bias=False, out_bias=True; CLIP and the VAE use
    biases everywhere."""

    def __init__(self, d_embed: int, d_cross: Optional[int] = None,
                 in_bias: bool = True, out_bias: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        d_kv = d_cross if d_cross is not None else d_embed
        kw = dict(dtype=dtype, device=device)
        self.q = linear.Linear(d_embed, d_embed, bias=in_bias, **kw)
        self.k = linear.Linear(d_kv, d_embed, bias=in_bias, **kw)
        self.v = linear.Linear(d_kv, d_embed, bias=in_bias, **kw)
        self.out = linear.Linear(d_embed, d_embed, bias=out_bias, **kw)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def materialized_attention(q, k, v, causal: bool, policy: Policy,
                           return_probs: bool = False):
    """q, k, v: (B, H, S, Dh).  Port of ``_xla_attention``: scores and
    softmax in ``policy.softmax_dtype``, probs cast to q's dtype for @ v;
    with ``return_probs`` -> (out, probs in ``policy.softmax_dtype``)."""
    sd = policy.softmax_dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.to(sd), k.to(sd).transpose(-1, -2)) * scale
    if causal:
        sq, sk = scores.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype), v.to(q.dtype)).to(q.dtype)
    return (out, probs) if return_probs else out


def _fused_proj(parts, x: torch.Tensor, policy: Policy, quant: str = "none"):
    """Several same-input linears as ONE matmul (weights concatenated on the
    out dim, in the given order), then split.  The split parts are views
    whose rows are ``len(parts) * C`` apart.  w8a8 where the contraction is
    wide; no w8 branch, as in the JAX package."""
    if quant != "none":
        from . import quant as quant_mod

        if quant_mod.matmul_wants_int8(quant, parts[0].weight.shape[1]):
            y = quant_mod.int8_linear(x, *quant_mod.fused(parts)).to(policy.compute_dtype)
            return y.split(parts[0].weight.shape[0], dim=-1)
    w = torch.cat([p.weight for p in parts], 0).to(policy.compute_dtype)
    b = None if parts[0].bias is None else \
        torch.cat([p.bias for p in parts]).to(policy.compute_dtype)
    y = torch.nn.functional.linear(x.to(policy.compute_dtype), w, b)
    return y.split(parts[0].weight.shape[0], dim=-1)


def route(kv_len: int, head_dim: int, *, causal: bool, cross: bool,
          backend: str, cuda: bool = True) -> str:
    """Which attention runs: ``"plain"`` (materialized scores), ``"bsc"``
    (K1), ``"onepass"`` (K2), ``"streamed"`` (K4) or ``"multipass"``
    (K3).

    A kernel is picked only where its wrapper takes ``head_dim``
    (:func:`~.cuda.flash_attention.takes_head_dim`; ``cuda`` False asks
    for the CPU, whose plain versions take every head dim up to each
    kernel's largest).  A head dim no kernel takes runs materialized
    below :data:`FLASH_ONLY_KV` and raises ``ValueError`` at or above it."""
    def takes(kernel):
        return takes_head_dim(kernel, head_dim, cuda=cuda)

    def long_kernel():
        if not causal and takes("streamed"):
            return "streamed"
        return "multipass" if takes("multipass") else None

    if kv_len >= FLASH_ONLY_KV:
        found = long_kernel()
        if found is None:
            raise ValueError(
                f"attention over {kv_len} KV tokens (>= FLASH_ONLY_KV = {FLASH_ONLY_KV}) "
                f"at head dim {head_dim}: no flash kernel takes it (K3 takes multiples "
                f"of 8 up to {MULTIPASS_MAX_DH}), and materialized scores do not fit")
        return found
    if backend != "kernel" or kv_len < KERNEL_MIN_KV:
        return "plain"
    if not (causal or cross):
        if takes("bsc"):
            return "bsc"
        return "multipass" if takes("multipass") else "plain"
    if -(-kv_len // 128) * 128 > ONEPASS_MAX_KV:
        return long_kernel() or "plain"
    if takes("onepass"):
        return "onepass"
    return "multipass" if takes("multipass") else "plain"


def apply_identity(p: Attention, x: torch.Tensor, *, policy: Policy = FP32,
                   quant: str = "none") -> torch.Tensor:
    """Self-attention with the identity as its attention map: every token
    attends only to itself, so the output is ``out(v(x))``, without q, k,
    scores or softmax.  The perturbed branch of Perturbed-Attention
    Guidance (Ahn et al. 2024; diffusers' ``PAGIdentitySelfAttnProcessor``);
    port of the JAX package's ``apply_identity``."""
    return linear.apply(p.out, linear.apply(p.v, x, policy, quant), policy, quant)


def apply(p: Attention, x: torch.Tensor, context: Optional[torch.Tensor] = None,
          *, n_heads: int, causal: bool = False, backend: str = "plain",
          policy: Policy = FP32, fuse: bool = True, ip=None, return_probs: bool = False,
          quant: str = "none", grid_width: Optional[int] = None):
    """x: (B, S, D); context: (B, S_kv, D_cross) for cross-attention, or a
    ``(ctx_k, ctx_v)`` pair of such tensors (a hypernetwork's, as the JAX
    package takes it), k projected from ``ctx_k`` and v from ``ctx_v``.

    ``ip``: IP-Adapter decoupled attention, ``(layer, tokens, scale)``: the
    4 or 16 image tokens (B, n, D_cross) projected by ``layer``'s bias-free
    ``k`` and ``v``, attended by this layer's q heads with materialized
    scores (never a kernel: the KV is a handful of tokens) and added times
    the tensor ``scale`` before the out projection.

    ``return_probs`` (SAG's capture of the mid block's map): materialized
    scores whatever the backend, as the JAX package's ``_xla_attention``,
    -> (output, probabilities (B, H, S, S_kv) in ``policy.softmax_dtype``);
    :func:`route` never sees such a call.

    ``grid_width``: the width of the token grid x's tokens lie on, which a
    self-attention needs under a row split (module docstring)."""
    tp = getattr(p, "tp_group", None)
    if tp is not None:  # the rank's heads
        n_heads //= torch.distributed.get_world_size(tp)
    if context is None:
        if fuse:
            q, k, v = _fused_proj((p.q, p.k, p.v), x, policy, quant)
        else:
            q, k, v = (linear.apply(m, x, policy, quant) for m in (p.q, p.k, p.v))
    else:
        # a hypernetwork gives k and v contexts of their own (a pair)
        ctx_k, ctx_v = context if isinstance(context, tuple) else (context, context)
        q = linear.apply(p.q, x, policy, quant)
        if fuse and (ctx_v is ctx_k or quant != "w8"):
            # each context through the one fused k/v matmul of the
            # single-context path, k kept from ctx_k's, v from ctx_v's: a
            # pair of equal contexts gives that path's k and v bit for bit
            k, v = _fused_proj((p.k, p.v), ctx_k, policy, quant)
            if ctx_v is not ctx_k:
                v = _fused_proj((p.k, p.v), ctx_v, policy, quant)[1]
        else:
            # the JAX package's unfused path (w8 reaches it with a pair)
            k, v = linear.apply(p.k, ctx_k, policy, quant), linear.apply(p.v, ctx_v, policy,
                                                                        quant)
    split = mesh_mod.row_split() if context is None else None
    if split is not None:  # the whole KV over the rank's q rows
        if grid_width is None:
            raise ValueError("self-attention under a row split needs the grid_width of "
                             "its tokens")
        k, v = mesh_mod.gather_tokens(torch.cat([k, v], -1), grid_width).split(k.shape[-1], -1)
    if return_probs:
        out, probs = materialized_attention(*(_split_heads(t, n_heads) for t in (q, k, v)),
                                            causal, policy, return_probs=True)
        if tp is not None:  # every head's map, in rank order
            parts = [torch.empty_like(probs)
                     for _ in range(torch.distributed.get_world_size(tp))]
            torch.distributed.all_gather(parts, probs.contiguous(), group=tp)
            probs = torch.cat(parts, dim=1)
        if split is not None:  # every q row's map
            probs = mesh_mod.gather_tokens(probs, grid_width, dim=2)
        return linear.apply(p.out, _merge_heads(out), policy, quant), probs
    path = route(k.shape[1], q.shape[-1] // n_heads, causal=causal,
                 cross=context is not None or q.shape[1] != k.shape[1], backend=backend,
                 cuda=q.is_cuda)
    if q.shape[1] == 0:  # a rank with no rows of the grid
        path = "plain"
    if path == "bsc":
        out = flash_attention_bsc(q, k, v, n_heads=n_heads)
    else:
        heads = [_split_heads(t, n_heads) for t in (q, k, v)]  # views, no copy
        if path == "onepass":
            out = flash_attention_onepass(*heads, causal=causal)
        elif path == "streamed":
            out = flash_attention_streamed(*heads)
        elif path == "multipass":
            out = flash_attention_multipass(*heads, causal=causal)
        else:
            out = materialized_attention(*heads, causal, policy)
        out = _merge_heads(out)
    if ip is not None:
        layer, tokens, scale = ip
        k_ip, v_ip = (linear.apply(m, tokens, policy, quant) for m in (layer.k, layer.v))
        if tp is not None:  # the local heads' columns of the replicated k/v
            d, r = q.shape[-1], torch.distributed.get_rank(tp)
            k_ip, v_ip = k_ip[..., r * d:(r + 1) * d], v_ip[..., r * d:(r + 1) * d]
        k_ip, v_ip = _split_heads(k_ip, n_heads), _split_heads(v_ip, n_heads)
        out_ip = materialized_attention(_split_heads(q, n_heads), k_ip, v_ip, False, policy)
        out = out + scale.to(out.dtype) * _merge_heads(out_ip)
    return linear.apply(p.out, out, policy, quant)
