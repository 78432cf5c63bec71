"""Token merging for Stable Diffusion (ToMe; Bolya & Hoffman 2023, ``tomesd``
semantics), port of ``ops/tome.py``.

Before a large self-attention, the ``ratio`` most redundant tokens are
merged into their most similar neighbours, attention runs over the reduced
sequence, and the outputs are unmerged (a merged token copies its
destination's output).  Every shape is static: the merge count ``r`` comes
from the block's grid and the ratio (:func:`plan`, pure numpy: a verbatim
copy of the JAX package's, which tests/test_torch_import.py holds).

  * dst tokens: the top-left member of every ``sx`` x ``sy`` cell (tomesd's
    ``use_rand=False``); src tokens: every other one;
  * bipartite soft matching: each src token's best cosine similarity to any
    dst, the ``r`` most similar src tokens merged (mean) into their best
    dst; ties keep the lower src position first (a stable sort, as
    ``jnp.argsort`` sorts);
  * unmerge: the dst outputs copied back to the tokens merged into them.

The mean-merge is deterministic on the card: the JAX package's scatter-add
(``.at[].add``) would become ``index_add_``, whose CUDA atomics add in a
different order from run to run.  Here the sums are a one-hot (B, n_dst, r)
product with the merged values, a matmul, which adds in a fixed order, and
the counts the one-hot's row sums (exact small integers).  Every other step
is a gather: the unmerge inverts the sort's and the plan's permutations
rather than scattering.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def plan(h: int, w: int, sx: int = 2, sy: int = 2,
         ratio: float = 0.5) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static merge plan for an (h, w) token grid.

    Returns ``(dst_idx, src_idx, r)``: flat token indices of the dst set
    (one per stride cell, top-left member) and the src set (everything
    else), and the merge count ``r = floor(h*w * ratio)`` — the tomesd /
    A1111 "Token merging ratio" convention counts the TOTAL tokens (a
    review finding: ``ratio * len(src)`` under-merged by 25% at the 2x2
    stride), clamped to the src count like tomesd.
    """
    if h % sy or w % sx:
        raise ValueError(f"token grid {h}x{w} not divisible by the ToMe "
                         f"stride {sy}x{sx}")
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flat = (ii * w + jj).ravel()
    is_dst = ((ii % sy == 0) & (jj % sx == 0)).ravel()
    dst_idx = flat[is_dst]
    src_idx = flat[~is_dst]
    r = int(h * w * ratio)
    return dst_idx, src_idx, max(0, min(r, len(src_idx) - 1))


def _indices(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array on ``device``; to a card through pinned memory
    without blocking, so that the host does not wait for the queued work."""
    t = torch.from_numpy(np.ascontiguousarray(idx, np.int64))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) at the per-sample token indices idx (B, K) -> (B, K, C)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def merge(x: torch.Tensor, dst_idx, src_idx, r: int):
    """x: (B, N, C) -> merged (B, N - r, C) and the unmerge info.

    The merged layout is ``[unmerged src (n_src - r), dst (n_dst)]``.
    Matching metric: cosine similarity of ``x`` itself in fp32."""
    b, n, c = x.shape
    n_src = len(src_idx)
    order_in = _indices(np.concatenate([src_idx, dst_idx]), x.device)
    xs_all = x.index_select(1, order_in)
    src, dst = xs_all[:, :n_src], xs_all[:, n_src:]
    xs, xd = src.float(), dst.float()
    xs = xs / torch.clamp(torch.linalg.vector_norm(xs, dim=-1, keepdim=True), min=1e-6)
    xd = xd / torch.clamp(torch.linalg.vector_norm(xd, dim=-1, keepdim=True), min=1e-6)
    scores = torch.matmul(xs, xd.transpose(1, 2))   # (B, n_src, n_dst)
    best = scores.amax(dim=-1)                       # best-dst similarity
    best_dst = scores.argmax(dim=-1)                 # that dst (the first of ties)
    # the r most redundant src tokens, in descending similarity
    order = torch.argsort(-best, dim=-1, stable=True)
    merged_sel, kept_sel = order[:, :r], order[:, r:]
    kept = _take(src, kept_sel)
    m_vals = _take(src, merged_sel)
    m_dst = best_dst.gather(1, merged_sel)           # (B, r)
    # mean-merge into dst, in a fixed order of adds: a one-hot product
    onehot = torch.nn.functional.one_hot(m_dst, dst.shape[1]).transpose(1, 2)
    sums = torch.matmul(onehot.to(dst.dtype), m_vals)
    cnt = onehot.sum(dim=-1, dtype=torch.float32)    # (B, n_dst)
    dst_m = (dst + sums) / (1.0 + cnt)[..., None].to(dst.dtype)
    out = torch.cat([kept, dst_m], dim=1)
    info = {"order": order, "m_dst": m_dst, "n_src": n_src, "r": r,
            "unperm": _indices(np.argsort(np.concatenate([src_idx, dst_idx])), x.device),
            "merged_sel": merged_sel, "kept_sel": kept_sel}
    return out, info


def unmerge(y: torch.Tensor, info) -> torch.Tensor:
    """y: (B, N - r, C), attention's output in the merged layout -> (B, N,
    C): every token its own output, a merged token its destination's."""
    n_src, r = info["n_src"], info["r"]
    kept_y, dst_y = y[:, :n_src - r], y[:, n_src - r:]
    merged_y = _take(dst_y, info["m_dst"])
    # src outputs in the sort's order, back to src positions, then [src, dst]
    # back to token positions
    src_y = _take(torch.cat([merged_y, kept_y], dim=1), torch.argsort(info["order"], dim=-1))
    return torch.cat([src_y, dst_y], dim=1).index_select(1, info["unperm"])
