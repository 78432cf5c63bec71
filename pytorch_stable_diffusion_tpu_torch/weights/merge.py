"""Checkpoint merging, the A1111 "Checkpoint Merger" tab's two modes (port
of ``weights/merge.py``).

Pure weight transforms over already-loaded models, so merges compose with
every loader and format; each parameter is computed in fp32 on the models'
device and cast back to its own dtype.
"""

from __future__ import annotations

from ..models import MODEL_NAMES, assemble
from ..models.config import SDConfig


def merge_models(a, b, cfg: SDConfig, alpha: float = 0.5, c=None):
    """Weighted-sum merge ``(1-alpha)·A + alpha·B``, or — with ``c`` —
    add-difference ``A + alpha·(B − C)``.

    ``a``/``b``/``c`` are models dicts of one architecture (``cfg``); the
    SD models that ``a`` holds (``clip2`` with SDXL) are merged and returned
    as new models.
    Arithmetic runs in fp32 and casts back to A's parameter dtypes."""
    alpha = float(alpha)
    out = {}
    for name in (n for n in MODEL_NAMES if n in a):
        sa, sb = a[name].state_dict(), b[name].state_dict()
        sc = None if c is None else c[name].state_dict()
        merged = {}
        for k, x in sa.items():
            y = sb[k].to(x.device)
            if sc is None:
                m = (1.0 - alpha) * x.float() + alpha * y.float()
            else:
                m = x.float() + alpha * (y.float() - sc[k].to(x.device).float())
            merged[k] = m.to(x.dtype)
        out[name] = merged
    return assemble(cfg, out)
