"""Quality metrics (a copy of the JAX package's ``utils/metrics.py`` below
this docstring, which ``tests/test_torch_parallel.py`` holds verbatim):
PSNR of latents or float images (peak max |a|), of uint8 images (peak
255), and the mean absolute error of latents.  Pure numpy.
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = None) -> float:
    """Peak signal-to-noise ratio in dB.

    peak defaults to max(|a|) for latents/float images; pass 255 for uint8
    images (the conventional image-PSNR definition).
    """
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    if peak is None:
        peak = max(float(np.abs(a).max()), 1e-12)
    return 10.0 * np.log10(peak**2 / max(mse, 1e-30))


def image_psnr(a, b) -> float:
    """PSNR for uint8 HWC images (peak 255)."""
    return psnr(np.asarray(a, np.float64), np.asarray(b, np.float64), peak=255.0)


def latent_mae(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b)))
