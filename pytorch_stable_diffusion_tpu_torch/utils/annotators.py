"""Gaussian blur of a grayscale map in numpy (a copy of ``blur`` of the JAX
package's ``utils/annotators.py`` and the two helpers it calls).

The pipeline blurs an inpainting mask with it (``mask_blur``) and the API
seeds ``masked_content="fill"`` with it.  Importing the original would run
the JAX package's ``__init__`` and so import jax; the rest of that module
(the ControlNet hint annotators) comes with slice E.
tests/test_torch_import.py holds the copy to the original.
"""

from __future__ import annotations

import numpy as np


def to_hint(image) -> np.ndarray:
    """PIL / uint8 / float image -> (H, W) float grayscale in [0, 1]."""
    arr = np.asarray(image, np.float32)
    if arr.ndim == 3:
        arr = arr[..., :3] @ np.asarray([0.299, 0.587, 0.114], np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return np.clip(arr, 0.0, 1.0)


def _gauss_kernel(sigma: float):
    r = max(int(3.0 * sigma), 1)
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur(image, sigma: float = 2.0) -> np.ndarray:
    """Separable gaussian blur with reflect padding."""
    g = to_hint(image)
    k = _gauss_kernel(sigma)
    r = len(k) // 2
    p = np.pad(g, r, mode="reflect")
    p = np.apply_along_axis(lambda row: np.convolve(row, k, "valid"), 1, p)
    p = np.apply_along_axis(lambda col: np.convolve(col, k, "valid"), 0, p)
    return np.clip(p, 0.0, 1.0)
