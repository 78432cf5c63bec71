"""ControlNet hint preprocessors ("annotators") in numpy: a copy of the JAX
package's ``utils/annotators.py``.

  canny       full Canny: gaussian -> Sobel -> non-maximum suppression ->
              double threshold -> hysteresis
  lineart     Sobel magnitude, white lines on black
  scribble    thresholded edges thickened by dilation
  invert      1 - x
  blur        gaussian blur (also the pipeline's ``mask_blur`` and the
              API's ``masked_content="fill"``)
  hint_rgb    a (H, W) map in [0, 1] -> the (H, W, 3) uint8 image that
              ``control_image`` / ``adapter_image`` take

All take and return float arrays in [0, 1]; ``to_hint`` adapts any uint8
or PIL input.  Importing the original would run the JAX package's
``__init__`` and so import jax, so the port keeps its own copy: below this
docstring it is the original's text, which tests/test_torch_import.py
holds it to.
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


def _sobel(g: np.ndarray):
    p = np.pad(g, 1, mode="reflect")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2.0 \
        + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2])
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2.0 \
        + (p[2:, :-2] - p[:-2, :-2]) + (p[2:, 2:] - p[:-2, 2:])
    return gx, gy


def lineart(image) -> np.ndarray:
    """Sobel-magnitude line drawing, white lines on black (the ControlNet
    lineart convention after inversion of a pencil sketch)."""
    gx, gy = _sobel(to_hint(image))
    mag = np.hypot(gx, gy)
    m = mag.max()
    return mag / m if m > 0 else mag


def invert(image) -> np.ndarray:
    return 1.0 - to_hint(image)


def scribble(image, threshold: float = 0.25, thickness: int = 1) -> np.ndarray:
    """Binary thick edges (the scribble/softedge hint family)."""
    e = (lineart(image) > threshold).astype(np.float32)
    for _ in range(thickness):
        p = np.pad(e, 1, mode="constant")
        e = np.maximum.reduce([p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1],
                               p[1:-1, :-2], p[1:-1, 2:]])
    return e


def canny(image, low: float = 0.1, high: float = 0.2,
          sigma: float = 1.4) -> np.ndarray:
    """Full Canny edge detection -> binary (H, W) float in {0, 1}.

    Thresholds are on the normalized gradient magnitude (cv2.Canny's
    100/200 over uint8 gradients ≈ 0.1/0.2 here).
    """
    g = blur(image, sigma)
    gx, gy = _sobel(g)
    mag = np.hypot(gx, gy)
    m = mag.max()
    if m > 0:
        mag = mag / m
    ang = np.arctan2(gy, gx)  # [-pi, pi]

    # non-maximum suppression: quantize gradient direction to 4 sectors
    sector = ((np.round(ang / (np.pi / 4.0)).astype(int)) % 4)
    p = np.pad(mag, 1, mode="constant")
    c = p[1:-1, 1:-1]
    neigh = [
        (p[1:-1, 2:], p[1:-1, :-2]),   # 0:   horizontal gradient -> E/W
        (p[2:, 2:], p[:-2, :-2]),      # 45
        (p[2:, 1:-1], p[:-2, 1:-1]),   # 90:  vertical
        (p[2:, :-2], p[:-2, 2:]),      # 135
    ]
    keep = np.zeros_like(c, bool)
    for s, (a, b) in enumerate(neigh):
        keep |= (sector == s) & (c >= a) & (c >= b)
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong

    # hysteresis: BFS from strong edges through weak ones
    edges = strong.copy()
    frontier = strong
    while frontier.any():
        p = np.pad(frontier, 1, mode="constant")
        grown = (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
                 | p[1:-1, :-2] | p[1:-1, 2:]
                 | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])
        frontier = grown & weak & ~edges
        edges |= frontier
    return edges.astype(np.float32)


def hint_rgb(hint2d: np.ndarray) -> np.ndarray:
    """(H, W) [0,1] map -> (H, W, 3) uint8 hint image for the pipeline's
    ``control_image`` argument."""
    h = np.clip(np.asarray(hint2d, np.float32), 0.0, 1.0)
    return np.repeat((h * 255.0).astype(np.uint8)[..., None], 3, axis=-1)
