"""Named random streams on ``torch.Generator`` (port of ``core/rng.py``).

The JAX package folds a stable role tag (sha256 of the stream name), the
sample index and, for per-step noise, the step index into one root key, so
results do not depend on evaluation order or batch size.  Torch has no
counter-based key, so each (seed, role tag, sample index, step) tuple is
hashed into the seed of its own CPU generator.

Streams: 'latent_init', 'encoder_noise' (per sample), 'sampler' (per
sample and step), and the streams of the samplers that run their own
grids: 'restart' (per sample and op), 'dpm_fast' (per sample and
segment) and 'dpm_adaptive' (per sample and iteration), as in the JAX
package; and 'chunk', whose draw k is the seed of ``generate_many``'s
chunk k > 0 (:func:`chunk_seed`).  A variation seed (slice F) draws its
noise from the 'latent_init' stream of that seed (:func:`variation_normal`),
as the JAX package draws it from ``PRNGKey(variation_seed)``, so that seed
1 at variation strength 1 with ``variation_seed=2`` starts from seed 2's
noise.  All noise of a request is drawn here
on the CPU and copied to the device once: CPU and CUDA generators give
different numbers for one seed, so this makes a seed give the same image
on either device, and the denoise loop never waits on the host.
tests/test_torch_pipeline.py, tests/test_torch_samplers.py and
tests/test_torch_weights.py freeze the first values of each stream.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch

def _tag(name: str) -> int:
    """Stable role tag: sha256(name), as the JAX package derives it."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def stream_seed(seed: int, name: str, index: int = 0,
                step: Optional[int] = None) -> int:
    """64-bit generator seed for one (seed, stream, sample, step) draw."""
    msg = f"{int(seed)}/{_tag(name)}/{int(index)}/{-1 if step is None else int(step)}"
    return int.from_bytes(hashlib.sha256(msg.encode()).digest()[:8], "little")


def chunk_seed(seed: int, k: int) -> int:
    """The seed of ``generate_many``'s chunk ``k``: the request's own for
    chunk 0, so that a call of one chunk equals ``generate_images``, and the
    'chunk' stream's draw ``k`` after it, so that no (seed, k > 0) repeats
    the noise of another seed's chunk 0, as ``seed + k`` would."""
    return int(seed) if k == 0 else stream_seed(seed, "chunk", k)


def generator(seed: int, name: str, index: int = 0,
              step: Optional[int] = None) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(stream_seed(seed, name, index, step))
    return g


def batch_normal(seed: int, name: str, batch: int, shape: Sequence[int],
                 step: Optional[int] = None) -> torch.Tensor:
    """(batch, *shape) float32 standard normal on the CPU; sample i draws
    the same values whatever the batch size."""
    return torch.stack([
        torch.randn(tuple(shape), generator=generator(seed, name, i, step),
                    dtype=torch.float32)
        for i in range(batch)])


def step_normals(seed: int, name: str, n: int, batch: int,
                 shape: Sequence[int]) -> torch.Tensor:
    """(n, batch, *shape): one ``batch_normal`` draw of stream ``name`` per
    step, op, segment or iteration 0..n-1."""
    return torch.stack([batch_normal(seed, name, batch, shape, step=i)
                        for i in range(n)])


def variation_normal(variation_seed: int, batch: int, shape: Sequence[int]) -> torch.Tensor:
    """(batch, *shape): the initial noise of ``variation_seed``, its
    'latent_init' stream, which ``pipeline.slerp_noise`` blends into the
    request's own."""
    return batch_normal(variation_seed, "latent_init", batch, shape)
