"""Sequence (spatial) parallelism, the batch-1 latency mode (port of
``parallel/sp.py``).

Data parallelism (``dp.py``) scales throughput only: one image's denoise
loop still runs on one card.  This mode splits the UNet's work on one
image over the mesh's ``model`` axis by latent rows, so that the cards
share it.  The models stay whole on every rank (no Megatron split, so the
fused q/k/v projection stays on).  The JAX package constrains the UNet
input's sharding and lets GSPMD insert the halo exchanges and the
GroupNorm reductions, with self-attention in a ``shard_map``; eager torch
does each exchange by hand under ``core/mesh.split_rows``, which the
pipeline holds around each UNet and ControlNet evaluation:

* every conv fetches the rows it reads past the rank's own (a halo row
  each side of a 3x3 conv; ``ops/conv.py``), and the int8 tiers' im2col
  sees them too;
* GroupNorm and reference AdaIN add their sums, sums of squares and counts
  over the model group (``ops/norm.py``, ``models/unet.py``);
* self-attention all-gathers K and V and attends the rank's q rows over the
  whole sequence (``ops/attention.py``): K2, K3 or K4, never K1, which
  assumes Sq = Sk; SAG's map is gathered whole;
* the res blocks take the plain conv tier (K5 fetches no halo), FreeU
  filters the whole skip;
* a level the model axis does not divide is cut in ceil-sized blocks, some
  ranks short or empty (``core/mesh.RowSplit``).

Everything outside the evaluations (the samplers, the guidance combines,
the VAE, the text towers) runs on the whole latents on every model rank.
Under a data axis too, each data rank's model group splits its samples'
rows.  On one card, two gloo ranks can share it (``chip_smoke.py``'s H3a
phase): that checks the exchanges, not the latency gain.
"""

from __future__ import annotations

from ..core import mesh as mesh_mod
from .dp import replicate_params


def generate_spatial(prompt, uncond_prompt="", *, mesh, models=None, **kwargs):
    """Single-image (or small-batch) generation with every UNet evaluation
    split over ``mesh``'s model axis by latent rows.  The keywords of
    ``pipeline.generate``; every rank calls it alike and gets the image."""
    from .. import pipeline as pipeline_mod

    models = replicate_params(models, mesh, axes=(mesh_mod.DATA_AXIS, mesh_mod.MODEL_AXIS))
    return pipeline_mod.generate(prompt, uncond_prompt, models=models, mesh=mesh,
                                 sequence_parallel=True, **kwargs)
