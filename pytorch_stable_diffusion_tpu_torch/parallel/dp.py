"""Data-parallel generation over the mesh's ``data`` axis (port of
``parallel/dp.py``).

Generation is embarrassingly data-parallel: every rank holds the whole
models and runs its rows of the batch (``pipeline._run_on_mesh``); the
images are gathered at the end.  A sample's noise is drawn at its index in
the whole batch (``core/rng.py``), so sample i gets the same noise on any
layout, and the batch-wide reductions (the int8 tiers' per-tensor
activation scale, dpm_adaptive's error norm) are reduced over the data
group: the images equal the single-device ones.

The JAX package places one host copy of the weights on every device; here
each process loads or builds its own copy, and :func:`replicate_params`
checks that the copies agree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import mesh as mesh_mod


def _checksum(models) -> torch.Tensor:
    """Per parameter, its float64 sum and sum of squares, in model order."""
    sums = []
    for name in sorted(models):
        nets = models[name] if isinstance(models[name], (list, tuple)) else [models[name]]
        for net in nets:
            if isinstance(net, torch.nn.Module):
                for p in net.parameters():
                    d = p.detach().double()
                    sums.append(torch.stack([d.sum(), d.square().sum()]))
    return torch.cat(sums) if sums else torch.zeros(0, dtype=torch.float64)


def replicate_params(models, mesh, axes=(mesh_mod.DATA_AXIS,)):
    """Check that every rank of each of the mesh's ``axes`` holds the same
    weights (a checksum of each parameter, gathered over the axis's
    group); raises ``ValueError`` where one differs.  Returns ``models``.
    Sequence parallelism (``parallel/sp.py``) checks the model axis too."""
    mine = None
    for axis in axes:
        if mesh_mod.axis_size(mesh, axis) == 1:
            continue
        group = mesh_mod.axis_group(mesh, axis)
        if mine is None:
            mine = _checksum(models).to(mesh.device_type)
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        for r, other in enumerate(parts):
            if not torch.equal(other, parts[0]):
                raise ValueError(f"{axis} rank {r} holds other weights than {axis} rank 0: "
                                 "every rank must load or build the same models")
    return models


def generate_images_dp(prompts, uncond_prompts="", *, mesh=None, models=None, **kwargs):
    """Batched txt2img/img2img split over the mesh's data axis.

    ``len(prompts)`` must divide by the data-axis size.  Every rank calls it
    alike and gets all the images (B, H, W, 3) uint8, equal to the
    single-device ones for the same seed."""
    from .. import pipeline as pipeline_mod

    mesh = mesh or mesh_mod.make_mesh()
    models = replicate_params(models, mesh)
    images, _ = pipeline_mod._run_generate(list(prompts), uncond_prompts, models=models,
                                           mesh=mesh, **kwargs)
    return images
