"""Device mesh on ``torch.distributed`` (port of ``core/mesh.py``).

The JAX package is single-controller: one process drives every device and
GSPMD partitions one program over a ``jax.sharding.Mesh``.  The port is
multi-controller: one process a card, started by ``torchrun`` (or any
launcher that sets up the default process group), each running the same
Python code on its own share.  :func:`make_mesh` lays the world out as a
``DeviceMesh`` with dims ``("data", "model")``, the model axis innermost,
so that tensor-parallel ranks are neighbours.

There is no ``replicated`` or ``data_sharded``: placement is per rank.
``parallel/dp.py`` gives each data rank its rows of the batch;
``parallel/tp.py`` gives each model rank its slices of the weights.

:func:`split_batch` marks the process groups over which the current
request's batch is split, so that the few batch-wide reductions (the
int8 tiers' per-tensor activation scale, dpm_adaptive's error norm) are
taken over the whole batch, as GSPMD takes them in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BATCH_GROUPS = contextvars.ContextVar("batch_groups", default=())


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: Optional[int] = None, model: int = 1):
    """A (data, model) ``DeviceMesh`` over the default process group's
    ranks (which must be initialized: ``torchrun`` or
    ``dist.init_process_group``), on "cuda" under NCCL and on "cpu" under
    gloo.  Default: every rank on the data axis."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh():
    """The 1x1 mesh of a world of one process."""
    return make_mesh(data=1, model=1)


def axis_size(mesh, axis: str) -> int:
    return mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def local_batch(global_batch: int, mesh) -> int:
    d = axis_size(mesh, DATA_AXIS)
    if global_batch % d:
        raise ValueError(f"batch {global_batch} not divisible by data axis {d}")
    return global_batch // d


@contextlib.contextmanager
def split_batch(groups: Tuple):
    """Inside the block the request's batch is split over ``groups``."""
    token = _BATCH_GROUPS.set(tuple(groups))
    try:
        yield
    finally:
        _BATCH_GROUPS.reset(token)


def batch_groups() -> Tuple:
    """The process groups over which the current request's batch is split
    (empty on one device)."""
    return _BATCH_GROUPS.get()


def all_reduce_max(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` reduced (MAX) over each group, in place."""
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return t


def all_reduce_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` reduced (SUM) over each group, in place."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t
