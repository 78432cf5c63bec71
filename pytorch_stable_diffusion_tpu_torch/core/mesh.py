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

Sequence parallelism (``parallel/sp.py``) splits the rows of every UNet
level over the model group instead: :func:`split_rows` holds a
:class:`RowSplit` around each UNet (and ControlNet) evaluation, and the
ops read it to exchange what GSPMD exchanges in the JAX package: the
rows a conv reads past the rank's own (:func:`fetch_rows`), the
GroupNorm and AdaIN moments (:func:`split_var_mean`), and self-attention's
K and V (:func:`gather_tokens`).  Every rank holds the whole latents
outside those evaluations.  The int8 tiers' activation scale reduces over
the batch's groups and the rows' (:func:`reduce_groups`); dpm_adaptive's
error norm, a sum over latents every model rank holds whole, over the
batch's only (:func:`batch_groups`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BATCH_GROUPS = contextvars.ContextVar("batch_groups", default=())
_ROWS = contextvars.ContextVar("row_split", default=None)


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


def reduce_groups() -> Tuple:
    """The process groups over which a tensor inside a UNet evaluation is
    split: the batch's (:func:`batch_groups`) and, under a row split, the
    rows' model group.  A MAX over them is the whole tensor's."""
    split = _ROWS.get()
    return batch_groups() + (() if split is None else (split.group,))


def agree_max(values: Sequence[int], mesh) -> List[int]:
    """Each of ``values`` reduced (MAX) over ``mesh``'s data group: what a
    data rank decides from its rows alone, decided from the whole batch.
    ``mesh`` None or one data rank: the values as they are."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis_group(mesh, DATA_AXIS))
    return t.tolist()


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


# ------------------------------------------------------------- row split (SP)
@dataclasses.dataclass(frozen=True)
class RowSplit:
    """Sequence parallelism's split of the UNet's rows over ``group``.

    Every level's rows are cut in ceil-sized blocks: of a level of H rows,
    rank r holds rows ``[r*b, (r+1)*b) ∩ [0, H)`` with ``b = ceil(H /
    size)``, so that some ranks may be short or empty where the model axis
    does not divide a level.  One rule at every level keeps the encoder's
    skips and the decoder's features on the same rows.  A level's H is
    read from its width, which is not split: ``H = height * w / width``
    (``height`` and ``width`` are the latents').  ``device_type`` is where
    the collectives run: "cuda" under NCCL, "cpu" under gloo (ranks that
    compute on a card then exchange through the host)."""

    group: object
    rank: int
    size: int
    height: int
    width: int
    device_type: str

    def level_rows(self, w: int) -> int:
        h, rest = divmod(self.height * w, self.width)
        if rest:
            raise ValueError(f"a level {w} wide is not a level of a {self.height}x"
                             f"{self.width} latent grid")
        return h

    def span(self, rows: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """The global rows ``[lo, hi)`` that ``rank`` (default: this one)
        holds of a level of ``rows`` rows."""
        b = -(-rows // self.size)
        r = self.rank if rank is None else rank
        return min(r * b, rows), min((r + 1) * b, rows)

    def spans(self, rows: int) -> List[Tuple[int, int]]:
        return [self.span(rows, r) for r in range(self.size)]


def model_rows(mesh, height: int, width: int) -> RowSplit:
    """The :class:`RowSplit` of ``mesh``'s model axis for a latent grid of
    ``height`` x ``width``."""
    return RowSplit(group=axis_group(mesh, MODEL_AXIS), rank=axis_rank(mesh, MODEL_AXIS),
                    size=axis_size(mesh, MODEL_AXIS), height=height, width=width,
                    device_type=mesh.device_type)


@contextlib.contextmanager
def split_rows(split: Optional[RowSplit]):
    """Inside the block the UNet's rows are split as ``split`` says (None:
    not split)."""
    token = _ROWS.set(split)
    try:
        yield
    finally:
        _ROWS.reset(token)


def row_split() -> Optional[RowSplit]:
    """The current :class:`RowSplit`, or None outside :func:`split_rows`."""
    return _ROWS.get()


def _wire(t: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """``t`` as the collective sends it: on its device type, contiguous,
    bf16 as bytes under gloo (a gather moves bytes; gloo takes neither bf16
    nor int16), its last dim then twice as long."""
    t = t.to(split.device_type).contiguous()
    if t.dtype == torch.bfloat16 and split.device_type == "cpu":
        t = t.view(torch.uint8)
    return t


def gather_pieces(x: torch.Tensor, dim: int, counts: Sequence[int],
                  split: Optional[RowSplit] = None) -> torch.Tensor:
    """Every rank's piece of a tensor cut along ``dim`` (rank r's holds
    ``counts[r]`` entries there), joined in rank order on x's device.
    ``dim`` is not the last dim, along which bf16 crosses gloo as bytes."""
    split = split or _ROWS.get()
    most = max(counts)
    if x.shape[dim] < most:
        pad = list(x.shape)
        pad[dim] = most - x.shape[dim]
        x_send = torch.cat([x, x.new_zeros(pad)], dim)
    else:
        x_send = x
    t = _wire(x_send, split)
    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t, group=split.group)
    whole = torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim)
    if whole.dtype != x.dtype:
        whole = whole.view(x.dtype)
    return whole.to(x.device)


def gather_rows(x: torch.Tensor, split: Optional[RowSplit] = None) -> torch.Tensor:
    """The whole (N, C, H, W) level from every rank's rows of it."""
    split = split or _ROWS.get()
    rows = split.level_rows(x.shape[-1])
    return gather_pieces(x, 2, [hi - lo for lo, hi in split.spans(rows)], split)


def gather_tokens(t: torch.Tensor, width: int, dim: int = 1,
                  split: Optional[RowSplit] = None) -> torch.Tensor:
    """The whole token sequence of a level ``width`` tokens wide (row-major
    tokens along ``dim``) from every rank's rows of it."""
    split = split or _ROWS.get()
    rows = split.level_rows(width)
    return gather_pieces(t, dim, [(hi - lo) * width for lo, hi in split.spans(rows)], split)


def local_rows(x: torch.Tensor, split: Optional[RowSplit] = None) -> torch.Tensor:
    """This rank's rows of a whole (N, C, H, W) level."""
    split = split or _ROWS.get()
    lo, hi = split.span(x.shape[2])
    return x[:, :, lo:hi]


def fetch_rows(x: torch.Tensor, needs: Sequence[Sequence[int]], *,
               circular: bool = False) -> torch.Tensor:
    """The global rows ``needs[rank]`` of the level whose rows this rank
    holds as ``x`` (N, C, h, W), in that order: zeros for a row outside the
    level, or the row it wraps to under ``circular``.  ``needs`` lists
    every rank's rows, so that every rank takes the same collective: where
    each needed row is the rank's own or the first or last row of another
    rank (a 3x3 conv's halo on aligned levels), one all-gather of every
    rank's first and last rows; otherwise (a level the model axis does not
    divide, read across a stride or an upsample) an all-gather of the
    whole level."""
    split = _ROWS.get()
    rows = split.level_rows(x.shape[-1])
    spans = split.spans(rows)
    lo, hi = spans[split.rank]

    def wrap(g):
        if circular:
            return g % rows
        return g if 0 <= g < rows else None

    edge = {}
    for r, (a, b) in enumerate(spans):
        if b > a:
            edge.setdefault(a, 2 * r)
            edge.setdefault(b - 1, 2 * r + 1)
    by_edges = all(g is None or spans[r][0] <= g < spans[r][1] or g in edge
                   for r, need in enumerate(needs) for g in map(wrap, need))
    zero = x.new_zeros(x.shape[:2] + (1, x.shape[3]))
    if by_edges:
        ends = torch.cat([x[:, :, :1], x[:, :, -1:]], 2) if hi > lo else \
            x.new_zeros(x.shape[:2] + (2, x.shape[3]))
        parts = gather_pieces(ends, 2, [2] * split.size, split)

        def source(g):
            if g is None:
                return zero, 0
            return (x, g - lo) if lo <= g < hi else (parts, edge[g])
    else:
        whole = gather_rows(x, split)

        def source(g):
            return (zero, 0) if g is None else (whole, g)
    # runs of consecutive rows of one tensor joined as slices: an index
    # tensor's copy to the card would wait for the work queued before it
    runs = []
    for g in needs[split.rank]:
        t, i = source(wrap(g))
        if runs and t is not zero and runs[-1][0] is t and sum(runs[-1][1:]) == i:
            runs[-1][2] += 1
        else:
            runs.append([t, i, 1])
    if not runs:
        return x[:, :, :0]
    return torch.cat([t.narrow(2, i, n) for t, i, n in runs], 2)


def split_var_mean(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.var_mean(x, dims, unbiased=False)``, taken over every rank's
    part of the tensor under a row split: the sums, sums of squares and
    counts added over the model group in float64, in one all-reduce."""
    split = _ROWS.get()
    if split is None:
        return torch.var_mean(x, dim=dims, unbiased=False)
    xd = x.double()
    count = math.prod(x.shape[d] for d in dims)
    s1 = xd.sum(dim=dims)
    moments = torch.stack([s1, xd.square().sum(dim=dims), torch.full_like(s1, count)])
    t = moments.to(split.device_type)
    dist.all_reduce(t, group=split.group)
    t = t.to(x.device)
    mean = t[0] / t[2]
    var = torch.clamp(t[1] / t[2] - mean.square(), min=0.0)
    return var.to(x.dtype), mean.to(x.dtype)
