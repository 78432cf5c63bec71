"""Tensor parallelism over the mesh's ``model`` axis (port of
``parallel/tp.py``).

Megatron-style column-then-row sharding of the transformer matmuls, as
the JAX package's parameter PartitionSpecs lay it out:

* q/k/v and the FFN's up-projection (the UNet's ``geglu_proj``, CLIP's
  ``fc1``) are column-parallel: each rank holds its output channels, so
  its heads and hidden units, and needs no communication on entry;
* ``out`` and the down-projection (``geglu_out``, ``fc2``) are
  row-parallel: each rank contracts its input slice, one
  ``all_reduce(SUM)`` a layer sums the parts, and the bias is added after
  the sum.

This holds for the UNet (``diffusion``) and the text towers (``clip``,
``clip2``); the VAE, the side nets and the motion modules stay
replicated.  ``geglu_proj``'s output is the value half then the gate half,
so a rank holds the same slice of each.

The JAX package writes only the specs and lets GSPMD insert the
collectives; in eager torch the layers do it themselves: a sharded
attention module and a row-parallel linear carry the model group as
``tp_group`` (``ops/attention.py``, ``ops/linear.py``), the attention then
runs at the local head count (K1 takes it as it stands), and under w8a8 a
row-parallel layer reduces its scales and int32 sums over the group
(``ops/quant.py``).  Where a layer's head count or FFN width does not
divide by the model axis, the layer stays replicated: it computes the
same numbers (GSPMD would pad instead).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..core import mesh as mesh_mod

COL, GEGLU, ROW = "col", "geglu", "row"

#: spec per attention leaf: column-parallel projections, row-parallel out;
#: ``out.bias`` stays replicated (added after the sum)
_ATTN_LEAF = {"q.weight": COL, "k.weight": COL, "v.weight": COL,
              "q.bias": COL, "k.bias": COL, "v.bias": COL, "out.weight": ROW}
#: the models tensor parallelism shards
SHARDED = ("diffusion", "clip", "clip2")


def tp_spec(model_name: str, key: str) -> Optional[str]:
    """The split of ONE port parameter (``COL``: output channels,
    ``GEGLU``: output channels of each half, ``ROW``: input channels, None:
    replicated), from its name alone: usable without the model (the
    streamed loader, ``weights/stream.py``, slices each tensor as it reads
    it).  :func:`layer_divides` says whether the layer takes it."""
    leaf = ".".join(key.rsplit(".", 2)[-2:])
    if model_name == "diffusion":
        if ".self_attn." in key or ".cross_attn." in key:
            return _ATTN_LEAF.get(leaf)
        if leaf in ("geglu_proj.weight", "geglu_proj.bias"):
            return GEGLU
        if leaf == "geglu_out.weight":
            return ROW
    elif model_name in ("clip", "clip2"):
        if ".attn." in key:
            return _ATTN_LEAF.get(leaf)
        if leaf in ("fc1.weight", "fc1.bias"):
            return COL
        if leaf == "fc2.weight":
            return ROW
    return None


def layer_divides(model_cfg, key: str, shape, n_model: int) -> bool:
    """Whether the layer of parameter ``key`` (of ``shape``) splits evenly
    over ``n_model`` ranks: an attention's head count, an FFN's hidden
    width.  ``model_cfg``: the model's ``UNetConfig`` or ``CLIPConfig``."""
    leaf = ".".join(key.rsplit(".", 2)[-2:])
    if leaf.startswith(("geglu_proj.", "fc1.")):
        width = shape[0] // 2 if leaf.startswith("geglu") else shape[0]
    elif leaf.startswith(("geglu_out.", "fc2.")):
        width = shape[1]
    else:  # q/k/v/out: shape[0] is the attention's width
        width = model_cfg.heads_for(shape[0]) if hasattr(model_cfg, "heads_for") \
            else model_cfg.n_heads
    return width % n_model == 0


def take(spec: str, x: torch.Tensor, rank: int, n_model: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` (a weight (out, in) or a bias) under
    ``spec``, a view."""
    if spec == COL:
        return x.chunk(n_model, 0)[rank]
    if spec == GEGLU:
        value, gate = x.chunk(2, 0)
        return torch.cat([value.chunk(n_model, 0)[rank], gate.chunk(n_model, 0)[rank]])
    return x.chunk(n_model, 1)[rank]


def model_spec(name: str, model_cfg, key: str, shape, n_model: int) -> Optional[str]:
    """:func:`tp_spec` where the layer divides over ``n_model`` ranks, else
    None (replicated)."""
    spec = tp_spec(name, key)
    if spec is None or n_model == 1 or not layer_divides(model_cfg, key, shape, n_model):
        return None
    return spec


def _shard(model: nn.Module, name: str, group, rank: int, n_model: int) -> nn.Module:
    """A copy of ``model`` whose column- and row-parallel parameters are the
    rank's slices (contiguous copies), the others shared with ``model``,
    and whose sharded attention modules and row-parallel linears carry
    ``tp_group``; works on the ``meta`` device too."""
    out = copy.deepcopy(model, memo={id(p): p for p in model.parameters()})
    for key, p in list(out.named_parameters()):
        spec = model_spec(name, out.cfg, key, p.shape, n_model)
        if spec is None:
            continue
        owner_path, leaf = key.rsplit(".", 1)
        owner = out.get_submodule(owner_path)
        setattr(owner, leaf, nn.Parameter(take(spec, p.data, rank, n_model).clone(),
                                          requires_grad=False))
        if spec == ROW:
            owner.tp_group = group
        if key.endswith(".q.weight"):  # the attention module: its local heads
            out.get_submodule(owner_path.rsplit(".", 1)[0]).tp_group = group
    out.tp_group = group
    return out


def shard_models(models, mesh):
    """The models with the UNet and the text towers sharded over the mesh's
    model axis (the rank's slices); every other entry as it is.  With a
    model axis of 1 this is the models themselves (the DP layout)."""
    n_model = mesh_mod.axis_size(mesh, mesh_mod.MODEL_AXIS)
    if n_model == 1:
        return models
    group = mesh_mod.axis_group(mesh, mesh_mod.MODEL_AXIS)
    rank = mesh_mod.axis_rank(mesh, mesh_mod.MODEL_AXIS)
    return {name: _shard(m, name, group, rank, n_model)
            if name in SHARDED and getattr(m, "tp_group", None) is None else m
            for name, m in models.items()}


def assemble(cfg, state_dicts, mesh):
    """Models around sharded state dicts (``weights/stream.py`` with
    ``tp=True``): the models built on ``meta``, sharded as
    :func:`shard_models` shards them, then loaded with no copy."""
    from ..models import _finish, construct

    n_model = mesh_mod.axis_size(mesh, mesh_mod.MODEL_AXIS)
    group = mesh_mod.axis_group(mesh, mesh_mod.MODEL_AXIS) if n_model > 1 else None
    rank = mesh_mod.axis_rank(mesh, mesh_mod.MODEL_AXIS)
    out = {}
    for name, m in construct(cfg).items():
        if name not in state_dicts:
            continue
        if name in SHARDED and n_model > 1:
            m = _shard(m, name, group, rank, n_model)
        sd = state_dicts[name]
        m.load_state_dict(sd, strict=True, assign=True)
        _finish(m, next(iter(sd.values())).device)
        out[name] = m
    return out


def generate_images_tp(prompts, uncond_prompts="", *, mesh, models=None, **kwargs):
    """Batched generation with TP (and DP where the data axis > 1): the
    models sharded over the model axis, the batch split over the data axis.
    Every rank calls it alike and gets all the images (B, H, W, 3) uint8."""
    from .. import pipeline as pipeline_mod

    models = shard_models(models, mesh)
    images, _ = pipeline_mod._run_generate(list(prompts), uncond_prompts, models=models,
                                           mesh=mesh, **kwargs)
    return images
