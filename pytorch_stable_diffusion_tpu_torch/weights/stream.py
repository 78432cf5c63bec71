"""Streamed checkpoint loading: tensor by tensor from the file to the
device (port of ``weights/stream.py``).

``convert.load_sd_checkpoint`` reads the whole source state dict into host
memory before converting it (~2.1 GB for an fp16 SD-1.5 file, then
``build_models`` copies it to the device).  This module walks the same
converter rules ONE TENSOR AT A TIME:

    read from the file mapping -> layout -> dtype cast -> copy to the
    device -> host copy released

so host memory holds one tensor at a time, and each one lands in its
final place: the returned state dicts are on the device in
``cfg.policy.param_dtype``, ready for ``models.assemble`` (no second
copy).  ``.safetensors`` streams through the native reader's memory map;
``.ckpt`` has no random-access container, so it is read eagerly first (the
placement is still per tensor), as in the JAX package.

``mesh=`` (slice H2, ``core/mesh.py``): each rank loads its own copy onto
its device (a DP replica); with ``tp=True`` it reads only its own slices
of the tensors that tensor parallelism splits over the mesh's model axis
(``parallel/tp.model_spec``: q/k/v and the FFN's up-projection by output
channels, ``out`` and the down-projection by input channels, where the
layer divides), so the returned state dicts hold local shapes:
``parallel/tp.assemble(cfg, state_dicts, mesh)`` builds the models
around them.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..models.config import SDConfig
from . import convert as convert_mod


def _lazy_state_dict(path: str, allow_unsafe_fallback: bool) -> Mapping:
    p = str(path)
    if p.endswith(".safetensors"):
        from . import native_io

        return native_io.SafetensorsFile(p)
    # .ckpt: zip-of-pickle has no per-tensor random access — eager read
    return convert_mod.load_state_dict(p, allow_unsafe_fallback=allow_unsafe_fallback)


def load_sd_checkpoint_streamed(path: str, cfg: SDConfig, *, device=None, mesh=None,
                                tp: bool = False, allow_unsafe_fallback: bool = False):
    """File path -> port state dicts on ``device`` (the card unless the
    caller names another; without a card this raises), streamed.

    Returns what ``convert.load_sd_checkpoint`` returns, with the same
    coverage guarantees (both directions, by ``convert``), but every tensor
    already on the device in ``cfg.policy.param_dtype``; with ``mesh`` and
    ``tp=True``, the rank's slices of the tensors tensor parallelism splits."""
    if tp and mesh is None:
        raise ValueError("tp=True needs a mesh (its model axis)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_sd_checkpoint_streamed: no CUDA device; pass "
                               "device='cpu' to load onto the CPU")
        device = "cuda"
    device = torch.device(device)
    dtype = cfg.policy.param_dtype

    def place(name, key, x):
        return x.to(device=device, dtype=dtype)

    if tp:
        from ..core.mesh import MODEL_AXIS, axis_rank, axis_size
        from ..parallel import tp as tp_mod

        n_model, rank = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
        model_cfgs = {"diffusion": cfg.unet, "clip": cfg.clip, "clip2": cfg.clip2}

        def place(name, key, x):  # noqa: F811 (the rank's slice, read alone)
            spec = None if name not in tp_mod.SHARDED else tp_mod.model_spec(
                name, model_cfgs[name], key, x.shape, n_model)
            if spec is not None:
                x = tp_mod.take(spec, x, rank, n_model)
            return x.to(device=device, dtype=dtype).contiguous()

    src = _lazy_state_dict(path, allow_unsafe_fallback)
    try:
        return convert_mod.convert(src, cfg, place=place)
    finally:
        if hasattr(src, "close"):
            src.close()
