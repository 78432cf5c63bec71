"""The SD models and how to build them.

``build_models`` constructs CLIP (and SDXL's second tower, ``clip2``), the
VAE encoder/decoder and the UNet on
the ``meta`` device, materializes them on the target device, and fills
them either from port state dicts (``weights/convert.py``) or with random
weights from an explicit ``torch.Generator`` (the JAX init's distributions:
uniform ±1/sqrt(fan_in) for linears/convs, N(0, 0.02) token embedding,
ones/zeros norms, zero positions).  Weights are stored in
``cfg.policy.param_dtype``; on CUDA the 4-D conv weights are laid out
``channels_last``.  Inference only: no parameter requires a gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .clip import CLIP
from .config import SDConfig, check_ported, model_names
from .unet import UNet
from .vae import Decoder, Encoder

#: every model a family may hold; ``config.model_names`` gives a family's
MODEL_NAMES = ("clip", "clip2", "encoder", "decoder", "diffusion")


def construct(cfg: SDConfig, device="meta") -> Dict[str, nn.Module]:
    """Uninitialized models (``device="meta"`` allocates nothing)."""
    check_ported(cfg)
    kw = dict(dtype=cfg.policy.param_dtype, device=device)
    out = {"clip": CLIP(cfg.clip, **kw), "encoder": Encoder(cfg.vae, **kw),
           "decoder": Decoder(cfg.vae, **kw), "diffusion": UNet(cfg.unet, **kw)}
    if cfg.clip2 is not None:
        out["clip2"] = CLIP(cfg.clip2, **kw)
    return {name: out[name] for name in model_names(cfg)}


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Random init in module order, from ``generator``."""
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def build_models(cfg: SDConfig, *, device=None,
                 state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 generator: Optional[torch.Generator] = None,
                 vision_config=None) -> Dict[str, nn.Module]:
    """-> {"clip", ["clip2",] "encoder", "decoder", "diffusion"} ready for
    inference, and the side nets (slice E) ``state_dicts`` holds:
    "controlnet" and "t2i_adapter" (a state dict, or a list of them for
    several nets), "ip_adapter" and "clip_vision" (of ``vision_config``,
    by default ``clip_vision.vit_h14()``), and AnimateDiff's "motion"
    modules (slice G), as :func:`build_side_nets` builds them.

    The models are built on the card (``"cuda"``) unless ``device`` names
    another one; with no device given and no card present this raises
    instead of carrying on on the CPU.  With ``state_dicts``
    (``weights.convert`` output) the weights load with strict key coverage;
    without, they are drawn from ``generator`` (a generator on ``device``;
    None uses torch's default one)."""
    device = target_device(device)
    models = construct(cfg)
    for name, m in models.items():
        m.to_empty(device=device)
        if state_dicts is None:
            reset_parameters(m, generator)
        else:
            m.load_state_dict(state_dicts[name], strict=True)
        _finish(m, device)
    if state_dicts is not None:
        models.update(build_side_nets(cfg, state_dicts, device=device,
                                      vision_config=vision_config))
    return models


def build_side_nets(cfg: SDConfig, state_dicts, *, device=None,
                    vision_config=None) -> Dict[str, object]:
    """The side nets of ``state_dicts`` (``weights.convert.SIDE_NETS``) as
    modules on ``device`` in the policy's dtype: a ControlNet or
    T2I-Adapter list for a list of state dicts."""
    from . import clip_vision, controlnet, motion, t2i_adapter

    device = target_device(device)
    dtype = cfg.policy.param_dtype
    build = {
        "controlnet": lambda sd: controlnet.build(cfg, device=device, state_dict=sd),
        "t2i_adapter": lambda sd: t2i_adapter.build(cfg, device=device, state_dict=sd),
        "ip_adapter": lambda sd: clip_vision.build_ip_adapter(sd, dtype=dtype, device=device),
        "clip_vision": lambda sd: clip_vision.build_clip_vision(
            vision_config or clip_vision.vit_h14(), dtype=dtype, device=device,
            state_dict=sd),
        "motion": lambda sd: motion.build(cfg.unet, state_dict=sd, dtype=dtype, device=device),
    }
    out = {}
    for name, make in build.items():
        if name in state_dicts:
            sd = state_dicts[name]
            out[name] = [make(x) for x in sd] if isinstance(sd, (list, tuple)) else make(sd)
    return out


def target_device(device) -> torch.device:
    """``device``, or the card when None; with no card and no device named
    this raises instead of carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_models: no CUDA device; pass device='cpu' "
                               "to build the models on the CPU")
        device = "cuda"
    return torch.device(device)


def _finish(m: nn.Module, device: torch.device) -> None:
    if device.type == "cuda":
        m.to(memory_format=torch.channels_last)
    m.eval().requires_grad_(False)


def assemble(cfg: SDConfig, state_dicts: Dict[str, Dict[str, torch.Tensor]]
             ) -> Dict[str, nn.Module]:
    """Models around the given tensors, with no copy: each parameter of the
    returned models IS its state-dict tensor (strict key coverage).  Every
    tensor must already sit on one device in ``cfg.policy.param_dtype``.
    ``state_dicts`` may hold any of the models; only those are built.
    The weight transforms (``weights/``) build their results so, sharing
    every parameter they leave unchanged with the models they started from."""
    models = construct(cfg)
    out = {}
    for name, sd in state_dicts.items():
        devices = {t.device for t in sd.values()}
        dtypes = {t.dtype for t in sd.values()}
        if len(devices) != 1 or dtypes != {cfg.policy.param_dtype}:
            raise ValueError(f"assemble: {name} holds tensors on {devices} in {dtypes}; "
                             f"need one device and {cfg.policy.param_dtype}")
        m = models[name]
        m.load_state_dict(sd, strict=True, assign=True)
        _finish(m, devices.pop())
        out[name] = m
    return out


def state_dicts(models: Dict[str, nn.Module]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state dicts of the SD models of ``models`` (tensors that share
    the parameters' storage); other entries (a hypernetwork) are left out."""
    return {name: models[name].state_dict() for name in MODEL_NAMES if name in models}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
