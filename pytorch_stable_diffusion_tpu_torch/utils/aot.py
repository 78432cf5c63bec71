"""The exported generation program for one static configuration (port of
``utils/aot.py`` on ``torch.export``): the deployment path.

A serving process should not trace model code at start.
:func:`export_pipeline` exports what a request runs on the device for one
static configuration, and :func:`load_pipeline` (or :func:`prime_pipeline`,
which also makes one call) restores a callable that runs it without
tracing any model code.  The weights are arguments at call time, so one
artifact serves any checkpoint of its family.

What the artifact holds.  One ``bytes`` blob: a JSON header (the static
key, the device type the programs were exported for, the torch version,
the weights each program takes) and three programs exported with
``torch.export`` (non-strict, over copies of the models on the ``meta``
device whose parameters and buffers are inputs, saved without example
inputs, so that no weight is in the blob):

* ``prepare`` (``pipeline.prepare``): the tokens (and emphasis weights) to
  the context and SDXL's pooled and added conditioning, through the
  hypernetwork; img2img's VAE encode of the init image, with the
  encoder's noise an input; the once-a-request side-net work (ControlNet
  hint features, T2I-Adapter features, the IP-Adapter's vision tower and
  Resampler, InstructPix2Pix's and the 9-channel UNet's image latents).
* ``eps`` (``pipeline.guided_eps``): one guided UNet evaluation, the same
  function the eager ``generate`` runs at every evaluation: lanes and CFG
  with guidance rescale, PAG's and SAG's extra passes, the conversion to
  epsilon, the ControlNet residuals, adapter features, the hypernetwork's
  k/v, the IP tokens and the motion modules.  The latents, the timestep
  (a 0-d tensor), every scale and the host floats that come from the
  timestep (``sampling/ddpm.alpha_coef``) are inputs.
* ``decode`` (``pipeline.decode``): the VAE decode, whole or tiled, and
  the uint8 conversion.

The denoise loop stays on the host, as in ``generate``: the port's
samplers compute their float32 coefficients on the host from a Python
timestep, and the multistep ones keep a history whose length depends on
the start step, so a loop unrolled into one graph could not take
``start_step`` at call time (the JAX artifact does) and would grow with the
step count.  The loop is ``pipeline._denoise`` with the sampler modules of
``sampling/``, calling ``eps`` once an evaluation; the noise is drawn from
the named host streams of ``core/rng.py``.  So every one of the 18
samplers runs, ``start_step`` selects the img2img strength at call time,
and an artifact holds one UNet graph.  The hand-written kernels are
``torch.library`` custom ops (``ops/cuda/``), so the programs hold the ops
themselves, which launch the kernels on the card and run their plain
versions on the CPU.

Differences from the JAX module: the call takes ``seed`` (an int: the
named streams' root) where JAX takes a ``PRNGKey``, since torch cannot
reproduce threefry, and ``variation_seed`` an int; it also takes
``fixed_noise`` (as ``generate`` does, NCHW arrays), so that tests can hold
it to the JAX package.  Images are NHWC in [-1, 1] as there; the ready
latents of an ``img2img="latent"`` artifact are the port's (1|B, 4, h, w),
as ``generate(return_latents=True)`` returns them.  The artifact is tied to
its device type and torch version (the header records both), as the JAX
one is to its platform.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import io
import json
import struct
import zlib
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from .. import pipeline as pl
from ..core import dtypes
from ..models import config as config_mod
from ..models.config import SDConfig
from ..ops.cuda import conv as _k5  # noqa: F401  (registers the K5 op)
from ..ops.cuda import flash_attention as _fa  # noqa: F401  (registers K1-K4)
from ..sampling import ddpm

MAGIC = b"SDTORCHAOT1\n"
PROGRAMS = ("prepare", "eps", "decode")

#: programs exported in this process, by their key: an export of another
#: sampler, step count or tile of the same models shares them
_EXPORTED = {}
#: programs loaded in this process, by a hash of their bytes: artifacts that
#: differ only in their host loop share them
_LOADED = {}
_CACHED_MAX = 64


def _remember(cache: dict, key, value):
    if len(cache) >= _CACHED_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


# --------------------------------------------------------------- the header
def _encode_cfg(obj):
    """A config (nested frozen dataclasses, tuples, torch dtypes) as JSON."""
    if dataclasses.is_dataclass(obj):
        return {"__type__": type(obj).__name__,
                **{f.name: _encode_cfg(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.dtype):
        return {"__dtype__": str(obj).replace("torch.", "")}
    if isinstance(obj, (tuple, list)):
        return [_encode_cfg(v) for v in obj]
    return obj


_CFG_TYPES = {c.__name__: c for c in (SDConfig, config_mod.CLIPConfig, config_mod.VAEConfig,
                                       config_mod.UNetConfig, dtypes.Policy)}


def _decode_cfg(obj):
    if isinstance(obj, dict) and "__type__" in obj:
        cls = _CFG_TYPES[obj["__type__"]]
        return cls(**{k: _decode_cfg(v) for k, v in obj.items() if k != "__type__"})
    if isinstance(obj, dict) and "__dtype__" in obj:
        return getattr(torch, obj["__dtype__"])
    if isinstance(obj, list):
        return tuple(_decode_cfg(v) for v in obj)
    return obj


# ---------------------------------------------------------- models, weights
def _program_models(key: dict, models) -> dict:
    """The entries of the models dict each program runs."""
    prep = ["clip"] + (["clip2"] if "clip2" in models else [])
    if key["img2img"] is True or key["ip2p"] or key["inpaint"] == "unet9":
        prep.append("encoder")
    if key["use_control"]:
        prep.append("controlnet")
    if key["use_adapter"]:
        prep.append("t2i_adapter")
    if key["ip_adapter"]:
        prep += ["ip_adapter", "clip_vision"]
    if key["hypernetwork"] is not None:
        prep.append("hypernetwork")
    eps = ["diffusion"] + ["controlnet"] * key["use_control"] \
        + ["ip_adapter"] * key["ip_adapter"] + (["motion"] if key["n_frames"] else [])
    return {"prepare": prep, "eps": eps, "decode": ["decoder"]}


class _Models(nn.Module):
    """The named entries of the models dict as one module (a list of nets as
    a ``ModuleList``), whose parameter and buffer names are a program's
    weight names; its forward runs ``fn(models dict, *args)``, so that
    ``torch.func.functional_call`` can swap the weights in."""

    def __init__(self, models, names):
        super().__init__()
        for name in names:
            m = models[name]
            self.add_module(name, nn.ModuleList(m) if isinstance(m, (list, tuple)) else m)

    def forward(self, fn, *args):
        return fn({name: list(m) if isinstance(m, nn.ModuleList) else m
                   for name, m in self.named_children()}, *args)


def _weights(holder: nn.Module) -> dict:
    """Every parameter and buffer of ``holder`` by name, in module order."""
    out = dict(holder.named_parameters())
    out.update(holder.named_buffers())
    return out


def _signature(weights: dict) -> list:
    return [[k, list(v.shape), str(v.dtype).replace("torch.", "")] for k, v in weights.items()]


def _meta_copy(holder: _Models) -> _Models:
    """``holder`` with every parameter and buffer on the ``meta`` device:
    the structure the programs trace, holding no weight."""
    memo = {}
    for t in list(holder.parameters()) + list(holder.buffers()):
        m = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(m, requires_grad=False) if isinstance(t, nn.Parameter) else m
    return copy.deepcopy(holder, memo)


class _Traced(nn.Module):
    """The exported callable: ``fn(models, *args)`` over the meta copy of
    the models, its weights the first input.  The copy is not a submodule,
    so the export lifts no weight of its own."""

    def __init__(self, fn, meta: _Models):
        super().__init__()
        self._fn = fn
        self._meta = [meta]

    def forward(self, weights, *args):
        return torch.func.functional_call(self._meta[0], weights, (self._fn, *args))


def _zeros_like_meta(val):
    """A zero tensor with the shape, dtype, strides and device of a traced
    output's fake value."""
    return torch.zeros_like(torch.empty_strided(val.shape, val.stride(), dtype=val.dtype,
                                                device=val.device))


def _example_outputs(ep):
    """Zero tensors standing for an exported program's outputs (from the
    fake values the trace recorded): the next program's example inputs."""
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    leaves = [_zeros_like_meta(a.meta["val"]) for a in out_node.args[0]]
    return pytree.tree_unflatten(leaves, ep.call_spec.out_spec)


def _export(name: str, fn, models, names, args, cache_key) -> tuple:
    """-> (exported program, its compressed bytes, its weights' signature):
    ``fn(models, *args)`` exported over the named models, shared with an
    earlier export of the same key in this process."""
    holder = _Models(models, names)
    weights = _weights(holder)
    sig = _signature(weights)
    strides = tuple(tuple(v.stride()) for v in weights.values())
    key = (name, cache_key, str(next(iter(weights.values())).device), repr(sig), strides,
           repr(pytree.tree_map(lambda t: (tuple(t.shape), t.dtype, str(t.device),
                                           tuple(t.stride()))
                                if isinstance(t, torch.Tensor) else t, args)))
    if key in _EXPORTED:
        return _EXPORTED[key]
    traced = _Traced(fn, _meta_copy(holder))
    with torch.no_grad():
        ep = torch.export.export(traced, (weights, *args), strict=False)
    ep._example_inputs = None  # the weights: the artifact carries none
    _strip(ep)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return _remember(_EXPORTED, key, (ep, zlib.compress(buf.getvalue(), 6), sig))


def _noop_to(node) -> bool:
    """Whether ``node`` is a ``Tensor.to(dtype)`` that returns its input
    itself: the same dtype, no copy, no other memory format."""
    if node.op != "call_function" or node.target is not torch.ops.aten.to.dtype:
        return False
    val = node.args[0].meta.get("val") if isinstance(node.args[0], torch.fx.Node) else None
    dtype = node.args[1] if len(node.args) > 1 else node.kwargs.get("dtype")
    copy = node.args[3] if len(node.args) > 3 else node.kwargs.get("copy", False)
    fmt = node.args[4] if len(node.args) > 4 else node.kwargs.get("memory_format")
    return val is not None and dtype == val.dtype and not copy \
        and fmt in (None, torch.preserve_format) \
        and all(user.op != "output" for user in node.users)  # the outputs keep their names


def _strip(ep) -> None:
    """Drop what a served program does not need, each a Python call at every
    evaluation: the dtype and device assertions export puts before every
    ``.to`` and the ``.to`` calls that return their input (together most
    of an FP32 UNet graph's nodes); and the source stack traces in the
    nodes' metadata."""
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and not node.users \
                and node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    for node in list(graph.nodes):
        if _noop_to(node):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
        else:
            node.meta.pop("stack_trace", None)
    ep.graph_module.recompile()


def _f64(v) -> torch.Tensor:
    """A host float as the 0-d CPU tensor the programs take it as."""
    return torch.tensor(float(v), dtype=torch.float64)


def _coef(schedule, t: int):
    return tuple(_f64(c) for c in ddpm.alpha_coef(schedule, t))


# ------------------------------------------------------------------- export
def export_pipeline(cfg: SDConfig, models, *, n_steps: int = 50, batch: int = 1,
                    height: int = 512, width: int = 512, do_cfg: bool = True,
                    sampler: str = "ddpm", img2img=False, ddim_eta: float = 0.0,
                    decode_tile: Optional[int] = None, inpaint: Optional[str] = None,
                    use_control=False, use_adapter: bool = False, ip2p: bool = False,
                    emphasis: bool = False, guidance_rescale: float = 0.0,
                    timestep_spacing: str = "uniform", pag: bool = False,
                    sag: bool = False, variation: bool = False, hypernetwork=None,
                    ip_adapter: bool = False, ip_vision=None,
                    n_frames: Optional[int] = None, original_size=None,
                    crop_coords=(0, 0), target_size=None) -> bytes:
    """Serialize the generation program for one static configuration.

    ``models`` supplies the structure, shapes and dtypes and the device the
    programs are exported for (its UNet's); the artifact takes the weights
    as a call-time argument.  ``img2img=True`` exports the VAE encode of
    the init image, and the call's ``start_step`` selects the strength
    (``sampling.ddpm.start_step_for_strength``); ``img2img="latent"``
    takes ready latents (the hires-fix second pass and the base -> refiner
    handoff).  ``inpaint`` ("unet9" / "blend"), ``use_control`` (one net or
    a list in ``models["controlnet"]``), ``use_adapter``, ``ip2p``,
    ``emphasis``, ``guidance_rescale`` / ``timestep_spacing``, ``pag`` /
    ``sag`` (their scales at call time), ``variation`` (the variation seed
    and strength at call time), ``hypernetwork`` (the loader's static
    (activation, activate_output); the nets ride in ``models`` at call
    time), ``ip_adapter`` (with ``ip_vision``, the tower's config, by
    default ``models["clip_vision"]``'s), ``n_frames`` (AnimateDiff, with
    ``batch == n_frames``) and SDXL's ``original_size`` / ``crop_coords`` /
    ``target_size`` (through ``pipeline.canonical_size_ids``, as the live
    pipeline) are static per artifact, as in the JAX package; so are the
    config's backends and policy.  The JAX package's refusals, before any
    work."""
    f = cfg.vae.downsample_factor
    if height % f or width % f:
        raise ValueError(f"height/width must be multiples of {f}")
    if sampler not in pl.SAMPLERS:
        raise ValueError(f"Unknown sampler value {sampler!r}")
    if inpaint == "blend" and img2img is not True:
        raise ValueError("inpaint='blend' requires img2img=True")
    if inpaint is not None and img2img == "latent":
        raise ValueError("inpainting needs the pixel img2img path")
    if use_control and "controlnet" not in models:
        raise ValueError("use_control=True needs models['controlnet']")
    if use_adapter and "t2i_adapter" not in models:
        raise ValueError("use_adapter=True needs models['t2i_adapter']")
    if ip2p and (img2img or not do_cfg):
        raise ValueError("ip2p=True exports the InstructPix2Pix graph: "
                         "img2img must be False (the image input carries "
                         "the edit image) and do_cfg True")
    h_lat, w_lat = height // f, width // f
    if hypernetwork is not None and "hypernetwork" not in models:
        raise ValueError("hypernetwork metadata given but models has no "
                         "'hypernetwork' entry")
    if ip_adapter:
        if "ip_adapter" not in models or "clip_vision" not in models:
            raise ValueError("ip_adapter=True needs models['ip_adapter'] "
                             "and models['clip_vision']")
        if ip_vision is None:
            ip_vision = models["clip_vision"].cfg
    if n_frames is not None:
        # AnimateDiff artifact: the batch axis IS the frame axis
        if "motion" not in models:
            raise ValueError("n_frames needs models['motion']")
        if batch != n_frames:
            raise ValueError(f"n_frames artifacts use batch == n_frames "
                             f"(got batch={batch}, n_frames={n_frames})")
    # SDXL micro-conditioning is a static per-artifact choice, through the
    # live pipeline's helper
    size_ids = pl.canonical_size_ids(cfg, height, width, original_size, crop_coords,
                                     target_size)
    if inpaint not in (None, "unet9", "blend"):
        raise ValueError(f"inpaint must be None, 'unet9' or 'blend', got {inpaint!r}")
    pl._sampler_setup(cfg, sampler, timestep_spacing, n_steps)  # its ValueErrors
    n_nets = len(pl._listed(models["controlnet"])) if use_control else 0
    n_ads = len(pl._listed(models["t2i_adapter"])) if use_adapter else 0
    key = dict(n_steps=int(n_steps), batch=int(batch), height=int(height), width=int(width),
               do_cfg=bool(do_cfg), sampler=sampler, img2img=img2img,
               ddim_eta=float(ddim_eta), decode_tile=decode_tile, inpaint=inpaint,
               use_control=bool(use_control), n_control=n_nets, use_adapter=bool(use_adapter),
               n_adapter=n_ads, ip2p=bool(ip2p), emphasis=bool(emphasis),
               guidance_rescale=float(guidance_rescale), timestep_spacing=timestep_spacing,
               pag=bool(pag), sag=bool(sag), variation=bool(variation),
               hypernetwork=None if hypernetwork is None
               else [str(hypernetwork[0]), bool(hypernetwork[1])],
               ip_adapter=bool(ip_adapter),
               ip_size=ip_vision.image_size if ip_adapter else None,
               n_frames=None if n_frames is None else int(n_frames),
               size_ids=None if size_ids is None else list(size_ids))
    device = next(models["diffusion"].parameters()).device
    names = _program_models(key, models)
    run = _Run(cfg, key, device)
    with pl.quant_mod.weight_cache():
        progs, sigs = {}, {}
        p_args = (run.prep_inputs(noise=run.noise(0, None, None), **run.zero_inputs()),)
        ep, progs["prepare"], sigs["prepare"] = _export(
            "prepare", lambda m, x: pl.prepare(run.prep, m, x), models, names["prepare"],
            p_args, (cfg, run.prep))
        prepared = _example_outputs(ep)
        lat = torch.zeros((batch, cfg.vae.latent_channels, h_lat, w_lat), dtype=torch.float32,
                          device=device)
        ev = run.eval_inputs(prepared, cfg_scale=7.5, image_cfg_scale=1.5, control_scale=1.0,
                             pag_scale=1.0, sag_scale=1.0, ip_scale=1.0)
        t = torch.zeros((), dtype=torch.float32, device=device)
        ev["coef"] = (_f64(1.0), _f64(0.0))
        _, progs["eps"], sigs["eps"] = _export(
            "eps", lambda m, lat, t, x: pl.guided_eps(run.guide, m, lat, t, x), models,
            names["eps"], (lat, t, ev), (cfg, run.guide, float(guidance_rescale)))
        _, progs["decode"], sigs["decode"] = _export(
            "decode", lambda m, lat: pl.decode(cfg, m, lat, decode_tile), models,
            names["decode"], (lat,), (cfg, decode_tile))
    header = {"format": MAGIC.decode().strip(), "torch": torch.__version__,
              "platforms": [device.type], "key": key, "cfg": _encode_cfg(cfg),
              "programs": {}}
    offset = 0
    for name in PROGRAMS:
        header["programs"][name] = {"models": names[name], "weights": sigs[name],
                                    "offset": offset, "size": len(progs[name])}
        offset += len(progs[name])
    head = json.dumps(header).encode()
    return MAGIC + struct.pack("<Q", len(head)) + head + b"".join(progs[n] for n in PROGRAMS)


# -------------------------------------------------------------------- a call
class _Run:
    """The host's part of an artifact's request for one static key: the
    inputs of each program, the noise, the denoise loop."""

    def __init__(self, cfg: SDConfig, key: dict, device):
        self.cfg, self.key, self.device = cfg, key, torch.device(device)
        k = key
        self.f = cfg.vae.downsample_factor
        self.lat_shape = (cfg.vae.latent_channels, k["height"] // self.f,
                          k["width"] // self.f)
        n_lanes = 2 if k["do_cfg"] else 1
        self.prep = pl.Prep(cfg, k["batch"], n_lanes, img2img=k["img2img"] is True,
                            ip2p=k["ip2p"], inpaint=k["inpaint"],
                            hyper=None if k["hypernetwork"] is None
                            else tuple(k["hypernetwork"]))
        self.guide = pl.Guidance(cfg, k["batch"], k["do_cfg"], ip2p=k["ip2p"], pag=k["pag"],
                                 sag=k["sag"], n_frames=k["n_frames"])

    def image_shape(self):
        k = self.key
        if k["img2img"] == "latent":
            return (k["batch"],) + self.lat_shape
        return (k["batch"], k["height"], k["width"], 3)

    def zero_inputs(self) -> dict:
        """The call's array inputs, zero-filled (the export's examples and
        :func:`prime_pipeline`'s request)."""
        k, b = self.key, self.key["batch"]
        hw = (k["height"], k["width"])
        out = dict(cond_tokens=np.zeros((b, self.cfg.clip.max_len), np.int64),
                   input_image=np.zeros(self.image_shape(), np.float32))
        out["uncond_tokens"] = out["cond_tokens"]
        if k["inpaint"] is not None:
            out["mask"] = np.ones((b,) + hw + (1,), np.float32)
        if k["use_control"]:
            out["control_hint"] = np.zeros((k["n_control"], b) + hw + (3,), np.float32)
        if k["use_adapter"]:
            out["adapter_hint"] = np.zeros((k["n_adapter"], b) + hw + (3,), np.float32)
        if k["ip_adapter"]:
            out["ip_image"] = np.zeros((b, k["ip_size"], k["ip_size"], 3), np.float32)
        return out

    def noise(self, seed, fixed_noise, variation):
        _, _, _, stream, n_draws = self.setup()
        k = self.key
        noise = pl._draw_noise(seed=seed, fixed_noise=fixed_noise, batch=k["batch"],
                               lat_shape=self.lat_shape, n_steps=k["n_steps"], stream=stream,
                               n_draws=n_draws, encode=k["img2img"] is True,
                               inpaint=k["inpaint"], variation=variation)
        return {name: pl._to_device(v, self.device) for name, v in noise.items()}

    def setup(self):
        k = self.key
        return pl._sampler_setup(self.cfg, k["sampler"], k["timestep_spacing"], k["n_steps"])

    def pixels(self, input_image):
        """The pixels ``prepare`` encodes, NCHW, or None."""
        k = self.key
        if k["img2img"] is True or k["ip2p"]:
            return np.ascontiguousarray(np.asarray(input_image, np.float32)
                                        .reshape(self.image_shape()).transpose(0, 3, 1, 2))
        if k["inpaint"] == "unet9":  # inpainting from text: a zero image
            return np.zeros((1, 3, k["height"], k["width"]), np.float32)
        return None

    def prep_inputs(self, *, cond_tokens, uncond_tokens, input_image=None, mask=None,
                    control_hint=None, adapter_hint=None, adapter_scale=1.0,
                    cond_weights=None, uncond_weights=None, hypernetwork_strength=1.0,
                    ip_image=None, noise):
        k, b, cfg = self.key, self.key["batch"], self.cfg
        length = cfg.clip.max_len
        cond = np.asarray(cond_tokens, np.int64).reshape(b, length)
        tokens = np.concatenate([cond, np.asarray(uncond_tokens, np.int64).reshape(b, length)]) \
            if k["do_cfg"] else cond
        weights = None
        if k["emphasis"]:
            cw = np.ones((b, length), np.float32) if cond_weights is None \
                else np.asarray(cond_weights, np.float32).reshape(b, length)
            uw = np.ones((b, length), np.float32) if uncond_weights is None \
                else np.asarray(uncond_weights, np.float32).reshape(b, length)
            weights = np.concatenate([cw, uw]) if k["do_cfg"] else cw
        m = None if mask is None else self.mask(mask)
        hw = (k["height"], k["width"])

        def hints(h, n):
            return np.ascontiguousarray(np.asarray(h, np.float32).reshape((n, b) + hw + (3,))
                                        .transpose(0, 1, 4, 2, 3))

        return pl._prep_inputs(
            self.device, b, tokens=tokens, weights=weights,
            size_emb=None if cfg.unet.add_embed_dim is None
            else pl._size_embedding(cfg, k["height"], k["width"],
                                    None if k["size_ids"] is None else tuple(k["size_ids"])),
            pixels=self.pixels(input_image), noise=noise,
            mask=m if k["inpaint"] == "unet9" else None,
            mask_lat=None if k["inpaint"] != "unet9"
            else pl.mask_to_latent_nearest(m, self.f),
            hints=None if not k["use_control"] else hints(control_hint, k["n_control"]),
            adapter_hints=None if not k["use_adapter"]
            else hints(adapter_hint, k["n_adapter"]),
            adapter_scale=None if not k["use_adapter"]
            else np.broadcast_to(np.asarray(adapter_scale, np.float32), (k["n_adapter"],)),
            ip_image=None if not k["ip_adapter"]
            else np.asarray(ip_image, np.float32).reshape(
                (-1, k["ip_size"], k["ip_size"], 3)),
            hyper_strength=None if k["hypernetwork"] is None else hypernetwork_strength)

    def mask(self, mask):
        k = self.key
        return np.ascontiguousarray(np.broadcast_to(
            np.asarray(mask, np.float32).reshape((-1, k["height"], k["width"], 1)),
            (k["batch"], k["height"], k["width"], 1)))

    def eval_inputs(self, prepared, *, cfg_scale, image_cfg_scale, control_scale, pag_scale,
                    sag_scale, ip_scale):
        k = self.key
        t_cond = None
        if self.cfg.unet.time_cond_dim:
            t_cond = pl._to_device(pl.unet_mod.guidance_scale_embedding(
                torch.tensor(cfg_scale, dtype=torch.float32) - 1.0,
                self.cfg.unet.time_cond_dim), self.device)
        return pl._eval_inputs(
            self.guide, prepared, self.device, cfg_scale=_f64(cfg_scale),
            image_scale=_f64(image_cfg_scale),
            control_scale=np.broadcast_to(np.asarray(control_scale, np.float32),
                                          (k["n_control"],)) if k["use_control"] else None,
            ip_scale=ip_scale if k["ip_adapter"] else None, pag_scale=pag_scale,
            sag_scale=sag_scale, guidance_rescale=k["guidance_rescale"], t_cond=t_cond)


class _Program:
    """An exported program, run from its graph with the weights flattened
    once a request (the exported module's own entry would flatten and
    check every weight at every call)."""

    def __init__(self, ep):
        self.ep = ep
        self.gm = ep.graph_module
        self.out_spec = ep.call_spec.out_spec
        # the structure of the inputs after the weights: ((weights, *rest), {})
        spec = ep.call_spec.in_spec
        self.rest_spec = pytree.tree_structure(
            pytree.tree_unflatten([0] * spec.num_leaves, spec)[0][1:])
        self.lifted = []
        for spec in ep.graph_signature.input_specs:
            kind = spec.kind.name
            if kind == "USER_INPUT":
                self.lifted.append(None)
            elif kind in ("PARAMETER", "BUFFER"):
                self.lifted.append(ep.state_dict[spec.target])
            else:
                self.lifted.append(ep.constants[spec.target])

    def __call__(self, weights_flat, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self.rest_spec:
            raise ValueError(f"inputs {spec} do not fit the exported program's "
                             f"{self.rest_spec}")
        flat = iter(list(weights_flat) + leaves)
        full = [next(flat) if v is None else v for v in self.lifted]
        return pytree.tree_unflatten(list(self.gm(*full)), self.out_spec)


class LoadedPipeline:
    """A deserialized artifact; call like the JAX package's."""

    def __init__(self, blob: bytes):
        if not blob.startswith(MAGIC):
            raise ValueError("not an artifact of export_pipeline")
        (n,) = struct.unpack("<Q", blob[len(MAGIC):len(MAGIC) + 8])
        start = len(MAGIC) + 8
        self.header = json.loads(blob[start:start + n].decode())
        body = blob[start + n:]
        self.key = self.header["key"]
        self.cfg = _decode_cfg(self.header["cfg"])
        self.platforms = tuple(self.header["platforms"])
        if self.platforms[0] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this artifact was exported for the card, and no CUDA device "
                               "is present")
        self._programs = {}
        for name in PROGRAMS:
            p = self.header["programs"][name]
            data = body[p["offset"]:p["offset"] + p["size"]]
            digest = hashlib.sha256(data).hexdigest()
            self._programs[name] = _LOADED.get(digest) or _remember(
                _LOADED, digest, _Program(torch.export.load(io.BytesIO(zlib.decompress(data)))))
        self._run = _Run(self.cfg, self.key, self.platforms[0])

    @property
    def image_shape(self):
        """(batch, H, W, 3) of the image argument, or the port's (batch, 4,
        h, w) latents of an ``img2img="latent"`` artifact."""
        return self._run.image_shape()

    @property
    def token_shape(self):
        """(batch, max_len) of the cond/uncond token arguments."""
        return (self.key["batch"], self.cfg.clip.max_len)

    @property
    def aux_keys(self):
        """The call-time inputs the artifact was exported with, by the JAX
        package's aux names ('variation_seed' for its 'variation_key')."""
        k = self.key
        keys = ["latent_init"]
        keys += ["mask"] * (k["inpaint"] is not None)
        keys += ["control_hint", "control_scale"] * k["use_control"]
        keys += ["adapter_hint", "adapter_scale"] * k["use_adapter"]
        keys += ["image_cfg_scale"] * k["ip2p"]
        keys += ["cond_weights", "uncond_weights"] * k["emphasis"]
        keys += ["pag_scale"] * k["pag"] + ["sag_scale"] * k["sag"]
        keys += ["variation_seed", "variation_strength"] * k["variation"]
        keys += ["hyper_strength"] * (k["hypernetwork"] is not None)
        keys += ["ip_image", "ip_scale"] * k["ip_adapter"]
        return sorted(keys)

    def _weights(self, models, name):
        prog = self.header["programs"][name]
        weights = _weights(_Models(models, prog["models"]))
        if _signature(weights) != prog["weights"]:
            raise ValueError(f"the models do not fit the artifact's {name} program "
                             "(another family, side net or dtype)")
        return list(weights.values())

    def __call__(self, models, cond_tokens, uncond_tokens, seed, cfg_scale, start_step=0,
                 input_image=None, mask=None, control_hint=None, control_scale=1.0,
                 adapter_hint=None, adapter_scale=1.0, image_cfg_scale=1.5,
                 cond_weights=None, uncond_weights=None, pag_scale=1.0, sag_scale=1.0,
                 variation_seed=0, variation_strength=0.0, hypernetwork_strength=1.0,
                 ip_image=None, ip_scale=1.0, *, fixed_noise=None):
        """-> (uint8 images (B, H, W, 3), final latents (B, 4, h, w)) as
        numpy arrays.  ``seed``: the root of the named noise streams (an
        int, where the JAX package takes a ``PRNGKey``), or ``fixed_noise``
        injected as ``generate`` takes it.  ``input_image``: (B, H, W, 3)
        float32 in [-1, 1] for an img2img or InstructPix2Pix artifact, the
        port's (1|B, 4, h, w) latents for an ``img2img="latent"`` one
        (ignored by the others); ``start_step`` selects the img2img
        strength.  ``mask`` ((B, H, W, 1), 1 = repaint; all ones if None)
        for inpaint artifacts; ``control_hint`` ((N, B, H, W, 3) in [0, 1])
        and ``control_scale`` for ControlNet ones, ``adapter_hint`` and
        ``adapter_scale`` for T2I-Adapter ones, ``ip_image`` (the
        CLIP-preprocessed (1|B, S, S, 3)) and ``ip_scale`` for IP-Adapter
        ones; the scales, the emphasis weights and the variation seed as
        their artifacts take them."""
        k, run = self.key, self._run
        for name, v in (("control_hint", k["use_control"] and control_hint),
                        ("adapter_hint", k["use_adapter"] and adapter_hint),
                        ("ip_image", k["ip_adapter"] and ip_image)):
            if v is None:
                raise ValueError(f"this artifact needs {name}")
        img2img = k["img2img"] is not False
        if img2img and input_image is None:
            raise ValueError("this artifact needs input_image")
        start_step = int(start_step) if img2img else 0
        if not 0 <= start_step < k["n_steps"]:
            raise ValueError(f"start_step must be in [0, {k['n_steps']}), got {start_step}")
        w = {name: self._weights(models, name) for name in PROGRAMS}
        progs = self._programs
        schedule, timesteps, plan, _, _ = run.setup()
        entry_ts = timesteps if plan is None else plan["start_t"]
        variation = (variation_seed, variation_strength) \
            if k["variation"] and variation_strength != 0.0 else None
        with torch.inference_mode():
            noise = run.noise(seed, fixed_noise, variation)
            prepared = progs["prepare"](w["prepare"], run.prep_inputs(
                cond_tokens=cond_tokens, uncond_tokens=uncond_tokens, input_image=input_image,
                mask=mask if k["inpaint"] is None or mask is not None
                else np.ones((1, k["height"], k["width"], 1), np.float32),
                control_hint=control_hint, adapter_hint=adapter_hint,
                adapter_scale=adapter_scale, cond_weights=cond_weights,
                uncond_weights=uncond_weights, hypernetwork_strength=hypernetwork_strength,
                ip_image=ip_image, noise=noise))
            lat0 = m_lat = None
            if k["img2img"] is True:
                lat0 = prepared["lat0"]
            elif k["img2img"] == "latent":
                lat0 = torch.as_tensor(np.asarray(input_image, np.float32))
                lat0 = pl._to_device(lat0.reshape((-1,) + run.lat_shape), run.device)
                lat0 = lat0.expand(k["batch"], -1, -1, -1)
            if lat0 is None:
                latents = noise["latent_init"]
            else:
                latents = ddpm.add_noise(schedule, lat0, int(entry_ts[start_step]),
                                         noise["latent_init"])
            if k["inpaint"] == "blend":
                m = run.mask(np.ones((1, k["height"], k["width"], 1), np.float32)
                             if mask is None else mask)
                m_lat = pl._to_device(pl._nchw(pl.mask_to_latent_area(m, run.f)), run.device)
            ev = run.eval_inputs(prepared, cfg_scale=cfg_scale,
                                 image_cfg_scale=image_cfg_scale,
                                 control_scale=control_scale, pag_scale=pag_scale,
                                 sag_scale=sag_scale, ip_scale=ip_scale)
            t_all = torch.arange(schedule.num_train_timesteps, dtype=torch.float32,
                                 device=run.device)

            def eps_at(i, lat, t, refresh=None):
                return progs["eps"](w["eps"], lat, t_all[int(t)],
                                    dict(ev, coef=_coef(schedule, t)))

            latents = pl._denoise(k["sampler"], schedule, timesteps, latents, noise, eps_at,
                                  start_step=start_step, plan=plan, eta=k["ddim_eta"],
                                  img2img=img2img, inpaint=k["inpaint"], lat0=lat0,
                                  m_lat=m_lat)
            images = progs["decode"](w["decode"], latents)
            return images.cpu().numpy(), latents.cpu().numpy()


def load_pipeline(blob: bytes) -> LoadedPipeline:
    return LoadedPipeline(blob)


def prime_pipeline(blob: bytes, models) -> LoadedPipeline:
    """Load the artifact and make one call with zero-filled inputs (the
    required hints and image prompt too: only the program, not its values,
    matters here), so that the first real request pays no start-up cost of
    its own (the programs' first run, the libraries' handles and kernel
    choices, the kernels' build and load); -> the ready pipeline."""
    loaded = load_pipeline(blob)
    loaded(models, seed=0, cfg_scale=7.5, **loaded._run.zero_inputs())
    return loaded
