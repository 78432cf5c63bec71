"""The port's public names against the JAX package's, name by name.

Each public top-level ``def``, ``class`` and UPPER-case constant of every
JAX module (read from its source with ``ast``: JAX is never imported here)
must be in the port's module at the same path, or have a port object named
in :data:`COUNTERPART` (an ``nn.Module`` for an ``init``, its ``forward``
or another method for an ``apply``), or a reason in :data:`NO_COUNTERPART`.
So "the port does all that the JAX package does" is a test result.
"""

import ast
import importlib
import os

import pytest

from test_torch_import import JAX_PACKAGE, NOT_PORTED, REPO, _jax_modules

PORT = "pytorch_stable_diffusion_tpu_torch"

#: JAX name -> the port object that does its work ("module.attr[.attr]")
COUNTERPART = {
    "core/rng.py::stream": "core.rng.stream_seed",
    "core/rng.py::step_key": "core.rng.stream_seed",
    "core/rng.py::batch_keys": "core.rng.generator",
    "core/rng.py::normal_like": "core.rng.batch_normal",
    "ops/attention.py::init": "ops.attention.Attention",
    "ops/conv.py::init": "ops.conv.Conv",
    "ops/linear.py::init": "ops.linear.Linear",
    "ops/norm.py::init": "ops.norm.Norm",
    "parallel/tp.py::unet_tp_rules": "parallel.tp.tp_spec",
    "parallel/tp.py::clip_tp_rules": "parallel.tp.tp_spec",
    "models/clip.py::init": "models.clip.CLIP",
    "models/clip.py::apply": "models.clip.CLIP.forward",
    "models/clip.py::apply_with_pooled": "models.clip.CLIP.forward_with_pooled",
    "models/clip_vision.py::init": "models.clip_vision.CLIPVision",
    "models/clip_vision.py::apply": "models.clip_vision.CLIPVision.forward",
    "models/clip_vision.py::apply_projected": "models.clip_vision.CLIPVision.project",
    "models/clip_vision.py::apply_resampler": "models.clip_vision.Resampler.forward",
    "models/clip_vision.py::project_image_tokens": "models.clip_vision.ImageProj.forward",
    "models/controlnet.py::init": "models.controlnet.ControlNet",
    "models/controlnet.py::encode_hint": "models.controlnet.ControlNet.encode_hint",
    "models/controlnet.py::apply": "models.controlnet.ControlNet.forward",
    "models/esrgan.py::init": "models.esrgan.RRDBNet",
    "models/esrgan.py::apply": "models.esrgan.RRDBNet.forward",
    "models/motion.py::apply_motion": "models.motion.MotionModule.forward",
    "models/t2i_adapter.py::init": "models.t2i_adapter.T2IAdapter",
    "models/t2i_adapter.py::apply": "models.t2i_adapter.T2IAdapter.forward",
    "models/unet.py::init_res_block": "models.unet.ResBlock",
    "models/unet.py::apply_res_block": "models.unet.ResBlock.forward",
    "models/unet.py::init_attn_block": "models.unet.AttnBlock",
    "models/unet.py::apply_attn_block": "models.unet.AttnBlock.forward",
    "models/unet.py::init": "models.unet.UNet",
    "models/unet.py::apply": "models.unet.UNet.forward",
    "models/vae.py::init_res_block": "models.vae.ResBlock",
    "models/vae.py::apply_res_block": "models.vae.ResBlock.forward",
    "models/vae.py::init_attn_block": "models.vae.AttnBlock",
    "models/vae.py::apply_attn_block": "models.vae.AttnBlock.forward",
    "models/vae.py::init_encoder": "models.vae.Encoder",
    "models/vae.py::apply_encoder": "models.vae.Encoder.forward",
    "models/vae.py::init_decoder": "models.vae.Decoder",
    "models/vae.py::apply_decoder": "models.vae.Decoder.forward",
}

#: JAX name -> why the port has no object for it
NO_COUNTERPART = {
    "core/dtypes.py::cast_pytree": "casts a pytree's leaves; a port model is an nn.Module, "
                                   "cast with Module.to(dtype)",
    "core/mesh.py::replicated": "a jax NamedSharding; a torch.distributed rank holds its "
                                "own tensors",
    "core/mesh.py::data_sharded": "a jax NamedSharding; each data rank takes its rows "
                                  "(core/mesh.local_batch)",
    "parallel/tp.py::BIAS_COL": "a jax PartitionSpec; the port's specs are tp_spec's strings, "
                                "a column-parallel bias takes COL",
    "parallel/tp.py::REPL": "a jax PartitionSpec; a replicated tensor has no spec "
                            "(tp_spec returns None)",
    "sampling/lms.py::init_state": "the zero history lax.scan carries; the port's host loop "
                                   "grows the history as a list (sampling/lms.step)",
    "models/esrgan.py::pixel_unshuffle": "NHWC space-to-depth; the port is NCHW and calls "
                                         "torch.nn.functional.pixel_unshuffle",
}


def public_names(path):
    """The public top-level defs, classes and UPPER-case constants of a
    module's source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                    if isinstance(e, ast.Name) and e.id.isupper():
                        out.append(e.id)
    return [n for n in out if not n.startswith("_")]


def port_module(rel):
    """The port's module at the JAX module's path ``rel`` (``a/b.py``)."""
    parts = [p for p in rel[:-len(".py")].split("/") if p != "__init__"]
    return importlib.import_module(".".join([PORT] + parts))


def resolve(dotted):
    """The port object at ``dotted`` (the longest importable module prefix,
    then attributes)."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([PORT] + parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


JAX_MODULES = sorted(m for m in _jax_modules() if not m.startswith(NOT_PORTED))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_a_counterpart(rel):
    missing = []
    for name in public_names(os.path.join(JAX_PACKAGE, rel)):
        key = f"{rel}::{name}"
        if key in NO_COUNTERPART:
            continue
        if key in COUNTERPART:
            assert callable(resolve(COUNTERPART[key])), key
        elif not hasattr(port_module(rel), name):
            missing.append(key)
    assert missing == []


def test_name_maps_are_not_stale():
    """Each key of both maps is a public name of the JAX module that the
    port's module at its path lacks; the walk reaches the names this
    slice added."""
    keys = {f"{rel}::{name}" for rel in JAX_MODULES
            for name in public_names(os.path.join(JAX_PACKAGE, rel))}
    assert len(keys) > 250 and {"core/dtypes.py::MIXED", "pipeline.py::get_time_embedding",
                                "weights/native_io.py::build_error"} <= keys
    for key in list(COUNTERPART) + list(NO_COUNTERPART):
        rel, name = key.split("::")
        assert key in keys, key
        assert not hasattr(port_module(rel), name), f"{key}: the port has it now"
    assert not set(COUNTERPART) & set(NO_COUNTERPART)


def _all_of(path):
    """``__all__`` of a module's source."""
    with open(path) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_top_level_names_match_jax():
    import pytorch_stable_diffusion_tpu_torch as port

    jax_all = _all_of(os.path.join(JAX_PACKAGE, "__init__.py"))
    port_all = _all_of(os.path.join(REPO, PORT, "__init__.py"))
    assert "load_models" in jax_all and "MIXED" in jax_all
    assert set(jax_all) <= set(port_all), sorted(set(jax_all) - set(port_all))
    assert port.__all__ == port_all
    for name in port_all:
        assert getattr(port, name) is not None, name
    from pytorch_stable_diffusion_tpu_torch import (MIXED, CLIPTokenizer, generate,  # noqa: F401
                                                    get_time_embedding, load_diffusers_models,
                                                    load_models, load_models_streamed, rescale)

    assert MIXED == port.Policy(param_dtype=port.FP32.param_dtype,
                                compute_dtype=port.BF16.compute_dtype)
