"""Slice D's weight files and transforms in the port against the JAX
package, at the tiny config, with no JAX model init: the weights are a
seeded port model's, and the JAX side gets them through its own loaders
(``weights/convert.convert`` of the port's CompVis export).

Files: the port's ``.safetensors`` writer and a torch zip ``.ckpt`` read by
both packages (equal tensors, strict coverage), the VAE override's two key
forms, the restricted unpickler's refusals, BF16 without ``ml_dtypes``,
diffusers directories, the streamed loader and the native save format.
Transforms, each against the JAX module on the same inputs: LoRA (kohya,
PEFT, LoCon; fp32, 1e-6 relative), merge, textual inversion and every
hypernetwork activation (1e-6).  Requests against JAX ``generate()``: a
hypernetwork txt2img over a 19-window prompt (the JAX package's one-pass
kernel in interpret mode, the port's K2 plain version on a ``(ctx_k,
ctx_v)`` pair), a textual-inversion txt2img and ``generate_many`` over 5
prompts in chunks of 2 (three JAX compiles).
"""

import os
import pickle
import subprocess
import sys
import zipfile
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import psnr, to_nchw
from test_torch_families import families  # noqa: F401  (the tiny SDXL, refiner, SD-2)

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.weights import convert as jconvert
from pytorch_stable_diffusion_tpu.weights import diffusers as jdif
from pytorch_stable_diffusion_tpu.weights import hypernetwork as jhyper
from pytorch_stable_diffusion_tpu.weights import lora as jlora
from pytorch_stable_diffusion_tpu.weights import merge as jmerge
from pytorch_stable_diffusion_tpu.weights import native_io as jnative
from pytorch_stable_diffusion_tpu.weights import textual_inversion as jti
from pytorch_stable_diffusion_tpu.weights import tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.models import build_models, config, state_dicts
from pytorch_stable_diffusion_tpu_torch.models.config import tiny_sd_config
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights import diffusers as dif
from pytorch_stable_diffusion_tpu_torch.weights import hypernetwork as hyper
from pytorch_stable_diffusion_tpu_torch.weights import lora, merge, save, stream
from pytorch_stable_diffusion_tpu_torch.weights import textual_inversion as ti
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "cat", "dog", "photo", "of"]
CFG = tiny_sd_config()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the tiny tensors (as tests/test_torch_samplers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed):
    return build_models(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def models():
    return _models(5)


@pytest.fixture(scope="module")
def compvis(models):
    """The port's CompVis export of ``models`` (fp32 tensors) and as numpy."""
    sd = convert.deconvert(models, CFG)
    return sd, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jparams(compvis):
    """The same weights as the JAX package's pytrees, through its converter."""
    return jconvert.convert(compvis[1], jconfig.tiny_sd_config())


@pytest.fixture(scope="module")
def files(compvis, tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    paths = {"safetensors": str(d / "m.safetensors"), "ckpt": str(d / "m.ckpt")}
    save.write_safetensors(compvis[0], paths["safetensors"])
    torch.save({"state_dict": compvis[0], "global_step": 7}, paths["ckpt"])
    return paths


def _assert_state_dicts_equal(got, want, **tol):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            if tol:
                np.testing.assert_allclose(got[name][k].float().numpy(), v.float().numpy(),
                                           err_msg=f"{name}.{k}", **tol)
            else:
                assert torch.equal(got[name][k], v), f"{name}.{k}"


# ------------------------------------------------------------------ files
@pytest.mark.parametrize("kind", ["safetensors", "ckpt"])
def test_load_parity_with_jax(files, compvis, jparams, models, kind):
    """Both packages read the file to the same tensors, convert them with
    strict coverage both ways, and the port's models load them strictly."""
    ours = convert.load_state_dict(files[kind])
    ref = jconvert.load_state_dict(files[kind])
    assert set(ours) == set(ref) == set(compvis[0])
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    sds = convert.load_sd_checkpoint(files[kind], CFG)
    _assert_state_dicts_equal(sds, convert.from_jax_params(jparams, CFG))
    _assert_state_dicts_equal(sds, state_dicts(models))
    build_models(CFG, device="cpu", state_dicts=sds)  # strict on the target side


def test_convert_coverage_is_exact_both_ways(compvis):
    sd = dict(compvis[0])
    sd.pop("model.diffusion_model.out.2.bias")
    with pytest.raises(KeyError, match="missing source key"):
        convert.convert(sd, CFG)
    with pytest.raises(KeyError, match="unconsumed"):
        convert.convert(dict(compvis[0], stray=torch.zeros(1)), CFG)
    assert set(convert.deconvert(convert.convert(compvis[0], CFG), CFG)) == set(compvis[0])


@pytest.mark.parametrize("prefixed", [True, False], ids=["prefixed", "unprefixed"])
def test_convert_vae_matches_jax(compvis, prefixed):
    vae = {k: v for k, v in compvis[1].items() if k.startswith("first_stage_model.")}
    if not prefixed:
        vae = {k[len("first_stage_model."):]: v for k, v in vae.items()}
    vae["loss.logvar"] = np.zeros(1, np.float32)  # training-only: ignored
    enc, dec = convert.convert_vae(vae, CFG)
    jenc, jdec = jconvert.convert_vae(vae, jconfig.tiny_sd_config())
    want = convert.from_jax_params({"clip": {}, "diffusion": {}, "encoder": jenc,
                                    "decoder": jdec}, CFG)
    _assert_state_dicts_equal({"encoder": enc, "decoder": dec},
                              {"encoder": want["encoder"], "decoder": want["decoder"]})
    with pytest.raises(KeyError, match="unconsumed VAE keys"):
        stray = ("first_stage_model." if prefixed else "") + "decoder.stray"
        convert.convert_vae(dict(vae, **{stray: np.zeros(1)}), CFG)


def _evil_ckpt(path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps({"x": Evil()}))


def test_legacy_and_hostile_files_are_refused(tmp_path):
    """A pre-zip torch file needs ``allow_unsafe_fallback``; a pickle with a
    non-tensor global is refused always, and never retried by torch.load."""
    legacy = str(tmp_path / "legacy.ckpt")
    torch.save({"w": torch.ones(2)}, legacy, _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError, match="allow_unsafe_fallback"):
        convert.load_state_dict(legacy)
    assert torch.equal(convert.load_state_dict(legacy, allow_unsafe_fallback=True)["w"],
                       torch.ones(2))
    evil = str(tmp_path / "evil.ckpt")
    _evil_ckpt(evil)
    for allow in (False, True):
        with mock.patch.object(torch, "load", side_effect=AssertionError("retried")):
            with pytest.raises(pickle.UnpicklingError, match="refusing"):
                convert.load_state_dict(evil, allow_unsafe_fallback=allow)


_BF16 = """
import sys, torch
from pytorch_stable_diffusion_tpu_torch.weights import convert, save
x = torch.linspace(-3, 3, 24).reshape(4, 6).to(torch.bfloat16)
save.write_safetensors({"w": x}, sys.argv[1] + "/b.safetensors")
torch.save({"state_dict": {"w": x}}, sys.argv[1] + "/b.ckpt")
for f in ("b.safetensors", "b.ckpt"):
    got = convert.load_state_dict(sys.argv[1] + "/" + f)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x), f
print("ML_DTYPES", "ml_dtypes" in sys.modules)
"""


def test_bf16_files_load_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BF16, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ML_DTYPES False" in out.stdout


def test_safetensors_writer_is_read_by_both_readers(compvis, files):
    """The port's writer against the JAX package's native reader and the
    ``safetensors`` package; fp16 and bf16 files too."""
    from safetensors import safe_open

    with safe_open(files["safetensors"], framework="np") as f:
        for k in f.keys():
            np.testing.assert_array_equal(f.get_tensor(k), compvis[1][k], err_msg=k)
    for k, v in jnative.load_safetensors(files["safetensors"]).items():
        np.testing.assert_array_equal(v, compvis[1][k], err_msg=k)
    for dtype in (torch.float16, torch.bfloat16):
        path = files["safetensors"].replace("m.", f"m_{str(dtype)[6:]}.")
        save.save_safetensors(state_dicts(_models(5)), CFG, path, dtype=dtype)
        got = convert.load_state_dict(path)
        for k, v in compvis[0].items():
            assert got[k].dtype == dtype and torch.equal(got[k], v.to(dtype)), k


def test_failed_reader_build_raises_with_the_compiler_message(files, tmp_path, monkeypatch):
    """No second reader: where g++ fails, reading a .safetensors file raises
    with the compiler's message."""
    from pytorch_stable_diffusion_tpu_torch.weights import native_io

    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_build_error", None)
    monkeypatch.setattr(native_io, "library_path", lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(native_io, "_build", lambda so: "g++ failed: no toolchain here")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed: no toolchain here"):
        convert.load_state_dict(files["safetensors"])


def test_save_native_roundtrip(models, tmp_path):
    path = str(tmp_path / "m.pt")
    save.save_native(models, path)
    _assert_state_dicts_equal(save.load_native(models, path), state_dicts(models))
    sds = state_dicts(models)
    sds["clip"] = dict(sds["clip"], stray=torch.zeros(1))
    with pytest.raises(KeyError, match="unexpected"):
        save.load_native(sds, path)


class _ModelAxis:
    """A stand-in for a (data 1, model 2) ``DeviceMesh`` seen from model rank
    1: the loader reads only the model axis's size and rank."""

    def __getitem__(self, axis):
        return type("Axis", (), {"size": lambda self: 2 if axis == "model" else 1})()

    def get_local_rank(self, axis):
        return 1 if axis == "model" else 0


@pytest.mark.parametrize("kind", ["safetensors", "ckpt"])
def test_streamed_load_equals_eager_load(files, kind):
    """And with ``tp=True``, model rank 1's slices: the second half of each
    column-parallel tensor's rows (of each GeGLU half's), of each
    row-parallel weight's columns; every other tensor whole."""
    from pytorch_stable_diffusion_tpu_torch.parallel import tp

    eager = convert.load_sd_checkpoint(files[kind], CFG)
    got = stream.load_sd_checkpoint_streamed(files[kind], CFG, device="cpu")
    _assert_state_dicts_equal(got, eager)
    sliced = stream.load_sd_checkpoint_streamed(files[kind], CFG, device="cpu",
                                                mesh=_ModelAxis(), tp=True)
    q = "encoder.1.attn.self_attn.q.weight"
    torch.testing.assert_close(sliced["diffusion"][q], eager["diffusion"][q][8:],
                               rtol=0, atol=0)
    g = eager["diffusion"]["encoder.1.attn.geglu_proj.weight"]
    torch.testing.assert_close(sliced["diffusion"]["encoder.1.attn.geglu_proj.weight"],
                               torch.cat([g[32:64], g[96:]]), rtol=0, atol=0)
    o = "encoder.1.attn.geglu_out.weight"
    torch.testing.assert_close(sliced["diffusion"][o], eager["diffusion"][o][:, 32:],
                               rtol=0, atol=0)
    n = {"col": 0, "geglu": 0, "row": 0}
    for name, sd in eager.items():
        for key, full in sd.items():
            spec = tp.tp_spec(name, key)
            n[spec] = n.get(spec, 0) + 1
            if spec is None:
                torch.testing.assert_close(sliced[name][key], full, rtol=0, atol=0)
    assert min(n.values()) > 0  # every split met
    with pytest.raises(ValueError, match="needs a mesh"):
        stream.load_sd_checkpoint_streamed(files[kind], CFG, device="cpu", tp=True)


def test_diffusers_roundtrip_and_coverage(models, jparams, tmp_path):
    """The port's diffusers export equals the JAX package's; a diffusers
    directory loads back to the same state dicts; stray or missing keys
    raise."""
    unet_sd, vae_sd, te_sd = dif.deconvert_diffusers(models, CFG)
    for ours, ref in zip((unet_sd, vae_sd, te_sd),
                         jdif.deconvert_diffusers(jparams, jconfig.tiny_sd_config())):
        assert set(ours) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    for sub, name, sd in (("unet", "diffusion_pytorch_model", unet_sd),
                          ("vae", "diffusion_pytorch_model", vae_sd),
                          ("text_encoder", "model", te_sd)):
        os.makedirs(tmp_path / sub)
        save.write_safetensors(sd, str(tmp_path / sub / f"{name}.safetensors"))
    _assert_state_dicts_equal(dif.load_diffusers_pipeline(str(tmp_path), CFG),
                              state_dicts(models))
    enc, dec = convert.load_vae(str(tmp_path / "vae"), CFG)
    _assert_state_dicts_equal({"encoder": enc, "decoder": dec},
                              {k: state_dicts(models)[k] for k in ("encoder", "decoder")})
    with pytest.raises(KeyError, match="unconsumed diffusers keys"):
        dif.convert_diffusers(dict(unet_sd, stray=torch.zeros(1)), vae_sd, te_sd, CFG)
    del te_sd["text_model.final_layer_norm.bias"]
    with pytest.raises(KeyError, match="missing diffusers key"):
        dif.convert_diffusers(unet_sd, vae_sd, te_sd, CFG)


# ------------------------------------------------------------------- LoRA
def _lora_sd(models, fmt, seed=0):
    """A LoRA over a spread of targets: UNet and text-encoder linears, the
    UNet's 1x1 proj convs (linear factors) and 3x3 res convs (LoCon)."""
    r = np.random.RandomState(seed)
    targets = lora._weight_targets(CFG)
    picked = [k for k in sorted(targets)
              if any(s in k for s in ("attn1.to_q", "attn2.to_v", "ff.net.2", "proj_in",
                                      "resnets.0.conv1", "self_attn.k_proj", "mlp.fc1"))]
    sds = state_dicts(models)
    shapes = {k: sds[targets[k][0][0]][targets[k][0][1]].shape for k in picked}
    sd = {}
    for k in picked:
        shape, rank = shapes[k], 4
        if len(shape) == 4 and shape[2] == 3:  # LoCon: 3x3 down, 1x1 up
            down, up = r.randn(rank, shape[1], 3, 3), r.randn(shape[0], rank, 1, 1)
        else:
            down, up = r.randn(rank, shape[1]), r.randn(shape[0], rank)
        root, rest = k.split(".", 1)
        if fmt == "kohya":
            name = ("lora_unet_" if root == "unet" else "lora_te_") + rest.replace(".", "_")
            sd[f"{name}.lora_down.weight"] = down.astype(np.float32) * 0.1
            sd[f"{name}.lora_up.weight"] = up.astype(np.float32) * 0.1
            sd[f"{name}.alpha"] = np.float32(2.0)
        else:
            sd[f"{k}.lora_A.weight"] = down.astype(np.float32) * 0.1
            sd[f"{k}.lora_B.weight"] = up.astype(np.float32) * 0.1
    return sd


@pytest.mark.parametrize("fmt", ["kohya", "peft"])
def test_lora_merge_matches_jax(models, jparams, fmt):
    sd = _lora_sd(models, fmt)
    got = lora.apply_lora(models, CFG, sd, 0.7)
    ref = jlora.apply_lora(jparams, jconfig.tiny_sd_config(), sd, 0.7)
    _assert_state_dicts_equal(state_dicts(got), convert.from_jax_params(ref, CFG),
                              rtol=1e-6, atol=1e-7)
    changed = [n for n in ("clip", "diffusion", "encoder", "decoder")
               if got[n] is not models[n]]
    assert changed == ["clip", "diffusion"]
    # untouched parameters are shared, merged ones new
    assert got["diffusion"].conv_out.weight.data_ptr() == \
        models["diffusion"].conv_out.weight.data_ptr()
    assert not torch.equal(got["diffusion"].encoder[0].res.conv1.weight,
                           models["diffusion"].encoder[0].res.conv1.weight)


def test_peft_adapter_named_keys_merge_where_jax_refuses_them(models, jparams):
    """PEFT's ``.lora_A.default.weight`` keys merge as the plain PEFT form;
    the JAX package's grouping refuses them (its comment names the form,
    its suffix test misses it), a fault the port does not copy."""
    plain = _lora_sd(models, "peft")
    named = {k.replace(".lora_A.", ".lora_A.default.").replace(".lora_B.", ".lora_B.default."): v
             for k, v in plain.items()}
    _assert_state_dicts_equal(state_dicts(lora.apply_lora(models, CFG, named, 0.7)),
                              state_dicts(lora.apply_lora(models, CFG, plain, 0.7)))
    with pytest.raises(ValueError, match="unrecognized LoRA key"):
        jlora.apply_lora(jparams, jconfig.tiny_sd_config(), named, 0.7)


def test_lora_errors(models):
    sd = _lora_sd(models, "kohya")
    with pytest.raises(KeyError, match="no target"):
        lora.apply_lora(models, CFG, dict(sd, **{"lora_unet_nowhere.lora_down.weight":
                                                 np.zeros((4, 2), np.float32)}))
    lora.apply_lora(models, CFG, dict(sd, **{"lora_unet_nowhere.lora_down.weight":
                                             np.zeros((4, 2), np.float32)}), strict=False)
    with pytest.raises(ValueError, match="zero modules"):
        lora.apply_lora(models, CFG, {"lora_unet_nowhere.lora_down.weight":
                                      np.zeros((4, 2), np.float32)}, strict=False)
    with pytest.raises(ValueError, match="LoHa"):
        lora.apply_lora(models, CFG, {"lora_unet_x.hada_w1_a": np.zeros(2)})
    key = next(k for k in sd if k.endswith("lora_up.weight"))
    with pytest.raises(ValueError, match="missing its up factor"):
        lora.apply_lora(models, CFG, {k: v for k, v in sd.items() if k != key})


def test_lora_scale_zero_is_identity(models):
    got = lora.apply_lora(models, CFG, _lora_sd(models, "kohya"), 0.0)
    _assert_state_dicts_equal(state_dicts(got), state_dicts(models))


# ------------------------------------------------------------------ merge
@pytest.fixture(scope="module")
def others():
    """Two more seeded models, and as the JAX package's pytrees."""
    ms = [_models(6), _models(7)]
    return ms, [jconvert.convert({k: v.numpy() for k, v in convert.deconvert(m, CFG).items()},
                                 jconfig.tiny_sd_config()) for m in ms]


@pytest.mark.parametrize("third", [False, True], ids=["weighted_sum", "add_difference"])
def test_merge_matches_jax(models, jparams, others, third):
    others, jothers = others
    got = merge.merge_models(models, others[0], CFG, 0.3, others[1] if third else None)
    ref = jmerge.merge_models(jparams, jothers[0], 0.3, jothers[1] if third else None)
    _assert_state_dicts_equal(state_dicts(got), convert.from_jax_params(ref, CFG), **TOL)


# ----------------------------------------------------- textual inversion
def test_add_embeddings_matches_jax(models, jparams):
    r = np.random.RandomState(3)
    embs = {"<cat-toy>": r.randn(2, 32).astype(np.float32),
            "<style>": r.randn(32).astype(np.float32)}
    tok = make_test_tokenizer(WORDS, max_len=16)
    jtok = jtokenizer.make_test_tokenizer(WORDS, max_len=16)
    got, gtok, gcfg = ti.add_embeddings(models, tok, CFG, embs)
    ref, rtok, rcfg = jti.add_embeddings(jparams, jtok, jconfig.tiny_sd_config(), embs)
    assert gcfg.clip.vocab_size == rcfg.clip.vocab_size == 1024 + 3
    assert got["clip"].cfg.vocab_size == 1027 and models["clip"].cfg.vocab_size == 1024
    np.testing.assert_array_equal(got["clip"].token_embedding.numpy(),
                                  np.asarray(ref["clip"]["token_embedding"]))
    for text in ("a <cat-toy> photo of <style>", "a cat", "<STYLE> dog"):
        assert gtok.encode(text) == rtok.encode(text)
        assert gtok.encode_windows(text) == rtok.encode_windows(text)
    assert tok.encode("<style>") != gtok.encode("<style>")  # the original is untouched
    assert got["diffusion"] is models["diffusion"]
    with pytest.raises(ValueError, match="dim"):
        ti.add_embeddings(models, tok, CFG, {"<bad>": np.zeros((1, 8), np.float32)})
    xl = {"<xl>": {"clip_l": np.zeros((1, 32)), "clip_g": np.zeros((1, 64))}}
    with pytest.raises(ValueError, match="dual-tower"):  # as the JAX package
        jti.add_embeddings(jparams, jtok, jconfig.tiny_sd_config(), xl)
    with pytest.raises(ValueError, match="dual-tower"):
        ti.add_embeddings(models, tok, CFG, xl)


def test_load_embedding_formats_match_jax(tmp_path):
    r = np.random.RandomState(4)
    vec = r.randn(2, 32).astype(np.float32)
    torch.save({"string_to_param": {"*": torch.from_numpy(vec)}, "name": "toy"},
               str(tmp_path / "a1111.pt"))
    save.write_safetensors({"emb_params": torch.from_numpy(vec)},
                           str(tmp_path / "a1111.safetensors"))
    torch.save({"<diff>": torch.from_numpy(vec)}, str(tmp_path / "learned_embeds.bin"))
    save.write_safetensors({"clip_l": torch.zeros(1, 32), "clip_g": torch.zeros(1, 64)},
                           str(tmp_path / "xl.safetensors"))
    for name in ("a1111.pt", "a1111.safetensors", "learned_embeds.bin"):
        got = ti.load_embedding(str(tmp_path / name))
        ref = jti.load_embedding(str(tmp_path / name))
        assert list(got) == list(ref), name
        np.testing.assert_array_equal(next(iter(got.values())).numpy(),
                                      next(iter(ref.values())))
    assert list(ti.load_embedding(str(tmp_path / "a1111.pt"), token="<t>")) == ["<t>"]
    got, ref = ti.load_embedding(str(tmp_path / "xl.safetensors")), \
        jti.load_embedding(str(tmp_path / "xl.safetensors"))
    assert list(got) == list(ref) == ["xl"]
    for k in ("clip_l", "clip_g"):  # the SDXL dual-tower pair, one trigger
        np.testing.assert_array_equal(got["xl"][k].numpy(), ref["xl"][k])


# ---------------------------------------------------------- hypernetwork
def _net(r, d, layer_norm):
    """A 1-2-1 HypernetworkModule state dict; index gaps where A1111 puts
    its activation modules, a LayerNorm after the first Linear."""
    sd = {"linear.0.weight": r.randn(2 * d, d) * 0.2, "linear.0.bias": r.randn(2 * d) * 0.1}
    i = 2
    if layer_norm:
        sd.update({"linear.2.weight": 1.0 + r.randn(2 * d) * 0.1,
                   "linear.2.bias": r.randn(2 * d) * 0.1})
        i = 4
    sd.update({f"linear.{i}.weight": r.randn(d, 2 * d) * 0.2,
               f"linear.{i}.bias": r.randn(d) * 0.1})
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def _hyper_obj(act, layer_norm=False, activate_output=False, d=32, seed=0):
    r = np.random.RandomState(seed)
    return {d: (_net(r, d, layer_norm), _net(r, d, layer_norm)), "name": "hn",
            "activation_func": act, "activate_output": activate_output,
            "add_layer_norm": layer_norm, "layer_structure": [1, 2, 1]}


def _jax_obj(obj):
    return {k: (tuple({n: t.numpy() for n, t in sd.items()} for sd in v)
                if isinstance(k, int) else v) for k, v in obj.items()}


@pytest.mark.parametrize("act,layer_norm,activate_output",
                         [(a, False, False) for a in sorted(hyper.ACTIVATIONS)]
                         + [("relu", True, False), ("mish", True, True),
                            ("gelu", False, True)])
def test_apply_hypernetwork_matches_jax(act, layer_norm, activate_output, tmp_path):
    obj = _hyper_obj(act, layer_norm, activate_output)
    path = str(tmp_path / "hn.pt")
    torch.save(obj, path)
    net, meta = hyper.load_hypernetwork(path)
    tree, jmeta = jhyper.load_hypernetwork(_jax_obj(obj))
    assert meta == jmeta == (act, activate_output)
    ctx = np.random.RandomState(1).randn(2, 20, 32).astype(np.float32)
    for strength in (0.0, 0.7):
        got = hyper.apply_hypernetwork(net, torch.from_numpy(ctx), torch.tensor(strength),
                                       activation=act, activate_output=activate_output)
        ref = jhyper.apply_hypernetwork(tree, jnp.asarray(ctx), jnp.float32(strength),
                                        activation=act, activate_output=activate_output)
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        if strength == 0.0:
            assert all(torch.equal(g, torch.from_numpy(ctx)) for g in got)
    # the JAX tree converts to the same module
    conv = convert.hypernetwork_from_jax(tree)
    for a, b in zip(conv.state_dict().values(), net.state_dict().values()):
        assert torch.equal(a, b)


def test_hypernetwork_loader_errors():
    with pytest.raises(ValueError, match="activation"):
        hyper.load_hypernetwork(_hyper_obj("nope"))
    with pytest.raises(ValueError, match="unexpected hypernetwork key"):
        hyper.load_hypernetwork(dict(_hyper_obj("relu"), bogus=1))
    net, meta = hyper.load_hypernetwork(_hyper_obj("relu", d=16))
    with pytest.raises(ValueError, match="context width 32"):
        hyper.apply_hypernetwork(net, torch.zeros(1, 4, 32), torch.tensor(1.0),
                                 activation="relu", activate_output=False)


# ------------------------------------------------------------------- rng
def test_chunk_stream_golden_values():
    """generate_many's chunk seeds — frozen, as the other streams are."""
    assert rng.chunk_seed(1337, 0) == 1337
    assert rng.chunk_seed(1337, 1) == rng.stream_seed(1337, "chunk", 1)
    assert rng.chunk_seed(1337, 1) == 14915361323046399603
    assert rng.chunk_seed(1337, 2) == 2247497234211070013
    assert rng.chunk_seed(0, 1) not in (0, 1, rng.chunk_seed(1, 1))
    first = float(rng.batch_normal(rng.chunk_seed(1337, 1), "latent_init", 1, (4,))[0, 0])
    np.testing.assert_allclose(first, 0.41413167119026184, rtol=1e-6)


# --------------------------------------------- requests against generate()
STEPS = 2


def _noise(batch, hw, seed=11):
    r = np.random.RandomState(seed)
    lat = hw // 2
    return {"latent_init": r.randn(batch, lat, lat, 4).astype(np.float32),
            "sampler_noise": r.randn(STEPS, batch, lat, lat, 4).astype(np.float32)}


def _nchw(noise):
    return {"latent_init": to_nchw(noise["latent_init"]),
            "sampler_noise": np.transpose(noise["sampler_noise"], (0, 1, 4, 2, 3))}


#: 19 windows of the tiny tokenizer's 16 tokens: a 304-token context
LONG_PROMPT = " ".join(["a photo of a cat of a dog"] * 30) + " BREAK a cat"
#: cross-attentions per UNet evaluation of tiny_sd_config
CROSS_ATTN = 6


def test_hypernetwork_request_matches_jax(models, jparams):
    """FP32, 32x32: every cross-attention over the 304-token context runs
    the port's K2 plain version on k and v projected from the pair's own
    contexts (two allocations), the JAX package its one-pass Pallas kernel
    in interpret mode."""
    obj = _hyper_obj("relu", layer_norm=True, seed=3)
    net, meta = hyper.load_hypernetwork(obj)
    tree, _ = jhyper.load_hypernetwork(_jax_obj(obj))
    noise = _noise(1, 32)
    kw = dict(uncond_prompt="a dog", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=32, width=32, return_latents=True, long_prompts=True,
              hypernetwork=meta, hypernetwork_strength=0.7)
    ref_img, ref_lat = jpipeline.generate(
        LONG_PROMPT, models=dict(jparams, hypernetwork=tree),
        tokenizer=jtokenizer.make_test_tokenizer(WORDS, max_len=16),
        config=jconfig.tiny_sd_config(attention_backend="pallas"), fixed_noise=noise, **kw)
    cfg = tiny_sd_config(attention_backend="kernel")
    with mock.patch.object(fa, "flash_attention_onepass_plain",
                           wraps=fa.flash_attention_onepass_plain) as k2:
        img, lat = pipeline.generate(LONG_PROMPT, models=dict(models, hypernetwork=net),
                                     tokenizer=make_test_tokenizer(WORDS, max_len=16),
                                     config=cfg, fixed_noise=_nchw(noise), **kw)
    assert k2.call_count == CROSS_ATTN * STEPS
    _, k, v = k2.call_args.args[:3]
    assert k.shape[2] == 19 * 16
    assert k.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0
    with pytest.raises(ValueError, match="prompt editing"):
        pipeline.generate("a [cat:dog:1] photo", models=dict(models, hypernetwork=net),
                          tokenizer=make_test_tokenizer(WORDS, max_len=16), config=cfg,
                          n_inference_steps=STEPS, height=16, width=16, hypernetwork=meta)
    with pytest.raises(ValueError, match="no 'hypernetwork' entry"):
        pipeline.generate("a cat", models=models, config=cfg, hypernetwork=meta,
                          tokenizer=make_test_tokenizer(WORDS, max_len=16))
    narrow, _ = hyper.load_hypernetwork(_hyper_obj("relu", d=16))
    with pytest.raises(ValueError, match="no entry for context width 32"):
        pipeline.generate("a cat", models=dict(models, hypernetwork=narrow), config=cfg,
                          hypernetwork=meta, tokenizer=make_test_tokenizer(WORDS, max_len=16))


def test_textual_inversion_request_matches_jax(models, jparams):
    emb = {"<toy>": np.random.RandomState(8).randn(2, 32).astype(np.float32)}
    tmodels, ttok, tcfg = ti.add_embeddings(models, make_test_tokenizer(WORDS, max_len=16),
                                            CFG, emb)
    jmodels, jtok, jcfg = jti.add_embeddings(
        jparams, jtokenizer.make_test_tokenizer(WORDS, max_len=16),
        jconfig.tiny_sd_config(), emb)
    assert max(ttok.encode("a <toy> cat")) >= 1024
    noise = _noise(1, 16)
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=STEPS, seed=0,
              height=16, width=16, return_latents=True)
    ref_img, ref_lat = jpipeline.generate("a <toy> cat", models=jmodels, tokenizer=jtok,
                                          config=jcfg, fixed_noise=noise, **kw)
    img, lat = pipeline.generate("a <toy> cat", models=tmodels, tokenizer=ttok, config=tcfg,
                                 fixed_noise=_nchw(noise), **kw)
    assert psnr(lat, to_nchw(ref_lat)) > 55.0
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_generate_many_matches_jax(models, jparams):
    """5 prompts in chunks of 2 (the last padded) under injected noise."""
    prompts = ["a cat", "a dog", "a photo of a cat", "of a dog", "cat"]
    noise = _noise(2, 16)
    kw = dict(batch_size=2, n_inference_steps=STEPS, seed=3, height=16, width=16)
    ref = jpipeline.generate_many(prompts, "", models=jparams,
                                  tokenizer=jtokenizer.make_test_tokenizer(WORDS, max_len=16),
                                  config=jconfig.tiny_sd_config(), fixed_noise=noise, **kw)
    got = pipeline.generate_many(prompts, "", models=models,
                                 tokenizer=make_test_tokenizer(WORDS, max_len=16),
                                 config=CFG, fixed_noise=_nchw(noise), **kw)
    assert got.shape == ref.shape == (5, 16, 16, 3) and got.dtype == np.uint8
    assert psnr(got.astype(np.float32), ref.astype(np.float32)) > 40.0


# ------------------------------------------------- SDXL (slice C2)
def _sdxl_lora_sd(models, cfg, fmt, seed=5):
    """A LoRA over SDXL targets: CLIP-L (``lora_te1_``) and bigG
    (``lora_te2_``, its text projection too) linears, the UNet's linears in
    a stacked block's second layer, its 1x1 proj convs (linear factors) and
    a 3x3 res conv (LoCon)."""
    r = np.random.RandomState(seed)
    targets = lora._weight_targets(cfg)
    picked = [k for k in sorted(targets)
              if any(s in k for s in ("transformer_blocks.1.attn1.to_q", "attn2.to_v",
                                      "proj_in", "resnets.0.conv1", "self_attn.k_proj",
                                      "mlp.fc1", "text_projection", "add_embedding.linear_1"))]
    assert any(k.startswith("text_encoder_2.") for k in picked)
    assert "text_encoder_2.text_projection" in picked
    sds = state_dicts(models)
    sd = {}
    for k in picked:
        model, dst, kind = targets[k][0]
        shape = sds[model][dst].shape
        if kind == "linear_t":  # the port keeps (in, out); the file's Linear is (out, in)
            shape = shape[::-1]
        rank = 4
        if len(shape) == 4 and shape[2] == 3:
            down, up = r.randn(rank, shape[1], 3, 3), r.randn(shape[0], rank, 1, 1)
        else:
            down, up = r.randn(rank, shape[1]), r.randn(shape[0], rank)
        root, rest = k.split(".", 1)
        if fmt == "kohya":
            name = {"unet": "lora_unet_", "text_encoder": "lora_te1_",
                    "text_encoder_2": "lora_te2_"}[root] + rest.replace(".", "_")
            sd[f"{name}.lora_down.weight"] = down.astype(np.float32) * 0.1
            sd[f"{name}.lora_up.weight"] = up.astype(np.float32) * 0.1
            sd[f"{name}.alpha"] = np.float32(2.0)
        else:
            sd[f"{k}.lora_A.weight"] = down.astype(np.float32) * 0.1
            sd[f"{k}.lora_B.weight"] = up.astype(np.float32) * 0.1
    return sd


@pytest.mark.parametrize("fmt", ["kohya", "peft"])
def test_sdxl_lora_merge_matches_jax(families, fmt):
    """Both towers' roots (``lora_te1_``/``lora_te2_``, ``text_encoder.`` /
    ``text_encoder_2.``) and the stacked layers' UNet targets, merged
    against JAX ``weights/lora.py`` on the same weights, within 1e-6."""
    cfg, jcfg, jp, xl_models = families["sdxl"]
    sd = _sdxl_lora_sd(xl_models, cfg, fmt)
    got = lora.apply_lora(xl_models, cfg, sd, 0.7)
    ref = jlora.apply_lora(jp, jcfg, sd, 0.7)
    _assert_state_dicts_equal(state_dicts(got), convert.from_jax_params(ref, cfg),
                              rtol=1e-6, atol=1e-7)
    assert [n for n in config.model_names(cfg) if got[n] is not xl_models[n]] == \
        ["clip", "clip2", "diffusion"]


def test_sdxl_dual_tower_textual_inversion_matches_jax(families):
    """A dual-tower embedding grows both token tables together, with the
    same ids, as the JAX package's; a single-tower embedding on SDXL raises
    ValueError in both."""
    cfg, jcfg, jp, xl_models = families["sdxl"]
    r = np.random.RandomState(6)
    embs = {"<xl-toy>": {"clip_l": r.randn(2, 16).astype(np.float32),
                         "clip_g": r.randn(2, 32).astype(np.float32)}}
    got, gtok, gcfg = ti.add_embeddings(xl_models, make_test_tokenizer(WORDS, max_len=16),
                                        cfg, embs)
    ref, rtok, rcfg = jti.add_embeddings(jp, jtokenizer.make_test_tokenizer(WORDS, max_len=16),
                                         jcfg, embs)
    assert gcfg.clip.vocab_size == gcfg.clip2.vocab_size == rcfg.clip2.vocab_size == 1026
    for tower in ("clip", "clip2"):
        np.testing.assert_array_equal(got[tower].token_embedding.numpy(),
                                      np.asarray(ref[tower]["token_embedding"]))
    assert gtok.encode("a <xl-toy> cat") == rtok.encode("a <xl-toy> cat")
    assert got["diffusion"] is xl_models["diffusion"]
    single = {"<one>": np.zeros((1, 16), np.float32)}
    for fn, m, t, c in ((ti.add_embeddings, xl_models, make_test_tokenizer(WORDS, max_len=16),
                         cfg),
                        (jti.add_embeddings, jp, jtokenizer.make_test_tokenizer(WORDS, max_len=16),
                         jcfg)):
        with pytest.raises(ValueError, match="single-tower"):
            fn(m, t, c, single)
