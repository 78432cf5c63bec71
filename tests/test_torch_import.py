"""The PyTorch port imports without jax, and its copied pure-Python pieces
agree with the JAX package's originals."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pytorch_stable_diffusion_tpu import prompt_schedule as jax_schedule
from pytorch_stable_diffusion_tpu.models import motion as jax_motion
from pytorch_stable_diffusion_tpu.utils import annotators as jax_annotators
from pytorch_stable_diffusion_tpu.weights import ckpt_reader as jax_ckpt_reader
from pytorch_stable_diffusion_tpu.weights import tokenizer as jax_tokenizer
from pytorch_stable_diffusion_tpu_torch import prompt_schedule as torch_schedule
from pytorch_stable_diffusion_tpu_torch.models import motion as torch_motion
from pytorch_stable_diffusion_tpu_torch.utils import annotators as torch_annotators
from pytorch_stable_diffusion_tpu_torch.weights import ckpt_reader as torch_ckpt_reader
from pytorch_stable_diffusion_tpu_torch.weights import tokenizer as torch_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "pytorch_stable_diffusion_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pytorch_stable_diffusion_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "pytorch_stable_diffusion_tpu."))
             or n == "pytorch_stable_diffusion_tpu")
print("IMPORTED", " ".join(sorted(n for n in sys.modules if n.startswith(p.__name__ + "."))))
print("BAD", bad)
"""
#: the modules that hold a kernel's wrapper and plain version
KERNEL_MODULES = ("ops.cuda.flash_attention", "ops.cuda.conv")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    names = re.search(r"IMPORTED (.*)", out.stdout).group(1).split()
    assert len(names) >= 24  # every module of the slices was imported
    for mod in KERNEL_MODULES + ("ops.norm", "ops.tome", "models.unet", "pipeline", "api",
                                 "utils.annotators", "utils.image", "models.controlnet",
                                 "models.t2i_adapter", "models.clip_vision", "models.motion",
                                 "models.esrgan") + tuple(
            f"weights.{m}" for m in ("ckpt_reader", "native_io", "convert", "diffusers", "lora",
                                     "textual_inversion", "hypernetwork", "merge", "stream",
                                     "save", "ip_adapter", "animatediff", "esrgan")):
        assert f"pytorch_stable_diffusion_tpu_torch.{mod}" in names, mod


def test_every_kernel_source_has_a_wrapper():
    """Each CUDA source of csrc/ is built by the wrapper module that names
    it (ops/cuda/build.py loads ``csrc/<name>.cu``)."""
    sources = sorted(f[:-3] for f in os.listdir(os.path.join(PACKAGE, "csrc"))
                     if f.endswith(".cu"))
    wrappers = ""
    for mod in KERNEL_MODULES:
        with open(os.path.join(PACKAGE, *mod.split(".")) + ".py") as f:
            wrappers += f.read()
    assert sources == ["flash_attention_bsc", "flash_attention_multipass",
                       "flash_attention_onepass", "flash_attention_streamed",
                       "scaled_silu_conv3x3"]
    for name in sources:
        assert f'"{name}"' in wrappers or f"sdt_{name}" in wrappers, name


def test_every_kernel_header_is_built():
    """Each shared header of csrc/ is included by a kernel source, directly or
    through another header, so build.py's hash of every header covers what
    the libraries are built from and no header is left unbuilt."""
    csrc = os.path.join(PACKAGE, "csrc")
    text = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
            if f.endswith((".cu", ".cuh"))}
    reached = {f for f in text if f.endswith(".cu")}
    while True:
        more = {h for h in text if h.endswith(".cuh") and h not in reached
                and any(f'#include "{h}"' in text[f] for f in reached)}
        if not more:
            break
        reached |= more
    assert sorted(h for h in text if h.endswith(".cuh")) == sorted(
        h for h in reached if h.endswith(".cuh"))
    assert "wgmma.mma_async" in text["wgmma.cuh"]
    assert "cp.async.bulk.tensor" in text["flash_attention_tc.cuh"]
    for name in ("flash_attention_bsc.cu", "flash_attention_streamed.cu",
                 "flash_attention_onepass.cu", "flash_attention_multipass.cu",
                 "scaled_silu_conv3x3.cu"):
        assert '#include "flash_attention_tc.cuh"' in text[name], name


def test_k2_bf16_path_is_the_wgmma_template():
    """K2's bf16 path is the wgmma + TMA template of K1 and K4 in its
    one-pass form, with no mma.sync body left beside it; its fp32 path
    stays on the CUDA cores."""
    with open(os.path.join(PACKAGE, "csrc", "flash_attention_onepass.cu")) as f:
        text = f.read()
    with open(os.path.join(PACKAGE, "csrc", "flash_attention_tc.cuh")) as f:
        template = f.read()
    assert "mma.sync" not in text and "ldmatrix" not in text
    assert "sdt_tc::attention_tc_body<DH, NWG, true, atom_of(DH)>" in text
    assert "attention_tc_body<DH, NWG, false>" in template  # K1 and K4
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in text  # K2's wide, swizzled TMA boxes
    assert "wgmma" in template and "mma.sync" not in template
    assert "onepass_f32_kernel" in text
    # the C interface the wrapper binds is unchanged
    assert re.search(r"int sdt_flash_attention_onepass\(const void\* q, const void\* k, "
                     r"const void\* v, void\* o,\s+const long long\* strides, int batch, "
                     r"int n_heads, int sq,\s+int sk, int head_dim, int dtype, int causal, "
                     r"void\* stream\)", text)


def _built_widths(source, pattern):
    with open(os.path.join(PACKAGE, "csrc", source)) as f:
        return sorted(int(d) for d in re.findall(pattern, f.read()))


@pytest.mark.parametrize("kernel", ["bsc", "streamed", "onepass", "multipass"])
def test_wrapper_head_dims_match_the_sources(kernel):
    """The head dims ``takes_head_dim`` admits on the card are those each
    kernel source dispatches to: K1's SDT_CASE list, K4's and K2's
    ``case D: return launch<D>`` switch, and K3's guard (a multiple of 8 up
    to its largest padded width) with each Dh padded to the first width
    that holds it, in both dtypes."""
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    if kernel == "multipass":
        with open(os.path.join(PACKAGE, "csrc", "flash_attention_multipass.cu")) as f:
            text = f.read()
        guard = re.search(r"head_dim > (\d+) \|\| head_dim % 8\)", text)
        assert guard and int(guard.group(1)) == fa.MULTIPASS_MAX_DH
        for launch in ("launch", "launch_fp32"):
            # if (dh <= N) return launch<N>(...); ...; return launch<MAX>(...)
            steps = re.findall(rf"if \(dh <= (\d+)\)\s*return {launch}<(\d+)>", text)
            assert steps and all(a == b for a, b in steps), launch
            last = re.findall(rf"\n  return {launch}<(\d+)>", text)
            assert last == [str(fa.MULTIPASS_MAX_DH)], launch
        built = [dh for dh in range(1, 1025) if fa.takes_head_dim(kernel, dh)]
        assert built == list(range(8, fa.MULTIPASS_MAX_DH + 1, 8))
        return
    source, pattern = {
        "bsc": ("flash_attention_bsc.cu", r"SDT_CASE\((\d+)\)\n"),
        "streamed": ("flash_attention_streamed.cu", r"case (\d+): return launch<\1>"),
        "onepass": ("flash_attention_onepass.cu", r"case (\d+): return launch<\1>"),
    }[kernel]
    dims = _built_widths(source, pattern)
    assert dims, source
    assert dims == [dh for dh in range(1, 1025) if fa.takes_head_dim(kernel, dh)]
    assert not fa.takes_head_dim(kernel, max(dims) + 8)
    if kernel == "onepass":  # the schedule report dispatches the same head dims
        assert _built_widths(source, r"SDT_PLAN\((\d+)\)[ \n]") == dims


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+pytorch_stable_diffusion_tpu\b(?!_torch)",
                         src, re.M), path


WORDS = ["a", "cat", "dog", "photo", "of", "the", "painting"]
TEXTS = ["a photo of a cat", "The Painting", "a  cat\n of\tdog", "cat&dog!!",
         "catdog", "", "caté", " ".join(["painting"] * 100)]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_copies_agree(text):
    ours = torch_tokenizer.make_test_tokenizer(WORDS, max_len=16)
    ref = jax_tokenizer.make_test_tokenizer(WORDS, max_len=16)
    assert ours.encode(text) == ref.encode(text)
    assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    assert ours.encode_windows(text) == ref.encode_windows(text)


def _body(mod):
    """A module's source below its docstring."""
    with open(mod.__file__) as f:
        return f.read().split('"""', 2)[2]


def test_tokenizer_copy_is_verbatim_below_the_docstring():
    """The copy may differ from the original only in its module docstring."""
    assert _body(torch_tokenizer) == _body(jax_tokenizer)


def test_ckpt_reader_copy_differs_only_in_its_bf16_view():
    """Below the docstring the copy is the original but for ``_bf16``, which
    reads BF16 storages as raw uint16 instead of importing ml_dtypes."""
    import difflib

    diff = [line for line in difflib.unified_diff(
        _body(jax_ckpt_reader).splitlines(), _body(torch_ckpt_reader).splitlines(),
        lineterm="", n=0) if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert diff == ["-    import ml_dtypes", "-",
                    "-    return np.dtype(ml_dtypes.bfloat16)",
                    "+    return np.dtype(np.uint16)  # raw bf16 bits: no storage type here "
                    "is uint16"]


def test_prompt_schedule_copy_is_verbatim_below_the_docstring():
    assert _body(torch_schedule) == _body(jax_schedule)


#: tests/test_prompt_schedule.py's prompts
SCHEDULED = ["a [cat:dog:0.5] pet", "[cat:dog:1]", "x[ add:2]", "[drop ::2]now",
             "[a|b|c]", "a [word] here", "(cat:1.3)", "[big [cat:dog:1]]", "plain"]


@pytest.mark.parametrize("text", SCHEDULED)
def test_prompt_schedule_copies_agree(text):
    assert torch_schedule.has_schedule(text) == jax_schedule.has_schedule(text)
    for step in range(1, 7):
        assert torch_schedule.realize(text, step, 6) == jax_schedule.realize(text, step, 6)
    ours, idx = torch_schedule.schedule_prompts([text, "x"], ["", text], 6)
    ref, ref_idx = jax_schedule.schedule_prompts([text, "x"], ["", text], 6)
    assert ours == ref
    np.testing.assert_array_equal(idx, ref_idx)


def test_tome_plan_copy_is_verbatim():
    """``ops/tome.py`` keeps a copy of the JAX package's pure-numpy ``plan``
    (the import test above shows the module imports without jax): the same
    source text, and the same plans."""
    import inspect

    from pytorch_stable_diffusion_tpu.ops import tome as jax_tome
    from pytorch_stable_diffusion_tpu_torch.ops import tome as torch_tome

    assert inspect.getsource(torch_tome.plan) == inspect.getsource(jax_tome.plan)
    for h, w, sx, sy, ratio in ((64, 64, 2, 2, 0.5), (32, 48, 2, 2, 0.3), (6, 4, 1, 2, 0.9),
                                (4, 4, 2, 2, 0.99)):
        for ours, ref in zip(torch_tome.plan(h, w, sx, sy, ratio),
                             jax_tome.plan(h, w, sx, sy, ratio)):
            np.testing.assert_array_equal(ours, ref)


def test_blur_copy_is_verbatim():
    """The port's ``utils/annotators.py`` is the original below its
    docstring: every annotator (``blur`` and the two helpers it calls, and
    slice E's canny, lineart, scribble, invert and hint_rgb), each the
    original's source text."""
    import inspect

    assert _body(torch_annotators) == _body(jax_annotators)
    names = sorted(n for n, v in vars(jax_annotators).items()
                   if callable(v) and getattr(v, "__module__", "") == jax_annotators.__name__)
    assert names == ["_gauss_kernel", "_sobel", "blur", "canny", "hint_rgb", "invert",
                     "lineart", "scribble", "to_hint"]
    for name in names:
        assert inspect.getsource(getattr(torch_annotators, name)) == \
            inspect.getsource(getattr(jax_annotators, name)), name


ANNOTATED = {"uint8 RGB": lambda r: r.randint(0, 256, (24, 20, 3)).astype(np.uint8),
             "unit gray": lambda r: r.rand(19, 23).astype(np.float32),
             "blocks": lambda r: np.kron(r.rand(4, 4), np.ones((6, 6))).astype(np.float32)}
ANNOTATORS = {"canny": {}, "canny 0.05/0.3": dict(low=0.05, high=0.3, sigma=1.0),
              "lineart": {}, "scribble": dict(threshold=0.3, thickness=2), "invert": {},
              "to_hint": {}}


@pytest.mark.parametrize("annotator", list(ANNOTATORS))
@pytest.mark.parametrize("kind", list(ANNOTATED))
def test_annotator_copies_agree(kind, annotator):
    """Each annotator of the copy gives the original's array exactly, and
    hint_rgb of it the original's uint8 hint image."""
    x = ANNOTATED[kind](np.random.RandomState(12))
    name = annotator.split()[0]
    got = getattr(torch_annotators, name)(x, **ANNOTATORS[annotator])
    want = getattr(jax_annotators, name)(x, **ANNOTATORS[annotator])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(torch_annotators.hint_rgb(got), jax_annotators.hint_rgb(want))
    assert got.shape == x.shape[:2]


BLURRED = {"unit mask": lambda r: (r.rand(24, 20) > 0.5).astype(np.float32),
           "uint8 RGB": lambda r: r.randint(0, 256, (24, 20, 3)).astype(np.uint8),
           "0..255 float": lambda r: (r.rand(17, 9) * 255).astype(np.float32)}


@pytest.mark.parametrize("sigma", [0.5, 2.0, 4.0])
@pytest.mark.parametrize("kind", list(BLURRED))
def test_blur_copies_agree(kind, sigma):
    x = BLURRED[kind](np.random.RandomState(11))
    got = torch_annotators.blur(x, sigma=sigma)
    np.testing.assert_array_equal(got, jax_annotators.blur(x, sigma=sigma))
    assert got.shape == x.shape[:2] and got.dtype == np.float32


@pytest.mark.parametrize("length,channels", [(16, 320), (32, 640), (24, 1280), (3, 2)])
def test_positional_encoding_copies_agree(length, channels):
    """The motion modules' sinusoidal table, built in float64 and cast to
    float32 by both copies: equal bit for bit."""
    got = torch_motion.positional_encoding(length, channels)
    want = jax_motion.positional_encoding(length, channels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
