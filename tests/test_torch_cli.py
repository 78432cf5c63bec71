"""The port's command line (``python -m pytorch_stable_diffusion_tpu_torch``)
against the JAX package's and the port's own API, on the CPU.

The parser takes every flag and default of the JAX package's
``build_parser`` but three: ``--backend`` names the port's attention
backends (default "kernel"), ``--device`` is new (default "cuda"), and the
compilation cache (TPU-only) is gone.  ``main`` runs on a tiny checkpoint
the port saves and tokenizer files the test writes; each PNG's pixels
equal ``StableDiffusion``'s image of the same request, and the PNG carries
the JAX CLI's A1111 infotext.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu.__main__ import build_parser as jax_build_parser
from pytorch_stable_diffusion_tpu_torch.__main__ import build_parser, main
from pytorch_stable_diffusion_tpu_torch.api import StableDiffusion
from pytorch_stable_diffusion_tpu_torch.models import build_models, config, state_dicts
from pytorch_stable_diffusion_tpu_torch.weights.save import save_safetensors
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import bytes_to_unicode

WORDS = ["a", "cat", "dog"]


def write_tokenizer_assets(tmpdir, words):
    """Char-level vocab/merges FILES (same scheme as make_test_tokenizer);
    a copy of the JAX package's tests/test_cli.py helper."""
    btu = bytes_to_unicode()
    vocab, merges, seen = {}, [], set()

    def add(tok):
        if tok not in vocab:
            vocab[tok] = len(vocab)

    for ch in btu.values():
        add(ch)
        add(ch + "</w>")
    for w in words:
        chars = [btu[b] for b in w.encode("utf-8")]
        chars[-1] += "</w>"
        while len(chars) > 1:
            pair = (chars[0], chars[1])
            if pair not in seen:
                seen.add(pair)
                merges.append(pair)
                add(pair[0] + pair[1])
            chars[:2] = [chars[0] + chars[1]]
    add("<|startoftext|>")
    add("<|endoftext|>")
    vocab_path = os.path.join(tmpdir, "vocab.json")
    merges_path = os.path.join(tmpdir, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: test\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_is_the_jax_parser_but_three_flags():
    ours, ref = _actions(build_parser()), _actions(jax_build_parser())
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert ours["device"].default == "cuda"
    assert ours["backend"].default == "kernel"
    assert ours["backend"].choices == ["plain", "kernel"]
    for dest, a in ref.items():
        b = ours[dest]
        assert (b.option_strings, b.nargs, b.type, b.required, b.const) == \
            (a.option_strings, a.nargs, a.type, a.required, a.const), dest
        if dest != "backend":
            assert (b.default, b.choices) == (a.default, a.choices), dest


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    cfg = config.tiny_sd_config()
    models = build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    ckpt = os.path.join(d, "tiny.safetensors")
    save_safetensors(state_dicts(models), cfg, ckpt)
    vocab, merges = write_tokenizer_assets(d, WORDS)
    init = os.path.join(d, "init.png")
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)) \
        .save(init)
    sd = StableDiffusion.from_checkpoint(
        ckpt, vocab, merges, config=config.tiny_sd_config(attention_backend="kernel"),
        device="cpu")
    return d, ckpt, vocab, merges, init, sd


def _main(assets, name, *extra):
    d, ckpt, vocab, merges = assets[:4]
    out = os.path.join(d, name)
    assert main(["--ckpt", ckpt, "--vocab", vocab, "--merges", merges, "--prompt", "a cat",
                 "--steps", "2", "--seed", "9", "--width", "32", "--height", "32",
                 "--sampler", "ddim", "--config-preset", "tiny", "--device", "cpu",
                 "--out", out, *extra]) == 0
    return Image.open(out)


def test_cli_txt2img_equals_the_api(assets):
    png = _main(assets, "txt.png")
    want = assets[5].txt2img("a cat", seed=9, n_inference_steps=2, height=32, width=32,
                             sampler_name="ddim")
    np.testing.assert_array_equal(np.asarray(png), want)


def test_cli_img2img_equals_the_api(assets):
    png = _main(assets, "img.png", "--image", assets[4], "--strength", "0.6")
    want = assets[5].img2img("a cat", Image.open(assets[4]).convert("RGB"), strength=0.6,
                             seed=9, n_inference_steps=2, height=32, width=32,
                             sampler_name="ddim")
    np.testing.assert_array_equal(np.asarray(png), want)


def test_cli_png_infotext(assets):
    """The JAX CLI's A1111 'parameters' tEXt chunk, to the character."""
    png = _main(assets, "meta.png", "--uncond-prompt", "a dog")
    assert png.text["parameters"] == (
        "a cat\nNegative prompt: a dog\nSteps: 2, Sampler: ddim, CFG scale: 7.5, "
        f"Seed: 9, Size: 32x32, Denoising strength: 0.8, Model: {assets[1]}")
