"""The port's ``StableDiffusion`` API and ``generate_many`` at the tiny
config on the CPU: the port's forms of the JAX package's tests/test_api.py
cases (txt2img, img2img, batch, the checkpoint round trip) and of
tests/test_generate_many.py's five; the hypernetwork carried through every
``with_*`` method; the refusals of ``mesh=``, of the later slices' methods
and of a missing card.
"""

import json

import numpy as np
import pytest
import torch

from pytorch_stable_diffusion_tpu_torch import StableDiffusion, generate_many, generate_images
from pytorch_stable_diffusion_tpu_torch.models import build_models, state_dicts
from pytorch_stable_diffusion_tpu_torch.models.config import tiny_sd_config
from pytorch_stable_diffusion_tpu_torch.weights import hypernetwork as hyper
from pytorch_stable_diffusion_tpu_torch.weights import lora, save
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

N_STEPS = 2
H = W = 16
CFG = tiny_sd_config()
WORDS = ["a", "cat", "dog", "photo", "of"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the tiny tensors (as tests/test_torch_samplers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models(CFG, device="cpu", generator=torch.Generator().manual_seed(9))


@pytest.fixture(scope="module")
def tok():
    return make_test_tokenizer(WORDS, max_len=CFG.clip.max_len)


@pytest.fixture(scope="module")
def sd(models, tok):
    return StableDiffusion(models, tok, CFG, device="cpu")


KW = dict(n_inference_steps=N_STEPS, height=H, width=W)


def test_txt2img(sd):
    img = sd.txt2img("a cat", seed=1, **KW)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8


def test_img2img(sd):
    init = (np.random.RandomState(0).rand(H, W, 3) * 255).astype(np.uint8)
    img = sd.img2img("a cat", init, strength=0.5, seed=1, **KW)
    assert img.shape == (H, W, 3)


def test_batch(sd):
    imgs = sd.generate_batch(["a cat", "a dog"], seed=1, **KW)
    assert imgs.shape == (2, H, W, 3)


def test_from_checkpoint_roundtrip(sd, tok, tmp_path):
    """Save, reload through the files a user has (the checkpoint, vocab.json
    and merges.txt), and generate the same image."""
    ckpt = str(tmp_path / "m.safetensors")
    save.save_safetensors(sd.models, CFG, ckpt)
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(tok.encoder, f)
    with open(tmp_path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
        for a, b in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get):
            f.write(f"{a} {b}\n")
    sd2 = StableDiffusion.from_checkpoint(ckpt, str(tmp_path / "vocab.json"),
                                          str(tmp_path / "merges.txt"), config=CFG,
                                          device="cpu")
    for name, sd_ in state_dicts(sd2.models).items():
        for k, v in sd_.items():
            assert torch.equal(v, sd.models[name].state_dict()[k]), (name, k)
    img = sd2.txt2img("a cat", seed=1, **KW)
    assert img.shape == (H, W, 3)
    np.testing.assert_array_equal(img, sd.txt2img("a cat", seed=1, **KW))


# ------------------------------------------------------------ generate_many
def _kw(models, tok):
    return dict(models=models, tokenizer=tok, config=CFG, **KW)


def test_generate_many_first_chunk_matches_generate_images(models, tok):
    prompts = ["a cat", "a dog", "a photo", "of a cat", "dog"]  # 5 = 2 + 2 + 1 padded
    many = generate_many(prompts, batch_size=2, seed=7, **_kw(models, tok))
    assert many.shape == (5, H, W, 3) and many.dtype == np.uint8
    # chunk 0 uses the request's seed: it equals a plain generate_images call
    np.testing.assert_array_equal(many[0:2], generate_images(prompts[0:2], seed=7,
                                                             **_kw(models, tok)))
    np.testing.assert_array_equal(many, generate_many(prompts, batch_size=2, seed=7,
                                                      **_kw(models, tok)))


def test_generate_many_no_cross_call_seed_collision(models, tok):
    """seed 0's chunk 1 is not seed 1's chunk 0, as ``seed + k`` would make it."""
    a = generate_many(["cat", "cat"], batch_size=1, seed=0, **_kw(models, tok))
    b = generate_many(["cat", "cat"], batch_size=1, seed=1, **_kw(models, tok))
    assert (a[1] != b[0]).any()
    assert (a[1] != b[1]).any()


def test_generate_many_distinct_chunks_differ(models, tok):
    imgs = generate_many(["cat", "cat"], batch_size=1, seed=0, **_kw(models, tok))
    assert (imgs[0] != imgs[1]).any()


def test_generate_many_empty(models, tok):
    out = generate_many([], **_kw(models, tok))
    assert out.shape == (0, H, W, 3) and out.dtype == np.uint8


def test_generate_many_uncond_length_check(models, tok):
    with pytest.raises(ValueError, match="length"):
        generate_many(["a", "b"], ["u"] * 3, **_kw(models, tok))


def test_generate_many_chunks_per_sample_init_images(sd):
    """A 4-D init image array goes with its prompts, the last chunk padded."""
    init = (np.random.RandomState(1).rand(3, H, W, 3) * 255).astype(np.uint8)
    many = sd.generate_many(["a cat"] * 3, batch_size=2, seed=4, input_image=init,
                            strength=0.6, **KW)
    first = sd.generate_batch(["a cat"] * 2, seed=4, input_image=init[:2], strength=0.6, **KW)
    np.testing.assert_array_equal(many[:2], first)
    with pytest.raises(ValueError, match="input images"):
        sd.generate_many(["a cat"] * 2, input_image=init, **KW)


def test_prompt_matrix_and_xyz_grid(sd):
    grid = sd.prompt_matrix("a cat|photo|dog", batch_size=4, seed=1, **KW)
    assert grid.shape == (2 * H, 2 * W, 3)
    grid = sd.xyz_grid("a cat", x=("cfg_scale", [5.0, 7.5]), y=("seed", [1, 2, 3]), **KW)
    assert grid.shape == (3 * H, 2 * W, 3)


# ---------------------------------------------------------- with_* methods
def _hypernetwork(d=32):
    r = np.random.RandomState(2)

    def net():
        return {"linear.0.weight": torch.from_numpy(r.randn(2 * d, d).astype(np.float32)) * 0.2,
                "linear.0.bias": torch.zeros(2 * d),
                "linear.2.weight": torch.from_numpy(r.randn(d, 2 * d).astype(np.float32)) * 0.2,
                "linear.2.bias": torch.zeros(d)}

    return hyper.load_hypernetwork({d: (net(), net()), "activation_func": "relu"})


def _small_lora(sd):
    name = "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k"
    model, dst, _ = lora._weight_targets(CFG)[name][0]
    w = sd.models[model].state_dict()[dst]
    r = np.random.RandomState(3)
    return {f"{name}.lora_A.weight": r.randn(2, w.shape[1]).astype(np.float32),
            f"{name}.lora_B.weight": r.randn(w.shape[0], 2).astype(np.float32)}


def test_clone_keeps_the_hypernetwork(sd, tmp_path):
    """Every ``with_*`` method goes through ``_clone``, which carries the
    attached hypernetwork; each clone's image equals the same transform
    applied with the hypernetwork attached last."""
    hn = _hypernetwork()
    base = sd.with_hypernetwork(hn, strength=0.7)
    assert base.txt2img("a cat", seed=2, **KW).shape == (H, W, 3)
    assert not np.array_equal(base.txt2img("a cat", seed=2, **KW),
                              sd.txt2img("a cat", seed=2, **KW))
    save.save_safetensors(sd.models, CFG, str(tmp_path / "vae.safetensors"))
    clones = {"with_lora": lambda b: b.with_lora(_small_lora(sd), 0.5),
              "with_vae": lambda b: b.with_vae(str(tmp_path / "vae.safetensors")),
              "with_textual_inversion": lambda b: b.with_textual_inversion(
                  {"<t>": np.ones((1, 32), np.float32)}),
              "merged_with": lambda b: b.merged_with(sd, 0.5)}
    for name, build in clones.items():
        clone = build(base)
        assert clone._hyper == base._hyper, name
        assert clone.models["hypernetwork"] is base.models["hypernetwork"], name
        np.testing.assert_array_equal(
            clone.txt2img("a <t> cat" if "textual" in name else "a cat", seed=2, **KW),
            build(sd).with_hypernetwork(hn, 0.7).txt2img(
                "a <t> cat" if "textual" in name else "a cat", seed=2, **KW), err_msg=name)
    assert "hypernetwork" not in sd.models and sd._hyper is None


def test_with_methods_leave_the_original_untouched(sd):
    before = {n: {k: v.clone() for k, v in s.items()} for n, s in state_dicts(sd.models).items()}
    sd.with_lora(_small_lora(sd), 1.0)
    sd.with_textual_inversion({"<t>": np.ones((2, 32), np.float32)})
    sd.merged_with(sd, 0.2)
    for n, s in state_dicts(sd.models).items():
        for k, v in s.items():
            assert torch.equal(v, before[n][k]), (n, k)
    assert sd.config.clip.vocab_size == CFG.clip.vocab_size
    assert "<t>" not in sd.tokenizer.placeholders


def test_mesh_and_missing_card_raise(models, tok, monkeypatch):
    with pytest.raises(NotImplementedError, match="slice H2"):
        StableDiffusion(models, tok, CFG, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusion(models, tok, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusion.from_checkpoint("m.safetensors", "v.json", "m.txt", config=CFG)
