"""``generate()`` of the SDXL refiner over ``init_latents`` and of SD-2
v-prediction against the JAX package (slice C2), on the tiny topologies
and numpy-drawn weights of ``test_torch_families.py``, whose fixtures and
helpers this file shares; a file of its own so that its JAX compiles run
beside that file's under parallel test workers.  Tight comparisons run
the JAX package's ``jax.nn.gelu`` as the exact form (``exact_gelu``)."""

import numpy as np
import pytest

from conftest import psnr, to_nchw, to_nhwc
from test_torch_families import (HW, compare_generate, exact_gelu, families,  # noqa: F401
                                 one_torch_thread)

from pytorch_stable_diffusion_tpu_torch.sampling import ddpm


def test_refiner_over_init_latents_matches_jax(families, exact_gelu):  # noqa: F811
    """The base -> refiner hand-off: ready latents in the port's (1, 4, h, w)
    layout (JAX's (1, h, w, 4), transposed) noised to the entry timestep of
    strength 0.5 and refined with the 5 size ids (the aesthetic score the
    last); one bigG tower is context and pool.  No VAE encode; latents
    > 55 dB against JAX."""
    lat = np.random.RandomState(8).randn(1, 4, 16, 16).astype(np.float32)
    steps = 4
    db, img, ref_img, _ = compare_generate(
        families, "refiner", "a photo of a cat", steps=steps, strength=0.5,
        uncond_prompt="a dog", jax_kw=dict(init_latents=to_nhwc(lat)),
        port_kw=dict(init_latents=lat))
    assert ddpm.start_step_for_strength(steps, 0.5) == 2
    assert db > 55.0, db
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


@pytest.mark.parametrize("sampler,spacing", [("ddpm", "uniform"), ("euler", "karras"),
                                             ("dpm++", "karras")])
def test_sd2_v_prediction_matches_jax(families, exact_gelu, sampler, spacing):  # noqa: F811
    """Tiny SD-2 (OpenCLIP tower, head width 8) predicting v, turned into
    epsilon at every evaluation, through three samplers: latents > 55 dB
    against JAX."""
    db, img, ref_img, lat = compare_generate(
        families, "sd2", "a photo of a cat", steps=3, sampler_name=sampler,
        timestep_spacing=spacing)
    assert np.isfinite(lat).all()
    assert db > 55.0, db
    assert psnr(img.astype(np.float32), ref_img.astype(np.float32)) > 40.0


def test_init_latents_batch_and_layout(families):
    """One latent broadcast to a batch of two equals the batch given the
    same latent twice, bit for bit; a (B, 4, h, w) batch must match the
    prompts' count."""
    from pytorch_stable_diffusion_tpu_torch import pipeline
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    cfg, _, _, models = families["refiner"]
    lat = np.random.RandomState(9).randn(1, 4, 16, 16).astype(np.float32)
    kw = dict(models=models, config=cfg, height=HW, width=HW, n_inference_steps=3,
              strength=0.6, seed=4, tokenizer=make_test_tokenizer(["a", "cat", "dog"],
                                                                  max_len=16))
    one = pipeline.generate_images(["a cat", "a dog"], init_latents=lat, **kw)
    two = pipeline.generate_images(["a cat", "a dog"], init_latents=np.repeat(lat, 2, 0),
                                   **kw)
    np.testing.assert_array_equal(one, two)
    with pytest.raises(ValueError, match="init_latents shape"):
        pipeline.generate_images(["a cat", "a dog"], init_latents=np.repeat(lat, 3, 0), **kw)
    assert to_nchw(to_nhwc(lat)).shape == lat.shape
