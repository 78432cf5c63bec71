"""Slice B through ``generate()``, continued: heun and the dpm2 family (two
UNet evaluations a step, none past the final Euler step) and img2img at
strength 0.7 of the multistep samplers (their warm-up from start step 1)
against the JAX package's ``generate()``, as in
tests/test_torch_sampler_pipeline.py, whose fixtures and check these
cases share; a file of their own so that a second test worker takes their
JAX compiles.
"""

import pytest

from test_torch_sampler_pipeline import (case_ids, check_against_jax,  # noqa: F401
                                         one_torch_thread, setup)

CASES = [("heun", {"timestep_spacing": "karras"}), ("dpm2", {}), ("dpm2_a", {}),
         ("dpm++_2s_a", {}), ("dpm++_3m_sde", {"strength": 0.7}),
         ("plms", {"strength": 0.7}), ("lms", {"strength": 0.7})]


@pytest.mark.parametrize("sampler,options", CASES, ids=case_ids(CASES))
def test_sampler_matches_jax_generate(setup, tiny_models, tiny_tokenizer,  # noqa: F811
                                      sampler, options):
    """Latents > 55 dB and the uint8 image > 40 dB against JAX
    ``generate()`` on the same noise."""
    check_against_jax(setup, tiny_models, tiny_tokenizer, sampler, options)
