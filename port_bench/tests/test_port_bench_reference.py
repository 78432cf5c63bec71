"""The plain reference against the program at tiny sizes on the CPU, in
float32: the same seeded checkpoint, prompts and seeds through both."""

import numpy as np
import pytest
import torch

from port_bench import harness, system, traffic, weights
from port_bench.reference.pipeline import Reference
from port_bench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(config, mix, seed=11):
    cfg = system.port_config(config)
    tensors = weights.draw_checkpoint(config["model"], seed, "cpu", torch.float32)
    vocab, merges = traffic.vocabulary()
    tok = system.tokenizer(vocab, merges, config["model"]["text_encoders"][0]["context_length"])
    server = system.Server(harness.entry(mix["entry"]), system.load_models(cfg, tensors), tok,
                           cfg, "cpu")
    req = traffic.request(mix, seed, 0, traffic.words())
    got = server(req)
    ref = Reference(config["model"], weights.draw_checkpoint(config["model"], seed, "cpu",
                                                            torch.float32), vocab, "cpu")
    return req, got, ref


@pytest.mark.parametrize("family,sampler,spacing", [
    ("sd", "ddpm", "uniform"), ("sd", "dpm++", "karras"), ("sdxl", "dpm++", "karras"),
    ("sdxl", "ddpm", "uniform")])
def test_txt2img_matches_the_program(family, sampler, spacing):
    config = getattr(tiny, family)()
    req, got, ref = _both(config, tiny.mix(sampler=sampler, spacing=spacing))
    for j in range(len(got)):
        want = ref.txt2img(prompt=req["prompts"][j], uncond=req["uncond"], seed=req["seed"],
                           index=j, height=req["height"], width=req["width"],
                           sampler=sampler, steps=req["steps"], spacing=spacing,
                           cfg_scale=req["cfg_scale"]).numpy()
        diff = np.abs(got[j].astype(int) - want.astype(int))
        # float32 on both sides: only a value on a truncation boundary differs
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (family, j, diff.max())
        assert want.std() > 5.0  # a real image, not a constant


def test_hires_fix_matches_the_program():
    config = tiny.sd()
    mix = tiny.mix("hires_fix", sampler="dpm++", spacing="karras")
    req, got, ref = _both(config, mix)
    want = ref.hires_fix(prompt=req["prompts"][0], uncond=req["uncond"], seed=req["seed"],
                         index=0, height=req["height"], width=req["width"],
                         base_height=req["base_height"], base_width=req["base_width"],
                         strength=req["strength"], sampler="dpm++", steps=req["steps"],
                         spacing="karras", cfg_scale=req["cfg_scale"]).numpy()
    diff = np.abs(got[0].astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, diff.max()


def test_karras_grid_matches_the_program():
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    from port_bench.reference import pipeline as rp

    sched = ddpm.make_schedule()
    abar = rp.alphas_cumprod(tiny.sd()["model"])
    for n in (2, 3, 4, 20, 50):
        assert rp.timesteps(abar, "karras", n) == \
            [int(t) for t in ddpm.karras_timesteps(sched, n)]
        assert rp.timesteps(abar, "uniform", n) == \
            [int(t) for t in ddpm.inference_timesteps(n)]


def test_noise_contract_matches_the_program():
    from pytorch_stable_diffusion_tpu_torch.core import rng

    from port_bench.reference import pipeline as rp

    for seed in (0, 2**31 + 5):
        want = rng.step_normals(seed, "sampler", 3, 2, (4, 8, 8))
        for i in range(3):
            for j in range(2):
                assert torch.equal(rp.stream_normal(seed, "sampler", j, (4, 8, 8), step=i),
                                   want[i, j])
        assert torch.equal(rp.stream_normal(seed, "latent_init", 1, (4, 8, 8)),
                           rng.batch_normal(seed, "latent_init", 2, (4, 8, 8))[1])
