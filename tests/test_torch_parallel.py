"""Data and tensor parallelism on ``torch.distributed`` (``core/mesh.py``,
``parallel/dp.py``, ``parallel/tp.py``), ``progress``, the profiling
helpers and the metrics copy, on the CPU.

One module-scoped ``torch.multiprocessing.spawn`` of two gloo ranks on a
loopback port (``tests/torch_dist_worker.py``, which imports neither JAX
nor this module) runs every scenario: DP txt2img, DP with a ControlNet, DP
InstructPix2Pix with one edit image a prompt, DP under "conv" at width 160
(prompts whose rank-local activation absmax differs from the whole
batch's), DP with a BREAK prompt beside a one-window prompt (each data
rank takes long prompts and the window count from the whole batch), DP
with one IP-Adapter image a prompt, TP model=2 on tiny SD-1.5 and tiny SDXL, TP with PAG and SAG, TP
under "conv", "wide", "w8" and "none" at width 160,
``mesh=`` through ``StableDiffusion``, and the streamed loader's TP slices.
Each request is held to the same request on one process without a mesh
within one uint8 level, but TP under "conv" (test_tp_under_the_conv_tier
says why and what holds it).  JAX's TP is not run here: the single-process port is held to JAX
``generate()`` by the other port tests, and JAX's tests/test_tp.py holds its
TP to one device within one level.
"""

import io
import os
import socket
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu.utils import metrics as jmetrics
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.utils import metrics, profiling
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORLD = 2
SCENARIOS = ("dp", "dp controlnet", "dp ip2p", "dp conv 160", "dp long mixed",
             "dp ip a prompt", "tp sd", "tp sdxl", "tp pag sag", "tp wide 160", "tp w8 160",
             "tp none 160", "api dp", "api tp")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (a dict a rank)."""
    import torch.multiprocessing as mp

    import torch_dist_worker

    out = tmp_path_factory.mktemp("ranks")
    mp.spawn(torch_dist_worker.run, args=(WORLD, _free_port(), str(out)), nprocs=WORLD,
             join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_parallel_equals_one_process(ranks, scenario):
    """Both ranks return the whole batch, within one uint8 level of the
    request on one process."""
    for r, res in enumerate(ranks):
        got, want = res[scenario]
        assert got.shape == want.shape == (2, 32, 32, 3), (r, got.shape)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, (r, int(diff.max()))
    np.testing.assert_array_equal(ranks[0][scenario][0], ranks[1][scenario][0])


@pytest.mark.parametrize("tier", ["conv", "wide"])
def test_tp_row_parallel_int8_in_the_model(ranks, tier):
    """At width 160 the bottleneck's GeGLU down-projection (320 <- 1280)
    is the one w8a8 linear (K = 1280 = MIN_K).  Under TP it is row-parallel
    and still takes w8a8: the same (out, whole K) sites as on one process,
    each with its K split over the model group.  Under "wide" it is the
    tier's only int8 site, and the request is within one level
    (SCENARIOS) while it differs from "none"."""
    for r in ranks:
        tp_sites, one_sites = r[f"tp {tier} 160 int8 sites"]
        assert one_sites and [s[:2] for s in tp_sites] == [s[:2] for s in one_sites]
        assert all(split for *_, split in tp_sites) and not any(s[2] for s in one_sites)
        assert set(one_sites) == {(320, 1280, False)}
    assert not np.array_equal(ranks[0]["tp wide 160"][1], ranks[0]["tp none 160"][1])


def test_tp_under_the_conv_tier(ranks):
    """TP under "conv" at width 160.  A row-parallel w8a8 product (K split
    over the two ranks: scales reduced by MAX, int32 sums by SUM) equals the
    whole product on one process exactly, and w8's within fp32 rounding.
    The whole request is not within one level: the row-parallel float
    layers (attention ``out``, K = 160, takes no int8) sum their
    halves in another order, and the "conv" tier's per-tensor quantization
    at every following conv turns such rounding differences into
    quantization steps (test_torch_quant.py measures a 1e-6 input
    perturbation moving the tier's UNet output by 1.4e-2).  The same
    request under "none", "wide" and "w8" is within one level (SCENARIOS); under
    "conv" it is held to at most 4 levels mean and 30 dB (measured: 2.03
    levels, 39.6 dB)."""
    for r in ranks:
        int8_gap, w8_gap, w8_max = r["tp int8 row"]
        assert int8_gap == 0.0
        assert w8_gap <= 1e-6 * w8_max
        got, want = r["tp conv 160"]
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.mean() <= 4.0 and metrics.image_psnr(got, want) > 30.0


def test_mesh_axes_and_errors(ranks):
    """make_mesh and local_batch raise the JAX package's ValueErrors."""
    assert ranks[0]["errors"] == ["mesh 3x1 != 2 devices",
                                  "2 devices not divisible by model=3",
                                  "batch 3 not divisible by data axis 2"]
    assert [r["axes"] for r in ranks] == [[2, 2, 0], [2, 2, 1]]


def test_tp_shards_the_models_and_the_streamed_load(ranks):
    """Each rank holds half the bottleneck's heads (tiny SD: 32 channels, 4
    heads), through ``StableDiffusion(mesh=)`` and ``parallel/tp.assemble``
    of the streamed loader's slices, which equal the slices of the eager
    load."""
    for res in ranks:
        assert res["api tp sharded"] == 16
        assert res["stream"]["equal"] and res["stream"]["sliced"] > 0
        assert res["stream"]["assembled"] == 16


def test_progress_prints_the_enqueued_steps():
    cfg = config.tiny_sd_config()
    models = build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    buf = io.StringIO()
    with redirect_stdout(buf):
        pipeline.generate("a cat", models=models, config=cfg, n_inference_steps=3,
                          sampler_name="ddim", height=16, width=16, progress=True,
                          tokenizer=make_test_tokenizer(["a", "cat"], cfg.clip.max_len))
    assert buf.getvalue() == "".join(f"\rdenoise step {i}/3" for i in (1, 2, 3)) + "\n"


def test_timed_phase_and_device_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.timed(sync=[x, {"y": x}]) as t, profiling.phase("matmul"):
        y = x @ x
    assert t.elapsed > 0 and y.shape == (64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.phase("traced"):
            x @ x
    assert any(e.key == "traced" for e in prof.key_averages())
    (trace,) = os.listdir(tmp_path)
    assert '"traced"' in (tmp_path / trace).read_text()


def test_metrics_copy_is_the_jax_file():
    """Below its docstring the port's utils/metrics.py is the JAX package's,
    and both give the same numbers."""
    def body(mod):
        with open(mod.__file__) as f:
            return f.read().split('"""', 2)[2]
    assert body(metrics) == body(jmetrics)
    r = np.random.RandomState(0)
    a, b = r.rand(2, 8, 8, 3), r.rand(2, 8, 8, 3)
    ia, ib = (r.rand(8, 8, 3) * 255).astype(np.uint8), (r.rand(8, 8, 3) * 255).astype(np.uint8)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.image_psnr(ia, ib) == jmetrics.image_psnr(ia, ib)
    assert metrics.latent_mae(a, b) == jmetrics.latent_mae(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.psnr(a, b[:1])


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
