"""A run driven on the CPU at a tiny size, past the harness's look for a
card: the result line's shape, and the check of the images, which has to
come out false when the timed path is broken underneath.

Faults planted, one test each: a sampler step that returns its state
unchanged; half of the UNet's batch left out, the mean of the other half
in its place; one image altered where the decoder produces it.  The cells
run on one card, so there is no exchange between cards to leave out.
The control (the program's own int8 tier, computed below the bf16 the
configuration states) runs on the card only."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, traced=False, seed=2**31 + 11):
    return harness.execute(cell, seed=seed, seconds=0.5, traced=traced, device="cpu",
                           t_start=time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    result = _run(tiny.cell(tiny.sd(), tiny.mix()), traced=traced)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    c = line["checks"]["pct_off3"]
    assert c["value"] <= c["limit"]
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"images_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_hires_fix_sdxl_and_bf16_cells_pass():
    assert _run(tiny.cell(tiny.sd(), tiny.mix("hires_fix", "dpm++", "karras"),
                          images=1))["correct"]
    assert _run(tiny.cell(tiny.sdxl(), tiny.mix(sampler="dpm++", spacing="karras")))["correct"]


def test_step_returning_its_state_unchanged_fails(monkeypatch):
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    monkeypatch.setattr(ddpm, "step", lambda schedule, t, latents, *a, **k: latents)
    assert _run(tiny.cell(tiny.sd(), tiny.mix()))["correct"] is False


def test_half_the_batch_left_out_fails(monkeypatch):
    from pytorch_stable_diffusion_tpu_torch.models.unet import UNet

    forward = UNet.forward

    def half(self, latents, *args, **kw):
        out = forward(self, latents, *args, **kw)
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:n].mean(dim=0, keepdim=True).expand_as(out[n:])])

    monkeypatch.setattr(UNet, "forward", half)
    assert _run(tiny.cell(tiny.sd(), tiny.mix()))["correct"] is False


def test_an_image_altered_where_it_is_produced_fails(monkeypatch):
    from pytorch_stable_diffusion_tpu_torch import pipeline

    decode = pipeline.decode

    def altered(*args, **kw):
        images = decode(*args, **kw).clone()
        images[0] = 255 - images[0]
        return images

    monkeypatch.setattr(pipeline, "decode", altered)
    assert _run(tiny.cell(tiny.sd(), tiny.mix()))["correct"] is False


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "sd15.t2i512.b8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sd15.t2i512.b8", "sdxl.t2i1024.b4",
                                      "sd15.hires2048.b1"])
def test_control_fails_the_check(card, workload):
    """The program's int8 tier (``quant="conv"``: every matrix product and
    convolution of the UNet in w8a8) in place of bf16, at the cell's own
    size: one request, the cell's sampled images against the float32
    reference."""
    from port_bench import calibrate

    cell = harness.load_cell(ROOT, workload)
    got = calibrate.readings(cell, 7, "conv", 1)
    assert any(got[k] > v["limit"] for k, v in cell.checks["limits"].items())
