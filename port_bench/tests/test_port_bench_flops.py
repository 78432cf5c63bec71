"""The yardstick's arithmetic against hand-worked values and against
torch's own operation counter over the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, harness
from port_bench.reference import model as ref
from port_bench.reference.pipeline import token_ids
from port_bench.tests import tiny
from port_bench import traffic, weights


def test_k1_bound_at_sd15_level_one():
    # (2, 4096, 320), 8 heads: 4·2·4096²·320 = 42.9 GFLOP over 989 TFLOP/s
    q = (2, 4096, 320)
    f = flops.attention_flops(q, q)
    assert f == 4 * 2 * 4096 * 4096 * 320
    assert flops.bound_s(f, flops.attention_bytes(q, q, q)) * 1e3 == pytest.approx(0.0434,
                                                                                   abs=5e-5)


def test_k4_operations_at_2048():
    q = (2, 8, 65536, 40)
    assert flops.attention_flops(q, q) / 1e12 == pytest.approx(11.0, abs=0.01)
    # bytes: q, k, v read once, the output written once, bf16
    assert flops.attention_bytes(q, q, q) == 2 * 4 * 2 * 8 * 65536 * 40


def test_k5_bound_and_bytes():
    x, w = (2, 960, 64, 64), (320, 960, 3, 3)
    assert flops.conv_flops(2, 64, 64, 960, 320) == 2 * 9 * 960 * 320 * 64 * 64 * 2
    assert flops.k5_bytes(x, w) == 2 * (2 * 960 * 4096 + 320 * 960 * 9 + 2 * 320 * 4096) \
        + 4 * (2 * 2 * 960 + 320)
    # chip_smoke.py's bound of this shape (PERF.md): 0.0458 ms, by operations
    assert flops.bound_s(flops.conv_flops(2, 64, 64, 960, 320),
                         flops.k5_bytes(x, w)) * 1e3 == pytest.approx(0.0458, abs=5e-5)


def test_roofline_of_recorded_calls():
    from port_bench.trace import OpCall

    q = [2, 4096, 320]
    calls = [OpCall("sdt_torch::flash_attention_bsc", [q, q, q, []], ["c10::BFloat16"] * 3,
                    0.0868e-3)] * 3
    assert flops.roofline_pct(calls, "sdt_torch::flash_attention_bsc") == \
        pytest.approx(50.0, rel=1e-3)
    assert flops.roofline_pct(calls, "sdt_torch::flash_attention_streamed") is None
    # fp32 inputs move twice the bytes
    conv = OpCall("sdt_torch::scaled_silu_conv3x3",
                  [[1, 8, 4, 4], [1, 8], [1, 8], [8, 8, 3, 3], [8]], ["float"] * 5, 1e-3)
    assert flops.call_bound_s(conv) == pytest.approx(
        flops.bound_s(flops.conv_flops(1, 4, 4, 8, 8), flops.k5_bytes((1, 8, 4, 4),
                                                                      (8, 8, 3, 3), 4)))


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("family", ["sd", "sdxl"])
def test_model_counts_equal_torch_counter_on_the_reference(family):
    """Every matrix product and convolution the reference runs, counted by
    torch, equals the arithmetic from the configuration's shapes."""
    torch.manual_seed(0)
    model = getattr(tiny, family)()["model"]
    w = ref.Weights(weights.draw_checkpoint(model, 3, "cpu", torch.float32), "cpu")
    vocab, _ = traffic.vocabulary()
    tokens = torch.tensor([token_ids(vocab, "qabc qxyz", 16)] * 2)
    assert _counted(lambda: ref.encode_prompts(w, model, tokens, (64, 64, 0, 0, 64, 64))) == \
        sum(flops.text_flops(te, 2) for te in model["text_encoders"])
    u = model["unet_config"]
    ctx = torch.randn(2, 16, u["context_dim"])
    add = torch.randn(2, u["adm_in_channels"]) if u.get("adm_in_channels") else None
    x = torch.randn(2, 4, 16, 24)
    assert _counted(lambda: ref.unet(w, u, x, 500, ctx, add)) == \
        flops.unet_flops(u, 2, 16, 24, 16)
    assert _counted(lambda: ref.decode(w, model, torch.randn(1, 4, 8, 8))) == \
        flops.vae_decode_flops(model["first_stage_config"], 1, 8, 8)


def test_request_counts_every_evaluation():
    model = tiny.sd()["model"]
    u = model["unet_config"]
    mix = tiny.mix()
    one_eval = flops.unet_flops(u, 4, 32, 32, 16)
    text = flops.text_flops(model["text_encoders"][0], 4)
    decode = flops.vae_decode_flops(model["first_stage_config"], 2, 32, 32)
    assert harness.entry("generate_images").request_flops(model, mix) == \
        4 * one_eval + text + decode
    hires = tiny.mix("hires_fix")
    # base pass: 4 steps at 16², the second 4 - int(4 · 0.6) = 2 steps at 32²
    assert harness.entry("hires_fix").request_flops(model, hires) == pytest.approx(
        2 * flops.text_flops(model["text_encoders"][0], 2)
        + 4 * flops.unet_flops(u, 2, 16, 16, 16) + 2 * flops.unet_flops(u, 2, 32, 32, 16)
        + flops.vae_decode_flops(model["first_stage_config"], 1, 32, 32))
