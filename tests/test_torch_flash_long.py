"""K4 and K3 in the port: the plain PyTorch versions of the streamed and
multi-pass flash-attention kernels against the JAX Pallas kernels
(interpret mode off-TPU, as tests/test_flash_chunked.py runs them), the CPU
behaviour of their wrappers, and the long-KV attention dispatch.

The CUDA kernels themselves run only on the card: chip_smoke.py and
tests/test_torch_cuda.py hold them against the plain versions there.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from pytorch_stable_diffusion_tpu.ops.pallas import flash_attention as jfa
from pytorch_stable_diffusion_tpu_torch.core.dtypes import FP32
from pytorch_stable_diffusion_tpu_torch.ops import attention
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)  # fp32, another summation order than XLA


def _qkv(b, h, sq, sk, dh, seed):
    r = np.random.RandomState(seed)
    return (r.randn(b, h, sq, dh).astype(np.float32),
            r.randn(b, h, sk, dh).astype(np.float32),
            r.randn(b, h, sk, dh).astype(np.float32))


def test_streamed_plain_matches_pallas_kernel():
    """KV 1100 in groups of 512 and chunks of 256: three groups, the ragged
    tail inside the third."""
    q, k, v = _qkv(1, 2, 256, 1100, 16, seed=0)
    ref = np.asarray(jfa._flash_attention_streamed(q, k, v, block_q=128,
                                                   group=512, chunk=256))
    got = fa.flash_attention_streamed_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("sq,sk,dh,causal,bq,bk", [
    (512, 4000, 16, False, 128, 2048),   # kv tail in the last grid step
    (2048, 2048, 16, True, 1024, 1024),  # causal across kv steps
    (384, 384, 16, False, 128, 128),     # test_multipass_kernel_end_to_end
    (384, 384, 16, True, 128, 128),
    (384, 300, 512, True, 128, 128),     # the VAE's head dim, causal, ragged KV
])
def test_multipass_plain_matches_pallas_kernel(sq, sk, dh, causal, bq, bk):
    q, k, v = _qkv(1, 2, sq, sk, dh, seed=1)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                         block_k=bk))
    got = fa.flash_attention_multipass_plain(*map(torch.from_numpy, (q, k, v)),
                                             causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_walks_q_rows_in_blocks(monkeypatch, causal):
    """With a small score budget the plain version walks many q-row blocks
    and still equals the materialized attention."""
    monkeypatch.setattr(fa, "PLAIN_SCORE_BYTES", 4 * 2 * 100 * 7)  # 7 rows a block
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 50, 100, 8, seed=2))
    got = fa.flash_attention_multipass_plain(q, k, v, causal)
    ref = attention.materialized_attention(q, k, v, causal, FP32)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _fused_views(b, s, heads, dh, seed):
    """q, k, v as the UNet makes them: slices of one (B, S, 3C) projection,
    viewed as (B, H, S, Dh) without a copy."""
    c = heads * dh
    qkv = torch.from_numpy(np.random.RandomState(seed).randn(b, s, 3 * c)
                           .astype(np.float32))
    return [t.reshape(b, s, heads, dh).transpose(1, 2) for t in qkv.split(c, dim=-1)]


@pytest.mark.parametrize("name", ["streamed", "multipass"])
def test_wrapper_on_cpu_takes_plain_and_counts_nothing(name):
    q, k, v = _fused_views(2, 300, 4, 16, seed=3)
    assert q.stride(2) == 3 * 4 * 16 and not q.is_contiguous()
    wrapper = getattr(fa, f"flash_attention_{name}")
    plain = getattr(fa, f"flash_attention_{name}_plain")
    kw = {"causal": True} if name == "multipass" else {}
    before = wrapper.launches
    got = wrapper(q, k, v, **kw)
    assert wrapper.launches == before == 0
    assert got.shape == (2, 4, 300, 16) and got.dtype == torch.float32
    ref = plain(*(t.contiguous() for t in (q, k, v)), *kw.values())
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name,dh", [("streamed", 136), ("multipass", 520)])
def test_wrapper_rejects_unsupported_inputs(name, dh):
    wrapper = getattr(fa, f"flash_attention_{name}")
    kw = {"causal": False} if name == "multipass" else {}
    wide = torch.zeros(1, 1, 8, dh)
    with pytest.raises(ValueError, match="head dims"):
        wrapper(wide, wide, wide, **kw)
    half = torch.zeros(1, 1, 8, 16, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        wrapper(half, half, half, **kw)
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="mismatch"):
        wrapper(q, torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16), **kw)


@pytest.mark.parametrize("kv,dh,causal,cross,backend,want", [
    (65536, 40, False, False, "kernel", "streamed"),   # 2048² UNet level 1
    (65536, 40, False, False, "plain", "streamed"),    # forced on any backend
    (40960, 128, False, False, "plain", "streamed"),
    (65536, 512, False, False, "plain", "multipass"),  # 2048² VAE mid block
    (40960, 160, False, False, "kernel", "multipass"),  # Dh past K4's 128
    (40960, 64, True, False, "kernel", "multipass"),   # causal long KV
    (40959, 40, False, False, "plain", "plain"),
    (40959, 40, False, False, "kernel", "bsc"),        # K1 below 40960
    (16384, 80, False, False, "kernel", "bsc"),        # 2048² level 2
    (4096, 512, False, False, "kernel", "multipass"),  # 512² VAE mid, kernel
    (256, 512, False, False, "kernel", "multipass"),
    (4096, 512, False, False, "plain", "plain"),       # 512² VAE mid, plain
    (9217, 40, False, True, "kernel", "streamed"),     # long cross-attention
    (9217, 64, True, False, "kernel", "multipass"),    # long causal
    (300, 160, False, True, "kernel", "onepass"),      # SD-1.5 level 3, long prompt
    (300, 192, False, True, "kernel", "multipass"),    # past K2's Dh 160
    (1024, 1280, True, False, "kernel", "plain"),      # no kernel takes Dh 1280
    (40960, 80, False, False, "plain", "multipass"),   # a Dh K4 lacks: K3
])
def test_route(kv, dh, causal, cross, backend, want):
    assert attention.route(kv, dh, causal=causal, cross=cross,
                           backend=backend) == want


@pytest.mark.parametrize("kv,dh,causal,cross", [
    (256, 64, True, False), (9216, 128, False, True), (9089, 40, True, False),
])
def test_route_leaves_k2_cases_unported(kv, dh, causal, cross):
    """The edges of K2's envelope (KV 256, padded KV 9216) route to the
    one-pass kernel; these cases raised before K2 was ported."""
    assert attention.route(kv, dh, causal=causal, cross=cross,
                           backend="kernel") == "onepass"


def test_route_reads_flash_only_kv_at_call_time(monkeypatch):
    monkeypatch.setattr(attention, "FLASH_ONLY_KV", 256)
    assert attention.route(256, 40, causal=False, cross=False,
                           backend="plain") == "streamed"
    assert attention.route(255, 40, causal=False, cross=False,
                           backend="plain") == "plain"


@pytest.mark.parametrize("heads,d,want", [(4, 32, "streamed"), (1, 192, "multipass")])
def test_attention_dispatches_long_kv(monkeypatch, heads, d, want):
    """With FLASH_ONLY_KV lowered, self-attention goes to K4 (Dh <= 128) or
    K3 (wider) with the fused projection's (B, H, S, Dh) views, and agrees
    with the materialized path."""
    torch.manual_seed(0)
    mod = attention.Attention(d).requires_grad_(False)
    for p in mod.parameters():
        p.normal_(0, 0.2)
    x = torch.randn(2, 300, d)
    ref = attention.apply(mod, x, n_heads=heads, backend="plain")
    monkeypatch.setattr(attention, "FLASH_ONLY_KV", 256)
    target = f"flash_attention_{want}"
    with mock.patch.object(attention, target, wraps=getattr(fa, target)) as spy:
        got = attention.apply(mod, x, n_heads=heads, backend="plain")
    assert spy.call_count == 1
    q = spy.call_args.args[0]
    assert q.shape == (2, heads, 300, d // heads) and q.stride(2) == 3 * d
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
