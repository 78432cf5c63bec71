"""K2 in the port: the plain PyTorch version of the one-pass flash-attention
kernel against the JAX package's one-pass Pallas kernel (interpret mode
off-TPU, as tests/test_flash_chunked.py runs it), its fully masked rows, the
CPU behaviour of its wrapper, and the cross-attention dispatch to it.

The CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_cuda.py hold it against the plain version there.
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


@pytest.mark.parametrize("b,h,sq,sk,dh,causal", [
    (1, 2, 1152, 1152, 16, False),   # test_chunked_matches_xla: 9 chunks (odd count)
    (1, 2, 1024, 1019, 16, False),   # masked tail inside the last chunk
    (1, 2, 640, 640, 16, True),      # causal, one chunk
    (1, 2, 1024, 1024, 16, True),    # causal across chunks
    (1, 2, 512, 300, 16, False),     # padded KV, partial final chunk
    (2, 4, 256, 308, 40, False),     # cross-attention over a 4-window prompt
    (1, 2, 128, 308, 160, False),    # SD-1.5 level 3's head dim
])
def test_onepass_plain_matches_pallas_kernel(b, h, sq, sk, dh, causal):
    # block_q 128 with the whole padded KV in one step: the one-pass call
    assert jfa._pick_chunk(128, -(-sk // 128) * 128, dh, 4) is not None
    q, k, v = _qkv(b, h, sq, sk, dh, seed=sq + sk + dh)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal, block_q=128))
    got = fa.flash_attention_onepass_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_onepass_plain_gives_zero_on_fully_masked_rows():
    """A row whose every score is -inf outputs 0, not NaN or the mean of V
    (the kernels' acc / max(l, 1e-30); tests/test_flash_edge.py pins the
    same for the Pallas kernel's update).  The other rows are untouched."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 70, 300, 16, seed=4))
    k[..., 0] = k[..., 0].abs() + 1.0
    q[:, :, 5, 0] = float("-inf")  # every score of row 5 is -inf
    for causal in (False, True):
        got = fa.flash_attention_onepass_plain(q, k, v, causal)
        assert torch.isfinite(got).all()
        assert (got[:, :, 5] == 0).all()
    rows = [r for r in range(70) if r != 5]
    got = fa.flash_attention_onepass_plain(q, k, v, False)
    ref = attention.materialized_attention(q[:, :, rows], k, v, False, FP32)
    torch.testing.assert_close(got[:, :, rows], ref, rtol=1e-5, atol=1e-5)


def _cross_views(b, sq, sk, heads, dh, seed):
    """q from its own (B, Sq, C) projection, k and v as the two halves of a
    fused (B, Sk, 2C) projection of the context, viewed as (B, H, S, Dh)."""
    c = heads * dh
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.randn(b, sq, c).astype(np.float32))
    kv = torch.from_numpy(r.randn(b, sk, 2 * c).astype(np.float32))
    return [t.reshape(b, t.shape[1], heads, dh).transpose(1, 2)
            for t in (q, *kv.split(c, dim=-1))]


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_takes_plain_and_counts_nothing(causal):
    q, k, v = _cross_views(2, 100, 308, 4, 16, seed=3)
    assert k.stride(2) == 2 * 4 * 16 and not k.is_contiguous()
    before = fa.flash_attention_onepass.launches
    got = fa.flash_attention_onepass(q, k, v, causal=causal)
    assert fa.flash_attention_onepass.launches == before == 0
    assert got.shape == (2, 4, 100, 16) and got.dtype == torch.float32
    ref = fa.flash_attention_onepass_plain(*(t.contiguous() for t in (q, k, v)), causal)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wrapper_rejects_unsupported_inputs():
    wide = torch.zeros(1, 1, 8, 168)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_onepass(wide, wide, wide, causal=False)
    half = torch.zeros(1, 1, 8, 16, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_onepass(half, half, half, causal=False)
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="mismatch"):
        fa.flash_attention_onepass(q, torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16),
                                   causal=False)
    kv = torch.zeros(1, 2, 9217, 16)  # padded to 9344, past the envelope
    with pytest.raises(ValueError, match="9216"):
        fa.flash_attention_onepass(q, kv, kv, causal=False)


def test_cross_attention_dispatches_to_k2():
    """Cross-attention over a >= 256-token context on the kernel backend
    calls K2 with the head-split views of q and of the fused k/v projection
    (rows 2C apart), and agrees with the materialized path; a 255-token
    context and the plain backend do not call it."""
    torch.manual_seed(0)
    mod = attention.Attention(32, d_cross=24, in_bias=False).requires_grad_(False)
    for p in mod.parameters():
        p.normal_(0, 0.2)
    x, ctx = torch.randn(2, 64, 32), torch.randn(2, 308, 24)
    ref = attention.apply(mod, x, ctx, n_heads=4, backend="plain")
    with mock.patch.object(attention, "flash_attention_onepass",
                           wraps=fa.flash_attention_onepass) as k2:
        got = attention.apply(mod, x, ctx, n_heads=4, backend="kernel")
        assert k2.call_count == 1
        q, k, _ = k2.call_args.args
        assert q.shape == (2, 4, 64, 8) and k.shape == (2, 4, 308, 8)
        assert k.stride(2) == 2 * 32 and k2.call_args.kwargs == {"causal": False}
        attention.apply(mod, x, ctx[:, :255], n_heads=4, backend="kernel")
        attention.apply(mod, x, ctx, n_heads=4, backend="plain")
        assert k2.call_count == 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
