"""K1 in the port: the plain PyTorch version of the flash_attention_bsc
kernel against the JAX Pallas kernel (interpret mode off-TPU, as
tests/test_flash_chunked.py runs it), the CPU behaviour of the kernel
wrapper, and the attention dispatch.

The CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_cuda.py hold it against the plain version there.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_stable_diffusion_tpu.ops.pallas import flash_attention as jfa
from pytorch_stable_diffusion_tpu_torch.ops import attention
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

CASES = [
    (512, 4, 16),    # multi-head lane slicing
    (576, 2, 16),    # S not a multiple of 128 or of the 64-row tiles
    (300, 1, 32),    # ragged KV tail + single head
    (2048, 2, 16),   # >= 2 KV chunks in the Pallas kernel
]


def _qkv(s, heads, dh, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, s, heads * dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,heads,dh", CASES)
def test_plain_matches_pallas_kernel(s, heads, dh):
    q, k, v = _qkv(s, heads, dh)
    ref = np.asarray(jfa.flash_attention_bsc(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), n_heads=heads,
                                             block_q=128))
    got = fa.flash_attention_bsc_plain(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,heads,dh", CASES[:3])
def test_wrapper_on_cpu_takes_plain_and_counts_nothing(s, heads, dh):
    """Strided views (rows 3C apart, as the fused q/k/v projection makes
    them) give the plain version's result; no kernel is launched."""
    q, k, v = _qkv(s, heads, dh, seed=3)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    qs, ks, vs = qkv.split(heads * dh, dim=-1)
    assert qs.stride(1) == 3 * heads * dh
    before = fa.flash_attention_bsc.launches
    got = fa.flash_attention_bsc(qs, ks, vs, n_heads=heads)
    assert fa.flash_attention_bsc.launches == before == 0
    ref = fa.flash_attention_bsc_plain(*map(torch.from_numpy, (q, k, v)), heads)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wrapper_rejects_mismatched_inputs():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_bsc(q, torch.zeros(1, 8, 8), torch.zeros(1, 8, 8),
                               n_heads=2)
    with pytest.raises(ValueError):
        fa.flash_attention_bsc(q, q, q, n_heads=3)


@pytest.mark.parametrize("kv,dh,causal,cross,backend,want", [
    (4096, 40, False, False, "kernel", "bsc"),      # 512² level 1
    (256, 160, False, False, "kernel", "bsc"),      # 512² level 3
    (4096, 512, False, False, "kernel", "multipass"),  # VAE mid block: K3
    (255, 40, False, False, "kernel", "plain"),     # short KV
    (64, 160, False, False, "kernel", "plain"),     # UNet mid block
    (77, 40, False, True, "kernel", "plain"),       # cross-attention
    (77, 64, True, False, "kernel", "plain"),       # CLIP
    (4096, 40, False, False, "plain", "plain"),     # plain backend
    (4096, 512, False, False, "plain", "plain"),    # VAE mid block at 512²
])
def test_route(kv, dh, causal, cross, backend, want):
    assert attention.route(kv, dh, causal=causal, cross=cross,
                           backend=backend) == want


@pytest.mark.parametrize("kv,dh,causal,cross,backend,kernel", [
    (256, 64, True, False, "kernel", "onepass"),       # causal long KV
    (300, 40, False, True, "kernel", "onepass"),       # long cross-attention
    (9216, 40, False, True, "kernel", "onepass"),      # the one-pass kernel's longest
    (8192, 128, True, False, "kernel", "onepass"),     # causal, Dh 128
    (1024, 80, False, True, "kernel", "onepass"),      # SD-1.5 level-2 width
    (4096, 64, True, False, "kernel", "onepass"),
])
def test_route_refuses_unported_flash_kernels(kv, dh, causal, cross, backend,
                                              kernel):
    """The cases these tests once held to a refusal, before K2 was ported:
    causal or cross-attention over 256..9216 KV tokens with Dh <= 160 now
    runs on the one-pass kernel K2; the long-KV cases K3/K4 carry are
    routed in tests/test_torch_flash_long.py."""
    assert attention.route(kv, dh, causal=causal, cross=cross,
                           backend=backend) == kernel


def test_self_attention_dispatches_to_k1():
    """>= 256-token non-causal self-attention on the kernel backend calls
    the K1 wrapper with the fused projection's strided views; cross- and
    short attention do not."""
    torch.manual_seed(0)
    mod = attention.Attention(32, in_bias=False).requires_grad_(False)
    for p in mod.parameters():
        p.normal_(0, 0.2)
    x = torch.randn(2, 256, 32)
    with mock.patch.object(attention, "flash_attention_bsc",
                           wraps=fa.flash_attention_bsc) as k1:
        got = attention.apply(mod, x, n_heads=4, backend="kernel")
        assert k1.call_count == 1
        q = k1.call_args.args[0]
        assert q.shape == (2, 256, 32) and q.stride(1) == 96
        attention.apply(mod, x[:, :255], n_heads=4, backend="kernel")
        assert k1.call_count == 1
    ref = attention.apply(mod, x, n_heads=4, backend="plain")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _fused_bf16(b, s, c, extra=0):
    return torch.zeros(b, s, 3 * c + extra, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,want", [
    # the UNet's q/k/v slices of one fused projection at SD-1.5's widths:
    # rows 3C x 2 bytes apart, heads Dh x 2 = 80 / 160 / 320 bytes
    (lambda: _fused_bf16(2, 4096, 320).split(320, dim=-1), True),
    (lambda: _fused_bf16(2, 256, 1280).split(1280, dim=-1), True),
    (lambda: torch.zeros(2, 300, 2 * 32).split(32, dim=-1), True),      # fp32 k/v halves
    (lambda: _fused_bf16(1, 64, 40, extra=1)[..., 1:].split(40, -1), False),  # 2 bytes off
    (lambda: _fused_bf16(1, 64, 40, extra=4)[..., :-4].split(40, -1), False),  # 248-byte rows
    (lambda: [_fused_bf16(2, 64, 40)[:, :, ::2]], False),               # channel stride 2
    (lambda: [_fused_bf16(1, 1, 40, extra=4)[..., :-4]], True),         # one row: its stride unused
])
def test_k1_alignment_rule(make, want):
    """K1's kernel reads its tiles with TMA: every pointer and every stride
    but the unit channel stride must be a multiple of 16 bytes, checked on
    the host (the wrapper raises ValueError for a CUDA tensor that breaks
    it)."""
    assert all(fa.aligned16(t) for t in make()) == want


_ROUTE_KV = (255, 256, 9216, 9217, 40959, 40960, 65536)


@pytest.mark.parametrize("dh", [4, 12, 36, *range(8, 1281, 8)])
def test_route_sends_only_head_dims_the_kernel_takes(dh):
    """Over both backends, both sides of 256, 9216 and 40960 KV tokens,
    causal or not, self or cross: every kernel ``route`` picks for the card
    takes the head dim there (``takes_head_dim``), and at or past
    FLASH_ONLY_KV a head dim no kernel takes raises ValueError."""
    for kv in _ROUTE_KV:
        for causal, cross in ((False, False), (True, False), (False, True)):
            long = (not causal and fa.takes_head_dim("streamed", dh)) \
                or fa.takes_head_dim("multipass", dh)
            for backend in ("plain", "kernel"):
                kw = dict(causal=causal, cross=cross, backend=backend)
                if kv >= attention.FLASH_ONLY_KV and not long:
                    with pytest.raises(ValueError, match="FLASH_ONLY_KV"):
                        attention.route(kv, dh, **kw)
                    continue
                path = attention.route(kv, dh, **kw)
                assert path == "plain" or fa.takes_head_dim(path, dh), (kv, causal,
                                                                         cross, backend)


@pytest.mark.parametrize("kv,dh,causal,cross,backend,want", [
    (4096, 64, False, False, "kernel", "bsc"),          # n_heads=5 at SD-1.5 widths
    (40960, 80, False, False, "kernel", "multipass"),   # a Dh K4 lacks: K3
    (4096, 96, False, False, "kernel", "multipass"),    # a Dh K1 lacks: K3
    (300, 192, False, True, "kernel", "multipass"),     # past K2's Dh 160
    (4096, 520, False, False, "kernel", "plain"),       # no kernel takes it
])
def test_route_by_the_kernels_head_dims(kv, dh, causal, cross, backend, want):
    assert attention.route(kv, dh, causal=causal, cross=cross,
                           backend=backend) == want


def test_route_on_the_cpu_keeps_each_kernels_range():
    """The plain versions take every head dim up to their kernel's largest,
    so the CPU keeps a kernel's path at head dims its card build lacks (the
    tiny test configs' Dh 4 and 8)."""
    assert attention.route(256, 4, causal=False, cross=False, backend="kernel",
                           cuda=False) == "bsc"
    assert attention.route(256, 4, causal=False, cross=False, backend="kernel") == "plain"
    assert attention.route(40960, 4, causal=False, cross=False, backend="plain",
                           cuda=False) == "streamed"
    with pytest.raises(ValueError, match="FLASH_ONLY_KV"):
        attention.route(40960, 4, causal=False, cross=False, backend="plain")
