"""The CUDA kernels of the port against their plain PyTorch versions, on the
card, and the sampler loops on the card against the CPU plain path.
Skipped where there is no CUDA device.

tests/conftest.py imports jax, which the GPU machine lacks, so on the card
run this file without it (it imports only torch, numpy and the port):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorch_stable_diffusion_tpu_torch.ops import norm
from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: max abs error against the fp32 plain version: bf16 output rounding
#: (|out| < ~1 -> half an ulp of bf16 is <= 2^-9) / fp32 summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def tolerance(dtype, ref):
    """TOL[dtype], scaled down to the reference's largest value where that is
    below 1: over a long KV the outputs are ~1e-2, and an absolute 2e-2 would
    pass a kernel that returned zeros."""
    return TOL[dtype] * min(1.0, ref.float().abs().max().item())


def _k1_views(b, sq, sk, c, dtype, cuda, seed=0):
    """q, k, v as the three C-wide slices of one fused (B, S, 3C) projection
    (rows 3C apart, as the model makes them): its first sq and sk rows."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, max(sq, sk), 3 * c, device=cuda, generator=g).to(dtype)
    q, k, v = qkv.split(c, dim=-1)
    return q[:, :sq], k[:, :sk], v[:, :sk]


@pytest.mark.parametrize("b,sq,sk,c,heads", [
    (2, 4096, 4096, 320, 8),    # SD-1.5 512², level 1: Dh 40
    (8, 4096, 4096, 320, 8),    # level 1 at batch 8 (four prompts, CFG)
    (2, 1024, 1024, 640, 8),    # level 2: Dh 80
    (2, 256, 256, 1280, 8),     # level 3: Dh 160
    (2, 4096, 4096, 1280, 8),   # 2048², level 3
    (2, 1024, 1024, 1280, 8),   # 2048², mid block
    (2, 300, 300, 32, 1),       # ragged KV tail, Dh 32
    (3, 77, 77, 32, 1),         # KV shorter than one tile
    # Sq not a multiple of the q tile, Sk not one of the KV tile: Dh 40 with 8
    # packed heads (a pad column read from the next head would show), Dh 80
    # (128-token tiles), Dh 160 (64-token tiles), Dh 32 with 4 heads
    (2, 1000, 1100, 320, 8),
    (1, 333, 200, 640, 8),
    (1, 130, 70, 1280, 8),
    (2, 65, 257, 128, 4),
    # Dh 64: SD-2.x/SDXL widths, and SD-1.5's level 1 at 5 heads
    (2, 4096, 4096, 320, 5),
    (1, 300, 333, 128, 2),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k1_matches_plain(cuda, b, sq, sk, c, heads, dtype):
    q, k, v = _k1_views(b, sq, sk, c, dtype, cuda)
    before = fa.flash_attention_bsc.launches
    got = fa.flash_attention_bsc(q, k, v, n_heads=heads)
    torch.cuda.synchronize()
    assert fa.flash_attention_bsc.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, c) and got.is_contiguous()
    ref = fa.flash_attention_bsc_plain(q, k, v, heads)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tolerance(dtype, ref), err


@pytest.mark.parametrize("c,tile", [(320, 128), (1280, 64)])  # Dh 40 and 160
def test_k1_planted_fault_fails_the_check(cuda, c, tile):
    """A call whose KV is short by one KV tile (a lost tile) must fail the
    tolerance the kernel is held to, or the check could not see such a
    fault."""
    q, k, v = _k1_views(2, 1024, 1024, c, torch.bfloat16, cuda)
    ref = fa.flash_attention_bsc_plain(q, k, v, 8)
    bad = fa.flash_attention_bsc(q, k[:, :-tile], v[:, :-tile], n_heads=8)
    err = (bad.float() - ref.float()).abs().max().item()
    assert err > tolerance(torch.bfloat16, ref), err


def test_k1_refuses_misaligned_rows(cuda):
    qkv = torch.zeros(1, 256, 3 * 320 + 1, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[..., 1:].split(320, dim=-1)  # pointers 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bsc(q, k, v, n_heads=8)
    qkv = torch.zeros(1, 256, 3 * 320 + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[..., :-4].split(320, dim=-1)  # rows 1928 bytes apart
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bsc(q, k, v, n_heads=8)


def test_k1_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 256, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_bsc(q, q, q, n_heads=1)


def test_k1_refuses_fp16(cuda):
    q = torch.zeros(1, 256, 40, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_bsc(q, q, q, n_heads=1)


@pytest.mark.parametrize("b,sq,c,heads", [
    (2, 4096, 640, 10),    # SDXL 1024², level 1 (10 layers a block at level 2)
    (2, 1024, 1280, 20),   # SDXL 1024², level 2 and the mid block
    (2, 4096, 768, 12),    # refiner 1024², level 1
    (2, 1024, 1536, 24),   # refiner 1024², level 2
    (2, 256, 1536, 24),    # refiner 1024², the mid block
    (2, 9216, 320, 5),     # SD-2.1 768², level 1
    (2, 2304, 640, 10),    # SD-2.1 768², level 2
    (2, 576, 1280, 20),    # SD-2.1 768², level 3
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k1_matches_plain_at_the_c2_shapes(cuda, b, sq, c, heads, dtype):
    """K1 at Dh 64 with the SD-2.1/SDXL head counts (slice C2)."""
    q, k, v = _k1_views(b, sq, sq, c, dtype, cuda, seed=7)
    got = fa.flash_attention_bsc(q, k, v, n_heads=heads)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bsc_plain(q, k, v, heads)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.shape == (b, sq, c) and err <= tolerance(dtype, ref), err


def _head_split_views(b, h, sq, sk, dh, dtype, cuda, seed):
    """q from its own (B, Sq, C) projection, k and v as the two halves of a
    fused (B, Sk, 2C) one, all viewed as (B, H, S, Dh) without a copy."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = h * dh
    q = torch.randn(b, sq, c, device=cuda, generator=g).to(dtype)
    kv = torch.randn(b, sk, 2 * c, device=cuda, generator=g).to(dtype)
    k, v = kv.split(c, dim=-1)
    return [t.reshape(b, t.shape[1], h, dh).transpose(1, 2) for t in (q, k, v)]


def _check_head_split(wrapper, plain, args, kw, dtype):
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    b, h, sq, dh = args[0].shape
    assert got.dtype == dtype and got.shape == (b, h, sq, dh)
    assert got.transpose(1, 2).is_contiguous()  # heads merge back without a copy
    ref = plain(*args, *kw.values())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tolerance(dtype, ref), err


@pytest.mark.parametrize("b,h,sq,sk,dh", [
    (2, 8, 4096, 4096, 40),    # SD-1.5 level-1 width at 512²
    (8, 8, 4096, 4096, 40),    # the same at batch 8
    (1, 2, 1000, 1100, 16),    # ragged q and KV tails
    (1, 1, 300, 5000, 64),
    (1, 2, 200, 9300, 128),    # K4's widest head
    (2, 8, 1000, 1100, 40),    # Sq not a multiple of the q tile, Sk not of the KV tile
    (1, 3, 129, 65, 128),      # one 64-token KV tile and one token
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k4_matches_plain(cuda, b, h, sq, sk, dh, dtype):
    args = _head_split_views(b, h, sq, sk, dh, dtype, cuda, seed=1)
    _check_head_split(fa.flash_attention_streamed, fa.flash_attention_streamed_plain,
                      args, {}, dtype)


def test_k4_takes_contiguous_head_split_tensors(cuda):
    """(B, H, S, Dh) tensors of their own, whose head stride is larger than
    their row stride (the views the UNet passes have it the other way)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    args = [torch.randn(2, 3, s, 40, device=cuda, generator=g).to(torch.bfloat16)
            for s in (300, 700, 700)]
    _check_head_split(fa.flash_attention_streamed, fa.flash_attention_streamed_plain,
                      args, {}, torch.bfloat16)


def test_k4_planted_fault_fails_the_check(cuda):
    """KV short by one 128-token tile must fail the tolerance."""
    q, k, v = _head_split_views(2, 8, 1024, 4096, 40, torch.bfloat16, cuda, seed=8)
    ref = fa.flash_attention_streamed_plain(q, k, v)
    bad = fa.flash_attention_streamed(q, k[:, :, :-128], v[:, :, :-128])
    err = (bad.float() - ref.float()).abs().max().item()
    assert err > tolerance(torch.bfloat16, ref), err


@pytest.mark.parametrize("b,h,sq,sk,dh,causal", [
    (1, 1, 4096, 4096, 512, False),  # the 512² VAE mid block on the kernel backend
    (1, 1, 1000, 1000, 512, True),   # causal, ragged
    (1, 2, 300, 1000, 64, True),     # causal with Sq < Sk
    (2, 2, 777, 500, 128, False),
    # padded widths: the tensor maps zero-fill the columns past the true Dh
    (1, 2, 333, 777, 64, False),
    (1, 2, 500, 3000, 80, False),    # a Dh K4 lacks
    (1, 1, 700, 2000, 320, False),
    (1, 1, 257, 513, 200, True),
    (1, 2, 1000, 1000, 128, True),   # causal across 64-row CTAs
    (1, 1, 1000, 1100, 512, False),  # ragged q and KV tails
    (2, 1, 300, 700, 512, True),     # causal with Sq < Sk over a few q tiles
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k3_matches_plain(cuda, b, h, sq, sk, dh, causal, dtype):
    args = _head_split_views(b, h, sq, sk, dh, dtype, cuda, seed=2)
    _check_head_split(fa.flash_attention_multipass, fa.flash_attention_multipass_plain,
                      args, {"causal": causal}, dtype)


@pytest.mark.parametrize("b,h,sq,sk,dh,causal", [
    # SD-1.5 512² under a 4-window prompt, CFG batch 2 and 8: levels 1 and 2
    # take the resident schedule (4 and 16 q tiles a CTA at level 1), level
    # 3 at batch 2 and the mid block the 64-row one, level 3 at batch 8 the
    # streamed one
    (2, 8, 4096, 308, 40, False),
    (8, 8, 4096, 308, 40, False),
    (2, 8, 1024, 308, 80, False),
    (8, 8, 1024, 308, 80, False),
    (2, 8, 256, 308, 160, False),
    (8, 8, 256, 308, 160, False),
    (2, 8, 64, 308, 160, False),
    # levels 1 and 2 under a 5- and a 6-window prompt: level 1 stays
    # resident (six stages at Dh 40), level 2 streams (three at Dh 80)
    (2, 8, 4096, 385, 40, False),
    (2, 8, 1024, 385, 80, False),
    (2, 8, 4096, 462, 40, False),
    (2, 8, 1024, 462, 80, False),
    (1, 2, 1000, 300, 16, False),    # ragged q and KV tails
    (2, 8, 1000, 300, 40, False),    # the same, resident
    (1, 2, 1024, 1024, 64, True),    # causal across tiles
    (1, 2, 333, 777, 128, True),     # causal, Sq < Sk, ragged
    (1, 1, 200, 9216, 40, False),    # the one-pass envelope's top
    # causal across several 128- and 192-row CTAs, whose warpgroups stop at
    # different KV tiles: streamed (128 and 192 rows at Dh 40 and at Dh 80;
    # 128 with Sq > Sk), resident with two q tiles a CTA (the second walks
    # more KV tiles)
    (4, 8, 2000, 2000, 40, True),
    (1, 8, 2304, 2304, 40, True),
    (2, 8, 2048, 2048, 80, True),
    (4, 8, 1500, 1500, 80, True),
    (2, 8, 2000, 1000, 40, True),
    (2, 8, 2000, 700, 40, True),
    (2, 8, 700, 1100, 64, True),     # causal, Sq < Sk, ragged
    # a KV of one tile and less (the kernel takes any length)
    (2, 8, 4096, 77, 40, False),
    (1, 2, 130, 1, 80, False),
    (2, 8, 300, 64, 160, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k2_matches_plain(cuda, b, h, sq, sk, dh, causal, dtype):
    args = _head_split_views(b, h, sq, sk, dh, dtype, cuda, seed=6)
    _check_head_split(fa.flash_attention_onepass, fa.flash_attention_onepass_plain,
                      args, {"causal": causal}, dtype)


@pytest.mark.parametrize("b,h,sq,sk", [
    (2, 10, 4096, 308), (2, 20, 1024, 308),   # SDXL 1024² under a 4-window prompt
    (2, 12, 4096, 308), (2, 24, 1024, 308),   # the refiner's widths
    (2, 5, 9216, 308),                        # SD-2.1 768², level 1
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k2_matches_plain_at_the_c2_shapes(cuda, b, h, sq, sk, dtype):
    """K2 at Dh 64 with the SD-2.1/SDXL head counts (slice C2)."""
    args = _head_split_views(b, h, sq, sk, 64, dtype, cuda, seed=8)
    _check_head_split(fa.flash_attention_onepass, fa.flash_attention_onepass_plain,
                      args, {"causal": False}, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k3_matches_plain_at_the_1024_vae(cuda, dtype):
    """K3 at the 1024² VAE mid block (SDXL and the refiner decode 1024²)."""
    args = _head_split_views(1, 1, 16384, 16384, 512, dtype, cuda, seed=9)
    _check_head_split(fa.flash_attention_multipass, fa.flash_attention_multipass_plain,
                      args, {"causal": False}, dtype)


@pytest.mark.parametrize("shape,want", [
    ((2, 8, 4096, 308, 40, False), (2, 8)),     # level 1: resident, 4 q tiles a CTA
    ((8, 8, 4096, 308, 40, False), (2, 2)),     # CFG batch 8: 16 q tiles a CTA
    ((2, 8, 1024, 308, 80, False), (2, 8)),     # level 2: resident, one q tile a CTA
    ((2, 8, 4096, 462, 40, False), (2, 8)),     # level 1, 6 windows: still resident
    ((2, 8, 1024, 385, 80, False), (2, 8)),     # level 2, 5 windows: streamed, same grid
    ((2, 8, 256, 308, 160, False), (1, 4)),     # level 3: 64-row CTAs
    ((2, 8, 64, 308, 160, False), (1, 1)),      # mid block
    ((8, 8, 256, 308, 160, False), (2, 2)),     # streamed, 128 rows
    ((2, 8, 9216, 9216, 40, False), (3, 48)),   # streamed, 192 rows
    ((2, 8, 2000, 700, 40, True), (2, 8)),      # causal, resident, 2 q tiles a CTA
    ((1, 8, 2304, 2304, 40, True), (3, 12)),    # causal, streamed, 192 rows
    ((4, 8, 2000, 2000, 40, True), (2, 16)),    # causal, streamed, 128 rows
    ((2, 8, 2048, 2048, 80, True), (2, 16)),    # causal, streamed, 128 rows, Dh 80
    ((4, 8, 1500, 1500, 80, True), (3, 8)),     # causal, streamed, 192 rows, Dh 80
])
def test_k2_schedule(cuda, shape, want):
    """The schedule K2's launch picks at SD-1.5's level shapes and at the
    edges the cases above rely on (an H100's 132 SMs)."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the expected schedules are an H100 SXM's (132 SMs)")
    got = fa.onepass_schedule(*shape)
    assert (got["warpgroups"], got["ctas"]) == want, got


def test_k2_planted_fault_fails_the_check(cuda):
    """KV short by 64 tokens must fail the tolerance at level 1's resident
    schedule."""
    q, k, v = _head_split_views(2, 8, 4096, 308, 40, torch.bfloat16, cuda, seed=10)
    ref = fa.flash_attention_onepass_plain(q, k, v, False)
    bad = fa.flash_attention_onepass(q, k[:, :, :-64], v[:, :, :-64], causal=False)
    err = (bad.float() - ref.float()).abs().max().item()
    assert err > tolerance(torch.bfloat16, ref), err


def test_k3_planted_fault_fails_the_check(cuda):
    """KV short by one 32-token tile must fail the tolerance."""
    q, k, v = _head_split_views(1, 1, 1024, 4096, 512, torch.bfloat16, cuda, seed=9)
    ref = fa.flash_attention_multipass_plain(q, k, v, False)
    bad = fa.flash_attention_multipass(q, k[:, :, :-32], v[:, :, :-32], causal=False)
    err = (bad.float() - ref.float()).abs().max().item()
    assert err > tolerance(torch.bfloat16, ref), err


def test_k2_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_onepass(q, q, q, causal=False)   # Dh 48 not instantiated
    kv = torch.zeros(1, 1, 9217, 40, device=cuda)
    with pytest.raises(ValueError, match="9216"):
        fa.flash_attention_onepass(kv[:, :, :64], kv, kv, causal=False)
    q = torch.zeros(1, 1, 64, 41, device=cuda)[..., 1:]  # rows 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_onepass(q, q, q, causal=True)


def test_k3_k4_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 1, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_streamed(q, q, q)       # Dh 48 not instantiated
    q = torch.zeros(1, 1, 64, 196, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_multipass(q, q, q, causal=False)   # not a multiple of 8
    q = torch.zeros(1, 1, 64, 41, device=cuda)[..., 1:]  # rows 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_streamed(q, q, q)


def _k5_inputs(b, cin, h, w, cout, dtype, cuda, seed):
    """x and the weight in channels_last memory, as the UNet holds them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(b, cin, h, w, device=cuda, generator=g).to(dtype).contiguous(memory_format=cl)
    scale = 1.0 + 0.2 * torch.randn(b, cin, device=cuda, generator=g)
    shift = 0.5 * torch.randn(b, cin, device=cuda, generator=g)
    weight = (torch.randn(cout, cin, 3, 3, device=cuda, generator=g) / (9 * cin) ** 0.5) \
        .to(dtype).contiguous(memory_format=cl)
    bias = 0.1 * torch.randn(cout, device=cuda, generator=g)
    return x, scale, shift, weight, bias


@pytest.mark.parametrize("b,cin,h,w,cout", [
    (2, 320, 64, 64, 320),     # SD-1.5 512², level 1
    (2, 1920, 32, 32, 640),    # level 2, decoder concat
    (2, 2560, 16, 16, 1280),   # level 3, decoder concat
    (2, 1280, 8, 8, 1280),     # level 4
    (2, 2560, 8, 8, 1280),     # level 4, decoder concat: Cin split across CTAs
    (1, 64, 10, 12, 128),      # ragged H and W
    (1, 24, 5, 7, 40),         # Cin not a multiple of 16, Cout not of 64
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k5_matches_plain(cuda, b, cin, h, w, cout, dtype):
    args = _k5_inputs(b, cin, h, w, cout, dtype, cuda, seed=3)
    before = k5.scaled_silu_conv3x3.launches
    got = k5.scaled_silu_conv3x3(*args)
    torch.cuda.synchronize()
    assert k5.scaled_silu_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = k5.scaled_silu_conv3x3_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    # relative to the largest output: bf16 rounds a conv's outputs (several
    # units) relatively
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("b,cin,h,w,cout", [
    (2, 384, 128, 128, 384),    # refiner 1024², level 0
    (2, 1152, 128, 128, 384),   # refiner, level-0 decoder concat (768 + 384)
    (2, 768, 64, 64, 768),      # refiner, level 1
    (2, 1536, 32, 32, 1536),    # refiner, levels 2 and 3
    (2, 3072, 16, 16, 1536),    # refiner, level-3 decoder concat
    (2, 960, 128, 128, 320),    # SDXL 1024², level-0 decoder concat
    (2, 2560, 32, 32, 1280),    # SDXL, level-2 decoder concat
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k5_matches_plain_at_the_c2_widths(cuda, b, cin, h, w, cout, dtype):
    """K5 at the refiner's 384·k channels and SDXL's 1024² convs (slice C2)."""
    args = _k5_inputs(b, cin, h, w, cout, dtype, cuda, seed=10)
    got = k5.scaled_silu_conv3x3(*args)
    torch.cuda.synchronize()
    ref = k5.scaled_silu_conv3x3_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.shape == (b, cout, h, w)
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


def test_k5_res_block_half_with_temb(cuda):
    """gn_silu_conv3x3 with the time embedding folded against the explicit
    x + t -> GroupNorm -> SiLU -> conv composition."""
    x, _, _, weight, bias = _k5_inputs(2, 640, 32, 32, 640, torch.bfloat16, cuda, seed=4)
    gn = norm.Norm(640, device=cuda)
    gn.reset_parameters()
    conv = torch.nn.Module()
    conv.weight, conv.bias = weight, bias
    t = torch.randn(2, 640, device=cuda).to(torch.bfloat16)
    got = k5.gn_silu_conv3x3(gn, conv, x, 32, temb=t)
    h = norm.group_norm_silu(gn, x + t[:, :, None, None], 32)
    ref = torch.nn.functional.conv2d(h, weight, bias.to(torch.bfloat16), padding=1)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16] * ref.float().abs().max().item(), err


def test_k5_refuses_what_it_does_not_take(cuda):
    x, scale, shift, weight, bias = _k5_inputs(1, 64, 8, 8, 64, torch.bfloat16, cuda, seed=5)
    with pytest.raises(ValueError, match="channels_last"):
        k5.scaled_silu_conv3x3(x.contiguous(), scale, shift, weight, bias)
    with pytest.raises(ValueError, match="channels_last"):
        k5.scaled_silu_conv3x3(x, scale, shift, weight.contiguous(), bias)
    with pytest.raises(ValueError, match="bfloat16"):
        k5.scaled_silu_conv3x3(x.half(), scale, shift, weight.half(), bias)


# ------------------------------------------------- the sampler loops (slice B)
def _psnr(a, b):
    a, b = np.asarray(a, np.float32).ravel(), np.asarray(b, np.float32).ravel()
    peak = max(np.abs(a).max(), 1e-12)
    return 10.0 * np.log10(peak**2 / max(np.mean((a - b) ** 2), 1e-30))


@pytest.fixture(scope="module")
def sd15_pair():
    """Full-width SD-1.5 in FP32 on the CPU (plain path) and on the card
    (kernel attention), the same weights from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    cfg_cpu = port.sd15_config(policy=port.FP32, attention_backend="plain")
    cfg_gpu = port.sd15_config(policy=port.FP32, attention_backend="kernel")
    cpu = port.build_models(cfg_cpu, device="cpu", generator=torch.Generator().manual_seed(7))
    gpu = port.build_models(cfg_gpu, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    tok = make_test_tokenizer(["a", "photograph", "of", "an", "astronaut"], max_len=77)
    return port, cfg_cpu, cpu, cfg_gpu, gpu, tok


#: K1 launches of one UNet evaluation at 128² (a 16x16 latent): the five
#: level-1 self-attentions over 256 tokens; level 2 (64 tokens) and the
#: 77-token cross-attentions take materialized scores
K1_PER_EVAL_128 = 5


@pytest.mark.parametrize("sampler,spacing,steps,evals", [
    ("euler_a", "uniform", 3, 3),        # one evaluation a step
    ("heun", "karras", 3, 5),            # two a step, none past the final Euler step
    ("dpm++_3m_sde", "karras", 4, 4),    # multistep state
    ("restart", "uniform", 3, 6),        # 3 ops of 2 (no restart segment below 20 steps)
    ("dpm_fast", "uniform", 3, 6),       # 2 segments of 3
    ("dpm_adaptive", "uniform", 3, None),  # 3 an iteration, at most 3 iterations
])
def test_sampler_loop_card_matches_cpu(cuda, sd15_pair, sampler, spacing, steps, evals):
    """A 128² FP32 request on the card against the CPU plain path: latents
    > 55 dB, image > 40 dB, and K1 launched at every level-1
    self-attention of every UNet evaluation of the loop."""
    from unittest import mock

    from pytorch_stable_diffusion_tpu_torch.sampling import dpm_adaptive

    port, cfg_cpu, cpu, cfg_gpu, gpu, tok = sd15_pair
    kw = dict(uncond_prompt="", cfg_scale=7.5, n_inference_steps=steps, seed=11,
              height=128, width=128, tokenizer=tok, return_latents=True,
              sampler_name=sampler, timestep_spacing=spacing)
    img_c, lat_c = port.generate("a photograph of an astronaut", models=cpu,
                                 config=cfg_cpu, **kw)
    iterations, sample = [], dpm_adaptive.sample

    def recording(*args, **kwargs):
        out = sample(*args, **kwargs)
        iterations.append(len(out[1]))
        return out

    before = fa.flash_attention_bsc.launches
    with mock.patch.object(dpm_adaptive, "sample", recording):
        img_g, lat_g = port.generate("a photograph of an astronaut", models=gpu,
                                     config=cfg_gpu, device="cuda", **kw)
    torch.cuda.synchronize()
    if evals is None:
        assert len(iterations) == 1 and 0 < iterations[0] <= steps
        evals = 3 * iterations[0]
    assert fa.flash_attention_bsc.launches - before == K1_PER_EVAL_128 * evals
    assert np.isfinite(lat_g).all()
    assert _psnr(lat_c, lat_g) > 55.0
    assert _psnr(img_c, img_g) > 40.0


# ------------------------------------------------------------------ slice D
@pytest.mark.parametrize("b,sq,dh", [(2, 4096, 40), (2, 1024, 80), (2, 256, 160),
                                     (2, 64, 160)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k2_separate_kv_allocations_match_plain(cuda, b, sq, dh, dtype):
    """A hypernetwork's cross-attention: k and v projected from contexts of
    their own, two contiguous (B, 308, C) allocations, at the four level
    shapes of 512² under a 4-window prompt."""
    g = torch.Generator(device=cuda).manual_seed(8)
    c = 8 * dh
    q, k, v = (torch.randn(b, s, c, device=cuda, generator=g).to(dtype)
               for s in (sq, 308, 308))
    assert k.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
    args = [t.reshape(b, t.shape[1], 8, dh).transpose(1, 2) for t in (q, k, v)]
    _check_head_split(fa.flash_attention_onepass, fa.flash_attention_onepass_plain,
                      args, {"causal": False}, dtype)


def test_native_reader_builds_and_reads(cuda, tmp_path):
    """The native safetensors reader builds with g++ into build/native/ and
    reads what the port writes, BF16 included, on the card's machine."""
    from pytorch_stable_diffusion_tpu_torch.weights import native_io, save

    g = torch.Generator(device=cuda).manual_seed(3)
    tensors = {"a": torch.randn(64, 32, device=cuda, generator=g).to(torch.bfloat16),
               "b": torch.randn(5, device=cuda, generator=g),
               "c": torch.randn(3, 3, 2, 2, device=cuda, generator=g).half()}
    path = str(tmp_path / "t.safetensors")
    save.write_safetensors(tensors, path)
    got = native_io.load_safetensors(path)
    assert native_io.available() and native_io.library_path().exists()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].to(cuda), v), k


def test_tiny_checkpoint_lora_request_card_matches_cpu(cuda, tmp_path):
    """from_checkpoint -> with_lora -> txt2img on the card against the same
    on the CPU plain path, FP32 at the tiny config (its head dims take the
    materialized path on either device)."""
    import json

    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.weights import convert, lora, save
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    cfg = port.tiny_sd_config(attention_backend="kernel")
    save.write_safetensors(convert.synthetic_state_dict(cfg, 4), str(tmp_path / "m.safetensors"))
    tok = make_test_tokenizer(["a", "cat", "dog"], max_len=16)
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(tok.encoder, f)
    with open(tmp_path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "".join(
            f"{a} {b}\n" for a, b in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)))
    picked = sorted(lora._weight_targets(cfg).items())[::7]
    images = {}
    for device in ("cpu", "cuda"):
        sd = port.StableDiffusion.from_checkpoint(
            str(tmp_path / "m.safetensors"), str(tmp_path / "vocab.json"),
            str(tmp_path / "merges.txt"), config=cfg, device=device)
        factors = {}
        for name, targets in picked:
            model, dst, _ = targets[0]
            w = sd.models[model].state_dict()[dst]
            rs = np.random.RandomState(len(name))
            if w.dim() == 4 and w.shape[2] == 3:
                down, up = rs.randn(2, w.shape[1], 3, 3), rs.randn(w.shape[0], 2, 1, 1)
            else:
                down, up = rs.randn(2, w.shape[1]), rs.randn(w.shape[0], 2)
            factors[f"{name}.lora_A.weight"] = (down * 0.1).astype(np.float32)
            factors[f"{name}.lora_B.weight"] = (up * 0.1).astype(np.float32)
        images[device] = sd.with_lora(factors, 0.8).txt2img(
            "a cat", seed=3, n_inference_steps=3, height=32, width=32)
    assert _psnr(images["cpu"], images["cuda"]) > 40.0


# ------------------------------------------------------------------ slice C3
@pytest.mark.parametrize("b,sq,c,heads", [
    (1, 4096, 320, 8), (1, 1024, 640, 8), (1, 256, 1280, 8),   # SD-1.5 512², LCM without CFG
    (3, 4096, 320, 8), (3, 1024, 640, 8), (3, 256, 1280, 8),   # InstructPix2Pix's three lanes
    (2, 5120, 320, 8), (2, 1280, 640, 8), (2, 320, 1280, 8),   # outpaint's 640x512 canvas
    (1, 4096, 640, 10), (1, 1024, 1280, 20),                   # SDXL 1024², LCM without CFG
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k1_matches_plain_at_the_c3_lane_counts(cuda, b, sq, c, heads, dtype):
    """K1 at slice C3's lane counts (1 without CFG, 3 for InstructPix2Pix)
    and outpaint's canvas (chip_smoke.C3_PLANS)."""
    q, k, v = _k1_views(b, sq, sq, c, dtype, cuda, seed=11)
    got = fa.flash_attention_bsc(q, k, v, n_heads=heads)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bsc_plain(q, k, v, heads)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.shape == (b, sq, c) and err <= tolerance(dtype, ref), err


@pytest.mark.parametrize("sq,dh", [(4096, 40), (1024, 80), (256, 160), (64, 160)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k2_matches_plain_at_the_c3_lane_count(cuda, sq, dh, dtype):
    """K2 under a 4-window prompt at InstructPix2Pix's three lanes."""
    args = _head_split_views(3, 8, sq, 308, dh, dtype, cuda, seed=12)
    _check_head_split(fa.flash_attention_onepass, fa.flash_attention_onepass_plain,
                      args, {"causal": False}, dtype)


@pytest.mark.parametrize("b,cin,h,w,cout", [
    (1, 960, 64, 64, 320), (1, 2560, 16, 16, 1280),    # SD-1.5 512², one lane
    (3, 960, 64, 64, 320), (3, 1920, 32, 32, 640),     # three lanes
    (2, 320, 128, 128, 320), (2, 960, 128, 128, 320),  # SD-1.5 1024² (hires_fix)
    (2, 960, 64, 80, 320), (2, 1280, 10, 8, 1280),     # outpaint's 640x512 canvas
    (1, 960, 128, 128, 320),                           # SDXL 1024², one lane
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k5_matches_plain_at_the_c3_lane_counts(cuda, b, cin, h, w, cout, dtype):
    args = _k5_inputs(b, cin, h, w, cout, dtype, cuda, seed=13)
    got = k5.scaled_silu_conv3x3(*args)
    torch.cuda.synchronize()
    ref = k5.scaled_silu_conv3x3_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.shape == (b, cout, h, w)
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("case", ["unet9 inpaint", "blend inpaint", "InstructPix2Pix",
                                  "LCM, no CFG"])
def test_c3_paths_card_match_cpu(cuda, case):
    """Each C3 path at the tiny config, FP32, on the card (kernel attention,
    conv and VAE backends) against the CPU plain path, the same weights and
    seed: images > 40 dB."""
    import dataclasses

    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    r = np.random.RandomState(14)
    image = r.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 4:20] = 1.0
    unet, opts = {
        "unet9 inpaint": (dict(in_channels=9), dict(input_image=image, mask_image=mask)),
        "blend inpaint": ({}, dict(input_image=image, mask_image=mask, strength=0.7,
                                   mask_blur=2)),
        "InstructPix2Pix": (dict(in_channels=8), dict(edit_image=image)),
        "LCM, no CFG": (dict(time_cond_dim=16), dict(do_cfg=False, sampler_name="lcm")),
    }[case]
    cfg = port.tiny_sd_config()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **unet))
    cpu = port.build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    gcfg = dataclasses.replace(cfg, attention_backend="kernel", conv_backend="kernel",
                               vae_attention_backend="kernel")
    gpu = port.build_models(gcfg, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    kw = dict(seed=3, n_inference_steps=3, height=32, width=32, return_latents=True,
              tokenizer=make_test_tokenizer(["a", "cat", "dog"], max_len=16), **opts)
    img_c, lat_c = port.generate("a cat", models=cpu, config=cfg, device="cpu", **kw)
    img_g, lat_g = port.generate("a cat", models=gpu, config=gcfg, device="cuda", **kw)
    assert np.isfinite(lat_g).all()
    assert _psnr(img_c, img_g) > 40.0


def _separate_views(b, h, sq, sk, dh, dtype, cuda, seed):
    """q, k and v each from its own (B, S, C) projection, viewed as (B, H, S,
    Dh): the reference read's q from the tokens and k, v from [own, banked]
    tokens through separate projections."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, h * dh, device=cuda, generator=g).to(dtype)
            .reshape(b, s, h, dh).transpose(1, 2) for s in (sq, sk, sk)]


@pytest.mark.parametrize("b,h,sq,sk,dh", [
    (2, 8, 4096, 8192, 40), (2, 8, 1024, 2048, 80), (2, 8, 256, 512, 160),  # SD-1.5 512²
    (2, 10, 4096, 8192, 64), (2, 20, 1024, 2048, 64),                         # SDXL 1024²
    (2, 8, 2304, 4608, 80), (2, 8, 144, 288, 160)])                           # SD-1.5 768²
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k2_matches_plain_at_the_reference_shapes(cuda, b, h, sq, sk, dh, dtype):
    """K2 over the reference reads' [own, banked] KV of 2·S tokens
    (chip_smoke.E_PLANS), its streamed schedule at level 1."""
    args = _separate_views(b, h, sq, sk, dh, dtype, cuda, seed=15)
    _check_head_split(fa.flash_attention_onepass, fa.flash_attention_onepass_plain,
                      args, {"causal": False}, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k4_matches_plain_with_sq_unequal_sk(cuda, dtype):
    """K4 at SD-1.5 768²'s reference read, (2, 8, 9216, 40) x KV 18432, held
    on its first 1024 q rows (the plain version's scores of every row would
    not fit)."""
    q, k, v = _separate_views(2, 8, 9216, 18432, 40, dtype, cuda, seed=16)
    got = fa.flash_attention_streamed(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_streamed_plain(q[:, :, :1024], k, v)
    assert got.shape == q.shape and torch.isfinite(got).all()
    err = (got[:, :, :1024].float() - ref.float()).abs().max().item()
    assert err <= tolerance(dtype, ref), err


@pytest.mark.parametrize("case", ["ControlNet", "two ControlNets", "T2I-Adapter",
                                  "IP-Adapter", "IP-Adapter plus", "reference attn",
                                  "reference adain"])
def test_e_paths_card_match_cpu(cuda, case):
    """Each slice E path at the tiny config, FP32, on the card (kernel
    attention, conv and VAE backends) against the CPU plain path, the same
    weights (the ControlNets' zero convs drawn too) and seed: images
    > 40 dB."""
    import dataclasses

    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv
    from pytorch_stable_diffusion_tpu_torch.models import (controlnet, reset_parameters,
                                                           t2i_adapter)
    from pytorch_stable_diffusion_tpu_torch.weights import ip_adapter
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    r = np.random.RandomState(17)
    image = r.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    vis = cv.tiny_vision_config()
    cfg = port.tiny_sd_config()
    gcfg = dataclasses.replace(cfg, attention_backend="kernel", conv_backend="kernel",
                               vae_attention_backend="kernel")
    cpu = port.build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    gpu = port.build_models(gcfg, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    if "ControlNet" in case:
        n = 1 + (case == "two ControlNets")
        nets = [controlnet.build(cfg, device="cpu", generator=torch.Generator().manual_seed(s))
                for s in range(n)]
        cpu["controlnet"] = nets
        gpu["controlnet"] = [controlnet.build(gcfg, device="cuda", state_dict=x.state_dict())
                             for x in nets]
        opts = dict(control_image=[image] * n, controlnet_scale=[0.8] * n)
    elif case == "T2I-Adapter":
        cpu["t2i_adapter"] = t2i_adapter.build(cfg, device="cpu",
                                               generator=torch.Generator().manual_seed(3))
        gpu["t2i_adapter"] = t2i_adapter.build(gcfg, device="cuda",
                                               state_dict=cpu["t2i_adapter"].state_dict())
        opts = dict(adapter_image=image)
    elif case.startswith("IP"):
        state = ip_adapter.synthetic_ip_state(cfg.unet, embed_dim=vis.proj_dim, seed=5)
        for group in state.values():
            for k, x in group.items():
                group[k] = x / np.sqrt(x.shape[1]) if x.ndim == 2 else x
        ada = cv.build_ip_adapter(ip_adapter.convert_ip_adapter(state, cfg.unet), device="cpu")
        if case.endswith("plus"):  # a Resampler of 16 queries, 2 layers of one 64-wide head
            proj = cv.Resampler(16, 64, vis.width, cfg.unet.d_context, 2, 64, 256)
            reset_parameters(proj, torch.Generator().manual_seed(6))
            ada = cv.IPAdapter(proj, dict(ada.layers.items()))
        cpu["ip_adapter"] = ada
        gpu["ip_adapter"] = cv.build_ip_adapter(ada.state_dict(), device="cuda")
        cpu["clip_vision"] = cv.build_clip_vision(vis, device="cpu",
                                                  generator=torch.Generator().manual_seed(4))
        gpu["clip_vision"] = cv.build_clip_vision(vis, device="cuda",
                                                  state_dict=cpu["clip_vision"].state_dict())
        opts = dict(ip_adapter_image=r.randint(0, 256, (16, 16, 3)).astype(np.uint8),
                    clip_vision_config=vis)
    else:
        opts = dict(reference_image=image, reference_mode=case.split()[1])
    kw = dict(seed=3, n_inference_steps=3, height=32, width=32, return_latents=True,
              sampler_name="euler",
              tokenizer=make_test_tokenizer(["a", "cat", "dog"], max_len=16), **opts)
    img_c, lat_c = port.generate("a cat", models=cpu, config=cfg, device="cpu", **kw)
    img_g, lat_g = port.generate("a cat", models=gpu, config=gcfg, device="cuda", **kw)
    assert np.isfinite(lat_g).all()
    assert _psnr(img_c, img_g) > 40.0


# ------------------------------------------------------------------- slice F
@pytest.mark.parametrize("b,sq,c,heads,rows", [
    (8, 1024, 320, 8, 1024),     # Hypertile 32 at 512²: level 1's four tiles, CFG
    (128, 1024, 320, 8, 256),    # the fast preset at 2048²: level 1's 64 tiles
    (32, 1024, 640, 8, 256),     # 2048² level 2
    (8, 1024, 1280, 8, 1024),    # 2048² level 3
    (200, 1024, 320, 8, 256),    # 2560²: level 1's 100 tiles
    (50, 1024, 640, 8, 256),     # 2560² level 2
    (32, 400, 1280, 8, 400),     # 2560² level 3: 20 x 20 tiles (ragged q and KV)
    (2, 1600, 1280, 8, 1600),    # 2560² mid block, untiled
    (8, 1024, 640, 10, 1024),    # SDXL 1024² level 1 under Hypertile 32
    (2, 2048, 320, 8, 2048),     # ToMe 0.5 at 512²: level 1's merged tokens
    (2, 2048, 640, 10, 2048),    # ToMe 0.5 at SDXL 1024²
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_k1_matches_plain_at_the_f_shapes(cuda, b, sq, c, heads, rows, dtype):
    """K1 at slice F's Hypertile tile batches and ToMe's merged lengths
    (chip_smoke.F_PLANS), checked on the first ``rows`` q rows."""
    q, k, v = _k1_views(b, sq, sq, c, dtype, cuda, seed=21)
    got = fa.flash_attention_bsc(q, k, v, n_heads=heads)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bsc_plain(q[:, :rows], k, v, heads)
    err = (got[:, :rows].float() - ref.float()).abs().max().item()
    assert got.shape == (b, sq, c) and err <= tolerance(dtype, ref), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_tome_merge_is_deterministic_on_the_card(cuda, dtype):
    """ToMe's mean-merge (a one-hot product, not atomics) gives the same
    bits on every run, and matches the CPU's selections."""
    from pytorch_stable_diffusion_tpu_torch.ops import tome

    dst_i, src_i, r = tome.plan(64, 64, 2, 2, 0.5)
    x = torch.randn(2, 4096, 320, generator=torch.Generator().manual_seed(3)).to(dtype)
    runs = [tome.merge(x.to(cuda), dst_i, src_i, r) for _ in range(3)]
    torch.cuda.synchronize()
    for out, info in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(info["m_dst"], runs[0][1]["m_dst"])
    y = torch.randn(2, 4096 - r, 320, device=cuda).to(dtype)
    assert torch.equal(tome.unmerge(y, runs[0][1]), tome.unmerge(y, runs[1][1]))
    if dtype == torch.float32:  # near-ties may order apart across devices
        cpu_sel = tome.merge(x, dst_i, src_i, r)[1]["merged_sel"]
        agree = (cpu_sel == runs[0][1]["merged_sel"].cpu()).float().mean().item()
        assert agree > 0.99, agree


def test_tiling_unet_forward_runs_no_k5(cuda):
    """Under seamless tiling the "kernel" conv tier runs the res blocks on
    the plain convs (K5 pads with zeros): 0 K5 launches, the output within
    fp32 rounding of the "plain" tier's, and roll-equivariant."""
    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.ops import conv

    cfg = port.tiny_sd_config()
    unet = port.build_models(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(2))["diffusion"]
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1, 4, 32, 32, device="cuda", generator=g) \
        .contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(1, 16, cfg.unet.d_context, device="cuda", generator=g)
    t = torch.tensor(300.0, device="cuda")
    before = k5.scaled_silu_conv3x3.launches
    with torch.inference_mode(), conv.circular_padding():
        got = unet(x, ctx, t, conv_backend="kernel", attention_backend="kernel")
        rolled = unet(torch.roll(x, (4, 6), (2, 3)), ctx, t, conv_backend="kernel",
                      attention_backend="kernel")
        plain = unet(x, ctx, t, conv_backend="plain", attention_backend="kernel")
    torch.cuda.synchronize()
    assert k5.scaled_silu_conv3x3.launches == before
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rolled, torch.roll(got, (4, 6), (2, 3)), rtol=1e-4, atol=1e-4)
    with torch.inference_mode():
        unet(x, ctx, t, conv_backend="kernel", attention_backend="kernel")
    torch.cuda.synchronize()
    assert k5.scaled_silu_conv3x3.launches > before  # outside the mode K5 runs
