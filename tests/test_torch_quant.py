"""The int8 tiers (``ops/quant.py``) against the JAX package's, on the CPU.

The functions on equal numpy inputs: the int8 values, the scales and the
int32 accumulators equal, the fp32 outputs within 1e-6 relative (of the
largest output: products summed in another order).  Then the dispatch at
each site, as the JAX package has it: w8 on every ``linear.apply`` and
``conv.apply`` but not on the fused projections or the transformer
blocks' 1x1 projections, w8a8 where the contraction is wide, nothing on
``time_proj``, ``conv_in``/``conv_out`` or K5 (a spy on its plain
version counts no call under any tier).  A tiny UNet under "conv" is
bit-identical to "none" (nothing crosses ``MIN_K``); a width-160 UNet
(3x3 K = 1440) under each tier runs the JAX ``unet.apply(quant=)``'s int8
sites, in its order, and stays within mean relative error 1e-3 of it under
"wide" and "w8" (5e-2 under "conv": MID_BOUND says why); one w8
``generate()`` equals JAX ``generate()`` on injected noise within one uint8
level.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu import pipeline as jpipeline
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.ops import quant as jquant
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer
from pytorch_stable_diffusion_tpu_torch import pipeline
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.models import unet as punet
from pytorch_stable_diffusion_tpu_torch.ops import attention, conv, linear, quant
from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
from pytorch_stable_diffusion_tpu_torch.weights import convert
from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

WORDS = ["a", "cat", "dog", "photo", "of"]
TIERS = ("wide", "conv", "w8")


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want):
    """Within 1e-6 relative of the largest output."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# ------------------------------------------------------------- functions
@pytest.mark.parametrize("shape,dims", [((5, 100), (0, 1)), ((36, 100), (1,)),
                                        ((2, 6, 6, 24), (0, 1, 2, 3))])
def test_quantize_matches_jax(shape, dims):
    x = _rand(1, *shape)
    x[0, 0] = 0.5 * np.abs(x).max() * 127 / 127.5  # a value near a .5 boundary
    q, s = quant.quantize(_t(x), dims)
    jq, js = jquant.quantize(jnp.asarray(x), dims)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [(5, 100, 36), (40, 64, 48), (3, 1280, 16)],
                         ids=["padded", "aligned", "wide"])
def test_int8_linear_matches_jax(m, k, n):
    """(5, 100) @ (100, 36) needs every pad of ``int_mm`` (M <= 16, K and N
    not multiples of 8)."""
    x, w, b = _rand(2, 2, m, k), _rand(3, n, k, scale=0.05), _rand(4, n)
    want = jquant.int8_linear(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b))
    got = quant.int8_linear(_t(x), _t(w), _t(b))
    assert got.dtype == torch.float32 and got.shape == (2, m, n)
    _close(got, want)
    jxq, _ = jquant.quantize(jnp.asarray(x), (0, 1, 2))
    jwq, _ = jquant.quantize(jnp.asarray(w.T), 0)
    jacc = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    acc = quant.int_mm(_t(np.asarray(jxq).reshape(-1, k)), _t(np.asarray(jwq).T))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).reshape(-1, n))


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, ((0, 1), (0, 1)))],
                         ids=["3x3", "down", "asym"])
def test_int8_conv_matches_jax(stride, padding):
    x, w, b = _rand(5, 2, 8, 8, 24), _rand(6, 3, 3, 24, 20, scale=0.05), _rand(7, 20)
    want = jquant.int8_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                            padding=padding, bias=jnp.asarray(b))
    wt = _t(np.transpose(w, (3, 2, 0, 1)))
    xp, pp = _t(to_nchw(x)), padding
    if not isinstance(padding, int):  # as conv.apply hands it over: padded, then VALID
        (top, bottom), (left, right) = padding
        xp, pp = torch.nn.functional.pad(xp, (left, right, top, bottom)), 0
    got = quant.int8_conv(xp, wt, stride=stride, padding=pp, bias=_t(b))
    _close(got, to_nchw(want))
    jxq, _ = jquant.quantize(jnp.asarray(x), (0, 1, 2, 3))
    jwq, _ = jquant.quantize(jnp.asarray(w), (0, 1, 2))
    pad = [(padding, padding)] * 2 if isinstance(padding, int) else list(padding)
    jacc = jax.lax.conv_general_dilated(jxq, jwq, (stride, stride), pad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    xq = _t(to_nchw(np.asarray(jxq)))
    if not isinstance(padding, int):
        xq = torch.nn.functional.pad(xq, (left, right, top, bottom))
    acc = quant.conv_int32(xq, _t(np.transpose(np.asarray(jwq), (3, 2, 0, 1))), (3, 3),
                           stride=stride, padding=pp)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_w8_matches_jax():
    x, w, b = _rand(8, 2, 6, 48), _rand(9, 40, 48, scale=0.05), _rand(10, 40)
    want = jquant.w8_linear(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b),
                            compute_dtype=jnp.float32)
    _close(quant.w8_linear(_t(x), _t(w), _t(b), torch.float32), want)
    xc, wc = _rand(11, 1, 8, 8, 16), _rand(12, 3, 3, 16, 24, scale=0.05)
    want = jquant.w8_conv(jnp.asarray(xc), jnp.asarray(wc), stride=2,
                          bias=jnp.asarray(b[:24]), compute_dtype=jnp.float32)
    got = quant.w8_conv(_t(to_nchw(xc)), _t(np.transpose(wc, (3, 2, 0, 1))), stride=2,
                        bias=_t(b[:24]), compute_dtype=torch.float32)
    _close(got, to_nchw(want))


def test_predicates_match_jax():
    assert quant.MIN_K == jquant.MIN_K
    for tier in ("none",) + TIERS:
        for c in (16, 142, 143, 320, 1279, 1280, 2560):
            for kh in (1, 3):
                assert quant.conv_wants_int8(tier, c, kh) == \
                    jquant.conv_wants_int8(tier, c, kh), (tier, c, kh)
            assert quant.matmul_wants_int8(tier, c) == jquant.matmul_wants_int8(tier, c)


# -------------------------------------------------------------- dispatch
class _Spy:
    """Counts the quant functions' calls by the id of the weight they take."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("int8_linear", "int8_conv", "w8_linear", "w8_conv"):
            real = getattr(quant, name)

            def spy(x, weight, *a, _name=name, _real=real, **kw):
                self.calls.append((_name, id(weight)))
                return _real(x, weight, *a, **kw)
            monkeypatch.setattr(quant, name, spy)

    def names(self):
        return [n for n, _ in self.calls]


def _linear(k, n, seed):
    p = linear.Linear(k, n)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    return p


@pytest.mark.parametrize("tier,k,want", [
    ("w8", 32, ["w8_linear"]), ("wide", 32, []), ("conv", 1279, []),
    ("wide", 1280, ["int8_linear"]), ("conv", 1280, ["int8_linear"]),
    ("none", 1280, [])])
def test_linear_dispatch(monkeypatch, tier, k, want):
    spy = _Spy(monkeypatch)
    p, x = _linear(k, 8, 0), _t(_rand(13, 3, k))
    got = linear.apply(p, x, quant=tier)
    assert spy.names() == want
    if not want:
        torch.testing.assert_close(got, linear.apply(p, x), rtol=0, atol=0)


@pytest.mark.parametrize("tier,c,ksize,want", [
    ("w8", 8, 1, ["w8_conv"]), ("conv", 160, 3, ["int8_conv"]), ("conv", 160, 1, []),
    ("wide", 160, 3, []), ("wide", 1280, 1, ["int8_conv"]), ("none", 160, 3, [])])
def test_conv_dispatch(monkeypatch, tier, c, ksize, want):
    spy = _Spy(monkeypatch)
    p = conv.Conv(c, 8, ksize)
    p.reset_parameters(torch.Generator().manual_seed(1))
    x = _t(_rand(14, 1, c, 4, 4))
    got = conv.apply(p, x, padding=ksize // 2, quant=tier)
    assert spy.names() == want
    if not want:
        torch.testing.assert_close(got, conv.apply(p, x, padding=ksize // 2), rtol=0, atol=0)


@pytest.mark.parametrize("k", [32, 1280])
def test_fused_and_1x1_projections_take_w8a8_only(monkeypatch, k):
    """The JAX package's ``_fused_proj`` and ``_proj1x1`` have no w8 branch:
    under "w8" both stay exact; under "wide" they take w8a8 from K = 1280."""
    spy = _Spy(monkeypatch)
    parts = [_linear(k, 16, s) for s in (2, 3, 4)]
    x = _t(_rand(15, 2, 5, k))
    plain = attention._fused_proj(parts, x, config.FP32)
    for a, b in zip(attention._fused_proj(parts, x, config.FP32, "w8"), plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    p = conv.Conv(k, 16, 1)
    p.reset_parameters(torch.Generator().manual_seed(5))
    torch.testing.assert_close(punet._proj1x1(p, x, config.FP32, "w8"),
                               punet._proj1x1(p, x, config.FP32), rtol=0, atol=0)
    assert spy.calls == []
    attention._fused_proj(parts, x, config.FP32, "wide")
    punet._proj1x1(p, x, config.FP32, "wide")
    assert spy.names() == (["int8_linear"] * 2 if k >= quant.MIN_K else [])


@pytest.fixture(scope="module")
def tiny():
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=61)
    return cfg, jcfg, jp, build_models(cfg, device="cpu",
                                       state_dicts=convert.from_jax_params(jp, cfg))


def _unet_in(cfg, seed=16, hw=8):
    x = _rand(seed, 2, cfg.unet.in_channels, hw, hw)
    ctx = _rand(seed + 1, 2, cfg.clip.max_len, cfg.unet.d_context)
    return _t(x), _t(ctx)


def test_unet_sites_under_w8(monkeypatch, tiny):
    """Under "w8" every res-block conv and shortcut, the down/upsample
    convs and the transformers' unfused projections take w8; conv_in,
    conv_out, the time MLP and ``time_proj`` do not, nor (fused) q/k/v."""
    spy = _Spy(monkeypatch)
    cfg, _, _, models = tiny
    unet = models["diffusion"]
    with torch.inference_mode():
        unet(*_unet_in(cfg), torch.tensor(421.0), quant="w8", fuse_qkv=True)
    seen = {i for _, i in spy.calls}
    layers = [lp for blk in unet.modules() if isinstance(blk, punet.AttnBlock)
              for lp in blk.layers()]
    never = [unet.conv_in.weight, unet.conv_out.weight, unet.time_embed.fc1.weight,
             unet.time_embed.fc2.weight]
    never += [m.time_proj.weight for m in unet.modules() if isinstance(m, punet.ResBlock)]
    never += [p.weight for lp in layers for p in (lp.self_attn.q, lp.self_attn.k,
                                                  lp.self_attn.v, lp.cross_attn.k,
                                                  lp.cross_attn.v)]
    assert not seen & {id(w) for w in never}
    taken = [c.weight for m in unet.modules() if isinstance(m, punet.ResBlock)
             for c in (m.conv1, m.conv2) + ((m.shortcut,) if m.shortcut else ())]
    taken += [s.down.weight for s in unet.encoder if s.down is not None]
    taken += [s.upsample.weight for s in unet.decoder if s.upsample is not None]
    taken += [p.weight for lp in layers for p in (lp.self_attn.out, lp.cross_attn.q,
                                                  lp.cross_attn.out, lp.geglu_proj,
                                                  lp.geglu_out)]
    assert {id(w) for w in taken} <= seen


@pytest.mark.parametrize("tier", TIERS)
def test_k5_never_runs_under_a_tier(monkeypatch, tiny, tier):
    calls = []
    real = k5.scaled_silu_conv3x3_plain
    monkeypatch.setattr(k5, "scaled_silu_conv3x3_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg, _, _, models = tiny
    with torch.inference_mode():
        for backend in ("kernel", "kernel_fold"):
            models["diffusion"](*_unet_in(cfg), torch.tensor(421.0), conv_backend=backend,
                                quant=tier)
        assert not calls
        models["diffusion"](*_unet_in(cfg), torch.tensor(421.0), conv_backend="kernel")
    assert calls  # the spy sees K5's plain version where no tier is set


def test_tiny_unet_conv_tier_is_inert(tiny):
    """Nothing of the tiny UNet crosses MIN_K (the JAX package's
    ``test_tiny_unet_quant_inert``)."""
    cfg, _, _, models = tiny
    with torch.inference_mode():
        a = models["diffusion"](*_unet_in(cfg), torch.tensor(421.0))
        b = models["diffusion"](*_unet_in(cfg), torch.tensor(421.0), quant="conv")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


#: the JAX package's width-160 UNet (tests/test_quant.py): 3x3 K = 1440
MID = dict(model_channels=160, ch_mults=(1, 2), attn_levels=(True, False), n_heads=4,
           d_context=64, groups=16)


@pytest.fixture(scope="module")
def mid():
    cfg = dataclasses.replace(config.tiny_sd_config(), unet=config.UNetConfig(**MID))
    jcfg = to_jax(cfg)
    jp = jax_params(jcfg, seed=62)
    sds = convert.from_jax_params(jp, cfg)
    unet = punet.UNet(cfg.unet)
    unet.load_state_dict(sds["diffusion"], strict=True)
    return cfg, jcfg, jp, unet.eval().requires_grad_(False)


#: the mean relative error bound of the whole width-160 UNet against JAX
#: ``unet.apply``.  Readings (port tier vs JAX tier, and in brackets the
#: port's "none" vs the JAX tier, what a tier that is not applied would
#: read): "wide" 8.3e-5 (4.1e-3: its one int8 site is the bottleneck's GeGLU
#: down-projection, K = 1280), "w8" 2.0e-6 (2.4e-2), "conv" 1.9e-2 (2.9e-2).
#: Under "conv" every conv quantizes its input, and one int8 value that a
#: float rounding difference upstream (1e-6 relative between XLA's and
#: torch's CPU kernels) moves across a .5 boundary moves the conv's outputs
#: by a quantization step: a 1e-6 relative perturbation of the port's own
#: input moves its "conv" output by 1.4e-2 (its "none" output by 2e-6).  So
#: no bound on the whole output tells a right "conv" tier from a missing
#: one; it is held at 5e-2 here, site by site at 1e-5
#: (test_mid_unet_conv_sites_match_jax), and by the int8 sites it runs,
#: which equal the JAX package's (test_mid_unet_int8_sites_match_jax).
MID_BOUND = {"wide": 1e-3, "w8": 1e-3, "conv": 5e-2}


@pytest.fixture(scope="module")
def mid_runs(mid):
    """tier -> the width-160 UNet on one input: (JAX output, port output,
    port "none" output, JAX int8 calls, port int8 calls), each call by
    function and weight shape as (out, in[, kh, kw]), in order; JAX's
    recorded while a fresh ``jax.jit`` traces ``unet.apply``."""
    cfg, jcfg, jp, unet = mid
    x, ctx = _rand(17, 1, 4, 8, 8), _rand(18, 1, 16, 64)
    with torch.inference_mode():
        exact = unet(_t(x), _t(ctx), torch.tensor(500.0)).numpy()
    runs = {}

    def run(tier):
        if tier in runs:
            return runs[tier]
        got_calls, want_calls, saved = [], [], []
        for name in ("int8_linear", "int8_conv", "w8_linear", "w8_conv"):
            def jspy(x, k, *a, _name=name, _real=getattr(jquant, name), **kw):
                s = k.shape  # JAX: (in, out) and HWIO
                want_calls.append((_name, (s[1], s[0]) if k.ndim == 2
                                   else (s[3], s[2], s[0], s[1])))
                return _real(x, k, *a, **kw)

            def spy(x, w, *a, _name=name, _real=getattr(quant, name), **kw):
                got_calls.append((_name, tuple(w.shape)))
                return _real(x, w, *a, **kw)
            saved += [(jquant, name, getattr(jquant, name)), (quant, name, getattr(quant, name))]
            setattr(jquant, name, jspy)
            setattr(quant, name, spy)
        try:
            # a new function object: traced anew, so the spies see every call
            japply = jax.jit(functools.partial(junet.apply, cfg=jcfg.unet, quant=tier))
            want = to_nchw(japply(jp["diffusion"], jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                                  jnp.asarray(ctx), 500))
            with torch.inference_mode(), quant.weight_cache():
                got = unet(_t(x), _t(ctx), torch.tensor(500.0), quant=tier).numpy()
        finally:
            for mod, name, real in saved:
                setattr(mod, name, real)
        runs[tier] = (want, got, exact, want_calls, got_calls)
        return runs[tier]
    return run


@pytest.mark.parametrize("tier", TIERS)
def test_mid_unet_tiers_match_jax(mid_runs, tier):
    want, got, exact, _, _ = mid_runs(tier)
    rel = lambda a: np.abs(a - want).mean() / np.abs(want).mean()  # noqa: E731
    assert rel(got) < MID_BOUND[tier], rel(got)
    assert not np.array_equal(got, exact)
    if tier != "conv":  # the tier left out fails the bound
        assert rel(exact) > MID_BOUND[tier], rel(exact)


@pytest.mark.parametrize("tier", TIERS)
def test_mid_unet_int8_sites_match_jax(mid_runs, tier):
    """The width-160 UNet's int8 calls under each tier, in order, by
    function and weight shape, equal the JAX ``unet.apply``'s: 1, 27 and 63
    calls."""
    _, _, _, want_calls, got_calls = mid_runs(tier)
    assert got_calls == want_calls
    assert len(got_calls) == {"wide": 1, "conv": 27, "w8": 63}[tier]


@pytest.mark.parametrize("path,stride", [
    ("encoder.0.res.conv1", 1), ("encoder.3.res.conv1", 1), ("encoder.3.res.conv2", 1),
    ("decoder.0.res.conv1", 1), ("decoder.0.res.shortcut", 1), ("encoder.2.down", 2),
    ("decoder.2.upsample", 1)], ids=lambda v: str(v))
def test_mid_unet_conv_sites_match_jax(mid, path, stride):
    """The "conv" tier's convs of the width-160 UNet (160 -> 160, 160 ->
    320, 320 -> 320, the decoder's 640 -> 320 and its 1x1 shortcut, which
    stays exact, the stride-2 and the upsample conv) on one input each:
    within 1e-5 of the largest output."""
    from pytorch_stable_diffusion_tpu.ops import conv as jconv

    cfg, _, jp, unet = mid
    p, jpp = unet.get_submodule(path), jp["diffusion"]
    for part in path.split("."):
        jpp = jpp[int(part)] if part.isdigit() else jpp[part]
    x = _rand(22, 1, p.weight.shape[1], 8, 8)
    pad = p.weight.shape[2] // 2
    want = to_nchw(jconv.apply(jpp, jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                               stride=stride, padding=pad, quant="conv"))
    with torch.inference_mode():
        got = conv.apply(p, _t(x), stride=stride, padding=pad, quant="conv")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_w8_generate_matches_jax(tiny):
    """One w8 request (8 DDIM steps, CFG) on injected noise: the uint8
    images within one level, everywhere."""
    cfg, jcfg, jp, models = tiny
    cfg = dataclasses.replace(cfg, quant="w8")
    jcfg = dataclasses.replace(jcfg, quant="w8")
    r = np.random.RandomState(19)
    noise = {"latent_init": r.randn(1, 8, 8, 4).astype(np.float32),
             "sampler_noise": r.randn(8, 1, 8, 8, 4).astype(np.float32)}
    kw = dict(cfg_scale=7.5, n_inference_steps=8, sampler_name="ddim", height=16, width=16)
    want = jpipeline.generate("a photo of a cat", models=jp, config=jcfg,
                              tokenizer=jtokenizer(WORDS, max_len=cfg.clip.max_len),
                              fixed_noise=noise, **kw)
    got = pipeline.generate("a photo of a cat", models=models, config=cfg,
                            tokenizer=make_test_tokenizer(WORDS, max_len=cfg.clip.max_len),
                            fixed_noise={"latent_init": to_nchw(noise["latent_init"]),
                                         "sampler_noise": np.transpose(
                                             noise["sampler_noise"], (0, 1, 4, 2, 3))},
                            **kw)
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1, diff.max()
