"""The port's ops (pytorch_stable_diffusion_tpu_torch/ops) against the JAX
ops on the same numpy inputs, under the FP32 policy.

Tolerance: 1e-5 abs/rel for elementwise ops, norms, linears and attention
(the same fp32 math in another summation order); 1e-4 for convolutions,
whose im2col/direct algorithms in XLA and oneDNN sum 9·C_in products in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu.ops import act as jact
from pytorch_stable_diffusion_tpu.ops import attention as jattn
from pytorch_stable_diffusion_tpu.ops import conv as jconv
from pytorch_stable_diffusion_tpu.ops import linear as jlinear
from pytorch_stable_diffusion_tpu.ops import norm as jnorm
from pytorch_stable_diffusion_tpu_torch.ops import act, attention, conv, linear, norm
from pytorch_stable_diffusion_tpu_torch.weights.convert import state_dict_from_jax_tree

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(module, jax_params):
    module.load_state_dict(state_dict_from_jax_tree(jax_params), strict=True)
    return module.requires_grad_(False)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_linear():
    jp = jlinear.init(jax.random.PRNGKey(0), 8, 6)
    x = _rand(1, 2, 5, 8)
    ref = np.asarray(jlinear.apply(jp, jnp.asarray(x)))
    got = linear.apply(_port(linear.Linear(8, 6), jp), _t(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["silu", "quick_gelu"])
def test_activations(name):
    x = _rand(2, 4, 33) * 3
    ref = np.asarray(getattr(jact, name)(jnp.asarray(x)))
    np.testing.assert_allclose(getattr(act, name)(_t(x)).numpy(), ref, **TOL)


@pytest.mark.parametrize("quirks", [False, True])
def test_geglu(quirks):
    h = _rand(3, 2, 7, 16) * 2
    ref = np.asarray(jact.geglu(jnp.asarray(h), reference_quirks=quirks))
    got = act.geglu(_t(h), reference_quirks=quirks).numpy()
    assert got.shape == (2, 7, 8)
    np.testing.assert_allclose(got, ref, **TOL)


def _norm_params(c, seed):
    return {"scale": jnp.asarray(1.0 + 0.1 * _rand(seed, c)),
            "bias": jnp.asarray(0.1 * _rand(seed + 1, c))}


@pytest.mark.parametrize("name", ["group_norm", "group_norm_silu"])
def test_group_norm(name):
    x = _rand(4, 2, 6, 5, 16) * 2 + 0.5  # NHWC for JAX
    jp = _norm_params(16, 5)
    ref = np.asarray(getattr(jnorm, name)(jp, jnp.asarray(x), 4))
    got = getattr(norm, name)(_port(norm.Norm(16), jp), _t(to_nchw(x)), 4).numpy()
    np.testing.assert_allclose(got, to_nchw(ref), **TOL)


def test_layer_norm():
    x = _rand(6, 2, 9, 24) * 3 + 1
    jp = _norm_params(24, 7)
    ref = np.asarray(jnorm.layer_norm(jp, jnp.asarray(x)))
    got = norm.layer_norm(_port(norm.Norm(24), jp), _t(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("ksize,stride,padding", [
    (3, 1, 1),                 # the res-block conv
    (3, 2, jconv.ASYM_DOWN),   # VAE encoder downsample: right/bottom pad only
    (3, 2, 1),                 # UNet downsample: symmetric pad 1
    (1, 1, 0),                 # shortcut / quant convs
])
def test_conv(ksize, stride, padding):
    jp = jconv.init(jax.random.PRNGKey(3), 6, 10, ksize)
    x = _rand(8, 2, 9, 8, 6)
    ref = np.asarray(jconv.apply(jp, jnp.asarray(x), stride=stride, padding=padding))
    pad = conv.ASYM_DOWN if padding == jconv.ASYM_DOWN else padding
    got = conv.apply(_port(conv.Conv(6, 10, ksize), jp), _t(to_nchw(x)),
                     stride=stride, padding=pad).numpy()
    np.testing.assert_allclose(got, to_nchw(ref), **CONV_TOL)


def test_upsample_nearest_2x():
    x = _rand(9, 2, 3, 5, 4)
    ref = np.asarray(jconv.upsample_nearest_2x(jnp.asarray(x)))
    got = conv.upsample_nearest_2x(_t(to_nchw(x))).numpy()
    np.testing.assert_array_equal(got, to_nchw(ref))


@pytest.mark.parametrize("kind,fuse", [
    ("self", True), ("self", False), ("causal", True), ("cross", True),
    ("cross", False),
])
def test_attention_plain_path(kind, fuse):
    """Short sequences: the materialized path on both sides (the JAX
    package's "xla" backend; the port's "plain")."""
    d, heads = 32, 4
    d_cross = 24 if kind == "cross" else None
    jp = jattn.init(jax.random.PRNGKey(4), heads, d, d_cross=d_cross)
    x = _rand(10, 2, 20, d)
    ctx = _rand(11, 2, 77, d_cross) if d_cross else None
    causal = kind == "causal"
    ref = np.asarray(jattn.apply(jp, jnp.asarray(x),
                                 None if ctx is None else jnp.asarray(ctx),
                                 n_heads=heads, causal=causal, backend="xla",
                                 fuse=fuse))
    mod = _port(attention.Attention(d, d_cross=d_cross), jp)
    got = attention.apply(mod, _t(x), None if ctx is None else _t(ctx),
                          n_heads=heads, causal=causal, backend="plain",
                          fuse=fuse).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_attention_kernel_backend_short_kv_is_plain():
    """On the kernel backend, KV < 256 and cross-attention stay on the
    materialized path, as the JAX "pallas" backend does."""
    d, heads = 32, 4
    jp = jattn.init(jax.random.PRNGKey(5), heads, d, d_cross=16)
    x, ctx = _rand(12, 1, 64, d), _rand(13, 1, 77, 16)
    ref = np.asarray(jattn.apply(jp, jnp.asarray(x), jnp.asarray(ctx),
                                 n_heads=heads, backend="pallas"))
    mod = _port(attention.Attention(d, d_cross=16), jp)
    got = attention.apply(mod, _t(x), _t(ctx), n_heads=heads,
                          backend="kernel").numpy()
    np.testing.assert_allclose(got, ref, **TOL)
