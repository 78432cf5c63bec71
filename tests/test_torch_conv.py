"""The port's fused GN -> SiLU -> conv3x3 (K5) and folded norms against the
JAX package, on the CPU.

The port's K5 wrapper runs its plain version on CPU tensors; the JAX side
runs the Pallas kernel in interpret mode (``ops/pallas/conv.py``), with the
block arguments of ``tests/test_pallas_conv.py`` (they choose the TPU grid
and go to the JAX side only).  Inputs are drawn with numpy from a seed.

Tolerances: 2e-4 for the fp32 conv (as ``test_pallas_conv.py``: 9·C
products summed in another order), 0.05 in bf16 (x + t and the activation
rounded to bf16 at other places), 1e-5 for the folded norms (the same fp32
statistics), 1e-4 for the res and transformer blocks (a few convs and
matmuls deep).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

from pytorch_stable_diffusion_tpu.core.dtypes import FP32 as JFP32
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.ops import norm as jnorm
from pytorch_stable_diffusion_tpu.ops.pallas import conv as pconv
from pytorch_stable_diffusion_tpu_torch.core.dtypes import FP32
from pytorch_stable_diffusion_tpu_torch.models import unet
from pytorch_stable_diffusion_tpu_torch.models.config import (CONV_BACKENDS,
                                                              check_ported,
                                                              tiny_sd_config)
from pytorch_stable_diffusion_tpu_torch.ops import conv, norm
from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
from pytorch_stable_diffusion_tpu_torch.weights.convert import state_dict_from_jax_tree

#: the port's conv tiers and the JAX package's names for them
JAX_TIER = {"plain": "xla", "kernel": "pallas", "fold": "fold",
            "kernel_fold": "pallas_fold"}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _params(seed, c_in, c_out):
    """JAX-layout norm and conv parameters: HWIO kernel ~ N(0, 1/(9·C))."""
    norm_p = {"scale": jnp.asarray(1.0 + 0.2 * _rand(seed, c_in)),
              "bias": jnp.asarray(0.1 * _rand(seed + 1, c_in))}
    conv_p = {"kernel": jnp.asarray(_rand(seed + 2, 3, 3, c_in, c_out) / np.sqrt(9 * c_in)),
              "bias": jnp.asarray(0.1 * _rand(seed + 3, c_out))}
    return norm_p, conv_p


def _port(module, jax_params):
    module.load_state_dict(state_dict_from_jax_tree(jax_params), strict=True)
    return module.requires_grad_(False)


def _port_params(norm_p, conv_p):
    c_in, c_out = conv_p["kernel"].shape[2:]
    return _port(norm.Norm(c_in), norm_p), _port(conv.Conv(c_in, c_out, 3), conv_p)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("shape,groups,kw", [
    ((2, 8, 8, 32), 4, {}),
    ((2, 16, 8, 32), 4, dict(block_h=4)),
    ((4, 8, 8, 32), 4, dict(batch_group=2)),
    ((1, 8, 16, 64), 8, dict(co_block=32)),
    ((2, 12, 8, 32), 4, dict(block_h=4)),
])
def test_plain_k5_matches_pallas(shape, groups, kw):
    b, h, w, c = shape
    c_out = kw.get("co_block", 0) * 2 or c
    norm_p, conv_p = _params(0, c, c_out)
    x = _rand(1, *shape)
    want = pconv.gn_silu_conv3x3(norm_p, conv_p, jnp.asarray(x), groups,
                                 interpret=True, **kw)
    before = k5.scaled_silu_conv3x3.launches
    got = k5.gn_silu_conv3x3(*_port_params(norm_p, conv_p), _t(to_nchw(x)), groups)
    assert k5.scaled_silu_conv3x3.launches == before  # CPU: the plain version
    assert got.shape == (b, c_out, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), to_nchw(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 0.05)],
                         ids=["fp32", "bf16"])
def test_plain_k5_temb_matches_pallas(dtype, tol):
    """The res block's second half: statistics over (x + t), t folded into
    the shift; the conv reads the raw x."""
    norm_p, conv_p = _params(7, 32, 32)
    x = _rand(8, 2, 8, 8, 32)
    t = _rand(9, 2, 32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = pconv.gn_silu_conv3x3(norm_p, conv_p, jnp.asarray(x).astype(jdt), 4,
                                 temb=jnp.asarray(t).astype(jdt), interpret=True)
    got = k5.gn_silu_conv3x3(*_port_params(norm_p, conv_p), _t(to_nchw(x), dtype), 4,
                             temb=_t(t, dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), to_nchw(np.asarray(want, np.float32)),
                               rtol=tol, atol=tol)


def test_plain_k5_pads_after_the_activation():
    """A border output sees zeros outside the image, not silu(shift): with a
    large shift the two differ, and the plain version matches the former."""
    x = _t(_rand(10, 1, 8, 5, 6))
    scale, shift = torch.ones(1, 8), torch.full((1, 8), 3.0)
    w, b = _t(_rand(11, 4, 8, 3, 3)) / 8, torch.zeros(4)
    a = torch.nn.functional.silu(x + 3.0)
    want = torch.nn.functional.conv2d(torch.nn.functional.pad(a, (1, 1, 1, 1)), w, b)
    got = k5.scaled_silu_conv3x3(x, scale, shift, w, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    planted = torch.nn.functional.conv2d(
        torch.nn.functional.silu(torch.nn.functional.pad(x, (1, 1, 1, 1)) + 3.0), w, b)
    assert (planted - want).abs().max() > 0.5


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's shape checks, and the kernel-side checks that run before
    any build: a contiguous (not channels_last) x and channel counts that are
    not multiples of 8 raise instead of being copied or padded."""
    x = torch.zeros(1, 8, 4, 4)
    s = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="Cout, 8, 3, 3"):
        k5.scaled_silu_conv3x3(x, s, s, torch.zeros(8, 4, 3, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="scale/shift"):
        k5.scaled_silu_conv3x3(x, s[:, :4], s, torch.zeros(8, 8, 3, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="channels_last"):
        k5._launch(x, s, s, torch.zeros(8, 8, 3, 3), torch.zeros(8))
    x12 = torch.zeros(1, 12, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="multiples of 8"):
        k5._launch(x12, s.new_zeros(1, 12), s.new_zeros(1, 12),
                   torch.zeros(8, 12, 3, 3), torch.zeros(8))


def test_skip_concat_keeps_channels_last():
    """The decoder's res blocks take torch.cat of channels_last tensors; the
    kernel needs that to stay channels_last rather than be copied."""
    a = torch.zeros(2, 16, 4, 6).contiguous(memory_format=torch.channels_last)
    b = torch.zeros(2, 8, 4, 6).contiguous(memory_format=torch.channels_last)
    assert torch.cat([a, b], dim=1).is_contiguous(memory_format=torch.channels_last)


def test_reference_takes_its_kernel_at_13_of_22_res_blocks_at_512():
    """On the TPU the JAX package's ``eligible`` sends a res block through
    the Pallas kernel only when both its convs have a 128-lane Cin and fit
    the VMEM model: at SD-1.5 512², CFG batch 2, 13 of the 22 blocks.  The
    port runs K5 at all 44 convs that chip_smoke.py's plan lists."""
    from chip_smoke import res_convs
    from pytorch_stable_diffusion_tpu_torch import sd15_config

    convs = res_convs(sd15_config(), 512, 512)
    assert len(convs) == 44 and len(set(convs)) == 14

    def on_tpu_kernel(h, w, c_in, c_out):
        return c_in % 128 == 0 and pconv.eligible((2, h, w, c_in), (3, 3, c_in, c_out))

    blocks = [convs[i:i + 2] for i in range(0, len(convs), 2)]
    taken = [b for b in blocks if all(on_tpu_kernel(*c) for c in b)]
    assert len(taken) == 13
    assert not on_tpu_kernel(64, 64, 960, 320)  # the shape chip_smoke.py times


# ----------------------------------------------------------- folded norms
@pytest.mark.parametrize("with_temb", [False, True], ids=["x", "x+t"])
def test_fold_gn_affine_matches_jax(with_temb):
    norm_p, _ = _params(12, 32, 32)
    x = _rand(13, 2, 6, 5, 32) * 2 + 0.5
    t = _rand(14, 2, 32) if with_temb else None
    want = pconv.fold_gn_affine(norm_p, jnp.asarray(x), 4,
                                temb=None if t is None else jnp.asarray(t))
    got = k5.fold_gn_affine(_port(norm.Norm(32), norm_p), _t(to_nchw(x)), 4,
                            temb=None if t is None else _t(t))
    for g, w in zip(got, want):
        assert g.shape == (2, 32) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_temb,apply_silu", [(False, True), (True, True),
                                                   (False, False)])
def test_group_norm_silu_folded_matches_jax(with_temb, apply_silu):
    norm_p, _ = _params(15, 32, 32)
    x = _rand(16, 2, 6, 5, 32) * 2 + 0.5
    t = _rand(17, 2, 32) if with_temb else None
    want = jnorm.group_norm_silu_folded(norm_p, jnp.asarray(x), 4, policy=JFP32,
                                        temb=None if t is None else jnp.asarray(t),
                                        apply_silu=apply_silu)
    got = norm.group_norm_silu_folded(_port(norm.Norm(32), norm_p), _t(to_nchw(x)), 4,
                                      temb=None if t is None else _t(t),
                                      apply_silu=apply_silu)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), rtol=1e-5, atol=1e-5)


def test_layer_norm_folded_matches_jax():
    p = {"scale": jnp.asarray(1.0 + 0.2 * _rand(18, 24)),
         "bias": jnp.asarray(0.1 * _rand(19, 24))}
    x = _rand(20, 2, 9, 24) * 3 + 1
    want = jnorm.layer_norm_folded(p, jnp.asarray(x), policy=JFP32)
    got = norm.layer_norm_folded(_port(norm.Norm(24), p), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("tier", CONV_BACKENDS)
@pytest.mark.parametrize("c_in,c_out", [(32, 32), (16, 32)], ids=["same", "shortcut"])
def test_res_block_matches_jax(tier, c_in, c_out):
    """Each tier against ``apply_res_block`` under the JAX name of the tier
    (its "pallas" tiers run the Pallas kernel in interpret mode: 8x8 is
    eligible on the CPU)."""
    import jax

    jp = junet.init_res_block(jax.random.PRNGKey(3), c_in, c_out, 64)
    jp["norm1"], jp["norm2"] = _params(21, c_in, c_in)[0], _params(23, c_out, c_out)[0]
    x = _rand(24, 2, 8, 8, c_in)
    t_emb = _rand(25, 1, 64)
    want = junet.apply_res_block(jp, jnp.asarray(x), jnp.asarray(t_emb), 4, JFP32,
                                 conv_backend=JAX_TIER[tier])
    block = _port(unet.ResBlock(c_in, c_out, 64), jp)
    with torch.inference_mode():
        got = block(_t(to_nchw(x)), _t(t_emb), 4, FP32, tier)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", CONV_BACKENDS)
def test_attn_block_matches_jax(tier):
    """The transformer block folds its norms under "fold"/"kernel_fold"."""
    import jax

    fold = tier in ("fold", "kernel_fold")
    jp = junet.init_attn_block(jax.random.PRNGKey(4), 32, 16)
    for name in ("norm", "ln1", "ln2", "ln3"):
        jp[name] = _params(26 + len(name), 32, 32)[0]
    x = _rand(30, 2, 6, 5, 32)
    ctx = _rand(31, 2, 7, 16)
    want = junet.apply_attn_block(jp, jnp.asarray(x), jnp.asarray(ctx), 4, 4, JFP32,
                                  fold_norms=fold)
    block = _port(unet.AttnBlock(32, 16), jp)
    with torch.inference_mode():
        got = block(_t(to_nchw(x)), _t(ctx), 4, 4, FP32, fold_norms=fold)
    np.testing.assert_allclose(got.numpy(), to_nchw(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["pallas", "pallas_fold", "xla", "kernel-fold"])
def test_jax_tier_names_raise_value_error(name):
    with pytest.raises(ValueError, match="conv_backend must be one of"):
        check_ported(tiny_sd_config(conv_backend=name))
