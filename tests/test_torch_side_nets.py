"""Slice E's modules against the JAX package: the ControlNet (hint plan,
hint encoder, forward), the T2I-Adapter (``pixel_unshuffle``, both
layouts), the CLIP vision tower and the IP-Adapter's image side, the
UNet's side inputs (``control``, ``adapter``, ``ip``, reference attention
and AdaIN, capture and read), and the weight converters (ControlNet in the
CompVis and diffusers schemas, T2I-Adapter in diffusers', IP-Adapter flat
and nested, CLIP vision).

Tiny SD-1.5 and SDXL topologies; the JAX parameters are drawn with numpy
into the JAX initializers' shapes (``test_torch_families.draw_tree``: the
zero convs drawn like any conv, so a residual is not zero) and carried
into the port by ``convert.from_jax_params``.  Plans and ``pixel_unshuffle``
are exact; forwards are held to the UNet bound of test_torch_models.py
(1e-4 abs/rel, fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import to_nchw
from test_torch_families import draw_tree, jax_params, to_jax

from pytorch_stable_diffusion_tpu.models import clip_vision as jcv
from pytorch_stable_diffusion_tpu.models import controlnet as jcontrolnet
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.models import t2i_adapter as jt2i
from pytorch_stable_diffusion_tpu.models import unet as junet
from pytorch_stable_diffusion_tpu.models import vae as jvae
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu.weights import convert as jconvert
from pytorch_stable_diffusion_tpu.weights import diffusers as jdiffusers
from pytorch_stable_diffusion_tpu.weights import ip_adapter as jip
from pytorch_stable_diffusion_tpu_torch.models import build_models, config
from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv
from pytorch_stable_diffusion_tpu_torch.models import controlnet, t2i_adapter
from pytorch_stable_diffusion_tpu_torch.models import unet as punet
from pytorch_stable_diffusion_tpu_torch.sampling import ddpm
from pytorch_stable_diffusion_tpu_torch.weights import convert, diffusers, ip_adapter

TOL = dict(rtol=1e-4, atol=1e-4)
HW = 32  # pixels; the tiny VAEs downsample 2x


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny tensors (parallel test workers
    oversubscribe the cores with torch's default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plus_state(ucfg, vis_cfg, n_queries=16, dim=64, depth=2, seed=0):
    """A published-layout IP-Adapter-plus state dict (the perceiver
    Resampler as image_proj, 2 heads of 64) with seeded weights, norms
    near 1."""
    r = np.random.RandomState(seed)

    def lin(o, i):
        return (r.randn(o, i) / np.sqrt(i)).astype(np.float32)

    def ln(n, prefix):
        return {f"{prefix}.weight": (1 + 0.1 * r.randn(n)).astype(np.float32),
                f"{prefix}.bias": (0.1 * r.randn(n)).astype(np.float32)}

    inner, d_ctx = 128, ucfg.d_context
    proj = {"latents": r.randn(1, n_queries, dim).astype(np.float32),
            "proj_in.weight": lin(dim, vis_cfg.width),
            "proj_in.bias": (0.1 * r.randn(dim)).astype(np.float32),
            "proj_out.weight": lin(d_ctx, dim),
            "proj_out.bias": (0.1 * r.randn(d_ctx)).astype(np.float32),
            **ln(d_ctx, "norm_out")}
    for i in range(depth):
        proj.update({**ln(dim, f"layers.{i}.0.norm1"), **ln(dim, f"layers.{i}.0.norm2"),
                     f"layers.{i}.0.to_q.weight": lin(inner, dim),
                     f"layers.{i}.0.to_kv.weight": lin(2 * inner, dim),
                     f"layers.{i}.0.to_out.weight": lin(dim, inner),
                     **ln(dim, f"layers.{i}.1.0"),
                     f"layers.{i}.1.1.weight": lin(4 * dim, dim),
                     f"layers.{i}.1.3.weight": lin(dim, 4 * dim)})
    state = ip_adapter.synthetic_ip_state(ucfg, seed=seed + 1)
    state["image_proj"] = proj
    return state


def scaled_ip_state(ucfg, vis_cfg, seed=0):
    """``synthetic_ip_state`` with its unit-normal weights scaled to a
    layer's usual magnitude (1/sqrt(fan in))."""
    st = ip_adapter.synthetic_ip_state(ucfg, embed_dim=vis_cfg.proj_dim, seed=seed)
    for group in st.values():
        for k, v in group.items():
            if k.endswith("weight") and v.ndim == 2:
                group[k] = v / np.sqrt(v.shape[1])
    return st


def side_jax_params(cfg, jcfg, seed, *, vis_cfg=None, n_nets=1):
    """JAX trees of every model of ``jcfg`` and its side nets: ``n_nets``
    ControlNets, a T2I-Adapter, and with ``vis_cfg`` a CLIP vision tower
    and a standard IP-Adapter."""
    jp = jax_params(jcfg, seed)
    r = np.random.RandomState(seed + 100)
    factor = jcfg.vae.downsample_factor
    nets = [draw_tree(lambda k: jcontrolnet.init(k, jcfg.unet, factor), r)
            for _ in range(n_nets)]
    jp["controlnet"] = nets[0] if n_nets == 1 else nets
    jp["t2i_adapter"] = draw_tree(lambda k: jt2i.init(k, jcfg.unet, factor), r)
    if vis_cfg is not None:
        jp["clip_vision"] = draw_tree(lambda k: jcv.init(k, vis_cfg), r)
        jp["ip_adapter"] = jip.convert_ip_adapter(scaled_ip_state(jcfg.unet, vis_cfg, seed),
                                                  jcfg.unet)
    return jp


def port_models(cfg, jp, vis_cfg=None):
    return build_models(cfg, device="cpu", state_dicts=convert.from_jax_params(jp, cfg),
                        vision_config=vis_cfg)


@pytest.fixture(scope="module")
def sd():
    """(port cfg, JAX cfg, JAX params, port models) of tiny SD-1.5 with a
    ControlNet, a T2I-Adapter, a tiny vision tower and an IP-Adapter."""
    cfg = config.tiny_sd_config()
    jcfg = to_jax(cfg)
    vis = cv.tiny_vision_config()
    jp = side_jax_params(cfg, jcfg, 60, vis_cfg=jcv.tiny_vision_config())
    return cfg, jcfg, jp, port_models(cfg, jp, vis)


@pytest.fixture(scope="module")
def xl():
    cfg = config.tiny_sdxl_config()
    jcfg = to_jax(cfg)
    jp = side_jax_params(cfg, jcfg, 61, vis_cfg=jcv.tiny_vision_config())
    return cfg, jcfg, jp, port_models(cfg, jp, cv.tiny_vision_config())


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ plans
CONFIGS = ["tiny_sd_config", "tiny_sdxl_config", "sd15_config", "sdxl_config",
           "sd21_config", "sdxl_refiner_config"]


@pytest.mark.parametrize("name", CONFIGS)
def test_plans_equal_the_jax_plans(name):
    """adapter_sites (n_levels and n_levels + 1 features), hint_plan at
    every VAE factor, ip_layer_plan and the synthetic IP state: exact."""
    u, ju = getattr(config, name)().unet, getattr(jconfig, name)().unet
    n = len(u.ch_mults)
    for n_feats in (n, n + 1):
        assert punet.adapter_sites(u, n_feats) == junet.adapter_sites(ju, n_feats)
    with pytest.raises(ValueError, match="adapter features"):
        punet.adapter_sites(u, n + 2)
    for factor in (2, 4, 8):
        assert controlnet.hint_plan(u, factor) == jcontrolnet.hint_plan(ju, factor)
    assert ip_adapter.ip_layer_plan(u) == jip.ip_layer_plan(ju)
    for flat in (False, True) if name.startswith("tiny") else ():  # the full ones: 10^8 draws
        ours = ip_adapter.synthetic_ip_state(u, seed=3, flat=flat)
        ref = jip.synthetic_ip_state(ju, seed=3, flat=flat)
        flat_ours = ours if flat else {f"{g}.{k}": v for g, d in ours.items() for k, v in d.items()}
        flat_ref = ref if flat else {f"{g}.{k}": v for g, d in ref.items() for k, v in d.items()}
        assert flat_ours.keys() == flat_ref.keys()
        for k in flat_ours:
            np.testing.assert_array_equal(flat_ours[k], flat_ref[k])
    for xl_layout in (False, True):
        assert t2i_adapter.adapter_layout(u, 8, xl_layout) == \
            jt2i.adapter_layout(ju, 8, xl_layout)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_pixel_unshuffle_matches_jax(factor):
    """F.pixel_unshuffle in NCHW gives the JAX NHWC order c·f² + i·f + j."""
    x = _rand(1, 2, 16, 24, 3)
    ref = jt2i.pixel_unshuffle(jnp.asarray(x), factor)
    got = t2i_adapter.pixel_unshuffle(_t(to_nchw(x)), factor)
    np.testing.assert_array_equal(got.numpy(), to_nchw(ref))
    with pytest.raises(ValueError, match="not divisible"):
        t2i_adapter.pixel_unshuffle(torch.zeros(1, 3, 8, 12), 8)


PIXELS = {"uint8 (S, S, 3)": lambda r: r.randint(0, 256, (16, 16, 3)).astype(np.uint8),
          "unit float": lambda r: r.rand(16, 16, 3).astype(np.float32),
          "batch of 2, RGBA": lambda r: r.randint(0, 256, (2, 16, 16, 4)).astype(np.uint8)}


@pytest.mark.parametrize("kind", list(PIXELS))
def test_preprocess_matches_jax(kind):
    x = PIXELS[kind](np.random.RandomState(4))
    got = cv.preprocess(x, cv.tiny_vision_config())
    np.testing.assert_array_equal(got, jcv.preprocess(x, jcv.tiny_vision_config()))
    with pytest.raises(ValueError, match="must be 16x16"):
        cv.preprocess(np.zeros((8, 16, 3)), cv.tiny_vision_config())


def test_vision_presets_equal_the_jax_presets():
    for name in ("vit_h14", "vit_bigg14", "vit_l14", "tiny_vision_config"):
        assert dataclasses.asdict(getattr(cv, name)()) == \
            dataclasses.asdict(getattr(jcv, name)())


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("family", ["sd", "xl"])
def test_controlnet_matches_jax(family, request):
    """encode_hint, then the forward (SD: no added conditioning; SDXL:
    stacked depth, add_cond), at a conditioning scale of 0.7."""
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    net, jnet = models["controlnet"], jp["controlnet"]
    r = np.random.RandomState(5)
    hint = r.rand(2, HW, HW, 3).astype(np.float32)
    lat = _rand(6, 2, HW // 2, HW // 2, 4)
    ctx = _rand(7, 2, 16, cfg.unet.d_context)
    add = None if cfg.unet.add_embed_dim is None else _rand(8, 2, cfg.unet.add_embed_dim)
    factor = jcfg.vae.downsample_factor
    jh, ref = jax.jit(lambda p, h, x, c, a: (
        jcontrolnet.encode_hint(p, h, jcfg.unet, factor),
        jcontrolnet.apply(p, x, c, 500, jcontrolnet.encode_hint(p, h, jcfg.unet, factor),
                          jcfg.unet, conditioning_scale=0.7, add_cond=a)))(
        jnet, jnp.asarray(hint), jnp.asarray(lat), jnp.asarray(ctx),
        None if add is None else jnp.asarray(add))
    with torch.inference_mode():
        h = net.encode_hint(_t(to_nchw(hint)))
        got = net(_t(to_nchw(lat)), _t(ctx), 500, h, conditioning_scale=torch.tensor(0.7),
                  add_cond=None if add is None else _t(add))
    np.testing.assert_allclose(h.numpy(), to_nchw(jh), **TOL)
    assert len(got["down"]) == len(ref["down"]) == len(controlnet.skip_channels(cfg.unet))
    for g, w in zip(got["down"] + [got["mid"]], ref["down"] + [ref["mid"]]):
        assert np.abs(np.asarray(w)).max() > 1e-3  # the drawn zero convs are not zeros
        np.testing.assert_allclose(g.numpy(), to_nchw(w), **TOL)


def test_fresh_controlnet_is_a_no_op():
    cfg = config.tiny_sd_config()
    net = controlnet.build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    net.zero_init_()
    with torch.inference_mode():
        out = net(torch.randn(1, 4, 16, 16), torch.randn(1, 16, 32), 10,
                  net.encode_hint(torch.rand(1, 3, 32, 32)), conditioning_scale=torch.tensor(1.0))
    assert all(float(d.abs().max()) == 0.0 for d in out["down"] + [out["mid"]])


@pytest.mark.parametrize("family", ["sd", "xl"])
def test_t2i_adapter_matches_jax(family, request):
    """full_adapter (SD: 2 features) and full_adapter_xl (SDXL: 3, the
    unshuffle doubled)."""
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    hint = np.random.RandomState(9).rand(2, HW, HW, 3).astype(np.float32)
    ref = jt2i.apply(jp["t2i_adapter"], jnp.asarray(hint), jcfg.unet,
                     jcfg.vae.downsample_factor)
    with torch.inference_mode():
        got = models["t2i_adapter"](_t(to_nchw(hint)))
    assert len(got) == len(ref) == len(cfg.unet.ch_mults) + (family == "xl")
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), to_nchw(w), **TOL)


def test_clip_vision_matches_jax(sd):
    """apply, stop_at_layer, apply_projected, project_image_tokens and the
    Resampler (IP-Adapter plus, 16 queries of 2 heads)."""
    cfg, jcfg, jp, models = sd
    vis, jvis = cv.tiny_vision_config(), jcv.tiny_vision_config()
    px = jcv.preprocess(np.random.RandomState(10).randint(0, 256, (2, 16, 16, 3))
                        .astype(np.uint8), jvis)
    tower = models["clip_vision"]
    jt = jp["clip_vision"]
    pxt = _t(to_nchw(px))
    full, penult, proj = jax.jit(lambda p, x: (
        jcv.apply(p, x, jvis), jcv.apply(p, x, jvis, stop_at_layer=1),
        jcv.apply_projected(p, x, jvis)))(jt, jnp.asarray(px))
    with torch.inference_mode():
        np.testing.assert_allclose(tower(pxt).numpy(), np.asarray(full), **TOL)
        np.testing.assert_allclose(tower(pxt, stop_at_layer=1).numpy(), np.asarray(penult),
                                   **TOL)
        emb = tower.project(pxt)
        np.testing.assert_allclose(emb.numpy(), np.asarray(proj), **TOL)
        ipa = models["ip_adapter"]
        np.testing.assert_allclose(
            ipa.image_proj(emb).numpy(),
            np.asarray(jcv.project_image_tokens(jp["ip_adapter"]["image_proj"],
                                                jnp.asarray(emb.numpy()), cfg.unet.d_context)),
            **TOL)
        state = plus_state(cfg.unet, vis)
        plus = cv.build_ip_adapter(ip_adapter.convert_ip_adapter(state, cfg.unet),
                                   device="cpu")
        jplus = jip.convert_ip_adapter(state, jcfg.unet)
        h = _rand(11, 2, vis.n_positions, vis.width)
        np.testing.assert_allclose(plus.image_proj(_t(h)).numpy(),
                                   np.asarray(jcv.apply_resampler(jplus["image_proj"],
                                                                  jnp.asarray(h))), **TOL)
    assert ip_adapter.num_image_tokens(plus) == jip.num_image_tokens(jplus, jcfg.unet) == 16
    assert ip_adapter.num_image_tokens(ipa) == jip.num_image_tokens(jp["ip_adapter"],
                                                                   jcfg.unet) == 4


# ------------------------------------------------------ the UNet's side inputs
def _unet_inputs(cfg, seed, batch=2):
    lat = _rand(seed, batch, HW // 2, HW // 2, 4)
    ctx = _rand(seed + 1, batch, 16, cfg.unet.d_context)
    add = None if cfg.unet.add_embed_dim is None else _rand(seed + 2, batch,
                                                            cfg.unet.add_embed_dim)
    return lat, ctx, add


def _run_both(cfg, jcfg, jp, models, seed, jax_kw, port_kw):
    lat, ctx, add = _unet_inputs(cfg, seed)
    ref = junet.apply(jp["diffusion"], jnp.asarray(lat), jnp.asarray(ctx), 700, jcfg.unet,
                      add_cond=None if add is None else jnp.asarray(add), **jax_kw)
    with torch.inference_mode():
        got = models["diffusion"](_t(to_nchw(lat)), _t(ctx), 700,
                                  add_cond=None if add is None else _t(add), **port_kw)
    return got, ref


def _control(seed, cfg):
    """Residuals of the UNet's skip channels, drawn with numpy: NHWC for
    JAX, NCHW for the port."""
    r = np.random.RandomState(seed)
    plan = punet.encoder_plan(cfg.unet)
    h = HW // 2
    down, level = [], 0
    for c, st in zip(controlnet.skip_channels(cfg.unet), plan):
        level += st["kind"] == "down"
        down.append(0.3 * r.randn(2, h >> level, h >> level, c).astype(np.float32))
    mid = 0.3 * r.randn(2, h >> level, h >> level, cfg.unet.level_channels[-1]) \
        .astype(np.float32)
    return ({"down": [jnp.asarray(d) for d in down], "mid": jnp.asarray(mid)},
            {"down": [_t(to_nchw(d)) for d in down], "mid": _t(to_nchw(mid))})


SIDE = ["control", "adapter", "ip"]


@pytest.mark.parametrize("family", ["sd", "xl"])
@pytest.mark.parametrize("side", SIDE)
def test_unet_side_inputs_match_jax(family, side, request):
    """control: residuals on every skip and the bottleneck; adapter: the
    adapter's own features (SD: a pre site at the attention level and a
    post site at the other; SDXL: n_levels + 1, the last after the
    bottleneck); ip: a standard IP-Adapter's tokens at scale 0.6 through
    every cross-attention layer (SDXL: a k/v pair for each stacked
    layer)."""
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    if side == "control":
        jc, pc = _control(12, cfg)
        jax_kw, port_kw = dict(control=jc), dict(control=pc)
    elif side == "adapter":
        hint = np.random.RandomState(13).rand(2, HW, HW, 3).astype(np.float32)
        feats = jt2i.apply(jp["t2i_adapter"], jnp.asarray(hint), jcfg.unet,
                           jcfg.vae.downsample_factor)
        jax_kw = dict(adapter=feats)
        port_kw = dict(adapter=[_t(to_nchw(f)) for f in feats])
    else:
        tokens = _rand(14, 2, 4, cfg.unet.d_context)
        jax_kw = dict(ip=(jp["ip_adapter"]["layers"], jnp.asarray(tokens), jnp.float32(0.6)))
        port_kw = dict(ip=(models["ip_adapter"].layers, _t(tokens), torch.tensor(0.6)))
    got, ref = _run_both(cfg, jcfg, jp, models, 15, jax_kw, port_kw)
    plain, _ = _run_both(cfg, jcfg, jp, models, 15, {}, {})
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the input moved the output
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


def test_adain_transform_matches_jax():
    r = np.random.RandomState(16)
    x = r.randn(4, 8, 6, 6).astype(np.float32)
    m, v = x.mean(axis=(2, 3), keepdims=True), x.var(axis=(2, 3), keepdims=True)
    m_ref, v_ref = r.randn(4, 8, 1, 1).astype(np.float32), r.rand(4, 8, 1, 1).astype(np.float32)
    mask = np.asarray([0, 0, 1, 1], np.float32)
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1))  # noqa: E731
    for pm in (mask, None):
        ref = junet.adain_transform(*(jnp.asarray(nhwc(a)) for a in (x, m, v, m_ref, v_ref)),
                                    jnp.float32(0.3), None if pm is None else jnp.asarray(pm))
        got = punet.adain_transform(*(_t(a) for a in (x, m, v, m_ref, v_ref)),
                                    torch.tensor(0.3), None if pm is None else _t(pm))
        np.testing.assert_allclose(got.numpy(), to_nchw(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["attn", "adain", "adain+attn"])
@pytest.mark.parametrize("family", ["sd", "xl"])
def test_reference_passes_match_jax(family, mode, request):
    """One reference evaluation, as the pipeline composes it: the reference
    latents re-noised to t by ddpm.add_noise, a 2-lane capture pass (its
    banks compared too), then the read with plain_mask [0, 1] at fidelity
    0.4."""
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    ref_lat0, noise = _rand(17, 1, 4, HW // 2, HW // 2), _rand(18, 1, 4, HW // 2, HW // 2)
    rn_j = jddpm.add_noise(jddpm.make_schedule(), jnp.asarray(np.transpose(ref_lat0, (0, 2, 3, 1))),
                           700, jnp.asarray(np.transpose(noise, (0, 2, 3, 1))))
    rn_p = ddpm.add_noise(ddpm.make_schedule(), _t(ref_lat0), 700, _t(noise))
    np.testing.assert_allclose(rn_p.numpy(), to_nchw(rn_j), rtol=1e-6, atol=1e-6)
    attn, adain = "attn" in mode, "adain" in mode
    jbank, jabank, pbank, pabank = {}, {}, {}, {}
    _, ctx, add = _unet_inputs(cfg, 19)
    jadd = None if add is None else jnp.asarray(add)
    padd = None if add is None else _t(add)
    junet.apply(jp["diffusion"], jnp.concatenate([rn_j, rn_j]), jnp.asarray(ctx), 700, jcfg.unet,
                add_cond=jadd, ref=("capture", jbank) if attn else None,
                ref_adain=("capture", jabank) if adain else None)
    with torch.inference_mode():
        assert models["diffusion"](torch.cat([rn_p, rn_p]), _t(ctx), 700, add_cond=padd,
                                   ref=("capture", pbank) if attn else None,
                                   ref_adain=("capture", pabank) if adain else None,
                                   head=False) is None
    assert pbank.keys() == jbank.keys() and pabank.keys() == jabank.keys()
    for k in pbank:
        np.testing.assert_allclose(pbank[k].numpy(), np.asarray(jbank[k]), **TOL)
    for k in pabank:
        for g, w in zip(pabank[k], jabank[k]):
            np.testing.assert_allclose(g.numpy(), to_nchw(w), **TOL)
    fid, mask = 0.4, np.asarray([0.0, 1.0], np.float32)
    jread = ("read", None, jnp.float32(fid), jnp.asarray(mask))
    pread = ("read", None, torch.tensor(fid), _t(mask))
    jax_kw = dict(ref=(jread[0], jbank, *jread[2:]) if attn else None,
                  ref_adain=(jread[0], jabank, *jread[2:]) if adain else None)
    port_kw = dict(ref=(pread[0], pbank, *pread[2:]) if attn else None,
                   ref_adain=(pread[0], pabank, *pread[2:]) if adain else None)
    got, ref = _run_both(cfg, jcfg, jp, models, 19, jax_kw, port_kw)
    plain, _ = _run_both(cfg, jcfg, jp, models, 19, {}, {})
    assert np.abs(got.numpy()[0] - plain.numpy()[0]).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("schema", ["compvis", "diffusers"])
@pytest.mark.parametrize("family", ["sd", "xl"])
def test_controlnet_round_trips_match_jax(family, schema, request):
    """CompVis ``control_model.*`` (in a merged file: the base model's keys
    are left alone) and diffusers ControlNetModel: the JAX deconverter's
    file converts in the port to the port's net exactly, the port's
    deconverter writes that file back, and a key of the file's own
    namespace that no rule reads raises."""
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    if schema == "compvis":
        conv, jdeconv, deconv = (convert.convert_controlnet, jconvert.deconvert_controlnet,
                                 convert.deconvert_controlnet)
        extra = "control_model.input_hint_block.99.weight"
    else:
        conv, jdeconv, deconv = (diffusers.convert_controlnet_diffusers,
                                 jdiffusers.deconvert_controlnet_diffusers,
                                 diffusers.deconvert_controlnet_diffusers)
        extra = "controlnet_cond_embedding.blocks.99.weight"
    file_sd = {k: torch.from_numpy(np.array(v)) for k, v in jdeconv(jp["controlnet"], jcfg).items()}
    merged = dict(file_sd)
    if schema == "compvis":
        merged["model.diffusion_model.conv_in.weight"] = torch.zeros(1)
    got = conv(merged, cfg)
    want = models["controlnet"].state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    back = deconv(models["controlnet"], cfg)
    assert back.keys() == file_sd.keys()
    for k in back:  # SDXL's proj_in/proj_out written as the (C, C) linears of its files
        torch.testing.assert_close(back[k], file_sd[k].reshape(back[k].shape), rtol=0, atol=0,
                                   msg=k)
    with pytest.raises(KeyError, match="unconsumed"):
        conv({**file_sd, extra: torch.zeros(1)}, cfg)


@pytest.mark.parametrize("family", ["sd", "xl"])
def test_t2i_adapter_round_trip_matches_jax(family, request):
    cfg, jcfg, jp, models = request.getfixturevalue(family)
    file_sd = {k: torch.from_numpy(np.array(v)) for k, v in
               jdiffusers.deconvert_t2i_adapter_diffusers(jp["t2i_adapter"], jcfg).items()}
    got = diffusers.convert_t2i_adapter_diffusers(file_sd, cfg)
    want = models["t2i_adapter"].state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    back = diffusers.deconvert_t2i_adapter_diffusers(models["t2i_adapter"], cfg)
    assert back.keys() == file_sd.keys()
    bare = diffusers.convert_t2i_adapter_diffusers(
        {k[len("adapter."):]: v for k, v in back.items()}, cfg)
    assert bare.keys() == want.keys()
    rebuilt = t2i_adapter.build(cfg, device="cpu", state_dict=got)
    assert len(rebuilt.body) == len(models["t2i_adapter"].body)


@pytest.mark.parametrize("layout", ["nested", "flat", "plus"])
def test_convert_ip_adapter_matches_jax(sd, layout):
    cfg, jcfg, _, _ = sd
    if layout == "plus":
        state = plus_state(cfg.unet, cv.tiny_vision_config(), seed=4)
    else:
        state = ip_adapter.synthetic_ip_state(cfg.unet, seed=4, flat=layout == "flat")
    got = ip_adapter.convert_ip_adapter(state, cfg.unet)
    want = convert.state_dict_from_jax_tree(jip.convert_ip_adapter(state, jcfg.unet))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert ip_adapter.num_image_tokens(got) == (16 if layout == "plus" else 4)
    bad = ip_adapter.synthetic_ip_state(cfg.unet, seed=4)
    bad["ip_adapter"]["999.to_k_ip.weight"] = bad["ip_adapter"]["1.to_k_ip.weight"]
    for fn, c in ((ip_adapter.convert_ip_adapter, cfg.unet),
                  (jip.convert_ip_adapter, jcfg.unet)):
        with pytest.raises(ValueError, match="unconsumed ip_adapter keys"):
            fn(bad, c)


def test_convert_clip_vision_matches_jax(sd):
    """An HF CLIPVisionModelWithProjection state dict, made from the JAX
    tree, converts to the port's tower exactly; a wrong config raises the
    JAX package's ValueError."""
    cfg, jcfg, jp, models = sd
    jt = jp["clip_vision"]
    v = "vision_model."
    hf = {v + "embeddings.class_embedding": jt["class_embedding"],
          v + "embeddings.patch_embedding.weight":
              np.transpose(jt["patch_embedding"]["kernel"], (3, 2, 0, 1)),
          v + "embeddings.position_embedding.weight": jt["position_embedding"],
          v + "embeddings.position_ids": np.arange(5)[None],
          "visual_projection.weight": np.asarray(jt["projection"]).T}
    for ours, p in (("pre_layrnorm", jt["pre_ln"]), ("post_layernorm", jt["post_ln"])):
        hf[f"{v}{ours}.weight"], hf[f"{v}{ours}.bias"] = p["scale"], p["bias"]
    for i, lp in enumerate(jt["layers"]):
        pre = f"{v}encoder.layers.{i}."
        for theirs, p in (("layer_norm1", lp["ln1"]), ("layer_norm2", lp["ln2"])):
            hf[pre + theirs + ".weight"], hf[pre + theirs + ".bias"] = p["scale"], p["bias"]
        for theirs, p in (("self_attn.q_proj", lp["attn"]["q"]), ("self_attn.k_proj",
                                                                  lp["attn"]["k"]),
                          ("self_attn.v_proj", lp["attn"]["v"]),
                          ("self_attn.out_proj", lp["attn"]["out"]),
                          ("mlp.fc1", lp["fc1"]), ("mlp.fc2", lp["fc2"])):
            hf[pre + theirs + ".weight"] = np.asarray(p["kernel"]).T
            hf[pre + theirs + ".bias"] = p["bias"]
    hf = {k: np.asarray(x, np.float32) for k, x in hf.items()}
    got = ip_adapter.convert_clip_vision(hf, cv.tiny_vision_config())
    want = models["clip_vision"].state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    wrong = dataclasses.replace(cv.tiny_vision_config(), image_size=24)
    for fn, c in ((ip_adapter.convert_clip_vision, wrong),
                  (jip.convert_clip_vision, jcv.CLIPVisionConfig(**dataclasses.asdict(wrong)))):
        with pytest.raises(ValueError, match="position embedding rows"):
            fn(dict(hf), c)


def test_vae_reference_encode_is_the_jax_encode(sd):
    """The reference image's one VAE encode (a 'ref_encoder' draw) is the
    JAX encoder's on the same noise."""
    cfg, jcfg, jp, models = sd
    px = np.random.RandomState(20).rand(1, HW, HW, 3).astype(np.float32) * 2 - 1
    noise = _rand(21, 1, HW // 2, HW // 2, 4)
    ref = jax.jit(lambda p, x, n: jvae.apply_encoder(p, x, n, jcfg.vae))(
        jp["encoder"], jnp.asarray(px), jnp.asarray(noise))
    with torch.inference_mode():
        got = models["encoder"](_t(to_nchw(px)), _t(to_nchw(noise)))
    np.testing.assert_allclose(got.numpy(), to_nchw(ref), **TOL)
