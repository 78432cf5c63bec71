"""Sequence parallelism (``parallel/sp.py``, ``generate(sequence_parallel=
True)``) on ``torch.distributed``, on the CPU.

One module-scoped ``torch.multiprocessing.spawn`` of four gloo ranks on a
loopback port (``tests/torch_sp_worker.py``, which imports neither JAX nor
this module) runs every scenario with the latent rows split four ways, or
two ways under a (2, 2) DP x SP mesh: txt2img, img2img, the "kernel"
attention backend, two heights whose deeper level the model axis does not
divide (ranks short, and one empty), two prompts over DP x SP, tiny SDXL, a
ControlNet, PAG with SAG, FreeU, seamless tiling, reference-only (attn and
AdaIN), DeepCache, a T2I-Adapter, an IP-Adapter, latent-blend and
9-channel inpainting, regional AND prompts, dpm_adaptive (whose error norm
must not count a sample once a model rank), a BREAK prompt with emphasis,
InstructPix2Pix, and the "w8" and "wide" tiers at width 160 (whose
activation scales reduce over the rows' group).  Each is held to the same
request on one process within one uint8 level (the bar of the JAX
package's tests/test_sp.py), on every rank.  Three of them (one prompt,
the level with an empty rank, DP x SP) are also held to the JAX package's
own ``generate(mesh=, sequence_parallel=True)`` on a mesh of four virtual
devices, with the same tiny models (drawn for the JAX package and
converted by ``convert.from_jax_params``) and the same injected noise,
within the same one level; the JAX requests run here while the ranks run.
The refusals are held to the JAX package's messages, which the JAX
``generate()`` raises here before it builds anything.
"""

import socket
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_families import jax_params, to_jax
from test_torch_guidance_modes import one_torch_thread  # noqa: F401

import pytorch_stable_diffusion_tpu as jsdt
from pytorch_stable_diffusion_tpu.core import mesh as jmesh
from pytorch_stable_diffusion_tpu.models import config as jconfig
from pytorch_stable_diffusion_tpu.weights.tokenizer import make_test_tokenizer as jtokenizer

WORLD = 4
SCENARIOS = ("sp", "sp img2img", "sp kernel", "sp uneven", "sp uneven empty", "dp x sp",
             "sp controlnet", "sp pag sag", "sp freeu", "sp tiling", "sp reference",
             "sp deepcache", "sp t2i adapter", "sp ip adapter", "sp inpaint blend",
             "sp and regions", "sp dpm_adaptive", "sp long prompt", "sp ip2p",
             "sp inpaint unet9", "sp sdxl", "sp w8 160", "sp wide 160")
#: the latent rows each rank's UNet evaluations take: ceil-sized blocks of
#: the latent height (16 rows at 32 px, 20 at 40 px, 12 at 24 px: the tiny
#: VAE's factor is 2) over the model axis
ROWS = {"sp uneven": [5, 5, 5, 5], "sp uneven empty": [3, 3, 3, 3], "dp x sp": [8, 8, 8, 8]}
REFUSALS = ("model axis 1", "height", "tome", "hypertile", "n_frames", "panorama")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_sp(jp, name):
    """The JAX package's images of ``torch_sp_worker.JAX_CASES[name]``
    under its own sequence parallelism, with the models ``jp``."""
    import torch_sp_worker as w
    from torch_dist_worker import WORDS

    prompts, (data, model), h, wd = w.JAX_CASES[name]
    cfg = jconfig.tiny_sd_config()
    mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    return jsdt.generate_images(
        prompts, models=jp, config=cfg, mesh=mesh, sequence_parallel=True, height=h, width=wd,
        seed=3, n_inference_steps=w.JAX_STEPS, sampler_name="ddim",
        fixed_noise=w.jax_case_noise(name),
        tokenizer=jtokenizer(WORDS, max_len=cfg.clip.max_len))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (a dict a rank), and under "jax reference" the
    JAX package's images of the worker's ``JAX_CASES``."""
    import torch.multiprocessing as mp

    import torch_sp_worker
    from pytorch_stable_diffusion_tpu_torch.models import config
    from pytorch_stable_diffusion_tpu_torch.weights import convert

    out = tmp_path_factory.mktemp("sp_ranks")
    cfg = config.tiny_sd_config()
    jp = jax_params(to_jax(cfg), seed=60)
    torch.save(convert.from_jax_params(jp, cfg), out / "jax_weights.pt")
    procs = mp.spawn(torch_sp_worker.run, args=(WORLD, _free_port(), str(out)), nprocs=WORLD,
                     join=False)
    want = {name: _jax_sp(jp, name) for name in torch_sp_worker.JAX_CASES}
    while not procs.join():
        pass
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r in res:
        r["jax reference"] = want
    return res


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sequence_parallel_equals_one_process(ranks, scenario):
    """Every rank returns the whole batch, within one uint8 level of the
    request on one process; each rank's UNet took its rows of the latents."""
    want = ranks[0][scenario][1]
    for r, res in enumerate(ranks):
        got = res[scenario][0]
        assert got.shape == want.shape and got.shape[0] == (2 if scenario == "dp x sp" else 1)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, (r, int(diff.max()))
        rows = set(res["rows"][scenario]["unet"])
        assert rows == {ROWS.get(scenario, [4] * WORLD)[r]}, (r, rows)
    if scenario == "sp controlnet":
        assert all(set(res["rows"][scenario]["controlnet"]) == {4} for res in ranks)


@pytest.mark.parametrize("scenario", ["sp", "sp uneven empty", "dp x sp"])
def test_sequence_parallel_matches_jax(ranks, scenario):
    """The port's sequence parallelism against the JAX package's on the
    same models, prompts and injected noise: every rank's whole batch
    within one uint8 level of the JAX image."""
    want = ranks[0]["jax reference"][scenario]
    for r, res in enumerate(ranks):
        got = res["jax"][scenario]
        assert got.shape == want.shape
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        print(f"{scenario}: rank {r} max {diff.max()} levels, mean {diff.mean():.4f}")
        assert diff.max() <= 1, (r, int(diff.max()))


def test_sp_under_the_conv_tier(ranks):
    """SP under "conv" at width 160, held as TP under "conv" is
    (test_torch_parallel.py::test_tp_under_the_conv_tier): the tier's
    per-tensor quantization at every 3x3 conv turns float rounding
    differences (the GroupNorm moments summed in another order, the
    attention over gathered K/V) into quantization steps, so the request is
    held to at most 4 levels mean and 30 dB, where "w8" and "wide" are
    within one level (SCENARIOS)."""
    from pytorch_stable_diffusion_tpu_torch.utils import metrics

    want = ranks[0]["sp conv 160"][1]
    for res in ranks:
        got = res["sp conv 160"][0]
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        print(f"sp conv 160: mean {diff.mean():.3f} levels, max {diff.max()}, "
              f"{metrics.image_psnr(got, want):.2f} dB")
        assert diff.mean() <= 4.0 and metrics.image_psnr(got, want) > 30.0
        assert set(res["rows"]["sp conv 160"]["unet"]) == {4}


def test_sp_in_bf16(ranks):
    """BF16 activations cross gloo as bytes (gloo takes no bf16): the
    request is whole on every rank and within 35 dB of one process, the
    bar the card holds BF16 SP to (chip_smoke.py H3a), since bf16 rounds
    the GroupNorm moments' and the attention's other summation orders
    visibly; every rank's image is the same."""
    from pytorch_stable_diffusion_tpu_torch.utils import metrics

    want = ranks[0]["sp bf16"][1]
    for res in ranks:
        got = res["sp bf16"][0]
        assert got.shape == want.shape and metrics.image_psnr(got, want) > 35.0
        np.testing.assert_array_equal(got, ranks[0]["sp bf16"][0])
        assert set(res["rows"]["sp bf16"]["unet"]) == {4}


def test_kernel_backend_attends_the_local_rows_over_the_whole_kv(ranks):
    """On the "kernel" backend the self-attentions of 256 tokens (16x16 at
    level 0) run the one-pass kernel's plain version (K2's) on each rank's
    64 q rows over the gathered 256 K/V tokens; K1's (which assumes Sq =
    Sk) never runs.  The 64-token level 1 and the 16-token contexts run
    materialized on the local rows, and the VAE's mid block (256 tokens on
    the plain VAE backend) on the whole latents, as every rank decodes
    them whole."""
    for res in ranks:
        calls = res["spy"]["sp kernel"]
        assert not [c for c in calls if c[0] == "flash_attention_bsc"]
        onepass = {c[1:] for c in calls if c[0] == "flash_attention_onepass"}
        assert onepass == {(64, 256)}
        plain = {c[1:] for c in calls if c[0] == "materialized_attention"}
        assert plain == {(16, 64), (64, 16), (16, 16), (256, 256)}


def _jax_refusal(name):
    """The JAX package's ValueError for the same request (it raises before
    it builds anything)."""
    cfg = jconfig.tiny_sd_config()
    m4 = jmesh.make_mesh(data=1, model=4, devices=jax.devices()[:4])
    m1 = jmesh.make_mesh(data=4, model=1, devices=jax.devices()[:4])
    extra = {"model axis 1": dict(mesh=m1), "height": dict(mesh=m4, height=20),
             "tome": dict(mesh=m4, tome_ratio=0.5),
             "hypertile": dict(mesh=m4, config=jconfig.with_hypertile(cfg, 8)),
             "n_frames": dict(mesh=m4, n_frames=4),
             "panorama": dict(mesh=m4, panorama=True, width=64)}[name]
    kw = dict(models={"motion": None}, config=cfg, height=32, width=32, n_inference_steps=3,
              tokenizer=jtokenizer(["a", "cat"], max_len=cfg.clip.max_len),
              sequence_parallel=True)
    with pytest.raises(ValueError) as err:
        jsdt.generate("a cat", **dict(kw, **extra))
    return str(err.value)


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_jax(ranks, name):
    want = _jax_refusal(name)
    assert [res["refusals"][name] for res in ranks] == [want] * WORLD


def test_refuses_a_unet_split_by_tensor_parallelism(ranks):
    """The port's own refusal: ``parallel/tp.shard_models``'s UNet holds a
    rank's heads, which gathered K/V of other ranks' rows would mix."""
    for res in ranks:
        assert "split by tensor parallelism" in res["refusals"]["tp models"]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
