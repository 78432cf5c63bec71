"""The port's samplers and timestep grids (slice B) against the JAX
package's modules, with no model: every ``timestep_spacing`` grid and the
zero-terminal-SNR schedule as equal arrays; the host tables (LMS
coefficients, DPM2 midpoints, the LCM grid, the restart and dpm_fast
plans) array by array; each step function carried over 5 steps on random
(2, 4, 8, 8) latents, eps and noise from a numpy seed, from start step 0
and, for the multistep samplers, from a later one (img2img), within rtol =
atol = 1e-5; restart's op, dpm_fast's segment and dpm_adaptive's
controller loop under a closed-form model; the frozen first values of the
three new random streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_stable_diffusion_tpu.sampling import ddim as jddim
from pytorch_stable_diffusion_tpu.sampling import ddpm as jddpm
from pytorch_stable_diffusion_tpu.sampling import dpm as jdpm
from pytorch_stable_diffusion_tpu.sampling import dpm2 as jdpm2
from pytorch_stable_diffusion_tpu.sampling import dpm_adaptive as jdpm_adaptive
from pytorch_stable_diffusion_tpu.sampling import dpm_fast as jdpm_fast
from pytorch_stable_diffusion_tpu.sampling import euler as jeuler
from pytorch_stable_diffusion_tpu.sampling import lcm as jlcm
from pytorch_stable_diffusion_tpu.sampling import lms as jlms
from pytorch_stable_diffusion_tpu.sampling import pndm as jpndm
from pytorch_stable_diffusion_tpu.sampling import restart as jrestart
from pytorch_stable_diffusion_tpu.sampling import unipc as junipc
from pytorch_stable_diffusion_tpu_torch.core import rng
from pytorch_stable_diffusion_tpu_torch.sampling import (ddim, ddpm, dpm, dpm2, dpm_adaptive,
                                                         dpm_fast, euler, lcm, lms, pndm,
                                                         restart, unipc)

SPACINGS = ("uniform", "trailing", "karras", "exponential", "sgm_uniform",
            "kl_optimal", "ays", "beta")
SHAPE = (2, 4, 8, 8)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors: as fast alone,
    and under parallel test workers torch's default pool (a thread a core
    in every worker) oversubscribes the cores, which made a 20-step restart
    request at 16x16 take 64 s instead of 0.6."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedules(zero_snr=False):
    return (ddpm.make_schedule(zero_terminal_snr=zero_snr),
            jddpm.make_schedule(zero_terminal_snr=zero_snr))


def _jax_grid(js, spacing, n):
    return {"uniform": lambda: jddpm.inference_timesteps(n),
            "trailing": lambda: jddpm.trailing_timesteps(n),
            "karras": lambda: jddpm.karras_timesteps(js, n),
            "exponential": lambda: jddpm.exponential_timesteps(js, n),
            "sgm_uniform": lambda: jddpm.sgm_uniform_timesteps(n),
            "kl_optimal": lambda: jddpm.kl_optimal_timesteps(js, n),
            "ays": lambda: jddpm.ays_timesteps(js, n),
            "beta": lambda: jddpm.beta_timesteps(js, n)}[spacing]()


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("beta_start", [ddpm.BETA_START, ddpm.REFERENCE_BETA_START])
def test_zero_terminal_snr_schedule_matches_jax(beta_start):
    ours = ddpm.make_schedule(beta_start=beta_start, zero_terminal_snr=True)
    ref = jddpm.make_schedule(beta_start=beta_start, zero_terminal_snr=True)
    np.testing.assert_array_equal(ours.betas, np.asarray(ref.betas))
    np.testing.assert_array_equal(ours.alphas_cumprod, np.asarray(ref.alphas_cumprod))
    assert ours.alphas_cumprod[-1] == np.float32(2.0**-24)
    betas = np.linspace(beta_start**0.5, 0.012**0.5, 1000) ** 2
    np.testing.assert_array_equal(ddpm.rescale_zero_terminal_snr(betas),
                                  jddpm.rescale_zero_terminal_snr(betas))


@pytest.mark.parametrize("zero_snr", [False, True], ids=["sd", "zero_snr"])
@pytest.mark.parametrize("n", [4, 20, 50])
@pytest.mark.parametrize("spacing", SPACINGS)
def test_timestep_spacings_match_jax(spacing, n, zero_snr):
    sched, js = _schedules(zero_snr)
    got = ddpm.timesteps_for(sched, spacing, n)
    want = _jax_grid(js, spacing, n)
    assert got.dtype == np.int32 and len(got) == n
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ddpm.sigmas_all(sched), jddpm.sigmas_all(js))


def test_unknown_spacing_raises():
    with pytest.raises(ValueError, match="timestep_spacing"):
        ddpm.timesteps_for(ddpm.make_schedule(), "bogus", 10)


def test_to_epsilon_matches_jax():
    sched, js = _schedules()
    r = np.random.RandomState(3)
    lat, out = (r.randn(*SHAPE).astype(np.float32) for _ in range(2))
    for kind in ("epsilon", "v"):
        want = np.asarray(jddpm.to_epsilon(js, 420, lat, out, kind))
        got = ddpm.to_epsilon(sched, 420, torch.from_numpy(lat), torch.from_numpy(out), kind)
        np.testing.assert_allclose(np.asarray(got), want, **TOL)
    with pytest.raises(ValueError):
        ddpm.to_epsilon(sched, 420, torch.from_numpy(lat), torch.from_numpy(out), "x0")


# ---------------------------------------------------------- host tables
@pytest.mark.parametrize("n", [4, 20, 50])
def test_host_tables_match_jax(n):
    sched, js = _schedules()
    ts = ddpm.karras_timesteps(sched, n)
    np.testing.assert_array_equal(lms.coeff_table(sched, ts), jlms.coeff_table(js, ts))
    for ancestral in (False, True):
        np.testing.assert_array_equal(dpm2.mid_timesteps(sched, ts, ancestral),
                                      jdpm2.mid_timesteps(js, ts, ancestral))
    np.testing.assert_array_equal(lcm.inference_timesteps(n), jlcm.inference_timesteps(n))
    np.testing.assert_array_equal(lcm.boundary_scalings(ts[0]),
                                  np.asarray(jlcm.boundary_scalings(int(ts[0]))))


def test_lcm_refuses_more_steps_than_its_grid():
    for mod in (lcm, jlcm):
        with pytest.raises(ValueError, match="original_steps"):
            mod.inference_timesteps(51)


@pytest.mark.parametrize("n", [3, 4, 5, 19, 20, 36, 50])
def test_restart_and_dpm_fast_plans_match_jax(n):
    """n < 20: plain Heun on Karras; 20..35: one 9-step restart; >= 36: two
    of n // 4 steps.  dpm_fast: each of the three remainder rules."""
    sched, js = _schedules()
    for got, want in ((restart.build_plan(sched, n), jrestart.build_plan(js, n)),
                      (dpm_fast.build_plan(sched, n), jdpm_fast.build_plan(js, n))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------- step functions
class _Side:
    """One package's modules and array type, so one runner drives both."""

    def __init__(self, port: bool):
        self.port = port
        self.sched = ddpm.make_schedule() if port else jddpm.make_schedule()
        self.m = dict(ddim=ddim, ddpm=ddpm, dpm=dpm, dpm2=dpm2, euler=euler, lcm=lcm,
                      lms=lms, pndm=pndm, unipc=unipc) if port else dict(
            ddim=jddim, ddpm=jddpm, dpm=jdpm, dpm2=jdpm2, euler=jeuler, lcm=jlcm,
            lms=jlms, pndm=jpndm, unipc=junipc)

    def arr(self, x):
        return torch.from_numpy(x) if self.port else jnp.asarray(x)

    def init(self, fn):
        return fn() if self.port else fn(SHAPE)


def _run(side: _Side, sampler: str, ts, start: int, draws):
    """``sampler``'s steps over ``ts`` from ``start``, each fed the next
    random eps (and noise), its state carried as the JAX pipeline's loop
    carries it; -> the latents after every step."""
    m, s = side.m, side.sched
    n = len(ts)
    prev_ts = np.append(ts[1:], -1).astype(np.int32)
    lat = side.arr(draws["lat"])
    state = {"dpm++": lambda: side.init(m["dpm"].init_state),
             "dpm++_sde": lambda: side.init(m["dpm"].init_state),
             "dpm++_3m_sde": lambda: side.init(m["dpm"].init_state_3m),
             "unipc": lambda: side.init(m["unipc"].init_state),
             "plms": lambda: side.init(m["pndm"].init_state),
             "lms": lambda: [] if side.port else m["lms"].init_state(SHAPE)}.get(
        sampler, lambda: None)()
    table = jnp.asarray(m["lms"].coeff_table(s, ts)) if sampler == "lms" and not side.port \
        else m["lms"].coeff_table(s, ts)
    mids = m["dpm2"].mid_timesteps(s, ts, ancestral=sampler != "dpm2")
    out = []
    for k, i in enumerate(range(start, n + (sampler == "plms"))):
        eps, eps2, noise = (side.arr(draws[key][k]) for key in ("eps", "eps2", "noise"))
        t, prev = (int(ts[min(i, n - 1)]), int(prev_ts[min(i, n - 1)]))
        # the JAX steps fall back to a uniform grid without prev_t; the
        # port's always take it, and its Euler step takes no noise
        kw = dict(prev_t=prev) if side.port else dict(num_inference_steps=n, prev_t=prev)
        no_noise = () if side.port else (None,)
        if sampler == "ddpm":
            lat = m["ddpm"].step(s, t, lat, eps, noise, num_inference_steps=n, prev_t=prev)
        elif sampler in ("ddim", "ddim_eta"):
            lat = m["ddim"].step(s, t, lat, eps, noise,
                                 eta=0.5 if sampler == "ddim_eta" else 0.0, **kw)
        elif sampler == "euler":
            lat = m["euler"].step(s, t, lat, eps, *no_noise, **kw)
        elif sampler == "euler_a":
            lat = m["euler"].step_ancestral(s, t, lat, eps, noise, **kw)
        elif sampler == "heun":
            lat = m["euler"].step_heun_correct(s, t, lat, eps, eps2, **kw)
        elif sampler == "lcm":
            lat = m["lcm"].step(s, t, lat, eps, noise, **kw)
        elif sampler == "dpm++":
            lat, state = m["dpm"].step(s, t, lat, eps, state, **kw)
        elif sampler == "dpm++_sde":
            lat, state = m["dpm"].step_sde(s, t, lat, eps, noise, state, **kw)
        elif sampler == "dpm++_3m_sde":
            lat, state = m["dpm"].step_sde_3m(s, t, lat, eps, noise, state, **kw)
        elif sampler == "unipc":
            lat, state = m["unipc"].step(s, t, lat, eps, state, **kw)
        elif sampler == "plms":
            idx = (i, start) if side.port else (jnp.int32(i), jnp.int32(start))  # traced there
            lat, state = m["pndm"].step(s, ts, prev_ts, *idx, lat, eps, state, n_steps=n)
        elif sampler == "lms":
            lat, state = m["lms"].step(s, table, i, start, t, lat, eps, state, prev_t=prev)
        elif prev >= 0 and sampler == "dpm2_a":
            lat = m["dpm2"].step_ancestral_second(s, t, lat, eps2, noise, prev_t=prev)
        elif prev >= 0 and sampler == "dpm++_2s_a":
            pred_mid = m["euler"].step(s, t, lat, eps, *no_noise,
                                       **dict(kw, prev_t=int(mids[i])))
            lat = m["dpm"].step_2s_ancestral_second(s, t, lat, pred_mid, eps2,
                                                    int(mids[i]), noise, prev_t=prev)
        else:  # dpm2's full step with the midpoint eps; the final Euler step
            lat = m["euler"].step(s, t, lat, eps2 if prev >= 0 else eps, *no_noise, **kw)
        out.append(np.asarray(lat, np.float32))
    return out


STEP_CASES = [(s, 0) for s in ("ddpm", "ddim", "ddim_eta", "euler", "euler_a", "heun",
                               "lcm", "dpm2", "dpm2_a", "dpm++_2s_a")] + \
    [(s, start) for s in ("dpm++", "dpm++_sde", "dpm++_3m_sde", "unipc", "plms", "lms")
     for start in (0, 2)]


@pytest.mark.parametrize("sampler,start", STEP_CASES,
                         ids=[f"{s}-start{st}" for s, st in STEP_CASES])
def test_steps_match_jax(sampler, start):
    """5 steps (plms: 5 iterations) down to the final one (prev_t < 0);
    lcm on its own grid, the others on Karras."""
    n = 5 + start - (sampler == "plms")
    sched = ddpm.make_schedule()
    ts = lcm.inference_timesteps(n) if sampler == "lcm" else ddpm.karras_timesteps(sched, n)
    r = np.random.RandomState(len(sampler) + start)
    draws = {"lat": r.randn(*SHAPE).astype(np.float32),
             **{k: r.randn(5, *SHAPE).astype(np.float32) for k in ("eps", "eps2", "noise")}}
    got = _run(_Side(port=True), sampler, ts, start, draws)
    want = _run(_Side(port=False), sampler, ts, start, draws)
    assert len(got) == len(want) == 5
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {k}", **TOL)


# ------------------------------------------- restart / dpm_fast bodies
def _closed_form_eps(abar, port: bool):
    """A smooth model: eps = sqrt(1 - abar_t) x + 0.05 sin(3 x)."""
    def eps(x, t):
        c = float(np.sqrt(1.0 - abar[int(t)]))
        return c * x + 0.05 * (torch.sin(3.0 * x) if port else jnp.sin(3.0 * x))
    return eps


def test_restart_and_dpm_fast_loop_bodies_match_jax():
    """Every op of a 20-step restart plan (one 9-step restart segment) and
    every segment of a 6-step dpm_fast plan, against the JAX pipeline's
    loop bodies (its ``pipeline.py`` restart and dpm_fast branches) written
    out with the JAX package's functions, on the same injected noise."""
    sched, js = _schedules()
    abar = sched.alphas_cumprod
    r = np.random.RandomState(9)
    x0 = r.randn(*SHAPE).astype(np.float32)

    rp = restart.build_plan(sched, 20)
    noises = r.randn(rp["n_ops"], *SHAPE).astype(np.float32)
    got, want = torch.from_numpy(x0), jnp.asarray(x0)
    jeps = _closed_form_eps(abar, port=False)
    for i in range(rp["n_ops"]):
        got = restart.run_op(sched, rp, i, got, torch.from_numpy(noises[i]),
                             _closed_form_eps(abar, port=True))
        tp, ts_, te = rp["t_prev"][i], rp["t_start"][i], rp["t_end"][i]
        x_k = want / jnp.sqrt(js.alphas_cumprod[tp]) + noises[i] * jnp.sqrt(rp["rvar"][i])
        lat = jnp.sqrt(js.alphas_cumprod[ts_]) * x_k
        eps = jeps(lat, ts_)
        pred = jeuler.step(js, ts_, lat, eps, None, num_inference_steps=20, prev_t=te)
        eps2 = jeps(pred, max(te, 0))
        want = jeuler.step_heun_correct(js, ts_, lat, eps, eps2, num_inference_steps=20,
                                        prev_t=te)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"op {i}", **TOL)

    fp = dpm_fast.build_plan(sched, 6)
    noises = r.randn(fp["m"], *SHAPE).astype(np.float32)
    got, want = torch.from_numpy(x0), jnp.asarray(x0)
    for i in range(fp["m"]):
        got = dpm_fast.run_segment(sched, fp, i, got, torch.from_numpy(noises[i]),
                                   _closed_form_eps(abar, port=True))
        t0, s1, s2 = fp["t0"][i], fp["s1"][i], fp["s2"][i]
        x_k = want / jnp.sqrt(js.alphas_cumprod[t0])
        eps0 = jeps(want, t0)
        u1 = x_k - fp["u1c"][i] * eps0
        eps1 = jeps(jnp.sqrt(js.alphas_cumprod[s1]) * u1, s1)
        u2 = x_k - fp["u2c0"][i] * eps0 - fp["u2c1"][i] * (eps1 - eps0)
        eps2 = jeps(jnp.sqrt(js.alphas_cumprod[s2]) * u2, s2)
        x_k = x_k - fp["e0c"][i] * eps0 - fp["c1"][i] * (eps1 - eps0) \
            - fp["c2"][i] * (eps2 - eps0) + fp["su"][i] * noises[i]
        t_next = fp["t0"][i + 1] if i + 1 < fp["m"] else fp["t_exit"]
        want = jnp.sqrt(js.alphas_cumprod[t_next]) * x_k
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"segment {i}",
                                   **TOL)


# --------------------------------------------------------- dpm_adaptive
@pytest.mark.parametrize("stiff,t_entry", [(False, 999), (True, 999), (False, 600)],
                         ids=["txt2img", "large_first_step", "img2img_entry"])
def test_dpm_adaptive_matches_jax(stiff, t_entry):
    """The same closed-form model, eps = sqrt(1 - abar_t) x + a sin(f x),
    and injected noise on both sides: equal evaluation timesteps (3 an
    iteration), equal accept/reject sequences, the result within 1e-4.  The
    smooth model has a 0.05, f 3; the stiff one a 2, f 10 at the top
    timestep 999 alone, so the default first step is too large there and
    the controller rejects and shrinks it until all three evaluations of an
    iteration quantize to 999.  No controller factor lies within 1e-3 of
    the threshold, so a last-bit difference in the error norm cannot take
    the other branch: the margin is asserted, not hoped for."""
    sched, js = _schedules()
    abar = sched.alphas_cumprod
    safety = dpm_adaptive.ACCEPT_SAFETY
    r = np.random.RandomState(t_entry)
    x_vp = r.randn(*SHAPE).astype(np.float32)
    noises = r.randn(20, *SHAPE).astype(np.float32)

    port_calls, jax_calls = [], []

    def wave(t):
        return (2.0, 10.0) if stiff and int(t) == 999 else (0.05, 3.0)

    def port_eps(x, t):
        port_calls.append((t, x.numpy().copy()))
        a, f = wave(t)
        return float(np.sqrt(1.0 - abar[int(t)])) * x + a * torch.sin(f * x)

    got, factors = dpm_adaptive.sample(sched, torch.from_numpy(x_vp), t_entry, port_eps,
                                       torch.from_numpy(noises), max_iters=20)
    jabar = jnp.asarray(abar)

    def jax_eps(x, t):
        jax_calls.append((int(t), np.asarray(x).copy()))
        a, f = wave(t)
        return jnp.sqrt(1.0 - jabar[t]) * x + a * jnp.sin(f * x)

    with jax.disable_jit():  # concrete values reach the recording closure
        want = jdpm_adaptive.sample(js, jnp.asarray(x_vp), jnp.int32(t_entry), jax_eps,
                                    jnp.asarray(noises), max_iters=20)

    margin = min(abs(float(f) - safety) for f in factors)
    assert margin > 1e-3, f"a controller factor lies {margin:.2e} from {safety}"
    assert len(port_calls) == len(jax_calls) == 3 * len(factors) <= 60
    assert [t for t, _ in port_calls] == [t for t, _ in jax_calls]
    for k, ((_, a), (_, b)) in enumerate(zip(port_calls, jax_calls)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=f"evaluation {k}")
    # iteration k was rejected iff iteration k+1 evaluates the same state
    jax_first = [x for _, x in jax_calls[::3]]
    jax_accepts = [not np.array_equal(a, b) for a, b in zip(jax_first, jax_first[1:])]
    accepts = [bool(f >= safety) for f in factors]
    assert accepts[:-1] == jax_accepts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if stiff:
        assert not accepts[0]  # the controller rejects and shrinks the first step


def test_dpm_adaptive_iteration_bound():
    sched = ddpm.make_schedule()
    x = torch.randn(*SHAPE, generator=torch.Generator().manual_seed(0))
    eps = _closed_form_eps(sched.alphas_cumprod, port=True)
    _, factors = dpm_adaptive.sample(sched, x, 999, eps, torch.zeros(2, *SHAPE),
                                     max_iters=2)
    assert len(factors) == 2


# -------------------------------------------------------------------- rng
def test_sampler_stream_golden_values():
    """First values of the restart, dpm_fast and dpm_adaptive streams for
    seed 1337 — frozen: changing them changes every image of those samplers
    for a given seed.  Each draw is per sample, so sample 0 is the same at
    any batch size."""
    expect = {"restart": (-1.3563896417617798, -0.3075493574142456),
              "dpm_fast": (0.20859740674495697, 0.22576498985290527),
              "dpm_adaptive": (-0.3412071466445923, -0.9205030202865601)}
    for name, (first, step2) in expect.items():
        draws = rng.step_normals(1337, name, 3, 2, (4,))
        assert draws.shape == (3, 2, 4) and draws.dtype == torch.float32
        np.testing.assert_allclose(float(draws[0, 0, 0]), first, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(draws[2, 0, 0]), step2, rtol=1e-6, err_msg=name)
        torch.testing.assert_close(rng.step_normals(1337, name, 3, 1, (4,))[:, 0],
                                   draws[:, 0], rtol=0, atol=0)
    assert (rng.step_normals(1337, "restart", 1, 1, (4,))
            - rng.step_normals(1337, "sampler", 1, 1, (4,))).abs().max() > 0.1
