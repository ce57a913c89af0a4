"""Cross-implementation parity: one explicit NS step vs the external
Fortran solver's field dumps (the reference's strongest end-to-end test,
test/part2.jl: 257x65, beta=0, Pr=1e-3, tol=1e-12, W from Winit.bin,
interior atol 1e-8), plus intermediate-field checks against the extra
fixture dumps and semi-implicit smoke tests."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core.config import InitScheme, NSConfig
from fpr_tpu.models import navier_stokes as ns
from fpr_tpu.utils.io import load_fortran, save_fortran

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def fortran_cfg():
    return NSConfig(
        nx=257, ny=65, Pr=1.0e-3, Ra=1.0e6, beta=0.0, tol=1.0e-12,
        ttot=0.1, W_init=InitScheme.FROM_ARRAY,
    )


@pytest.fixture(scope="module")
def one_step(fortran_cfg):
    W0 = load_fortran(os.path.join(FIX, "Winit.bin"))
    return ns.simulate(fortran_cfg, W0=W0, max_steps=1)


def _interior_close(got, ref, atol=1e-8):
    return np.abs(got[1:-1, 1:-1] - ref[1:-1, 1:-1]).max()


def test_fortran_loader_roundtrip(tmp_path):
    W = load_fortran(os.path.join(FIX, "Winit.bin"))
    assert W.shape == (65, 257)
    p = tmp_path / "w.bin"
    save_fortran(p, W)
    np.testing.assert_array_equal(load_fortran(p), W)


def test_cosine_init_matches_fortran(fortran_cfg):
    Tinit = load_fortran(os.path.join(FIX, "Tinit.bin"))
    T0 = np.asarray(ns.init_field(fortran_cfg, InitScheme.COSINE))
    assert _interior_close(T0, Tinit, 0) < 1e-12


def test_one_step_sizes(one_step):
    for name in ("T", "W", "S"):
        ref = load_fortran(os.path.join(FIX, f"{name}.bin"))
        assert getattr(one_step, name).shape == ref.shape


def test_one_step_values_vs_fortran(one_step):
    # interior values at atol 1e-8, the reference's bar (test/part2.jl:32-37)
    for name in ("T", "W", "S"):
        ref = load_fortran(os.path.join(FIX, f"{name}.bin"))
        err = _interior_close(getattr(one_step, name), ref)
        assert err < 1e-8, f"{name}: max interior |diff| = {err:.3e}"


def test_intermediates_vs_fortran(fortran_cfg):
    # the fixture set also carries vx/vy/dT2/Ra_dTdx dumps from the same
    # Fortran step — check our operator chain piecewise
    W0 = jnp.asarray(load_fortran(os.path.join(FIX, "Winit.bin")))
    T0 = ns.init_field(fortran_cfg, InitScheme.COSINE)
    S0 = jnp.zeros_like(W0)
    from fpr_tpu.core import bc
    from fpr_tpu.ops import stencil2d as ops
    from fpr_tpu.solvers.multigrid import mg_solve

    h = fortran_cfg.h
    S, _, _ = mg_solve(S0, W0, h, 0.0, 1e-12, 50)
    vx, vy = ops.velocity(S, h, h)
    assert _interior_close(np.asarray(vx), load_fortran(os.path.join(FIX, "vx.bin"))) < 1e-8
    assert _interior_close(np.asarray(vy), load_fortran(os.path.join(FIX, "vy.bin"))) < 1e-8

    T = bc.ns_temperature_bcs(T0)
    dT2 = ops.diffusion(T, fortran_cfg.k, h, h)
    dW2 = ops.diffusion(W0, fortran_cfg.Pr, h, h)
    Ra_dTdx = ops.buoyancy(T, fortran_cfg.Ra, h)
    assert _interior_close(np.asarray(dT2), load_fortran(os.path.join(FIX, "dT2.bin"))) < 1e-6
    assert _interior_close(np.asarray(dW2), load_fortran(os.path.join(FIX, "dW2.bin"))) < 1e-8
    assert _interior_close(np.asarray(Ra_dTdx), load_fortran(os.path.join(FIX, "Ra_dTdx.bin"))) < 1e-4


def test_semi_implicit_smoke():
    # a few semi-implicit steps on a small grid stay finite and bounded
    cfg = NSConfig(nx=65, ny=17, beta=0.5, Pr=0.1, tol=1e-7, ttot=1.0)
    out = ns.simulate(cfg, max_steps=5)
    assert np.isfinite(out.T).all() and np.isfinite(out.W).all()
    assert out.steps == 5
    assert out.T.min() > -0.5 and out.T.max() < 1.5


def test_explicit_vs_semi_implicit_dt():
    # beta >= 0.5 takes the advective dt, explicit takes min(dt_dif, dt_adv)
    # (compute_dt, part2.jl:76-87); with Pr small, dt_dif is tiny so the
    # semi-implicit run takes far fewer steps for the same ttot
    common = dict(nx=65, ny=17, Pr=1.0e-2, tol=1e-7, ttot=2e-2)
    exp = ns.simulate(NSConfig(beta=0.0, **common), max_steps=400)
    semi = ns.simulate(NSConfig(beta=0.5, **common), max_steps=400)
    # average dt must be larger without the diffusive restriction
    assert semi.sim_time / semi.steps > exp.sim_time / exp.steps
    assert semi.steps <= exp.steps


def test_simulate_fast_matches_host_loop_explicit():
    """The fused on-device loop (f32 state, ds solves) must reproduce the
    host-loop f64 path: identical step count, same dt sequence (via
    sim_time), fields to f32-trajectory accuracy over several steps."""
    from fpr_tpu.models.navier_stokes import simulate, simulate_fast

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM)
    rng = np.random.default_rng(7)
    W0 = rng.standard_normal((65, 65)) * 10.0
    ref = simulate(cfg, W0=W0, max_steps=6, dtype=jnp.float64)
    got = simulate_fast(cfg, W0=W0, max_steps=6)
    assert got.steps == ref.steps
    assert abs(got.sim_time - ref.sim_time) < 1e-6 * max(ref.sim_time, 1e-30)
    np.testing.assert_allclose(got.T, ref.T, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.W, ref.W, rtol=2e-4, atol=2e-4 * np.abs(ref.W).max())
    np.testing.assert_allclose(got.S, ref.S, rtol=2e-4, atol=2e-4 * np.abs(ref.S).max())


def test_simulate_fast_matches_host_loop_semi_implicit():
    from fpr_tpu.models.navier_stokes import simulate, simulate_fast

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.5, Pr=0.1,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM,
                   mg_solver="mixed")
    rng = np.random.default_rng(11)
    W0 = rng.standard_normal((65, 65)) * 10.0
    ref = simulate(cfg, W0=W0, max_steps=3, dtype=jnp.float64)
    got = simulate_fast(cfg, W0=W0, max_steps=3)
    assert got.steps == ref.steps
    np.testing.assert_allclose(got.T, ref.T, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.W, ref.W, rtol=1e-3, atol=1e-3 * np.abs(ref.W).max())


def test_simulate_fast_chunked_loop_matches_unchunked():
    """Crossing chunk boundaries (the long-run RPC-deadline guard) must not
    change the trajectory or the step count."""
    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM)
    rng = np.random.default_rng(3)
    W0 = rng.standard_normal((65, 65)) * 10.0
    one = simulate_fast(cfg, W0=W0, max_steps=7)
    chunked = simulate_fast(cfg, W0=W0, max_steps=7, chunk_steps=2)
    assert chunked.steps == one.steps
    np.testing.assert_array_equal(chunked.T, one.T)
    np.testing.assert_array_equal(chunked.W, one.W)


def test_simulate_fast_resume_bitwise():
    """Checkpoint/resume mid-run: M steps + resume to N == N straight steps
    BITWISE (the state payload carries the f32/ds state, the carried
    w_sumsq accumulator, and the ds sim-time pair verbatim)."""
    from fpr_tpu.models.navier_stokes import simulate_fast
    from fpr_tpu.utils import checkpoint

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM)
    rng = np.random.default_rng(5)
    W0 = rng.standard_normal((65, 65)) * 10.0
    full = simulate_fast(cfg, W0=W0, max_steps=9)
    part = simulate_fast(cfg, W0=W0, max_steps=5)
    assert part.steps == 5
    # round-trip the payload through the npz checkpoint
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ns.npz")
        checkpoint.save(p, **part.state)
        state = checkpoint.load(p)
    resumed = simulate_fast(cfg, max_steps=9, state0=state)
    assert resumed.steps == full.steps
    assert resumed.sim_time == full.sim_time
    np.testing.assert_array_equal(resumed.state["T"], full.state["T"])
    np.testing.assert_array_equal(resumed.state["W"], full.state["W"])
    np.testing.assert_array_equal(resumed.state["S_hi"], full.state["S_hi"])
    np.testing.assert_array_equal(resumed.state["S_lo"], full.state["S_lo"])
    np.testing.assert_array_equal(resumed.state["w_sumsq"], full.state["w_sumsq"])


def test_simulate_fast_snapshots():
    """snapshot_steps rides the chunk sync: cadence while running, final
    state last, times/steps monotone (reference do_vis, part2.jl:236-245)."""
    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM)
    rng = np.random.default_rng(6)
    W0 = rng.standard_normal((65, 65)) * 10.0
    # chunk_steps < snapshot_steps: cadence must still be snapshot_steps
    # (chunk boundaries are aligned to snapshot multiples), not chunk_steps
    out = simulate_fast(cfg, W0=W0, max_steps=13, snapshot_steps=4,
                        chunk_steps=3)
    assert out.snapshots is not None and len(out.snapshots) >= 2
    steps = [s[4] for s in out.snapshots]
    times = [s[3] for s in out.snapshots]
    assert steps == sorted(steps) and times == sorted(times)
    assert all(s % 4 == 0 for s in steps[:-1])
    assert steps[-1] == out.steps
    T_last = out.snapshots[-1][0]
    np.testing.assert_array_equal(T_last, out.T)


def test_fast_mg_default_upgrade_rules():
    """The f32 fast path upgrades a default MGConfig() to the DST-257
    ladder at production sizes only; explicit configs and small grids
    are never touched (measured rationale in fast_mg_default's doc)."""
    from fpr_tpu.core.config import CoarseSolver, MGConfig, NSConfig
    from fpr_tpu.models.navier_stokes import fast_mg_default

    up = fast_mg_default(NSConfig(nx=2049, ny=513))
    assert up.mg.coarse_size == 257
    assert up.mg.coarse_solver is CoarseSolver.DST
    assert (up.mg.pre_smooth, up.mg.post_smooth) == (3, 3)  # deep V(3,3)

    small = NSConfig(nx=257, ny=65)
    assert fast_mg_default(small).mg == MGConfig()

    explicit = NSConfig(nx=2049, ny=513, mg=MGConfig(coarse_size=33))
    assert fast_mg_default(explicit).mg.coarse_size == 33

    # mg_auto=False is the explicit opt-out: the default ladder survives
    opted_out = NSConfig(nx=2049, ny=513, mg_auto=False)
    assert fast_mg_default(opted_out).mg == MGConfig()

    # grids with 129 < min dim <= 257: the coarse size is clamped BELOW
    # the min dimension so at least one V-cycle level remains (and the
    # sharded planner keeps a shardable level — advisor round-3 finding)
    mid = fast_mg_default(NSConfig(nx=1025, ny=257))
    assert mid.mg.coarse_solver is CoarseSolver.DST
    assert mid.mg.coarse_size == 129


def test_fast_mg_default_clamped_grid_shards():
    """The clamped mid-size ladder must produce a valid shard plan (the
    round-3 default raised 'too small to shard' for min dims 130-257)."""
    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models.navier_stokes import fast_mg_default
    from fpr_tpu.solvers.dist_mg_ds import plan_shards

    cfg = fast_mg_default(NSConfig(nx=1025, ny=257))
    plan = plan_shards(cfg.ny, cfg.nx, 2, cfg.mg, replicate_below=257)
    assert plan.s >= 1


def test_simulate_fast_s_tol_factor_preserves_observables():
    """Relaxing the S-solve tolerance (s_tol_factor) must not change the
    step count / dt sequence and must keep fields within the solve
    tolerance of the reference-semantics run.  (At 2049x513 the bench's
    relaxed-S row checks the same step parity; this is the small-grid
    CPU witness of the contract.)"""
    import dataclasses

    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50, W_init=InitScheme.RANDOM)
    rng = np.random.default_rng(11)
    W0 = rng.standard_normal((65, 65)) * 10.0
    ref = simulate_fast(cfg, W0=W0, max_steps=8)
    rel = simulate_fast(
        dataclasses.replace(cfg, s_tol_factor=100.0), W0=W0, max_steps=8
    )
    assert rel.steps == ref.steps
    assert abs(rel.sim_time - ref.sim_time) < 1e-6 * max(ref.sim_time, 1e-30)
    for name in ("T", "W", "S"):
        a, b = getattr(rel, name), getattr(ref, name)
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(), 1e-30))
