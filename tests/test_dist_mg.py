"""Distributed production-tier multigrid (fpr_tpu/solvers/dist_mg_ds.py):
the sharded fused-leg V-cycle must reproduce the single-device
mg_solve_ds solver on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core.config import CoarseSolver, MGConfig
from fpr_tpu.ops import pallas2d, stencil2d
from fpr_tpu.ops.pallas2d import PAD
from fpr_tpu.parallel.mesh import make_mesh
from fpr_tpu.solvers import dist_mg_ds, multigrid


def test_smooth2r_row_offset_matches_global(rng):
    """The offset/masked kernels on hand-built shard-local windows must
    reproduce the corresponding rows of the global single-array call —
    bitwise (same arithmetic, same block recomputation)."""
    ny, nx = 97, 129
    h = 1.0 / 64.0
    ndev, ny_l, br = 2, 64, 32
    u = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    f = jnp.asarray(rng.random((ny, nx)), jnp.float32)

    # global reference at the same block size
    u_g, res_g = pallas2d.smooth2r_split_rp(
        pallas2d.pad2d(u, br)[: ny_l * ndev + 2 * PAD],
        pallas2d.pad2d(f, br)[: ny_l * ndev + 2 * PAD],
        ny, nx, br, h, 0.0,
    )

    # shard emulation: local rp arrays with neighbor rows in the ghosts
    up = jnp.pad(u, ((0, ndev * ny_l - ny), (0, 0)))
    fp = jnp.pad(f, ((0, ndev * ny_l - ny), (0, 0)))
    nxp = pallas2d.padded_cols(nx)
    for d in range(ndev):
        lo = d * ny_l
        blk = np.zeros((ny_l + 2 * PAD, nxp), np.float32)
        fblk = np.zeros((ny_l + 2 * PAD, nxp), np.float32)
        for (dst, src) in [(blk, up), (fblk, fp)]:
            body = np.asarray(src[max(0, lo - PAD) : lo + ny_l + PAD])
            start = PAD - (lo - max(0, lo - PAD))
            dst[start : start + body.shape[0], : nx] = body
        u_l, res_l = pallas2d.smooth2r_split_rp(
            jnp.asarray(blk), jnp.asarray(fblk), ny_l, nx, br, h, 0.0,
            row_off=lo, ny_mask=ny,
        )
        rows = min(ny_l, ny - lo)
        np.testing.assert_array_equal(
            np.asarray(u_l)[PAD : PAD + rows],
            np.asarray(u_g)[PAD + lo : PAD + lo + rows],
        )
        # parity-split residual: compare per-block even/odd halves
        np.testing.assert_array_equal(
            np.asarray(res_l)[PAD : PAD + ny_l],
            np.asarray(res_g)[PAD + lo : PAD + lo + ny_l],
        )


@pytest.mark.parametrize(
    "n,rep,smooths", [(1025, 513, 2), (2049, 1025, 2), (1025, 513, 3)]
)
def test_mg_solve_ds_sharded_matches_single(rng, n, rep, smooths):
    """Iteration parity + field agreement with the single-device ds solver
    (VERDICT round-2 item 1); smooths=3 covers the deep-smoothed
    production config over the mesh (one 8-row halo exchange per leg
    absorbs up to PAD-2 in-kernel sweeps bitwise)."""
    h = 1.0 / (n - 1)
    tol = 1e-6
    b = (
        jnp.zeros((n, n), jnp.float32)
        .at[1:-1, 1:-1]
        .set(jnp.asarray(rng.random((n - 2, n - 2)), jnp.float32))
    )
    cfg = MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST,
                   pre_smooth=smooths, post_smooth=smooths)
    mesh = make_mesh((8,), ("y",))

    (hi_d, lo_d), r_d, it_d = dist_mg_ds.mg_solve_ds_sharded(
        b, h, 0.0, tol, 20, mesh, axis="y", cfg=cfg, replicate_below=rep,
    )
    (hi_s, lo_s), r_s, it_s = multigrid.mg_solve_ds(
        None, b, h, 0.0, tol, 20, cfg=cfg, return_pair=True,
    )

    assert int(it_d) == int(it_s)
    u_d = np.asarray(hi_d, np.float64) + np.asarray(lo_d, np.float64)
    u_s = np.asarray(hi_s, np.float64) + np.asarray(lo_s, np.float64)
    scale = np.abs(u_s).max()
    assert np.abs(u_d - u_s).max() / scale < 1e-6

    # the distributed residual claim is a true converged residual
    res = stencil2d.residual(
        jnp.asarray(u_d), b.astype(jnp.float64), h, 0.0
    )
    rel = float(stencil2d.rms(res)) / float(stencil2d.rms(b.astype(jnp.float64)))
    assert rel < 2 * tol


def test_sharded_solver_rejects_small_grids():
    mesh = make_mesh((8,), ("y",))
    b = jnp.zeros((129, 129), jnp.float32)
    with pytest.raises(ValueError, match="too small"):
        dist_mg_ds.mg_solve_ds_sharded(b, 1 / 128.0, 0.0, 1e-6, 20, mesh)


# ---------------------------------------------------------------------------
# 2D (y, x) mesh decomposition (round-4 verdict item 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n,rep", [
    ((2, 4), 1025, 513),
    ((4, 2), 1025, 257),
    ((2, 2), 2049, 513),
])
def test_mg_solve_ds_sharded_2d_matches_single(rng, shape, n, rep):
    """Iteration parity + field agreement of the 2D-mesh solver with the
    single-device ds solver — the part-2 analog of part 1's Cartesian
    decomposition; column halos are 128-lane ghost slabs."""
    h = 1.0 / (n - 1)
    tol = 1e-6
    b = (
        jnp.zeros((n, n), jnp.float32)
        .at[1:-1, 1:-1]
        .set(jnp.asarray(rng.random((n - 2, n - 2)), jnp.float32))
    )
    cfg = MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST,
                   pre_smooth=3, post_smooth=3)
    mesh = make_mesh(shape, ("y", "x"))

    (hi_d, lo_d), r_d, it_d = dist_mg_ds.mg_solve_ds_sharded_2d(
        b, h, 0.0, tol, 20, mesh, cfg=cfg, replicate_below=rep,
    )
    (hi_s, lo_s), r_s, it_s = multigrid.mg_solve_ds(
        None, b, h, 0.0, tol, 20, cfg=cfg, return_pair=True,
    )

    assert int(it_d) == int(it_s)
    u_d = np.asarray(hi_d, np.float64) + np.asarray(lo_d, np.float64)
    u_s = np.asarray(hi_s, np.float64) + np.asarray(lo_s, np.float64)
    scale = np.abs(u_s).max()
    assert np.abs(u_d - u_s).max() / scale < 1e-6

    res = stencil2d.residual(
        jnp.asarray(u_d), b.astype(jnp.float64), h, 0.0
    )
    rel = float(stencil2d.rms(res)) / float(stencil2d.rms(b.astype(jnp.float64)))
    assert rel < 2 * tol


def test_sharded_2d_rejects_narrow_columns():
    # 8 column shards of a 1025-wide grid would leave < 256 cols/shard
    mesh = make_mesh((1, 8), ("y", "x"))
    b = jnp.zeros((1025, 1025), jnp.float32)
    with pytest.raises(ValueError, match="too small to 2D-shard"):
        dist_mg_ds.mg_solve_ds_sharded_2d(
            b, 1 / 1024.0, 0.0, 1e-6, 20, mesh, replicate_below=513,
        )


def test_simulate_fast_sharded_matches_single(rng):
    """The sharded explicit NS fast path vs single-device simulate_fast:
    same step count, fields agreeing to f32 reduction-order noise over a
    short window (per-cell arithmetic is identical; dt reductions are
    psum/pmax'd)."""
    import jax.numpy as jnp

    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import dist_ns
    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=129, ny=65, ttot=1e-3, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50)
    W0 = rng.standard_normal((65, 129)) * 10.0
    mesh = make_mesh((8,), ("y",))
    ref = simulate_fast(cfg, W0=W0, max_steps=6)
    got = dist_ns.simulate_fast_sharded(
        cfg, mesh, W0=W0, max_steps=6, replicate_below=33
    )
    assert got.steps == ref.steps
    assert abs(got.sim_time - ref.sim_time) < 1e-6
    scale = np.abs(ref.W).max()
    assert np.abs(got.W - ref.W).max() / scale < 1e-4
    assert np.abs(got.T - ref.T).max() < 1e-4
    assert np.abs(got.S - ref.S).max() / max(np.abs(ref.S).max(), 1e-30) < 1e-3


def test_mg_solve_ds_sharded_apply_bcs_matches_single(rng):
    """apply_bcs (NS temperature BCs) through the sharded solver: the
    per-shard defect kernel applies the Dirichlet rows against global
    indices and the transfers apply shard-local Neumann columns; must
    reproduce the single-device apply_bcs solve, including on a Helmholtz
    shift (the semi-implicit NS temperature equation's operator)."""
    n = 1025
    h = 1.0 / (n - 1)
    tol = 1e-6
    b = (
        jnp.zeros((n, n), jnp.float32)
        .at[1:-1, 1:-1]
        .set(jnp.asarray(rng.random((n - 2, n - 2)), jnp.float32))
    )
    cfg = MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST)
    mesh = make_mesh((8,), ("y",))

    for c in (0.0, 64.0):  # Poisson and Helmholtz-shifted
        (hi_d, lo_d), r_d, it_d = dist_mg_ds.mg_solve_ds_sharded(
            b, h, c, tol, 20, mesh, axis="y", cfg=cfg,
            replicate_below=513, apply_bcs=True,
        )
        (hi_s, lo_s), r_s, it_s = multigrid.mg_solve_ds(
            None, b, h, c, tol, 20, cfg=cfg, return_pair=True,
            apply_bcs=True,
        )
        assert int(it_d) == int(it_s)
        u_d = np.asarray(hi_d, np.float64) + np.asarray(lo_d, np.float64)
        u_s = np.asarray(hi_s, np.float64) + np.asarray(lo_s, np.float64)
        scale = np.abs(u_s).max()
        assert np.abs(u_d - u_s).max() / scale < 1e-6
        # the BCs must actually hold on the returned field
        np.testing.assert_allclose(u_d[0], 1.0, atol=1e-6)
        np.testing.assert_allclose(u_d[-1], 0.0, atol=1e-6)
        np.testing.assert_allclose(u_d[:, 0], u_d[:, 1], atol=1e-6)
        np.testing.assert_allclose(u_d[:, -1], u_d[:, -2], atol=1e-6)


def test_simulate_fast_sharded_semi_implicit_matches_single(rng):
    """The sharded SEMI-IMPLICIT fast path (rhs-mode operator kernel + two
    warm-started sharded Helmholtz solves per step, T with the temperature
    BCs) vs single-device simulate_fast: same step count, fields agreeing
    to f32 reduction-order noise over a short window."""
    import jax.numpy as jnp

    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import dist_ns
    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=129, ny=65, ttot=0.1, beta=0.5, Pr=0.01,
                   tol=1e-7, niters=50)
    W0 = rng.standard_normal((65, 129)) * 10.0
    mesh = make_mesh((8,), ("y",))
    ref = simulate_fast(cfg, W0=W0, max_steps=5)
    got = dist_ns.simulate_fast_sharded(
        cfg, mesh, W0=W0, max_steps=5, replicate_below=33
    )
    assert got.steps == ref.steps
    assert abs(got.sim_time - ref.sim_time) < 1e-6
    scale = np.abs(ref.W).max()
    assert np.abs(got.W - ref.W).max() / scale < 1e-3
    assert np.abs(got.T - ref.T).max() < 1e-3
    # the temperature BCs must hold on the gathered field
    np.testing.assert_allclose(got.T[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(got.T[-1], 0.0, atol=1e-6)
    np.testing.assert_allclose(got.T[:, 0], got.T[:, 1], atol=1e-6)


def test_simulate_fast_sharded_resume_bitwise(rng):
    """Sharded checkpoint/resume: M steps + resume(N) == straight N,
    bitwise, using the same global-field state schema as the single-device
    tier (checkpoints interoperate)."""
    import jax.numpy as jnp

    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import dist_ns

    cfg = NSConfig(nx=129, ny=65, ttot=10.0, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50)
    W0 = rng.standard_normal((65, 129)) * 10.0
    mesh = make_mesh((8,), ("y",))
    kw = dict(replicate_below=33)
    full = dist_ns.simulate_fast_sharded(cfg, mesh, W0=W0, max_steps=6, **kw)
    part = dist_ns.simulate_fast_sharded(cfg, mesh, W0=W0, max_steps=4, **kw)
    resumed = dist_ns.simulate_fast_sharded(
        cfg, mesh, max_steps=6, state0=part.state, **kw)
    assert resumed.steps == full.steps == 6
    np.testing.assert_array_equal(resumed.T, full.T)
    np.testing.assert_array_equal(resumed.W, full.W)
    assert resumed.sim_time == full.sim_time


def test_simulate_fast_sharded_snapshots(rng):
    """Chunk-synced snapshots on the sharded tier."""
    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import dist_ns

    cfg = NSConfig(nx=129, ny=65, ttot=10.0, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50)
    mesh = make_mesh((8,), ("y",))
    out = dist_ns.simulate_fast_sharded(
        cfg, mesh, max_steps=6, snapshot_steps=2, replicate_below=33)
    assert out.snapshots and len(out.snapshots) >= 2
    T, W, S, t, s = out.snapshots[-1]
    assert T.shape == (65, 129) and s == out.steps
