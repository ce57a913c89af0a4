"""3D dual-time diffusion tests — the analog of the reference's part-1
golden-sample test (test/part1.jl: 32^3, all variants agree at atol 1e-5)
plus residual-vs-oracle algebra and work-precision anchors."""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core import bc
from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu.models import diffusion3d
from fpr_tpu.ops import oracle, stencil3d


def test_outer_steps():
    # reference loop t in 0:dt:ttot-dt (part1_kernel_programming.jl:166)
    assert outer_steps(1.0, 0.2) == 5
    assert outer_steps(2.0, 0.2) == 10
    assert outer_steps(0.5, 0.2) == 2


def test_dual_time_step_matches_oracle(rng):
    # one pseudo-time iteration == explicit formula via the sparse 7-pt oracle
    n = 12
    g = Grid3D(n, n, n)
    dt, D = 0.2, 1.0
    dtau = pseudo_timestep(g.dx, g.dy, g.dz, D)
    Ht = rng.random((n, n, n))
    Htau = rng.random((n, n, n))

    new, sumsq = stencil3d.dual_time_step(
        jnp.asarray(Ht), jnp.asarray(Htau), dt, dtau, g.dx, g.dy, g.dz, D
    )

    L = oracle.stencil_7pt(n - 2, n - 2, n - 2) / g.dx**2  # cubic: dx=dy=dz
    # interior neighbors include boundary values; build full operator manually
    lap = np.zeros((n, n, n))
    Hi = Htau
    lap[1:-1, 1:-1, 1:-1] = (
        (Hi[1:-1, 1:-1, 2:] - 2 * Hi[1:-1, 1:-1, 1:-1] + Hi[1:-1, 1:-1, :-2]) / g.dx**2
        + (Hi[1:-1, 2:, 1:-1] - 2 * Hi[1:-1, 1:-1, 1:-1] + Hi[1:-1, :-2, 1:-1]) / g.dy**2
        + (Hi[2:, 1:-1, 1:-1] - 2 * Hi[1:-1, 1:-1, 1:-1] + Hi[:-2, 1:-1, 1:-1]) / g.dz**2
    )
    dHdtau = (Htau - Ht) / dt - D * lap
    expected = Htau.copy()
    expected[1:-1, 1:-1, 1:-1] -= dtau * dHdtau[1:-1, 1:-1, 1:-1]
    np.testing.assert_allclose(np.asarray(new), expected, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        float(sumsq), (dHdtau[1:-1, 1:-1, 1:-1] ** 2).sum(), rtol=1e-12
    )
    # interior Laplacian in the manual form also matches the sparse oracle
    # for a zero-boundary field (sanity of the oracle itself)
    Hz = np.zeros_like(Htau)
    Hz[1:-1, 1:-1, 1:-1] = Htau[1:-1, 1:-1, 1:-1]
    lap_o = (L @ Hz[1:-1, 1:-1, 1:-1].ravel()).reshape(n - 2, n - 2, n - 2)
    lap_z = np.zeros_like(Hz)
    lap_z[1:-1, 1:-1, 1:-1] = (
        (Hz[1:-1, 1:-1, 2:] - 2 * Hz[1:-1, 1:-1, 1:-1] + Hz[1:-1, 1:-1, :-2]) / g.dx**2
        + (Hz[1:-1, 2:, 1:-1] - 2 * Hz[1:-1, 1:-1, 1:-1] + Hz[1:-1, :-2, 1:-1]) / g.dy**2
        + (Hz[2:, 1:-1, 1:-1] - 2 * Hz[1:-1, 1:-1, 1:-1] + Hz[:-2, 1:-1, 1:-1]) / g.dz**2
    )
    np.testing.assert_allclose(lap_z[1:-1, 1:-1, 1:-1], lap_o, rtol=1e-10, atol=1e-10)


def test_init_gaussian_boundary_and_peak():
    g = Grid3D(32, 32, 32)
    H = stencil3d.init_gaussian(g, dtype=jnp.float64)
    H = bc.dirichlet_faces_3d(H)
    Hn = np.asarray(H)
    # nearest cell center sits 0.156 off the domain center in each dim:
    # 2*exp(-3*0.15625^2) = 1.8588
    assert Hn.max() == pytest.approx(1.8588, abs=1e-3)
    assert Hn[0].max() == 0.0 and Hn[:, 0].max() == 0.0 and Hn[:, :, 0].max() == 0.0


@pytest.fixture(scope="module")
def solved_32():
    cfg = DiffusionConfig(nx=32, ny=32, nz=32, ttot=1.0, tol=1e-8, policy=ExecutionPolicy.JNP)
    return diffusion3d.solve(cfg, dtype=jnp.float64)


def test_diffusion_32_converges(solved_32):
    out = solved_32
    assert out.converged
    # diffusion smooths the Gaussian: peak decays but stays positive
    assert 0 < out.H.max() < 2.0
    assert out.H[0].max() == 0.0  # Dirichlet faces preserved
    assert out.iters_total > 5 * 5  # a few pseudo-iters per physical step


def test_diffusion_32_probe_plateau(solved_32):
    # error-vs-grid-size plateau ~0.0794-0.0812 from 32^3 up holds at t=1?
    # (the published plateau is at ttot=2; at ttot=1 the value differs, so
    # just check the probe machinery returns a sensible interior value)
    g = Grid3D(32, 32, 32)
    v = diffusion3d.probe_trilinear(out_H := solved_32.H, g)
    assert 0.0 < v < 1.0


def test_diffusion_probe_value_128_matches_reference_anchor():
    # the BASELINE work-precision anchor: H(4.5,4.5,4.5) at ttot=2, tol=1e-6
    # equals 0.0799870 at 128^3; at 64^3 the plateau gives ~0.0796-0.0812
    # (error_vs_grid_size_experiment_results.csv).  64^3 keeps CPU time sane.
    cfg = DiffusionConfig(nx=64, ny=64, nz=64, ttot=2.0, tol=1e-6, policy=ExecutionPolicy.JNP)
    out = diffusion3d.solve(cfg, dtype=jnp.float64)
    g = Grid3D(64, 64, 64)
    # reference error_vs_grid_size_experiment_results.csv, nx=64 row:
    # val = 0.08115436500826592 (nearest-cell sample at (4.5,4.5,4.5))
    v = diffusion3d.probe_nearest(out.H, g)
    assert v == pytest.approx(0.08115436500826592, abs=2e-5)
    # true trilinear lands between the CSV's val and (buggy) interp columns
    vt = diffusion3d.probe_trilinear(out.H, g)
    assert 0.076 < vt < 0.082


def test_f32_matches_f64_iterations():
    # f32 storage must not change iterations-to-tolerance materially at
    # bench tolerances (the benchmark runs f32; SURVEY §7 risk item)
    cfg = DiffusionConfig(nx=32, ny=32, nz=32, ttot=0.4, tol=1e-6, policy=ExecutionPolicy.JNP)
    o64 = diffusion3d.solve(cfg, dtype=jnp.float64)
    o32 = diffusion3d.solve(cfg, dtype=jnp.float32)
    assert abs(o64.iters_total - o32.iters_total) <= 0.05 * o64.iters_total + 2
    np.testing.assert_allclose(o32.H, o64.H, atol=5e-5)


# --- golden field-snapshot test (reference test/part1.jl:18-42) -----------
#
# The reference commits a 12x12 sample of the z=15 slice at 32^3
# (test/reftest-files/test_1.bson) and holds all three solver variants to
# it at atol 1e-5 — the one test that catches a spatial-pattern regression
# which preserves probe values and residual norms.  Our golden is
# regenerated by scripts/make_golden_part1.py (JNP f64 tier).


@pytest.fixture(scope="module")
def golden_32():
    import os

    path = os.path.join(
        os.path.dirname(__file__), "fixtures", "golden_part1_32.npz"
    )
    return np.load(path)


@pytest.mark.parametrize(
    "policy,tol,dtype",
    [
        (ExecutionPolicy.JNP, 1e-8, jnp.float64),
        # f32 at tol 1e-7 sits 1.6e-6 off the f64 field at 32^3 (measured);
        # tol 1e-6 would leave 1.8e-5 > the reference's atol
        (ExecutionPolicy.PALLAS, 1e-7, jnp.float32),
        (ExecutionPolicy.PALLAS_DS, 1e-8, None),
    ],
    ids=["jnp", "pallas", "pallas_ds"],
)
def test_golden_field_snapshot(golden_32, policy, tol, dtype):
    cfg = DiffusionConfig(nx=32, ny=32, nz=32, ttot=1.0, tol=tol, policy=policy)
    kw = {} if dtype is None else {"dtype": dtype}
    res = diffusion3d.solve(cfg, **kw)
    assert res.converged
    inds = golden_32["indices"]
    z = int(golden_32["z_index"])
    sample = res.H[z][np.ix_(inds, inds)]
    np.testing.assert_allclose(sample, golden_32["H"], atol=1e-5)
    g = Grid3D(32, 32, 32)
    np.testing.assert_allclose(
        np.asarray(g.coords1d("x"))[inds], golden_32["X"], atol=1e-12
    )
