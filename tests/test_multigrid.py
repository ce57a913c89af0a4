"""Multigrid convergence tests — the analog of the reference's
parameterized sweep (test/multigrid.jl:30-58): MG must reach
r_rms < tol * rms(b) within 20 V-cycles for every config in
{policy} x {coarse l} x {grid k} x {jacobi, CG coarse}."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core.config import CoarseSolver, ExecutionPolicy, MGConfig, Smoother
from fpr_tpu.ops import oracle, stencil2d
from fpr_tpu.solvers import multigrid


def _manufactured(n, h, c, rng):
    xref = np.zeros((n, n))
    xref[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = (A @ xref[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)
    return xref, b


@pytest.mark.parametrize(
    "policy", [ExecutionPolicy.JNP, ExecutionPolicy.PALLAS]
)
@pytest.mark.parametrize("coarse_solver", [CoarseSolver.JACOBI, CoarseSolver.CG])
@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("k", [7, 8, 9, 10])
def test_mg_converges_within_20_vcycles(rng, k, l, coarse_solver, policy):
    """The reference's full 32-config matrix (test/multigrid.jl:30-58):
    {parallel, parallel_shmem} x l x k x {jacobi, CG} — here the two
    execution policies are the jnp tier and the fused-leg drop-ins, kept
    so all 32 reference configs EXECUTE."""
    n = 2**k + 1
    h = 1.0 / (n - 1)
    c = 0.0
    tol = 1e-6
    cfg = MGConfig(coarse_size=2**l + 1, coarse_solver=coarse_solver, policy=policy)
    _, b = _manufactured(n, h, c, rng)

    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, c, tol, 20, cfg=cfg
    )
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)
    assert int(iters) <= 20


def test_mg_converges_large_grid_jit(rng):
    # one bigger grid through the jitted entry (k=9 -> 513^2)
    n = 513
    h = 1.0 / (n - 1)
    tol = 1e-6
    _, b = _manufactured(n, h, 0.0, rng)
    u, r_rms, iters = multigrid.mg_solve_jit(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, tol, 20
    )
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)
    assert int(iters) <= 20


def test_mg_red_black_gs_smoother(rng):
    n = 129
    h = 1.0 / (n - 1)
    tol = 1e-6
    cfg = MGConfig(smoother=Smoother.RED_BLACK_GS)
    _, b = _manufactured(n, h, 0.0, rng)
    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, tol, 20, cfg=cfg
    )
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)
    assert int(iters) <= 20


def test_mg_helmholtz_shift(rng):
    # (nabla^2 - c) with c > 0 — the semi-implicit NS solves use this path
    n = 129
    h = 1.0 / (n - 1)
    c = 100.0
    tol = 1e-8
    _, b = _manufactured(n, h, c, rng)
    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, c, tol, 20
    )
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)


def test_mg_anisotropic_grid(rng):
    # the NS grid shape 257x65 descends to (17, 5) with coarse_size 5
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    b = np.zeros((ny, nx))
    b[1:-1, 1:-1] = rng.random((ny - 2, nx - 2))
    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((ny, nx)), jnp.asarray(b), h, 0.0, 1e-6, 30
    )
    assert float(r_rms) < 1e-6 * np.sqrt((b**2).sum() / (nx * ny))


# ---------------------------------------------------------------------------
# DST direct solver (fpr_tpu.solvers.dst) — the MXU coarse solve
# ---------------------------------------------------------------------------


def test_dst_solve_exact_vs_oracle(rng):
    """One DST solve == the sparse direct solve to fp accuracy (the solver
    is algebraically exact: the DST diagonalizes the 5-pt operator)."""
    import scipy.sparse.linalg as spla

    from fpr_tpu.solvers import dst

    for (ny, nx), c in [((33, 33), 0.0), ((17, 65), 3.1415)]:
        h = 1.0 / (ny - 1)
        b = np.zeros((ny, nx))
        b[1:-1, 1:-1] = rng.random((ny - 2, nx - 2))
        u, r_rms = dst.dst_solve(jnp.zeros((ny, nx)), jnp.asarray(b), h, c)
        A = oracle.helmholtz_operator(nx - 2, ny - 2, h, c)
        u_ref = spla.spsolve(A.tocsr(), b[1:-1, 1:-1].ravel()).reshape(
            ny - 2, nx - 2
        )
        np.testing.assert_allclose(np.asarray(u)[1:-1, 1:-1], u_ref, atol=1e-10)
        assert float(r_rms) < 1e-10 * np.sqrt((b**2).sum() / (nx * ny))


def test_dst_solve_nonzero_boundary(rng):
    """Defect-form DST handles a nonzero boundary ring on u0 exactly (the
    NS apply_bcs coarse case): the boundary is preserved and the interior
    residual vanishes."""
    from fpr_tpu.ops import stencil2d
    from fpr_tpu.solvers import dst

    ny, nx = 33, 33
    h = 1.0 / (ny - 1)
    u0 = np.zeros((ny, nx))
    u0[0, :] = 1.0                      # NS Dirichlet bottom
    u0[:, 0] = rng.random(ny)           # arbitrary side values
    b = np.zeros((ny, nx))
    b[1:-1, 1:-1] = rng.random((ny - 2, nx - 2))
    u, r_rms = dst.dst_solve(jnp.asarray(u0), jnp.asarray(b), h, 0.0)
    u = np.asarray(u)
    np.testing.assert_array_equal(u[0, :], u0[0, :])
    np.testing.assert_array_equal(u[:, 0], u0[:, 0])
    res = stencil2d.residual(jnp.asarray(u), jnp.asarray(b), h, 0.0)
    assert float(stencil2d.rms(res)) < 1e-10


def test_dst_traced_c(rng):
    """c may be traced (the NS Helmholtz shifts vary per step): one jitted
    solve reused across shift values stays exact."""
    from fpr_tpu.solvers import dst

    n = 33
    h = 1.0 / (n - 1)
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))

    @jax.jit
    def solve(b, c):
        return dst.dst_solve(jnp.zeros((n, n)), b, h, c)

    for c in [0.0, 17.0, 4096.0]:
        u, r_rms = solve(jnp.asarray(b), jnp.asarray(c))
        assert float(r_rms) < 1e-10, c


@pytest.mark.parametrize("coarse_size", [5, 65])
def test_mg_converges_dst_coarse(rng, coarse_size):
    """DST as the V-cycle coarse solver — including the truncated-ladder
    configuration (coarse_size=65) that removes the small-level subtree."""
    n = 257
    h = 1.0 / (n - 1)
    tol = 1e-8
    cfg = MGConfig(coarse_size=coarse_size, coarse_solver=CoarseSolver.DST)
    xref, b = _manufactured(n, h, 0.0, rng)
    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, tol, 20, cfg=cfg
    )
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)
    assert int(iters) <= 20


def test_mg_dst_whole_grid_is_coarse(rng):
    """coarse_size >= the grid: the 'V-cycle' degenerates to one exact DST
    solve per outer iteration — the small-k fast path."""
    n = 129
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=257, coarse_solver=CoarseSolver.DST)
    _, b = _manufactured(n, h, 0.0, rng)
    u, r_rms, iters = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, 1e-10, 20, cfg=cfg
    )
    assert float(r_rms) < 1e-10 * np.sqrt((b**2).sum() / n**2)
    assert int(iters) <= 2


def test_mg_warns_when_unconverged(rng, capfd):
    """Exiting the outer loop at niters still above tolerance emits a
    runtime warning (reference parity: multigrid.jl:78-80 warns too).
    The systematic trigger is the cold apply_bcs stagnation documented in
    mg_solve_ds_rp; here a deliberately starved iteration budget exercises
    the same exit path cheaply."""
    n = 129
    h = 1.0 / (n - 1)
    _, b = _manufactured(n, h, 0.0, rng)
    _, r_rms, it = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, 1e-12, 2
    )
    jax.effects_barrier()
    out = capfd.readouterr()
    assert int(it) == 2
    assert "NOT converged" in out.out + out.err

    # a converged solve stays silent
    _, r_rms, _ = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, 1e-6, 20
    )
    jax.effects_barrier()
    out = capfd.readouterr()
    assert "NOT converged" not in out.out + out.err


def test_mg_ds_warns_with_bc_hint(rng, capfd):
    """The ds tier's warning carries the cold-BC stagnation hint when
    apply_bcs is set (the one systematic way users hit non-convergence)."""
    n = 65
    h = 1.0 / (n - 1)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    multigrid.mg_solve_ds(
        None, jnp.asarray(b), h, 0.0, 1e-12, 2, apply_bcs=True
    )
    jax.effects_barrier()
    out = capfd.readouterr()
    assert "cold-BC stagnation" in out.out + out.err


def test_mg_ds_fused_dst_large_anisotropic(rng):
    """End-to-end through the fused legs with the child level at the DST
    coarse size (area >= PALLAS_MIN_AREA) — the NS production shape."""
    from fpr_tpu.core.config import CoarseSolver as CS

    ny, nx = 513, 2049
    h = 1.0 / (ny - 1)
    b = np.zeros((ny, nx), np.float32)
    b[1:-1, 1:-1] = rng.random((ny - 2, nx - 2))
    cfg = MGConfig(coarse_size=257, coarse_solver=CS.DST,
                   pre_smooth=3, post_smooth=3)
    u, r_rms, it = multigrid.mg_solve_ds(
        None, jnp.asarray(b), h, 0.0, 1e-7, 30, cfg=cfg
    )
    tolf = 1e-7 * np.sqrt((b.astype(np.float64) ** 2).sum() / (ny * nx))
    assert float(r_rms) < tolf
    assert int(it) <= 8


def test_mg_solution_accuracy(rng):
    # the converged iterate approximates the manufactured solution
    n = 129
    h = 1.0 / (n - 1)
    tol = 1e-10
    xref, b = _manufactured(n, h, 0.0, rng)
    u, r_rms, _ = multigrid.mg_solve(
        jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, tol, 50
    )
    rel = np.linalg.norm(np.asarray(u) - xref) / np.linalg.norm(xref)
    assert rel < 1e-8
