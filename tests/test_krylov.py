"""CG tests — analog of test/krylov.jl (66^2 Helmholtz, deliberately not a
2^k+1 grid) plus the MG-preconditioned CG composition, including the
production-tier double-single PCG (krylov.mg_pcg_ds)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core.config import CoarseSolver, MGConfig
from fpr_tpu.solvers import krylov


def test_cg_converges_helmholtz():
    n = 66
    h = 1.0 / (n - 1)
    c = 3.14
    tol = 1e-6
    b = np.ones((n, n))
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0

    x, r_rms, iters = krylov.cg(jnp.asarray(b), h, h, c, tol, 1000)
    assert float(r_rms) < tol * np.sqrt((b**2).sum() / n**2)
    assert int(iters) < 1000


def test_cg_solution_matches_oracle(rng):
    from fpr_tpu.ops import oracle

    n = 33
    h = 1.0 / (n - 1)
    c = 3.14
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    x, r_rms, _ = krylov.cg(jnp.asarray(b), h, h, c, 1e-12, 5000)
    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)
    import scipy.sparse.linalg as spla

    xd = spla.spsolve(A.tocsc(), b[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)
    np.testing.assert_allclose(np.asarray(x)[1:-1, 1:-1], xd, atol=1e-9)


def test_mg_preconditioned_cg_beats_plain_cg(rng):
    n = 129
    h = 1.0 / (n - 1)
    tol = 1e-8
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    bj = jnp.asarray(b)
    normb = np.sqrt((b**2).sum())

    x_pcg, r_pcg, it_pcg = krylov.mg_preconditioned_cg(
        bj, h, 0.0, tol, 100, mg_cfg=MGConfig()
    )
    x_cg, r_cg, it_cg = krylov.cg(bj, h, h, 0.0, tol, 3000)

    # both converged by their own ||r|| < tol * ||b|| criterion
    assert float(r_pcg) * n <= tol * normb * 1.001
    assert float(r_cg) * n <= tol * normb * 1.001
    assert int(it_pcg) < int(it_cg) / 10  # MG preconditioning slashes iters
    assert int(it_pcg) <= 25


# ---------------------------------------------------------------------------
# production-tier ds PCG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        MGConfig(),  # reference-parity ladder (V(2,2), jacobi coarse)
        MGConfig(coarse_size=65, coarse_solver=CoarseSolver.DST,
                 pre_smooth=3, post_smooth=3),  # production-shaped ladder
    ],
    ids=["default", "dst_v33"],
)
def test_mg_pcg_ds_converges_and_matches_ds_mg(rng, cfg):
    """The ds PCG reaches the same tolerance as mg_solve_ds and agrees
    with its solution to ds (~48-bit) accuracy — the true-residual
    replacement makes both solvers' exits the same quantity."""
    from fpr_tpu.solvers import multigrid

    n = 257
    h = 1.0 / (n - 1)
    tol = 1e-6
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    bj = jnp.asarray(b)
    tolf = tol * np.sqrt((b.astype(np.float64) ** 2).sum() / n**2)

    u, r_rms, it = krylov.mg_pcg_ds(bj, h, 0.0, tol, 30, cfg=cfg)
    assert float(r_rms) < tolf
    assert int(it) <= 12

    u_mg, _, _ = multigrid.mg_solve_ds(None, bj, h, 0.0, tol, 30, cfg=cfg)
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(u_mg), atol=2e-8 * float(np.abs(u_mg).max())
    )


def test_mg_pcg_ds_solution_accuracy_oracle(rng):
    """Tight-tolerance ds PCG reproduces the sparse direct solution down
    to the double-single representation floor (~5e-8 rel at 129^2 —
    mg_solve_ds lands on the identical value; the gate has headroom)."""
    import scipy.sparse.linalg as spla

    from fpr_tpu.ops import oracle

    n = 129
    h = 1.0 / (n - 1)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    u, r_rms, _ = krylov.mg_pcg_ds(jnp.asarray(b), h, 0.0, 1e-10, 40)
    A = oracle.helmholtz_operator(n - 2, n - 2, h, 0.0)
    xd = spla.spsolve(
        A.tocsc(), b[1:-1, 1:-1].astype(np.float64).ravel()
    ).reshape(n - 2, n - 2)
    rel = np.abs(np.asarray(u)[1:-1, 1:-1] - xd).max() / np.abs(xd).max()
    assert rel < 2e-7


def test_mg_pcg_ds_helmholtz_traced_c(rng):
    """Traced f32 Helmholtz shift (the NS solves' form of c) through the
    jitted entry; the pair return carries the hi/lo planes."""
    import jax

    n = 129
    h = 1.0 / (n - 1)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    (hi, lo), r_rms, it = krylov.mg_pcg_ds_jit(
        jnp.asarray(b), h, jnp.asarray(100.0, jnp.float32), 1e-9, 30,
        return_pair=True,
    )
    assert float(r_rms) < 1e-9 * np.sqrt((b.astype(np.float64)**2).sum() / n**2)
    assert np.abs(np.asarray(lo)).max() <= np.spacing(
        np.abs(np.asarray(hi)).max(), dtype=np.float32
    )


def test_matvec_dot_rp_matches_explicit(rng):
    """The fused dot-only matvec == sum(x * matvec(x)) elementwise-exactly
    up to f32 summation order (checked loosely) on an rp operand."""
    from fpr_tpu.ops import pallas2d

    ny, nx = 65, 129
    h = 1.0 / (ny - 1)
    br = pallas2d.layout_br(ny)
    x = np.zeros((ny, nx), np.float32)
    x[1:-1, 1:-1] = rng.random((ny - 2, nx - 2))
    x_rp = pallas2d.pad2d(jnp.asarray(x), br)
    acc = pallas2d.matvec_dot_rp(x_rp, ny, nx, br, h, 3.14)
    Ax = pallas2d.matvec(jnp.asarray(x), h, h, 3.14)
    ref = float(jnp.sum(jnp.asarray(x) * Ax))
    assert abs(float(acc) - ref) <= 1e-5 * abs(ref)
