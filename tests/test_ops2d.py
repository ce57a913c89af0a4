"""Algebraic unit tests of the 2D stencil operators against the sparse
oracle — the analog of the reference's SparseArrays-based tests
(test/multigrid.jl:102-138, test/krylov.jl)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.ops import oracle, stencil2d, transfer


def test_residual_matches_oracle(rng):
    # residual == A u - f elementwise, incl. Helmholtz shift (c = 3.1415),
    # mirroring test/multigrid.jl:102-138
    n = 64
    h = 1.0 / (n - 1)
    c = 3.1415
    u = rng.random((n, n))
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    f = rng.random((n, n))

    res = np.asarray(stencil2d.residual(jnp.asarray(u), jnp.asarray(f), h, c))

    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)
    expected = (A @ u[1:-1, 1:-1].ravel() - f[1:-1, 1:-1].ravel()).reshape(
        n - 2, n - 2
    )
    # residual values scale like 1/h^2 ~ 4e3, so absolute roundoff ~1e-10
    np.testing.assert_allclose(res[1:-1, 1:-1], expected, rtol=1e-10, atol=1e-9)
    # boundary ring is exactly zero
    assert np.all(res[0, :] == 0) and np.all(res[:, -1] == 0)


def test_matvec_matches_oracle(rng):
    n = 33
    h = 1.0 / (n - 1)
    c = 3.14
    x = rng.random((n, n))
    x[0, :] = x[-1, :] = x[:, 0] = x[:, -1] = 0.0
    got = np.asarray(stencil2d.matvec(jnp.asarray(x), h, h, c))
    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)
    expected = (A @ x[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)
    np.testing.assert_allclose(got[1:-1, 1:-1], expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_smoother_converges_manufactured(rng, smoother):
    # Jacobi converges to a manufactured solution b = A xref
    # (test/multigrid.jl:60-100); we additionally cover red-black GS.
    n = 33
    h = 1.0 / (n - 1)
    c = 0.0
    xref = np.zeros((n, n))
    xref[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = (A @ xref[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)

    tol = 1e-6
    tolb = tol * np.sqrt((b**2).sum() / n**2)
    bj = jnp.asarray(b)
    step = (
        stencil2d.jacobi_step
        if smoother == "jacobi"
        else lambda u, f, h, c: stencil2d.red_black_gs_step(u, f, h, c)
    )

    # iterate on device (the reference's host loop, test/multigrid.jl:84-95,
    # becomes a while_loop)
    import jax

    def cond(carry):
        _, r_rms, i = carry
        return jnp.logical_and(i < 20000, r_rms >= tolb)

    def body(carry):
        u, _, i = carry
        u, r_rms = step(u, bj, h, c)
        return u, r_rms, i + 1

    u, r_rms, iters = jax.lax.while_loop(
        cond, body, (jnp.zeros((n, n)), jnp.asarray(jnp.inf), 0)
    )
    assert float(r_rms) < tolb
    rel = np.linalg.norm(np.asarray(u) - xref) / np.linalg.norm(xref)
    assert rel < tolb


def test_restriction_injection(rng):
    nf = 17
    fine = rng.random((nf, nf))
    coarse = np.asarray(transfer.restrict(jnp.asarray(fine)))
    assert coarse.shape == (9, 9)
    # interior coarse points inject from even fine points
    np.testing.assert_allclose(coarse[1:-1, 1:-1], fine[2:-2:2, 2:-2:2])
    assert np.all(coarse[0, :] == 0) and np.all(coarse[:, 0] == 0)


def test_prolongation_gather_equals_scatter(rng):
    # all three implementations (transposed-conv, shift-gather, and the
    # reference-style numpy scatter, multigrid.jl:403-420) must agree —
    # linearity makes this exact
    for (nc_y, nc_x) in [(9, 9), (5, 17), (9, 33)]:
        coarse = rng.random((nc_y, nc_x))
        fine_shape = (2 * (nc_y - 1) + 1, 2 * (nc_x - 1) + 1)
        got = np.asarray(transfer.prolongate(jnp.asarray(coarse), fine_shape))
        got_shifts = np.asarray(
            transfer.prolongate_shifts(jnp.asarray(coarse), fine_shape)
        )
        ref = oracle.prolongate_scatter(coarse, fine_shape)
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(got_shifts, ref, rtol=1e-14, atol=1e-14)


def test_full_weighting_is_scaled_adjoint_of_prolongation(rng):
    # <R f, c> == 1/4 <f, P c> for interior-supported c (adjoint up to the
    # factor 4 from the 2x grid refinement)
    nc, nf = 9, 17
    f = rng.random((nf, nf))
    c = np.zeros((nc, nc))
    c[1:-1, 1:-1] = rng.random((nc - 2, nc - 2))
    Rf = np.asarray(transfer.restrict_full_weighting(jnp.asarray(f)))
    Pc = np.asarray(transfer.prolongate(jnp.asarray(c), (nf, nf)))
    lhs = (Rf * c).sum()
    rhs = 0.25 * (f * Pc).sum()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_prolongate_restrict_anisotropic(rng):
    # anisotropic ladder shapes as in preallocate_buffers (multigrid.jl:25-38)
    fine = rng.random((65, 257))
    c = np.asarray(transfer.restrict(jnp.asarray(fine)))
    assert c.shape == (33, 129)
    f2 = np.asarray(transfer.prolongate(jnp.asarray(c), (65, 257)))
    assert f2.shape == (65, 257)
