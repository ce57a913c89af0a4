"""Fused 2D smoother/residual/matvec parity (f64) and the row-padded
V-cycle + mixed-precision defect-correction solvers."""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core.config import MGConfig
from fpr_tpu.ops import pallas2d, stencil2d
from fpr_tpu.solvers import multigrid


@pytest.mark.parametrize("shape", [(17, 33), (33, 129), (65, 257)])
@pytest.mark.parametrize("c", [0.0, 3.14])
def test_kernels_match_jnp(rng, shape, c):
    ny, nx = shape
    u = jnp.asarray(rng.random(shape))
    f = jnp.asarray(rng.random(shape))
    h = 1.0 / (ny - 1)
    scale = 1.0 / h**2  # residual magnitudes; ulp-level reassociation only

    r_p = np.asarray(pallas2d.residual(u, f, h, c))
    r_j = np.asarray(stencil2d.residual(u, f, h, c))
    np.testing.assert_allclose(r_p, r_j, atol=1e-13 * scale)

    u_p, n_p = pallas2d.jacobi_step(u, f, h, c)
    u_j, n_j = stencil2d.jacobi_step(u, f, h, c)
    np.testing.assert_allclose(np.asarray(u_p), np.asarray(u_j), atol=1e-14)
    assert abs(float(n_p) - float(n_j)) < 1e-12 * scale

    m_p = np.asarray(pallas2d.matvec(u, h, h, c))
    m_j = np.asarray(stencil2d.matvec(u, h, h, c))
    np.testing.assert_allclose(m_p, m_j, atol=1e-13 * scale)


def test_pad_roundtrip(rng):
    a = jnp.asarray(rng.random((33, 129)))
    br = pallas2d.layout_br(33)
    np.testing.assert_array_equal(
        np.asarray(pallas2d.unpad2d(pallas2d.pad2d(a, br), 33, 129)), np.asarray(a)
    )


def test_fused_legs_match_composition(rng):
    # smooth2 == two smooths; smooth2r == smooth2 + residual;
    # corr_smooth2 == prolongate + subtract + smooth2 (multi-block shapes)
    from fpr_tpu.ops import transfer

    for (ny, nx), bcs in [((33, 129), False), ((65, 257), True)]:
        nyc, nxc = (ny - 1) // 2 + 1, (nx - 1) // 2 + 1
        br = pallas2d.layout_br(ny)
        u = pallas2d.pad2d(jnp.asarray(rng.random((ny, nx))), br)
        f = pallas2d.pad2d(jnp.asarray(rng.random((ny, nx))), br)
        corr = jnp.asarray(rng.random((nyc, nxc)))
        h, c = 1.0 / (ny - 1), 0.9

        u1, _ = pallas2d.smooth_rp(u, f, ny, nx, br, h, c, with_norm=False)
        u2, r2 = pallas2d.smooth_rp(u1, f, ny, nx, br, h, c, with_norm=True)
        v2, s2 = pallas2d.smooth2_rp(u, f, ny, nx, br, h, c, with_norm=True)
        np.testing.assert_allclose(
            np.asarray(pallas2d.unpad2d(v2, ny, nx)),
            np.asarray(pallas2d.unpad2d(u2, ny, nx)), atol=1e-14,
        )
        assert abs(float(s2) - float(r2)) < 1e-13

        res2 = pallas2d.residual_rp(v2, f, ny, nx, br, h, c)
        v2r, res2r = pallas2d.smooth2r_rp(u, f, ny, nx, br, h, c)
        np.testing.assert_allclose(
            np.asarray(pallas2d.unpad2d(v2r, ny, nx)),
            np.asarray(pallas2d.unpad2d(v2, ny, nx)), atol=1e-14,
        )
        np.testing.assert_allclose(
            np.asarray(pallas2d.unpad2d(res2r, ny, nx)),
            np.asarray(pallas2d.unpad2d(res2, ny, nx)), atol=1e-14,
        )

        # parity-split variant: same u'', and restrict_ps == restrict(res)
        v2s, res_ps = pallas2d.smooth2r_split_rp(u, f, ny, nx, br, h, c)
        np.testing.assert_array_equal(np.asarray(v2s), np.asarray(v2r))
        got_c = transfer.restrict_ps(res_ps, ny, nx, br, apply_bcs=bcs)
        ref_c = transfer.restrict(
            pallas2d.unpad2d(res2, ny, nx), apply_bcs=bcs
        )
        np.testing.assert_allclose(
            np.asarray(got_c), np.asarray(ref_c), atol=1e-14
        )

        corr_f = transfer.prolongate_rp(corr, (ny, nx), u.shape, apply_bcs=bcs)
        u_ref, r_ref = pallas2d.smooth2_rp(
            u - corr_f, f, ny, nx, br, h, c, with_norm=True
        )
        u_got, r_got = pallas2d.corr_smooth2_rp(
            u, f, corr, ny, nx, br, h, c, apply_bcs=bcs, with_norm=True
        )
        np.testing.assert_allclose(
            np.asarray(pallas2d.unpad2d(u_got, ny, nx)),
            np.asarray(pallas2d.unpad2d(u_ref, ny, nx)), atol=1e-14,
        )
        assert abs(float(r_got) - float(r_ref)) < 1e-13


def _manufactured(n, h, rng):
    from fpr_tpu.ops import oracle

    xref = np.zeros((n, n))
    xref[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    A = oracle.helmholtz_operator(n - 2, n - 2, h, 0.0)
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = (A @ xref[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)
    return xref, b


def test_rp_vcycle_matches_jnp_vcycle(rng, monkeypatch):
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    _, b = _manufactured(n, h, rng)
    bj = jnp.asarray(b)
    u1, r1, i1 = multigrid.mg_solve(jnp.zeros((n, n)), bj, h, 0.0, 1e-8, 30)
    u2, r2, i2 = multigrid.mg_solve_rp(jnp.zeros((n, n)), bj, h, 0.0, 1e-8, 30)
    assert int(i1) == int(i2)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1), atol=1e-14)


def test_mixed_precision_defect_correction(rng, monkeypatch):
    # f64 storage + f32 fused inner V-cycles converges to the f64 answer
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    xref, b = _manufactured(n, h, rng)
    bj = jnp.asarray(b)
    u, r, it = multigrid.mg_solve_mixed(jnp.zeros((n, n)), bj, h, 0.0, 1e-8, 40)
    f_rms = np.sqrt((b**2).mean())
    assert float(r) < 1e-8 * f_rms
    rel = np.linalg.norm(np.asarray(u) - xref) / np.linalg.norm(xref)
    assert rel < 1e-6
    assert int(it) <= 20


def test_mixed_helmholtz_with_bcs(rng, monkeypatch):
    # the NS T-solve shape: Helmholtz shift + Dirichlet/Neumann BCs.
    # Reference-shaped cycles (elim off): on this COLD weak-shift BC solve
    # both tiers stagnate along the IDENTICAL trajectory, which is exactly
    # what this test pins (tier parity, not convergence).
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(multigrid, "_ELIM_BC_SMOOTH", False)
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    c = 50.0
    b = jnp.asarray(rng.random((ny, nx)))
    u_ref, r_ref, it_ref = multigrid.mg_solve(
        jnp.zeros((ny, nx)), b, h, c, 1e-8, 40, apply_bcs=True
    )
    u_mix, r_mix, it_mix = multigrid.mg_solve_mixed(
        jnp.zeros((ny, nx)), b, h, c, 1e-8, 40, apply_bcs=True
    )
    np.testing.assert_allclose(np.asarray(u_mix), np.asarray(u_ref), atol=1e-6)


def test_elim_bc_smoothing_cuts_apply_bcs_outers(rng, monkeypatch):
    """Eliminated-BC smoothing (the round-5 apply_bcs preconditioner): the
    correction cycles copy the Neumann side columns after every sweep, so
    the BC contraction penalty vanishes — same converged solution, far
    fewer outer defect iterations (the NS semi T-solve took 16 -> 10
    under the production DST-257 ladder, 16 -> 7 in the full-recursion
    CPU probe; this is the CPU witness)."""
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    c = 0.5 / (h * h)  # the NS T Helmholtz regime (c*h^2 ~ 0.5)
    b = jnp.asarray(rng.random((ny, nx)) * c)
    u0 = jnp.asarray(rng.random((ny, nx)))

    monkeypatch.setattr(multigrid, "_ELIM_BC_SMOOTH", False)
    u_ref, _, it_ref = multigrid.mg_solve_ds(u0, b, h, c, 1e-8, 50,
                                             apply_bcs=True)
    monkeypatch.setattr(multigrid, "_ELIM_BC_SMOOTH", True)
    u_eli, r_eli, it_eli = multigrid.mg_solve_ds(u0, b, h, c, 1e-8, 50,
                                                 apply_bcs=True)
    f_rms = float(jnp.sqrt(jnp.mean(b * b)))
    assert float(r_eli) < 1e-8 * f_rms
    assert int(it_eli) <= int(it_ref) - 5, (int(it_eli), int(it_ref))
    # same solve contract: both converged iterates agree to tolerance and
    # carry the BCs
    np.testing.assert_allclose(np.asarray(u_eli), np.asarray(u_ref),
                               atol=1e-6)
    got = np.asarray(u_eli)
    np.testing.assert_allclose(got[:, 0], got[:, 1], atol=1e-12)
    np.testing.assert_allclose(got[:, -1], got[:, -2], atol=1e-12)


def test_stk_legs_match_split_kernels(rng):
    # the stacked legs (smooth2r_stk / corr_smooth2_stk) must be
    # bitwise-identical to the separate-operand legs on the physical
    # interior (ghost/pad rows are unspecified by contract); multi-block
    from fpr_tpu.ops import transfer

    ny, nx = 257, 129
    br = 64  # forces 5 blocks
    h, c = 1.0 / (ny - 1), 0.7
    total = pallas2d.padded_rows(ny, br)
    nxp = pallas2d.padded_cols(nx)
    f_rp = pallas2d.pad2d(jnp.asarray(rng.random((ny, nx))), br)
    zero = jnp.zeros((total, nxp), f_rp.dtype)
    P = pallas2d.PAD
    W = lambda a: np.asarray(a)[P : total - P]
    I = lambda a: np.asarray(pallas2d.unpad2d(a, ny, nx))

    u1, r1 = pallas2d.smooth2r_split_rp(zero, f_rp, ny, nx, br, h, c, zero_u=True)
    L = jnp.zeros((2, total, nxp), f_rp.dtype).at[1].set(f_rp)
    L1, res1 = pallas2d.smooth2r_stk(L, ny, nx, br, h, c, zero_u=True)
    np.testing.assert_array_equal(I(u1), I(L1[0]))
    np.testing.assert_array_equal(W(r1), W(res1))

    u2, r2 = pallas2d.smooth2r_split_rp(u1, f_rp, ny, nx, br, h, c)
    L2, res2 = pallas2d.smooth2r_stk(L1, ny, nx, br, h, c)
    np.testing.assert_array_equal(I(u2), I(L2[0]))
    np.testing.assert_array_equal(W(r2), W(res2))
    np.testing.assert_array_equal(np.asarray(L2[1]), np.asarray(f_rp))

    nyc, nxc = (ny - 1) // 2 + 1, (nx - 1) // 2 + 1
    coarse = jnp.asarray(rng.random((nyc, nxc)))
    u3, n3 = pallas2d.corr_smooth2_rp(
        u2, f_rp, coarse, ny, nx, br, h, c, with_norm=True
    )
    corrx = pallas2d.x_interleave_coarse(coarse)
    rows_needed = pallas2d.corr_rows_needed(ny, br)
    corrx_rp = jnp.zeros((rows_needed, nxp), corrx.dtype)
    corrx_rp = corrx_rp.at[P : P + corrx.shape[0], :nx].set(corrx)
    L3, n3s = pallas2d.corr_smooth2_stk(
        L2, corrx_rp, ny, nx, br, h, c, with_norm=True
    )
    np.testing.assert_array_equal(I(u3), I(L3[0]))
    assert float(n3) == float(n3s)


def test_vcycle_stk_matches_vcycle_rp(rng, monkeypatch):
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=17)
    f = jnp.asarray(rng.random((n, n)))
    br = pallas2d.layout_br(n)
    total = pallas2d.padded_rows(n, br)
    nxp = pallas2d.padded_cols(n)
    f_rp = pallas2d.pad2d(f, br)
    I = lambda a: np.asarray(pallas2d.unpad2d(a, n, n))

    u_rp = jnp.zeros((total, nxp), f.dtype)
    L = jnp.zeros((2, total, nxp), f.dtype).at[1].set(f_rp)
    for cyc in range(2):
        u_rp, r_rp = multigrid.vcycle_rp(
            u_rp, f_rp, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=(cyc == 0)
        )
        L, r_stk = multigrid.vcycle_stk(
            L, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=(cyc == 0)
        )
        np.testing.assert_array_equal(I(u_rp), I(L[0]))
        assert float(r_rp) == float(r_stk)


def test_vcycle_stk_handoff_ignores_stale_plane0(rng):
    # the ds defect pass leaves the output's plane 0 UNSPECIFIED (the stale
    # previous correction); the small-grid jnp handoff with assume_zero_u
    # must not read it.  Simulate the staleness by poisoning plane 0.
    n = 129  # default PALLAS_MIN_AREA -> whole solve is the handoff branch
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=17)
    f = jnp.asarray(rng.random((n, n)))
    br = pallas2d.layout_br(n)
    total = pallas2d.padded_rows(n, br)
    nxp = pallas2d.padded_cols(n)
    I = lambda a: np.asarray(pallas2d.unpad2d(a, n, n))

    L_clean = jnp.zeros((2, total, nxp), f.dtype).at[1].set(pallas2d.pad2d(f, br))
    L_stale = L_clean.at[0].set(1e6 * jnp.ones((total, nxp), f.dtype))
    out_clean, r_clean = multigrid.vcycle_stk(
        L_clean, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=True
    )
    out_stale, r_stale = multigrid.vcycle_stk(
        L_stale, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=True
    )
    np.testing.assert_array_equal(I(out_clean), I(out_stale))
    assert float(r_clean) == float(r_stale)


@pytest.mark.parametrize("ns", [1, 3])
def test_stk_legs_deep_smoothing(rng, ns):
    # the fused legs take the smooth count as a parameter: ns sweeps
    # must equal ns composed smooth_rp calls (+ residual / + correction),
    # with the SAME r_rms estimate semantics (residual feeding the last
    # smooth) at every depth
    from fpr_tpu.ops import transfer

    ny, nx = 257, 129
    br = 64  # forces 5 blocks
    h, c = 1.0 / (ny - 1), 0.7
    total = pallas2d.padded_rows(ny, br)
    nxp = pallas2d.padded_cols(nx)
    f_rp = pallas2d.pad2d(jnp.asarray(rng.random((ny, nx))), br)
    u_rp = pallas2d.pad2d(jnp.asarray(rng.random((ny, nx))), br)
    I = lambda a: np.asarray(pallas2d.unpad2d(a, ny, nx))

    # downward leg: ns smooths + residual (+ restriction row pass)
    v = u_rp
    for _ in range(ns):
        v, _ = pallas2d.smooth_rp(v, f_rp, ny, nx, br, h, c, with_norm=False)
    res = pallas2d.residual_rp(v, f_rp, ny, nx, br, h, c)
    L = jnp.stack([u_rp, f_rp])
    L1, res_ps = pallas2d.smooth2r_stk(L, ny, nx, br, h, c, ns=ns)
    np.testing.assert_allclose(I(L1[0]), I(v), atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(transfer.restrict_ps(res_ps, ny, nx, br)),
        np.asarray(transfer.restrict(pallas2d.unpad2d(res, ny, nx))),
        atol=1e-14,
    )
    # the separate-operand (sharded-tier) leg at the same depth is
    # bitwise-equal to the stk leg
    u1s, res_ps_s = pallas2d.smooth2r_split_rp(
        u_rp, f_rp, ny, nx, br, h, c, ns=ns
    )
    np.testing.assert_array_equal(I(u1s), I(L1[0]))
    P8 = pallas2d.PAD
    tot = pallas2d.padded_rows(ny, br)
    np.testing.assert_array_equal(
        np.asarray(res_ps_s)[P8 : tot - P8],
        np.asarray(res_ps)[P8 : tot - P8],
    )

    # upward leg: correction + ns post-smooths, norm from the last sweep
    nyc, nxc = (ny - 1) // 2 + 1, (nx - 1) // 2 + 1
    coarse = jnp.asarray(rng.random((nyc, nxc)))
    corr_f = transfer.prolongate_rp(coarse, (ny, nx), u_rp.shape)
    w = L1[0] - corr_f
    r_ref = None
    for s in range(ns):
        w, r = pallas2d.smooth_rp(
            w, f_rp, ny, nx, br, h, c, with_norm=(s == ns - 1)
        )
        r_ref = r
    corrx = pallas2d.x_interleave_coarse(coarse)
    rows_needed = pallas2d.corr_rows_needed(ny, br)
    corrx_rp = jnp.zeros((rows_needed, nxp), corrx.dtype)
    corrx_rp = corrx_rp.at[pallas2d.PAD : pallas2d.PAD + corrx.shape[0], :nx].set(corrx)
    L2, r_got = pallas2d.corr_smooth2_stk(
        L1, corrx_rp, ny, nx, br, h, c, with_norm=True, ns=ns
    )
    np.testing.assert_allclose(I(L2[0]), I(w), atol=1e-14)
    assert abs(float(r_got) - float(r_ref)) < 1e-13
    u2s, r_got_s = pallas2d.corr_smooth2_rp(
        L1[0], f_rp, coarse, ny, nx, br, h, c, with_norm=True, ns=ns
    )
    np.testing.assert_array_equal(I(u2s), I(L2[0]))
    assert float(r_got_s) == float(r_got)


def test_vcycle_stk_deep_smoothing_matches_vcycle_rp(rng, monkeypatch):
    # V(3,3) end-to-end: the stk V-cycle with pre=post=3 equals vcycle_rp's
    # generic (unfused-loop) path at the same counts
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=17, pre_smooth=3, post_smooth=3)
    assert multigrid._stk_eligible(cfg)
    f = jnp.asarray(rng.random((n, n)))
    br = pallas2d.layout_br(n)
    total = pallas2d.padded_rows(n, br)
    nxp = pallas2d.padded_cols(n)
    f_rp = pallas2d.pad2d(f, br)
    I = lambda a: np.asarray(pallas2d.unpad2d(a, n, n))

    u_rp = jnp.zeros((total, nxp), f.dtype)
    L = jnp.zeros((2, total, nxp), f.dtype).at[1].set(f_rp)
    for cyc in range(2):
        u_rp, r_rp = multigrid.vcycle_rp(
            u_rp, f_rp, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=(cyc == 0)
        )
        L, r_stk = multigrid.vcycle_stk(
            L, n, n, h, 0.0, 1e-8, cfg, assume_zero_u=(cyc == 0)
        )
        np.testing.assert_allclose(I(u_rp), I(L[0]), atol=1e-13)
        assert abs(float(r_rp) - float(r_stk)) < 1e-13


def test_rp_iterate_path_keeps_reference_trajectory_with_bcs(rng, monkeypatch):
    """mg_solve_rp is an ITERATE solver ('same contract as mg_solve'), so
    unlike the ds/mixed correction cycles it must NOT pick up eliminated-BC
    smoothing from apply_bcs — on the cold weak-shift BC solve where both
    tiers stagnate, their trajectories must stay identical even with the
    elim default ON (the review scenario for the elim plumbing)."""
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    assert multigrid._ELIM_BC_SMOOTH  # the default stays on for this test
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    c = 50.0
    b = jnp.asarray(rng.random((ny, nx)))
    u_ref, _, it_ref = multigrid.mg_solve(
        jnp.zeros((ny, nx)), b, h, c, 1e-8, 12, apply_bcs=True
    )
    u_rp, _, it_rp = multigrid.mg_solve_rp(
        jnp.zeros((ny, nx)), b, h, c, 1e-8, 12, apply_bcs=True
    )
    assert int(it_rp) == int(it_ref)
    np.testing.assert_allclose(np.asarray(u_rp), np.asarray(u_ref), atol=1e-6)
