"""Double-single (two-f32) arithmetic and the fused defect pass
(fpr_tpu.ops.ds): error-free transforms, residual parity vs the f64
oracle, and the all-f32 defect-correction solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.ops import ds as dsm
from fpr_tpu.ops import pallas2d, stencil2d
from fpr_tpu.solvers import multigrid


def test_eft_exactness(rng):
    """two_sum and two_prod must be EXACT (s + err == a + b in f64) — this
    also guards against the compiler reassociating/fusing the transforms."""
    a = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    b = jnp.asarray(rng.standard_normal(4096) * 1e-3, jnp.float32)

    s, e = jax.jit(dsm.two_sum)(a, b)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    ref = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(got, ref)

    p, e = jax.jit(dsm.two_prod)(a, b)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    ref = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(got, ref)


def test_ds_roundtrip(rng):
    x = jnp.asarray(rng.standard_normal((33, 65)))
    hi, lo = dsm.to_ds(x)
    assert float(jnp.abs(dsm.from_ds(hi, lo) - x).max()) < 1e-14
    # lo really extends the mantissa
    assert float(jnp.abs(x - hi.astype(jnp.float64)).max()) > 1e-9


@pytest.mark.parametrize("c", [0.0, 3.14])
@pytest.mark.parametrize("shape", [(33, 65), (65, 257)])
def test_defect_pass_matches_f64_residual(rng, shape, c):
    ny, nx = shape
    h = 1.0 / 64  # power-of-two 1/h^2 required
    u = jnp.asarray(rng.standard_normal(shape))
    f = jnp.asarray(rng.standard_normal(shape))
    br = pallas2d.layout_br(ny)

    def pack(a):
        hi, lo = dsm.to_ds(a)
        return jnp.stack([pallas2d.pad2d(hi, br), pallas2d.pad2d(lo, br)])

    e = jnp.zeros(
        (pallas2d.padded_rows(ny, br), pallas2d.padded_cols(nx)), jnp.float32
    )
    u_out, r32, r_rms = dsm.defect_pass(pack(u), pack(f), e, 0.0, ny, nx, br, h, c)

    ref = np.asarray(stencil2d.residual(u, f, h, c))  # f64, zero boundary
    got = np.asarray(pallas2d.unpad2d(r32, ny, nx), np.float64)
    # error model: the f32 OUTPUT representation costs eps_f32 * |r| per
    # value (r32 is f32 by contract); the ds evaluation itself carries the
    # ~2^-48 floor relative to the stencil scale |u|/h^2 — that floor is
    # what lets the defect correction converge to 1e-6 * rms(f) and is
    # what this bound pins down
    scale = np.abs(u).max() / h**2
    err = np.abs(got - ref)
    bound = 1.3e-7 * np.abs(ref) + 5e-13 * scale
    assert (err <= bound).all(), float((err - bound).max())
    ref_rms = np.sqrt((ref**2).mean())
    assert abs(float(r_rms) - ref_rms) < 1e-5 * ref_rms + 5e-13 * scale

    # u unchanged by a scale-0 update (up to the ~2e-15 ds representation
    # error of the entry round-trip)
    u_back = dsm.from_ds(
        pallas2d.unpad2d(u_out[0], ny, nx), pallas2d.unpad2d(u_out[1], ny, nx)
    )
    np.testing.assert_allclose(np.asarray(u_back), np.asarray(u), atol=1e-14)


def test_defect_pass_update(rng):
    ny, nx = 65, 129
    h = 1.0 / 64
    c = 1.5
    u = jnp.asarray(rng.standard_normal((ny, nx)))
    f = jnp.asarray(rng.standard_normal((ny, nx)))
    e64 = rng.standard_normal((ny, nx))
    e64[0] = e64[-1] = 0.0
    e64[:, 0] = e64[:, -1] = 0.0
    e = jnp.asarray(e64, jnp.float32)
    scale = 0.375  # exactly representable in f32 (the pass takes an f32 scale)
    br = pallas2d.layout_br(ny)

    def pack(a):
        hi, lo = dsm.to_ds(a)
        return jnp.stack([pallas2d.pad2d(hi, br), pallas2d.pad2d(lo, br)])

    u_out, r32, _ = dsm.defect_pass(
        pack(u), pack(f), pallas2d.pad2d(e, br), scale, ny, nx, br, h, c
    )
    u_ref = u - scale * e.astype(jnp.float64)
    got = dsm.from_ds(
        pallas2d.unpad2d(u_out[0], ny, nx), pallas2d.unpad2d(u_out[1], ny, nx)
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(u_ref), atol=2e-14)
    ref_r = np.asarray(stencil2d.residual(u_ref, f, h, c))
    scale_r = np.abs(np.asarray(u_ref)).max() / h**2
    got_r = np.asarray(pallas2d.unpad2d(r32, ny, nx), np.float64)
    err = np.abs(got_r - ref_r)
    assert (err <= 1.3e-7 * np.abs(ref_r) + 5e-13 * scale_r).all()


def test_mg_solve_ds_converges(rng, monkeypatch):
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    xref = np.zeros((n, n))
    xref[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    from fpr_tpu.ops import oracle

    A = oracle.helmholtz_operator(n - 2, n - 2, h, 0.0)
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = (A @ xref[1:-1, 1:-1].ravel()).reshape(n - 2, n - 2)
    bj = jnp.asarray(b)
    u, r, it = multigrid.mg_solve_ds(jnp.zeros((n, n)), bj, h, 0.0, 1e-8, 40)
    f_rms = np.sqrt((b**2).mean())
    assert float(r) < 1e-8 * f_rms
    rel = np.linalg.norm(np.asarray(u) - xref) / np.linalg.norm(xref)
    assert rel < 1e-6
    assert int(it) <= 20
    # the reported norm is the TRUE defect of the returned iterate
    res = np.asarray(stencil2d.residual(u, bj, h, 0.0))
    true_rms = np.sqrt((res**2).mean())
    assert abs(true_rms - float(r)) < 0.05 * true_rms + 1e-9 * f_rms

    # u0=None (zero-init fast path) gives the identical solve
    u2, r2, it2 = multigrid.mg_solve_ds(None, bj, h, 0.0, 1e-8, 40)
    assert int(it2) == int(it)
    np.testing.assert_array_equal(np.asarray(u2), np.asarray(u))


def test_mg_solve_ds_with_bcs_matches_mixed(rng, monkeypatch):
    """apply_bcs path (NS temperature BCs in the defect pass) converges to the same
    BC-constrained solution as mg_solve_mixed — the NS T-solve shape."""
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    # the NS semi-implicit regime: c = 1/(beta dt) is large, so the
    # Helmholtz solve is strongly diagonally dominant (mild shifts excite a
    # slowly-converging Neumann-column boundary mode in BOTH the mixed and
    # ds defect loops — same trajectory, an inherited property of the
    # reference's Dirichlet-correction V-cycle, not a ds defect)
    c = 2.0e4
    b = jnp.asarray(rng.random((ny, nx)) * c)
    u0 = jnp.asarray(rng.random((ny, nx)))
    u_ref, r_ref, _ = multigrid.mg_solve_mixed(
        u0, b, h, c, 1e-8, 40, apply_bcs=True
    )
    u_ds, r_ds, it = multigrid.mg_solve_ds(
        u0, b, h, c, 1e-8, 40, apply_bcs=True
    )
    f_rms = float(jnp.sqrt(jnp.mean(b * b)))
    assert float(r_ds) < 1e-8 * f_rms
    np.testing.assert_allclose(np.asarray(u_ds), np.asarray(u_ref), atol=1e-6)
    # the BCs really are enforced on the returned iterate
    got = np.asarray(u_ds)
    np.testing.assert_allclose(got[0, 1:-1], 1.0, atol=1e-12)
    np.testing.assert_allclose(got[-1, 1:-1], 0.0, atol=1e-12)
    np.testing.assert_allclose(got[:, 0], got[:, 1], atol=1e-12)
    np.testing.assert_allclose(got[:, -1], got[:, -2], atol=1e-12)


def test_mg_solve_ds_traced_c_and_f_single(rng, monkeypatch):
    """Runtime f32 Helmholtz shift (the NS c = 1/(beta dt) path) + the
    single-plane rhs: must converge to the Python-scalar-c, two-plane
    answer."""
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    ny, nx = 129, 129
    h = 1.0 / (ny - 1)
    c = 37.5  # exactly representable in f32: traced and static agree
    b32 = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    b = b32.astype(jnp.float64)

    u_ref, r_ref, it_ref = multigrid.mg_solve_ds(None, b, h, c, 1e-7, 40)

    from fpr_tpu.ops import pallas2d

    br = pallas2d.layout_br(ny)
    f_ds = pallas2d.pad2d(b32, br)[None]  # (1, total, nxp) single-plane rhs
    f_rms = float(jnp.sqrt(jnp.mean(b * b)))
    u_ds, r_rms, it = multigrid.mg_solve_ds_rp(
        None, f_ds, 1e-7 * f_rms, ny, nx, h,
        jnp.asarray(c, jnp.float32), 40,
    )
    assert float(r_rms) < 1e-7 * f_rms
    got = np.asarray(
        pallas2d.unpad2d(u_ds[0], ny, nx), np.float64
    ) + np.asarray(pallas2d.unpad2d(u_ds[1], ny, nx), np.float64)
    np.testing.assert_allclose(got, np.asarray(u_ref), atol=2e-7 * f_rms)


def test_mg_solve_ds_warm_start(rng, monkeypatch):
    """Warm-starting from a converged iterate must exit immediately-ish and
    keep the solution (the NS stream-function solve pattern)."""
    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    h = 1.0 / (n - 1)
    b = jnp.asarray(rng.random((n, n)))
    u1, r1, it1 = multigrid.mg_solve_ds(None, b, h, 0.0, 1e-7, 40)
    u2, r2, it2 = multigrid.mg_solve_ds(u1, b, h, 0.0, 1e-7, 40)
    assert int(it2) == 0  # already below tolerance: no outer iterations
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1), atol=1e-12)


def test_ds3d_dual_time_matches_f64(rng):
    """The double-single 3D dual-time tier must track the f64 jnp solve to
    ~1e-10 at a tolerance far below the f32 floor (the part-1
    error-vs-tolerance regime, part1_error_vs_tolerance_experiments.jl)."""
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.models import diffusion3d

    base = dict(nx=32, ny=32, nz=32, ttot=0.4, tol=1e-9)
    ref = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.JNP, **base), dtype=jnp.float64
    )
    got = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.PALLAS_DS, **base)
    )
    assert got.converged
    # identical iteration counts: the ds iteration reproduces the f64
    # residual trajectory well below the 1e-9 stopping threshold
    assert got.iters_total == ref.iters_total
    np.testing.assert_allclose(got.H, ref.H, atol=2e-10)


def test_defect_pass_extras(rng):
    """velocity_max and field_sumsq accumulators must match the XLA
    computations they replace in the NS fast loop."""
    ny, nx = 65, 129
    h = 1.0 / 64
    u = jnp.asarray(rng.standard_normal((ny, nx)))
    f = jnp.asarray(rng.standard_normal((ny, nx)))
    br = pallas2d.layout_br(ny)

    def pack(a):
        hi, lo = dsm.to_ds(a)
        return jnp.stack([pallas2d.pad2d(hi, br), pallas2d.pad2d(lo, br)])

    e = jnp.zeros(
        (pallas2d.padded_rows(ny, br), pallas2d.padded_cols(nx)), jnp.float32
    )
    u_out, r32, r_rms, (ax, ay, ss) = dsm.defect_pass(
        pack(u), pack(f), e, 0.0, ny, nx, br, h, 0.0,
        velocity_max=True, field_sumsq=True,
    )
    uh = np.asarray(u, np.float32)
    inv2h = np.float32(0.5 / h)
    vx = np.abs((uh[2:, 1:-1] - uh[:-2, 1:-1]) * inv2h)
    vy = np.abs((uh[1:-1, 2:] - uh[1:-1, :-2]) * inv2h)
    assert float(ax) == pytest.approx(float(vx.max()), rel=1e-6)
    assert float(ay) == pytest.approx(float(vy.max()), rel=1e-6)
    assert float(ss) == pytest.approx(float((uh.astype(np.float64) ** 2).sum()), rel=1e-5)


def test_mg_solve_ds_fmg(rng, monkeypatch):
    # FMG preamble: same tolerance, fewer (or equal) outer iterations,
    # solution agreeing with the plain path at the tolerance level
    from fpr_tpu.core.config import MGConfig

    monkeypatch.setattr(multigrid, "PALLAS_MIN_AREA", 65 * 65)
    n = 257
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=17)
    b = jnp.zeros((n, n), jnp.float32).at[1:-1, 1:-1].set(
        jnp.asarray(rng.standard_normal((n - 2, n - 2)), jnp.float32)
    )
    u0, r0, i0 = multigrid.mg_solve_ds(None, b, h, 0.0, 1e-6, 30)
    u1, r1, i1 = multigrid.mg_solve_ds(None, b, h, 0.0, 1e-6, 30, fmg=True)
    f_rms = float(jnp.sqrt(jnp.mean(b.astype(jnp.float64) ** 2)))
    assert float(r1) < 1e-6 * f_rms
    assert int(i1) <= int(i0)
    rel = float(
        jnp.linalg.norm((u1 - u0).astype(jnp.float64))
        / jnp.linalg.norm(u0.astype(jnp.float64))
    )
    assert rel < 1e-4
