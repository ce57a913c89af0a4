"""Matrix-free Krylov solvers for (nabla^2 - c) x = b.

- ``cg``: unpreconditioned conjugate gradient (reference cg!,
  krylov.jl:55-91): textbook CG with the matrix-free 5-point matvec,
  convergence on ||r|| < tol * ||b||, starting from x = 0.  Runs fully
  on-device inside a lax.while_loop (the reference syncs a host reduction
  per iteration).
- ``mg_preconditioned_cg``: PCG with one multigrid V-cycle as the
  preconditioner M^-1 — a composition the reference does not have (it only
  benchmarks MG-as-solver vs CG-at-coarse-level, multigrid_bench.jl:27);
  this is the BASELINE north-star "MG-preconditioned CG" config.

Deviation from the reference, on purpose: the reference's matvec writes only
the interior of its output buffer, so the *boundary* of p_hat silently keeps
whatever the buffer held before (krylov.jl:59-68) — a latent stale-state
quirk that only stays benign because every real caller passes a rhs with a
zero boundary ring.  Our matvec returns an exact linear operator (zero
boundary); for zero-boundary rhs the iterates are bitwise the same
algorithm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fpr_tpu.core.config import ExecutionPolicy, MGConfig
from fpr_tpu.ops import stencil2d


def _matvec_for(policy: ExecutionPolicy):
    if policy == ExecutionPolicy.PALLAS:
        from fpr_tpu.ops import pallas2d

        return pallas2d.matvec
    return stencil2d.matvec


def cg(b, hx, hy, c, tol, nmax: int, policy=ExecutionPolicy.JNP):
    """Solve (nabla^2 - c) x = b from x=0.  Returns (x, r_rms, iters)."""
    matvec = _matvec_for(policy)
    normb = jnp.sqrt(jnp.sum(b * b))
    tolb = tol * normb

    def cond(carry):
        _, _, _, _, normr, i = carry
        return jnp.logical_and(i < nmax, normr >= tolb)

    def body(carry):
        x, r, p, rho, _, i = carry
        Ap = matvec(p, hx, hy, c)
        alpha = rho / jnp.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rho_new = jnp.sum(r * r)
        normr = jnp.sqrt(rho_new)
        beta = rho_new / rho
        p = r + beta * p
        return x, r, p, rho_new, normr, i + 1

    x0 = jnp.zeros_like(b)
    rho0 = jnp.sum(b * b)
    x, r, _, _, _, i = jax.lax.while_loop(
        cond,
        body,
        (x0, b, b, rho0, jnp.asarray(jnp.inf, b.dtype), jnp.asarray(0, jnp.int32)),
    )
    r_rms = jnp.sqrt(jnp.sum(r * r) / b.size)
    return x, r_rms, i


def mg_preconditioned_cg(
    b,
    h,
    c,
    tol,
    nmax: int,
    mg_cfg: MGConfig = MGConfig(),
    n_precond_cycles: int = 1,
):
    """Flexible PCG with z = M^-1 r approximated by V-cycle(s) from zero.

    Uses the Polak-Ribiere (flexible) beta, beta = z_new.(r_new - r_old) /
    z_old.r_old, because the V-cycle preconditioner is not exactly symmetric
    (injection restriction is not the adjoint of bilinear prolongation);
    flexible CG stays robust under non-symmetric/variable preconditioning
    where textbook PCG stalls.

    Returns (x, r_rms, iters).  Converges in a handful of iterations where
    unpreconditioned CG needs O(n) — see
    fpr_tpu/experiments/multigrid_bench.py's work-precision comparison.
    """
    from fpr_tpu.solvers.multigrid import vcycle

    matvec = _matvec_for(mg_cfg.policy)
    normb = jnp.sqrt(jnp.sum(b * b))
    tolb = tol * normb

    def precond(r):
        z = jnp.zeros_like(r)
        for _ in range(n_precond_cycles):
            z, _ = vcycle(z, r, h, c, tol, mg_cfg, apply_bcs=False)
        return z

    def cond(carry):
        _, _, _, _, normr, i = carry
        return jnp.logical_and(i < nmax, normr >= tolb)

    def body(carry):
        x, r, p, rz, _, i = carry
        Ap = matvec(p, h, h, c)
        alpha = rz / jnp.sum(p * Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        normr = jnp.sqrt(jnp.sum(r_new * r_new))
        z_new = precond(r_new)
        rz_new = jnp.sum(r_new * z_new)
        beta = jnp.sum(z_new * (r_new - r)) / rz  # Polak-Ribiere
        p = z_new + beta * p
        return x, r_new, p, rz_new, normr, i + 1

    x0 = jnp.zeros_like(b)
    z0 = precond(b)
    rz0 = jnp.sum(b * z0)
    x, r, _, _, _, i = jax.lax.while_loop(
        cond,
        body,
        (x0, b, z0, rz0, jnp.asarray(jnp.inf, b.dtype), jnp.asarray(0, jnp.int32)),
    )
    r_rms = jnp.sqrt(jnp.sum(r * r) / b.size)
    return x, r_rms, i


# ---------------------------------------------------------------------------
# Production-tier MG-PCG: double-single accuracy, fused-leg V-cycle
# preconditioner, true-residual replacement — the BASELINE north-star
# composition at the framework's fastest tier (the f64 version above is a
# correctness reference).
# ---------------------------------------------------------------------------


def mg_pcg_ds(
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    cfg: MGConfig = MGConfig(),
    return_pair: bool = False,
    dots: str = "rowsum64",
):
    """Flexible (Polak-Ribiere) CG on (nabla^2 - c) u = f, preconditioned
    by one stacked fused-leg V-cycle, with the iterate in double-single
    (~48-bit) precision and TRUE-residual replacement:

    - z = M^-1 r is ``vcycle_stk`` from zero (the same fused legs as
      ``mg_solve_ds``; falls back to ``vcycle_rp`` for non-stk configs);
    - the curvature p.Ap comes from the cancellation-free gradient form
      (dots='rowsum64', the default) or the plain interior dot
      ``pallas2d.matvec_dot_rp``;
    - instead of the f32 recurrence r -= alpha*Ap (whose rounding floor
      eps*8|u|/h^2 sits far above tol*rms(f) on fine grids), each step
      folds alpha*p into the ds iterate and re-evaluates the residual at
      ~48 bits in ONE fused pass (``ds.defect_pass`` with
      scale = -alpha) — the returned norm is the true defect, so
      convergence is judged on exactly the same quantity as
      ``mg_solve_ds``;
    - beta is flexible Polak-Ribiere, beta = z_new.(r_new - r_old) /
      (z_old.r_old), because the injection/bilinear V-cycle is not
      symmetric (see ``mg_preconditioned_cg``).

    Zero initial guess (as the reference cg!, krylov.jl:62).  Returns
    (u, r_rms, iters); with return_pair the hi/lo f32 pair.

    Reference provenance: composes cg! (krylov.jl:55-91) with the V-cycle
    (multigrid.jl:91-170) — a configuration the reference benchmarks only
    as MG-alone vs CG-at-coarse-level (multigrid_bench.jl:27).

    Iteration counts (DST-513/V(5,5) ladder, tol 1e-6, docs/part2.md): at
    k <= 12 this PCG matches the f64 solver's count (4 at 4097^2, same as
    ds-MG's outer count) but does more work per iteration for the
    dots/axpys.  At k >= 13 Krylov acceleration COLLAPSES (11 iterations
    at 8193^2 vs the f64 solver's 3): the f32 V-cycle preconditioner
    evaluates its internal residuals at the eps*8n^2/h^2 cancellation
    floor, so M becomes a noisy operator and CG's two-term recurrence
    loses conjugacy — while defect-correction MG is immune by
    construction (every outer consumes the TRUE ~48-bit defect).  That is
    why the framework's production solver is mg_solve_ds rather than
    PCG.
    """
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import pallas2d
    from fpr_tpu.solvers.multigrid import _stk_eligible, vcycle_rp, vcycle_stk

    f32 = jnp.float32
    ny, nx = f.shape
    br = pallas2d.layout_br(ny)
    total = pallas2d.padded_rows(ny, br)
    nxp = pallas2d.padded_cols(nx)

    if f.dtype == jnp.float64:
        hi, lo = dsm.to_ds(f)
        f_ds = jnp.stack([pallas2d.pad2d(hi, br), pallas2d.pad2d(lo, br)])
    else:
        f_ds = pallas2d.pad2d(f.astype(f32), br)[None]
    f_rms = stencil2d.rms(f)
    tolf = jnp.asarray(tol * f_rms, f32)
    stk = _stk_eligible(cfg)

    def precond(r_rp):
        if stk:
            L = jnp.zeros((2, total, nxp), f32).at[1].set(r_rp)
            L, _ = vcycle_stk(L, ny, nx, h, c, tol, cfg, assume_zero_u=True)
            return L[0]
        z, _ = vcycle_rp(
            jnp.zeros((total, nxp), f32), r_rp, ny, nx, h, c, tol, cfg,
            assume_zero_u=True,
        )
        return z

    u_ds = jnp.zeros((2, total, nxp), f32)
    r0 = -f_ds[0]  # zero guess: r = A*0 - f (hi part; |lo| is below f32)

    def cond(carry):
        _, _, _, _, _, r_rms, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    PAD = pallas2d.PAD

    def dot(a, b):
        """Interior dot of two rp planes, restricted to the physical rows
        (the ghost rows are unspecified, and 0 * garbage would poison a
        whole-array sum).

        The CG dots z.r and p.Ap carry heavy sign cancellation (z is a
        smoothed copy of a rough r; A is definite but the ELEMENTWISE
        products alternate), so a flat f32 sum over 16M cells loses
        enough digits at k >= 12 to double the iteration count
        (measured: 8 vs the f64 solver's 3).  dots='rowsum64' sums each
        row in f32 (<= ~8k elements) and the ~ny row partials in f64 —
        two cheap fused passes, restoring f64-solver iteration counts."""
        ap = a[PAD : PAD + ny]
        bp = b[PAD : PAD + ny]
        if dots == "rowsum64":
            rows = jnp.sum(ap * bp, axis=1)
            return jnp.sum(rows.astype(jnp.float64)).astype(f32)
        return jnp.sum(ap * bp)

    def curvature(p):
        """p.Ap without forming Ap.  Forming Ap = (sum of neighbors -
        C p)/h^2 pointwise on the SMOOTH search direction p cancels
        catastrophically in f32 (relative error ~ eps*8*n^2/pi^2 — order
        ONE at k >= 11; measured: the plain-dot PCG stalls at ~0.2
        contraction/iter on 2049^2+ while the f64 solver does 3 iters).
        The quadratic form has an exactly equivalent gradient form with
        only same-sign terms:

            p.Ap = -( sum (dx p)^2 + sum (dy p)^2 ) / h^2 - c sum p^2

        for our A = (nabla^2 - c) with p zero on the boundary ring (the
        V-cycle guarantees it; dead rows/lanes are sliced away), which is
        cancellation-FREE and needs no extra precision."""
        pp = p[PAD : PAD + ny, :nx]
        ddx = pp[:, 1:] - pp[:, :-1]
        ddy = pp[1:, :] - pp[:-1, :]

        def s64(v):
            rows = jnp.sum(v * v, axis=1)
            return jnp.sum(rows.astype(jnp.float64)).astype(f32)

        quad = (s64(ddx) + s64(ddy)) * jnp.asarray(1.0 / (h * h), f32)
        if isinstance(c, (int, float)) and float(c) == 0.0:
            return -quad
        return -(quad + jnp.asarray(c, f32) * s64(pp))

    def body(carry):
        u_ds, r, r_old, p, rz_old, _, it = carry
        z = precond(r)
        s1 = dot(z, r)
        s2 = dot(z, r_old)
        beta = (s1 - s2) / rz_old
        p = z + beta * p
        if dots == "rowsum64":
            pAp = curvature(p)
        else:
            pAp = pallas2d.matvec_dot_rp(p, ny, nx, br, h, c)
        alpha = s1 / pAp
        # sign care: this framework's residual convention is r = A u - f
        # (the NEGATED textbook r), so z, p carry the negated directions
        # and the textbook update x += alpha*p_std becomes u -= alpha*p —
        # which is the defect kernel's native u' = u - scale*e with
        # scale = +alpha (all of CG's scalars are products of two negated
        # quantities and keep their textbook values)
        u_ds, r_new, r_rms = dsm.defect_pass(
            u_ds, f_ds, p, alpha, ny, nx, br, h, c
        )
        return u_ds, r_new, r, p, s1, r_rms, it + 1

    # r_old = r0 makes the first beta exactly 0 (s1 == s2) with p = 0, so
    # the first direction is p = z as in textbook PCG; rz_old's initial
    # value is then never consumed (multiplied into beta * p = 0)
    u_ds, _, _, _, _, r_rms, it = jax.lax.while_loop(
        cond,
        body,
        (
            u_ds, r0, r0, jnp.zeros((total, nxp), f32),
            jnp.asarray(1.0, f32), f_rms.astype(f32),
            jnp.asarray(0, jnp.int32),
        ),
    )
    from fpr_tpu.solvers.multigrid import _warn_unconverged

    _warn_unconverged("mg_pcg_ds", r_rms, tolf, it, niters)
    hi = pallas2d.unpad2d(u_ds[0], ny, nx)
    lo = pallas2d.unpad2d(u_ds[1], ny, nx)
    if return_pair:
        return (hi, lo), r_rms, it
    return dsm.from_ds(hi, lo, dtype=f.dtype), r_rms.astype(f.dtype), it


@functools.partial(
    jax.jit,
    static_argnames=("h", "tol", "niters", "cfg", "return_pair", "dots"),
)
def mg_pcg_ds_jit(f, h, c, tol, niters, cfg=MGConfig(), return_pair=False,
                  dots="rowsum64"):
    """Jitted zero-initial-guess mg_pcg_ds (the benchmark entry point)."""
    return mg_pcg_ds(
        f, h, c, tol, niters, cfg=cfg, return_pair=return_pair, dots=dots
    )
