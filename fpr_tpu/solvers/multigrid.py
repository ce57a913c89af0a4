"""Matrix-free geometric multigrid for (nabla^2 - c) u = f on 2^k+1 grids.

A re-design of the reference's recursive V-cycle
(MGsolve_2DPoisson! / Vcycle_2DPoisson!, multigrid.jl:41-170):

- The level count is static given the fine shape, so the V-cycle recursion
  is **unrolled at trace time** — no runtime recursion, no per-cycle buffer
  reallocation (the reference reallocates coarse buffers every cycle because
  the prealloc dict is not passed down, multigrid.jl:105-107; functional JAX
  removes the buffer bookkeeping entirely).
- The outer iterate-to-tolerance loop is a ``lax.while_loop`` with the
  residual check **on device** — the reference syncs device->host for a norm
  after every smooth (multigrid.jl:252); we compute a norm only where the
  algorithm consumes one (final fine-level post-smooth and the coarse-solve
  early exit).
- Smoothing is damped Jacobi with alpha = 4/5 (multigrid.jl:242-258), or
  red-black Gauss-Seidel (two masked half-sweeps; the data-parallel form
  of the reference's serial GS, multigrid.jl:269-297).
- Restriction/prolongation are the injection / gather-form-bilinear pair of
  fpr_tpu.ops.transfer.
- Coarse solve: <= 20*coarse_size damped-Jacobi iterations with early exit,
  or matrix-free CG (multigrid.jl:147-162).

Semantics parity notes: 2 pre- + 2 post-smooths; the correction is
*subtracted* (residual is defined as A u - f, multigrid.jl:139); convergence
is r_rms < tol * rms(f) where rms averages over the full grid including the
zero boundary ring (multigrid.jl:53-56); with apply_bcs the full
Dirichlet+Neumann BCs are applied to u at the top of every MG iteration and
the Neumann copy is applied to every transfer (multigrid.jl:60-62, 129, 136).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fpr_tpu.core import bc
from fpr_tpu.core.config import (
    CoarseSolver,
    ExecutionPolicy,
    MGConfig,
    Restriction,
    Smoother,
)
from fpr_tpu.core.grid import mg_levels
from fpr_tpu.ops import stencil2d


def _warn_unconverged(solver: str, r_rms, tolf, it, niters: int,
                      apply_bcs: bool = False):
    """Emit a runtime warning when an outer MG loop exits at ``niters``
    still above tolerance (the reference warns in the same situation,
    multigrid.jl:78-80 "Couldn't converge...").

    The one systematic way to hit this is a COLD, weakly-shifted solve
    with apply_bcs=True: the correction V-cycles smooth the side columns
    as zero-Dirichlet while the true correction satisfies Neumann there
    (only the transfers apply the copies), degrading the contraction to
    ~0.75/cycle — verified reference-semantics behavior (the f64
    mg_solve with per-iteration BC application stagnates identically),
    see docs/part2.md.  The NS solves (strong Helmholtz shifts + warm
    starts) never hit it.  jax.debug.print works under jit; the check is
    data-dependent so it costs one predicated callback, nothing when
    converged.
    """
    hint = (
        " (known cold-BC stagnation: the jnp-tier iterate cycle smooths "
        "the Neumann side columns as Dirichlet-0 — reference-parity "
        "behavior; the ds/rp correction cycles avoid it via eliminated-BC "
        "smoothing (_ELIM_BC_SMOOTH), see mg_solve_ds_rp's docstring)"
        if apply_bcs else ""
    )
    jax.lax.cond(
        jnp.logical_and(it >= niters, r_rms >= tolf),
        lambda ops: jax.debug.print(
            "WARNING: " + solver + " exited at niters={n} with r_rms "
            "{r:.3e} >= tol*rms(f) {t:.3e} — NOT converged" + hint,
            n=niters, r=ops[0], t=ops[1],
        ),
        lambda ops: None,
        (r_rms.astype(jnp.float32), jnp.asarray(tolf, jnp.float32)),
    )


def _smooth_fns(cfg: MGConfig):
    """Resolve (jacobi-or-GS smoother, residual) for the configured policy."""
    if cfg.policy == ExecutionPolicy.PALLAS:
        from fpr_tpu.ops import pallas2d

        residual = pallas2d.residual
        jacobi = pallas2d.jacobi_step
    else:
        residual = stencil2d.residual
        jacobi = stencil2d.jacobi_step

    if cfg.smoother == Smoother.RED_BLACK_GS:
        def smooth(u, f, h, c, with_norm):
            return stencil2d.red_black_gs_step(u, f, h, c, with_norm=with_norm)
    else:
        def smooth(u, f, h, c, with_norm):
            return jacobi(u, f, h, c, alpha=cfg.jacobi_damping, with_norm=with_norm)

    return smooth, residual


def _coarse_solve(u, f, h, c, tol, cfg: MGConfig, smooth):
    """Direct-ish coarse solve (multigrid.jl:145-166)."""
    max_iters = 20 * cfg.coarse_size
    if cfg.coarse_solver == CoarseSolver.DST:
        from fpr_tpu.solvers.dst import dst_solve

        return dst_solve(u, f, h, c)
    if cfg.coarse_solver == CoarseSolver.CG:
        from fpr_tpu.solvers.krylov import cg

        x, r_rms, _ = cg(f, h, h, c, tol, max_iters, policy=cfg.policy)
        # reference cg! OVERWRITES u with the from-zero solution
        # (krylov.jl:62,88) — the incoming iterate is discarded (it is zero
        # on every coarse-correction level anyway)
        return x, r_rms

    tol_rhs = tol * stencil2d.rms(f)

    def cond(carry):
        _, r_rms, i = carry
        return jnp.logical_and(i < max_iters, r_rms >= tol_rhs)

    def body(carry):
        u, _, i = carry
        u, r_rms = smooth(u, f, h, c, True)
        return u, r_rms, i + 1

    u, r_rms, _ = jax.lax.while_loop(
        cond, body, (u, jnp.asarray(jnp.inf, u.dtype), jnp.asarray(0, jnp.int32))
    )
    return u, r_rms


def vcycle(u, f, h, c, tol, cfg: MGConfig, apply_bcs: bool = False,
           constrain=None, elim: bool = False):
    """One V-cycle; returns (u, r_rms of the final fine-level smooth).

    Unrolled at trace time over the static level ladder.

    constrain: optional trace-time hook ``constrain(array) -> array``
    applied to every level's working arrays — the distributed solver
    (fpr_tpu.solvers.dist_multigrid) injects per-level GSPMD sharding
    constraints through it; None is a no-op.

    elim: eliminated-BC smoothing (side columns copied from their interior
    neighbor after every sweep — see _ELIM_BC_SMOOTH).  Set ONLY by the
    small-level subtree handoffs of the ds/rp correction cycles so the jnp
    subtree relaxes the same side-constrained operator as the fused legs
    above it; the direct mg_solve iterate path keeps reference semantics.
    """
    from fpr_tpu.ops import transfer

    smooth0, residual = _smooth_fns(cfg)
    if elim:
        def smooth(u, f, h, c, with_norm):
            u, r = smooth0(u, f, h, c, with_norm)
            u = u.at[:, 0].set(u[:, 1]).at[:, -1].set(u[:, -2])
            return u, r
    else:
        smooth = smooth0
    ny, nx = u.shape
    levels = mg_levels(nx, ny, cfg.coarse_size)  # validates 2^k+1 sides
    restrict = (
        transfer.restrict_full_weighting
        if cfg.resolved_restriction() is Restriction.FULL_WEIGHTING
        else transfer.restrict
    )
    con = constrain if constrain is not None else (lambda a: a)

    def descend(u, f, h, depth):
        nyl, nxl = u.shape
        top = depth == 0
        if min(nxl, nyl) <= cfg.coarse_size:
            return _coarse_solve(u, f, h, c, tol, cfg, smooth)

        # pre-smooth (norms unused -> skipped)
        for _ in range(cfg.pre_smooth):
            u, _ = smooth(u, f, h, c, False)

        # restrict residual
        res = residual(u, f, h, c)
        res_c = con(restrict(res, apply_bcs=apply_bcs))

        # coarse correction (zero initial guess), recursive
        corr_c = jnp.zeros_like(res_c)
        corr_c, _ = descend(corr_c, res_c, h * 2.0, depth + 1)

        # prolongate and correct (subtract: res = A u - f)
        corr_f = con(transfer.prolongate(corr_c, u.shape, apply_bcs=apply_bcs))
        u = u - corr_f

        # post-smooth; measure the norm only on the top level's last smooth
        r_rms = None
        for s in range(cfg.post_smooth):
            want = top and (s == cfg.post_smooth - 1)
            u, r = smooth(u, f, h, c, want)
            if want:
                r_rms = r
        return u, r_rms

    assert len(levels) >= 1
    return descend(u, f, h, 0)


def mg_solve(
    u0,
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    apply_bcs: bool = False,
    cfg: MGConfig = MGConfig(),
    constrain=None,
):
    """Iterate V-cycles until r_rms < tol * rms(f) (MGsolve_2DPoisson!,
    multigrid.jl:41-84).  Returns (u, r_rms, iterations).

    Fully jit-compatible; the convergence loop is a lax.while_loop carrying
    (u, r_rms, iter) with no host syncs.  ``constrain`` (see ``vcycle``)
    threads per-level GSPMD sharding hints through for the distributed
    solver.
    """
    con = constrain if constrain is not None else (lambda a: a)
    f_rms = stencil2d.rms(f)
    tolf = tol * f_rms

    def cond(carry):
        _, r_rms, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    def body(carry):
        u, _, it = carry
        if apply_bcs:
            u = bc.ns_temperature_bcs(u)
        u, r_rms = vcycle(
            u, f, h, c, tol, cfg, apply_bcs=apply_bcs, constrain=constrain
        )
        return con(u), r_rms, it + 1

    u, r_rms, it = jax.lax.while_loop(
        cond,
        body,
        (u0, jnp.asarray(jnp.inf, u0.dtype), jnp.asarray(0, jnp.int32)),
    )
    _warn_unconverged("mg_solve", r_rms, tolf, it, niters, apply_bcs)
    return u, r_rms, it


@functools.partial(jax.jit, static_argnames=("h", "tol", "niters", "apply_bcs", "cfg"))
def mg_solve_jit(u0, f, h, c, tol, niters, apply_bcs=False, cfg=MGConfig()):
    return mg_solve(u0, f, h, c, tol, niters, apply_bcs=apply_bcs, cfg=cfg)


# ---------------------------------------------------------------------------
# row-padded V-cycle with the fused legs (fpr_tpu.ops.pallas2d)
# ---------------------------------------------------------------------------

# below this cell count a level drops to the jnp tier (the small levels
# cost dispatch, not arithmetic, and each extra fused level adds variants
# to compile); area-based so wide NS rectangles (e.g. 513 x 2049) still
# take the fused legs
PALLAS_MIN_AREA = 1024 * 1024

# Eliminated-BC smoothing for apply_bcs correction cycles (round 5): the
# fused legs copy the Neumann side columns from their interior neighbor
# after EVERY Jacobi sweep, so the cycle relaxes the same side-constrained
# operator the outer defect measures.  Without it the correction cycle
# smooths the sides as Dirichlet-0 and the BC contraction degrades to
# ~0.75/cycle (the documented cold-BC stagnation; on the NS semi path the
# warm T Helmholtz solve took 16 outer defect iterations vs 10 with
# elimination under the production DST-257 ladder — 7 in the
# full-recursion CPU probe, flat 0.09 contraction).  Preconditioner-only:
# the true defect pass and the converged solution contract are untouched;
# reference cycles (multigrid.jl) apply BCs only in the transfers, exactly
# our elim=False behavior.
_ELIM_BC_SMOOTH = True


def _elim(apply_bcs: bool) -> bool:
    return bool(apply_bcs and _ELIM_BC_SMOOTH)


def vcycle_rp(u_rp, f_rp, ny, nx, h, c, tol, cfg: MGConfig, apply_bcs=False,
              assume_zero_u=False, elim=False):
    """One V-cycle on row-padded operands with the fused legs at large
    levels, handing the subtree below PALLAS_MIN_AREA to the jnp tier.

    Semantics identical to ``vcycle`` (Jacobi smoother only).
    assume_zero_u: caller guarantees u_rp == 0 (defect-correction top
    levels; always true for the recursive coarse corrections) — the
    downward leg then skips the u stream entirely, bitwise-identically.
    elim: eliminated-BC smoothing on every leg and the jnp subtree (see
    _ELIM_BC_SMOOTH) — set by CORRECTION-cycle callers only
    (mg_solve_ds_rp / mg_solve_mixed pass _elim(apply_bcs)); the iterate
    path (mg_solve_rp) keeps reference trajectory semantics.
    Returns (u_rp', r_rms of the final fine-level smooth).
    """
    from fpr_tpu.ops import pallas2d, transfer

    # the fused legs implement the damped-Jacobi smoother; other
    # smoothers take the jnp tier at every level.  A level at or below the
    # coarse size (possible with the large-coarse DST configs) is the
    # coarse solve itself — also a jnp-tier handoff.
    if (
        cfg.smoother is not Smoother.JACOBI
        or ny * nx < PALLAS_MIN_AREA
        or min(ny, nx) <= cfg.coarse_size
    ):
        import dataclasses

        u = pallas2d.unpad2d(u_rp, ny, nx)
        f = pallas2d.unpad2d(f_rp, ny, nx)
        # pin the small-level subtree to the jnp tier (pad-per-call
        # drop-ins would dominate at these sizes)
        sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
        u, r_rms = vcycle(u, f, h, c, tol, sub_cfg, apply_bcs=apply_bcs,
                          elim=elim)
        return pallas2d.pad2d(u, pallas2d.layout_br(ny)), r_rms

    br = pallas2d.layout_br(ny)
    alpha = cfg.jacobi_damping

    if (cfg.resolved_restriction() is not Restriction.FULL_WEIGHTING
            and 1 <= cfg.pre_smooth <= 6):
        # fused downward leg: all pre-smooths, the residual, AND the
        # restriction row pass (parity-split output)
        u_rp, res_ps = pallas2d.smooth2r_split_rp(
            u_rp, f_rp, ny, nx, br, h, c, alpha, zero_u=assume_zero_u,
            ns=cfg.pre_smooth, elim=elim,
        )
        res_c = transfer.restrict_ps(res_ps, ny, nx, br, apply_bcs=apply_bcs)
    else:
        for _ in range(cfg.pre_smooth):
            u_rp, _ = pallas2d.smooth_rp(
                u_rp, f_rp, ny, nx, br, h, c, alpha, with_norm=False
            )
        res_rp = pallas2d.residual_rp(u_rp, f_rp, ny, nx, br, h, c)
        if cfg.resolved_restriction() is Restriction.FULL_WEIGHTING:
            res_c = transfer.restrict_full_weighting(
                pallas2d.unpad2d(res_rp, ny, nx), apply_bcs=apply_bcs
            )
        else:
            res_c = transfer.restrict_rp(res_rp, ny, nx, apply_bcs=apply_bcs)

    nyc, nxc = res_c.shape
    brc = pallas2d.layout_br(nyc)
    corr_rp = jnp.zeros(
        (pallas2d.padded_rows(nyc, brc), pallas2d.padded_cols(nxc)), u_rp.dtype
    )
    fc_rp = pallas2d.pad2d(res_c, brc)
    corr_rp, _ = vcycle_rp(
        corr_rp, fc_rp, nyc, nxc, h * 2.0, c, tol, cfg, apply_bcs=apply_bcs,
        assume_zero_u=True, elim=elim,
    )

    if 1 <= cfg.post_smooth <= 6:
        # fused upward leg: prolongate + correct + all post-smooths
        u_rp, r_rms = pallas2d.corr_smooth2_rp(
            u_rp, f_rp, pallas2d.unpad2d(corr_rp, nyc, nxc), ny, nx, br, h, c,
            alpha, apply_bcs=apply_bcs, with_norm=True, ns=cfg.post_smooth,
            elim=elim,
        )
    else:
        corr_f = transfer.prolongate_rp(
            pallas2d.unpad2d(corr_rp, nyc, nxc), (ny, nx), u_rp.shape,
            apply_bcs=apply_bcs,
        )
        u_rp = u_rp - corr_f
        r_rms = None
        for s in range(cfg.post_smooth):
            want = s == cfg.post_smooth - 1
            u_rp, r = pallas2d.smooth_rp(
                u_rp, f_rp, ny, nx, br, h, c, alpha, with_norm=want
            )
            if want:
                r_rms = r
    return u_rp, r_rms


def _stk_eligible(cfg: MGConfig) -> bool:
    """The stacked V-cycle implements the fused-leg configuration only
    (Jacobi, 1-6 pre/post smooths, injection restriction).  The smooth
    count is a free parameter of the fused legs: deeper V(3,3)..V(5,5)
    cycles contract harder, which cuts outer defect iterations (see
    mg_solve_ds)."""
    return (
        cfg.smoother is Smoother.JACOBI
        and 1 <= cfg.pre_smooth <= 6
        and 1 <= cfg.post_smooth <= 6
        and cfg.resolved_restriction() is not Restriction.FULL_WEIGHTING
    )


def vcycle_stk(L, ny, nx, h, c, tol, cfg: MGConfig, apply_bcs=False,
               assume_zero_u=False, elim=False):
    """One V-cycle on the stacked level state L = (2, total, nxp) [u | f];
    both fused legs update plane 0 in place and leave f untouched.
    Semantically identical to ``vcycle_rp`` on (L[0], L[1]); requires
    _stk_eligible(cfg).

    Returns (L', r_rms): plane 0 the corrected iterate, plane 1 untouched.
    """
    from fpr_tpu.ops import pallas2d, transfer

    if ny * nx < PALLAS_MIN_AREA or min(ny, nx) <= cfg.coarse_size:
        import dataclasses

        # assume_zero_u means plane 0 is UNSPECIFIED, not zero: the ds
        # defect pass leaves the previous outer's correction there
        # (ds.defect_pass_stk).  Start the jnp cycle from an explicit zero
        # iterate.
        if assume_zero_u:
            u = jnp.zeros((ny, nx), L.dtype)
        else:
            u = pallas2d.unpad2d(L[0], ny, nx)
        f = pallas2d.unpad2d(L[1], ny, nx)
        sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
        u, r_rms = vcycle(u, f, h, c, tol, sub_cfg, apply_bcs=apply_bcs,
                          elim=elim)
        return L.at[0].set(pallas2d.pad2d(u, pallas2d.layout_br(ny))), r_rms

    br = pallas2d.layout_br(ny)
    alpha = cfg.jacobi_damping

    L, res_ps = pallas2d.smooth2r_stk(
        L, ny, nx, br, h, c, alpha, zero_u=assume_zero_u, ns=cfg.pre_smooth,
        elim=elim,
    )

    res_c = transfer.restrict_ps(res_ps, ny, nx, br, apply_bcs=apply_bcs)

    nyc, nxc = res_c.shape
    brc = pallas2d.layout_br(nyc)
    Lc = jnp.zeros(
        (2, pallas2d.padded_rows(nyc, brc), pallas2d.padded_cols(nxc)),
        L.dtype,
    )
    Lc = Lc.at[1, pallas2d.PAD : pallas2d.PAD + nyc, :nxc].set(res_c)
    Lc, _ = vcycle_stk(
        Lc, nyc, nxc, h * 2.0, c, tol, cfg, apply_bcs=apply_bcs,
        assume_zero_u=True, elim=elim,
    )

    corrx = pallas2d.x_interleave_coarse(
        pallas2d.unpad2d(Lc[0], nyc, nxc), apply_bcs=apply_bcs
    )
    rows_needed = pallas2d.corr_rows_needed(ny, br)
    nxp = pallas2d.padded_cols(nx)
    corrx_rp = jnp.zeros((rows_needed, nxp), corrx.dtype)
    corrx_rp = corrx_rp.at[pallas2d.PAD : pallas2d.PAD + corrx.shape[0], :nx].set(corrx)
    L, r_rms = pallas2d.corr_smooth2_stk(
        L, corrx_rp, ny, nx, br, h, c, alpha, with_norm=True,
        ns=cfg.post_smooth, elim=elim,
    )
    return L, r_rms


def mg_solve_rp(u0, f, h, c, tol, niters, apply_bcs=False, cfg=MGConfig()):
    """MGsolve with the row-padded fused-leg V-cycle.  Same contract as
    ``mg_solve``; pads once on entry, unpads on exit."""
    from fpr_tpu.ops import pallas2d

    ny, nx = u0.shape
    br = pallas2d.layout_br(ny)
    f_rms = stencil2d.rms(f)
    tolf = tol * f_rms
    f_rp = pallas2d.pad2d(f, br)

    def apply_bcs_rp(u_rp):
        # NS temperature BCs in rp coordinates (physical col nx-1, not -1)
        u_rp = u_rp.at[pallas2d.PAD, :].set(1.0)
        u_rp = u_rp.at[pallas2d.PAD + ny - 1, :].set(0.0)
        u_rp = u_rp.at[:, 0].set(u_rp[:, 1])
        u_rp = u_rp.at[:, nx - 1].set(u_rp[:, nx - 2])
        return u_rp

    def cond(carry):
        _, r_rms, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    def body(carry):
        u_rp, _, it = carry
        if apply_bcs:
            u_rp = apply_bcs_rp(u_rp)
        u_rp, r_rms = vcycle_rp(u_rp, f_rp, ny, nx, h, c, tol, cfg, apply_bcs)
        return u_rp, r_rms, it + 1

    u_rp, r_rms, it = jax.lax.while_loop(
        cond,
        body,
        (pallas2d.pad2d(u0, br), jnp.asarray(jnp.inf, u0.dtype), jnp.asarray(0, jnp.int32)),
    )
    return pallas2d.unpad2d(u_rp, ny, nx), r_rms, it


# ---------------------------------------------------------------------------
# Mixed-precision defect correction: f64 storage and residuals, f32 fused
# V-cycles
# ---------------------------------------------------------------------------


def mg_solve_mixed(
    u0,
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    apply_bcs: bool = False,
    cfg: MGConfig = MGConfig(),
    inner_cycles: int = 1,
):
    """Iterative-refinement MG: keep u and the defect in f64 (storage
    precision sets the achievable residual floor — plain f32 stalls around
    1e-1 at 4097^2), but run the V-cycles in f32 through the fused legs on
    the normalized defect:

        r   = A u - f                 (f64, one jnp pass)
        e   = MG_f32(r / ||r||)       (inner_cycles row-padded V-cycles)
        u  -= ||r|| * e               (f64 axpy)

    until rms(r) < tol * rms(f).  Returns (u, r_rms, outer_iterations).
    """
    from fpr_tpu.ops import pallas2d

    ny, nx = u0.shape
    f_rms = stencil2d.rms(f)
    tolf = tol * f_rms
    br32 = pallas2d.layout_br(ny)

    def cond(carry):
        _, r_rms, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    def body(carry):
        u, _, it = carry
        if apply_bcs:
            u = bc.ns_temperature_bcs(u)
        r = stencil2d.residual(u, f, h, c)  # f64
        scale = stencil2d.rms(r)
        safe = jnp.maximum(scale, jnp.asarray(jnp.finfo(u.dtype).tiny, u.dtype))
        r32 = (r / safe).astype(jnp.float32)
        e_rp = jnp.zeros(
            (pallas2d.padded_rows(ny, br32), pallas2d.padded_cols(nx)), jnp.float32
        )
        r32_rp = pallas2d.pad2d(r32, br32)
        e_rms = jnp.asarray(jnp.inf, jnp.float32)
        for cyc in range(inner_cycles):
            e_rp, e_rms = vcycle_rp(
                e_rp, r32_rp, ny, nx, h, c, tol, cfg, apply_bcs=apply_bcs,
                assume_zero_u=(cyc == 0), elim=_elim(apply_bcs),
            )
        e = pallas2d.unpad2d(e_rp, ny, nx).astype(u.dtype) * safe
        u = u - e
        # convergence signal: the POST-correction defect estimate.  The inner
        # V-cycle's final fine-level r_rms is rms(A e - r/||r||) in f32;
        # rescaled by ||r|| it estimates rms(A u' - f) for the corrected u'.
        # Carrying the pre-correction `scale` instead costs one extra outer
        # iteration (one f64 residual + one f32 V-cycle) after the tolerance
        # is actually met.  f32 rounding noise only ADDS to the measured rms,
        # so this estimate stays conservative (never exits early falsely).
        r_est = e_rms.astype(u.dtype) * safe
        return u, r_est, it + 1

    u, r_rms, it = jax.lax.while_loop(
        cond,
        body,
        (u0, jnp.asarray(jnp.inf, u0.dtype), jnp.asarray(0, jnp.int32)),
    )
    _warn_unconverged("mg_solve_mixed", r_rms, tolf, it, niters, apply_bcs)
    return u, r_rms, it


@functools.partial(
    jax.jit, static_argnames=("h", "tol", "niters", "apply_bcs", "cfg", "inner_cycles")
)
def mg_solve_mixed_jit(
    u0, f, h, c, tol, niters, apply_bcs=False, cfg=MGConfig(), inner_cycles=1
):
    return mg_solve_mixed(
        u0, f, h, c, tol, niters,
        apply_bcs=apply_bcs, cfg=cfg, inner_cycles=inner_cycles,
    )


# ---------------------------------------------------------------------------
# Double-single defect correction: the all-f32 outer loop (no f64 in the
# iteration at all — see fpr_tpu.ops.ds)
# ---------------------------------------------------------------------------


def _auto_inner_cycles(ny: int, nx: int, cfg: MGConfig = MGConfig()) -> int:
    """V-cycles per defect-correction outer iteration (static, trace-time).

    One cycle per outer for deep smoothing (pre_smooth >= 3: the cycle
    already contracts hard, and a second one costs more than the defect
    pass it saves) and on grids from 8193 up, where the fine-level legs
    dominate; two otherwise (fewer outer defect passes).  These crossovers
    were tuned on earlier hardware and await re-measurement on the GPU
    (ROADMAP)."""
    if cfg.pre_smooth >= 3:
        return 1
    return 1 if max(ny, nx) >= 8193 else 2


def _fmg_guess(r32_rp, ny, nx, h, c, tol, cfg: MGConfig, apply_bcs=False):
    """Full-multigrid initial guess for A e = r32 (f32, row-padded in/out).

    Restrict the rhs down the ladder (full weighting — injection on a
    rough rhs aliases its high modes), solve the coarsest level directly,
    then prolongate upward with one V-cycle per level (the fine level's
    cycle included — FMG's classical 'solve to discretization error in
    one sweep').  Costs ~1.33 fine V-cycles + the transfer pyramid, and
    replaces 1-2 defect-correction outer iterations (multigrid.jl has no
    FMG mode; reference cost anchor is its repeated V-cycling,
    multigrid.jl:41-84).

    Off by default: on earlier hardware the preamble cost back what the
    saved outer iteration bought at 4097^2 and more at 8193^2.  Useful
    when a better-than-zero initial guess is needed for a SINGLE
    non-repeated solve."""
    from fpr_tpu.ops import pallas2d, transfer

    levels = [(ny, nx, h, pallas2d.unpad2d(r32_rp, ny, nx))]
    while min(levels[-1][0], levels[-1][1]) > cfg.coarse_size:
        nyl, nxl, hl, rl = levels[-1]
        rc = transfer.restrict_full_weighting(rl, apply_bcs=apply_bcs)
        levels.append((rc.shape[0], rc.shape[1], hl * 2.0, rc))

    nyl, nxl, hl, rl = levels[-1]
    smooth, _ = _smooth_fns(cfg)
    e, _ = _coarse_solve(jnp.zeros_like(rl), rl, hl, c, tol, cfg, smooth)

    for nyl, nxl, hl, rl in reversed(levels[:-1]):
        e = transfer.prolongate(e, (nyl, nxl), apply_bcs=apply_bcs)
        brl = pallas2d.layout_br(nyl)
        totall = pallas2d.padded_rows(nyl, brl)
        nxpl = pallas2d.padded_cols(nxl)
        Ll = (
            jnp.zeros((2, totall, nxpl), jnp.float32)
            .at[0].set(pallas2d.pad2d(e, brl))
            .at[1].set(pallas2d.pad2d(rl, brl))
        )
        Ll, _ = vcycle_stk(
            Ll, nyl, nxl, hl, c, tol, cfg, apply_bcs=apply_bcs,
            assume_zero_u=False, elim=_elim(apply_bcs),
        )
        e = pallas2d.unpad2d(Ll[0], nyl, nxl)

    return pallas2d.pad2d(e, pallas2d.layout_br(ny))


def mg_solve_ds_rp(
    u_ds,
    f_ds,
    tolf,
    ny: int,
    nx: int,
    h: float,
    c,
    niters: int,
    cfg: MGConfig = MGConfig(),
    inner_cycles: int | None = None,
    apply_bcs: bool = False,
    r0=None,
    tol: float = 1e-7,
    velocity_max: bool = False,
    field_sumsq: bool = False,
    fmg: bool = False,
    extras0=None,
):
    """Row-padded core of the double-single defect-correction solver.

    Operates entirely in rp space so a caller iterating many solves (the NS
    time loop) never pays pad/unpad/pack passes:

    - u_ds: (2, total, nxp) f32 hi/lo stack, or None for a zero guess.
    - f_ds: (2, total, nxp) hi/lo stack, or (1, total, nxp) for an
      exactly-f32 rhs (halves the defect pass's f traffic).
    - tolf: absolute tolerance on rms(r) (caller computes tol * rms(f)).
    - c may be a traced f32 scalar (the NS Helmholtz shifts 1/(beta dt)).
    - CONVERGENCE CAVEAT (measured): with apply_bcs the correction
      V-cycle smooths the side columns as zero-Dirichlet while the true
      correction satisfies Neumann there (only the transfers apply the
      copies), so the contraction degrades to ~0.75/cycle on a cold
      pure-Poisson BC solve (c=0, tight tol: stagnates at niters on
      513x257 regardless of coarse solver).  The NS temperature solves —
      the only apply_bcs consumers — operate with strong Helmholtz
      shifts (c = 1/(beta*dt)) and warm starts, where convergence is
      fast.  This is REFERENCE-SEMANTICS behavior, not a ds-tier
      regression: the jnp-tier mg_solve (per-iteration BC application
      exactly as multigrid.jl:60-62) stagnates identically on the same
      cold problem — the BC'd Poisson operator needs a Neumann-aware
      smoother neither framework has.
    - apply_bcs: NS temperature BCs applied to u inside the defect pass
      each outer iteration (and through the V-cycle transfers), mirroring
      mg_solve_mixed's per-iteration BC application (multigrid.jl:60-62).
    - r0: optionally, a precomputed initial defect (r32_rp, r_rms) — e.g.
      -f for a zero guess without BCs.  With the extras flags set, r0
      requires extras0 = the (max_vx, max_vy, sumsq) describing u_ds (the
      values the skipped initial defect pass would have produced — the NS
      fast loop gets them from the fused operator pass,
      pallas_ns.ns_fused_rp(with_defect=True)).
    - velocity_max / field_sumsq: compute max|curl u'| components and
      sumsq(u'_hi) in the defect pass; the LAST pass's values describe the
      returned iterate.

    Returns (u_ds', r_rms, outer_iterations) — plus an extras tuple
    (max_vx, max_vy, sumsq) when either flag is set.
    """
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import pallas2d

    if inner_cycles is None:
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    br = pallas2d.layout_br(ny)
    total = pallas2d.padded_rows(ny, br)
    nxp = pallas2d.padded_cols(nx)
    # the layout br is recomputed here; a caller that packed with a
    # different br would have its rows silently misinterpreted
    if f_ds.shape[-2:] != (total, nxp):
        raise ValueError(
            f"f_ds layout {f_ds.shape[-2:]} != expected {(total, nxp)} "
            f"for ny={ny}, nx={nx} (br={br}); pack with pallas2d.pad2d(_, {br})"
        )
    if u_ds is not None and u_ds.shape[-2:] != (total, nxp):
        raise ValueError(
            f"u_ds layout {u_ds.shape[-2:]} != expected {(total, nxp)}"
        )
    f_single = f_ds.shape[0] == 1
    tolf = jnp.asarray(tolf, jnp.float32)
    extras_on = velocity_max or field_sumsq
    if extras_on and r0 is not None and extras0 is None:
        raise ValueError(
            "extras flags with r0 need extras0 (the skipped initial "
            "defect pass's values)"
        )
    kw = dict(apply_bcs=apply_bcs, f_single=f_single,
              velocity_max=velocity_max, field_sumsq=field_sumsq)

    zero_e = jnp.zeros((total, nxp), jnp.float32)
    if u_ds is None:
        u_ds = jnp.zeros((2, total, nxp), jnp.float32)
    if r0 is not None:
        r32, r_rms = r0
        extras = tuple(extras0) if extras_on else ()
    else:
        # initial defect (scale = 0: the Dekker product with 0 is exactly 0)
        out = dsm.defect_pass(u_ds, f_ds, zero_e, 0.0, ny, nx, br, h, c, **kw)
        if extras_on:
            u_ds, r32, r_rms, extras = out
        else:
            u_ds, r32, r_rms = out
            extras = ()

    def cond(carry):
        _, _, r_rms, _, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    L_fmg = None
    if fmg and _stk_eligible(cfg):
        # FMG preamble: coarse-to-fine initial guess for the first defect
        # equation, then one ds defect pass to fold it into u and measure
        # the true defect — typically replaces 1-2 outer iterations
        e0 = _fmg_guess(r32, ny, nx, h, c, tol, cfg, apply_bcs=apply_bcs)
        out = dsm.defect_pass_stk(
            u_ds, f_ds, jnp.stack([e0, r32]), 1.0, ny, nx, br, h, c, **kw)
        if extras_on:
            u_ds, L_fmg, r_rms, extras = out
        else:
            u_ds, L_fmg, r_rms = out

    if _stk_eligible(cfg):
        # stacked V-cycle: the level state L = [e | r32] is the loop carry,
        # updated in place by both legs each cycle and then by the defect
        # pass, which writes the new defect straight into plane 1
        L0 = (
            L_fmg
            if L_fmg is not None
            else jnp.zeros((2, total, nxp), jnp.float32).at[1].set(r32)
        )

        def body(carry):
            u_ds, L, _, _, it = carry
            for cyc in range(inner_cycles):
                L, _ = vcycle_stk(
                    L, ny, nx, h, c, tol, cfg, apply_bcs=apply_bcs,
                    assume_zero_u=(cyc == 0), elim=_elim(apply_bcs),
                )
            out = dsm.defect_pass_stk(u_ds, f_ds, L, 1.0, ny, nx, br, h, c, **kw)
            if extras_on:
                u_ds, L, r_rms, ex = out
            else:
                u_ds, L, r_rms = out
                ex = ()
            return u_ds, L, r_rms, ex, it + 1

        u_ds, _, r_rms, extras, it = jax.lax.while_loop(
            cond, body, (u_ds, L0, r_rms, extras, jnp.asarray(0, jnp.int32))
        )
        if extras_on:
            return u_ds, r_rms, it, extras
        return u_ds, r_rms, it

    def body(carry):
        u_ds, r32, _, _, it = carry
        e_rp = zero_e
        for cyc in range(inner_cycles):
            e_rp, _ = vcycle_rp(
                e_rp, r32, ny, nx, h, c, tol, cfg, apply_bcs=apply_bcs,
                assume_zero_u=(cyc == 0), elim=_elim(apply_bcs),
            )
        out = dsm.defect_pass(u_ds, f_ds, e_rp, 1.0, ny, nx, br, h, c, **kw)
        if extras_on:
            u_ds, r32, r_rms, ex = out
        else:
            u_ds, r32, r_rms = out
            ex = ()
        return u_ds, r32, r_rms, ex, it + 1

    u_ds, _, r_rms, extras, it = jax.lax.while_loop(
        cond, body, (u_ds, r32, r_rms, extras, jnp.asarray(0, jnp.int32))
    )
    if extras_on:
        return u_ds, r_rms, it, extras
    return u_ds, r_rms, it


def mg_solve_ds(
    u0,
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    cfg: MGConfig = MGConfig(),
    inner_cycles: int | None = None,
    return_pair: bool = False,
    apply_bcs: bool = False,
    fmg: bool = False,
):
    """Defect-correction MG with the double-single fused outer pass.

    Same contract as ``mg_solve_mixed``, but the outer iteration is a
    single fused pass (fpr_tpu.ops.ds.defect_pass) instead of an f64
    residual + rms + axpy + cast chain: u and f live as
    hi/lo f32 pairs (~48 mantissa bits), the defect norm is TRUE (computed
    on the just-corrected iterate, not an estimate), and the f32 V-cycles
    consume the pass's row-padded rhs directly.

    Pass u0=None for a zero initial guess: the entry conversion of u0 and
    the initial defect pass are then skipped entirely (r0 = -f, the norm is
    rms(f)) — the common case for MG benchmarks and the NS stream-function
    solve's cold start.  Returns (u, r_rms, outer_iterations) in f's dtype.
    """
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import pallas2d

    ny, nx = f.shape
    br = pallas2d.layout_br(ny)

    def pack(a):
        hi, lo = dsm.to_ds(a) if a.dtype == jnp.float64 else (
            a.astype(jnp.float32), jnp.zeros(a.shape, jnp.float32)
        )
        return jnp.stack([pallas2d.pad2d(hi, br), pallas2d.pad2d(lo, br)])

    if f.dtype != jnp.float64:
        # exactly-f32 rhs: single-plane layout — the defect pass skips the
        # lo plane's traffic
        f_ds = pallas2d.pad2d(f.astype(jnp.float32), br)[None]
    else:
        f_ds = pack(f)
    f_rms = stencil2d.rms(f)
    tolf = jnp.asarray(tol * f_rms, jnp.float32)

    if u0 is None and not apply_bcs:
        # zero initial guess: r = A*0 - f = -f, no defect pass needed
        u_ds = None
        r0 = (-f_ds[0], f_rms.astype(jnp.float32))
    else:
        u_ds = pack(u0) if u0 is not None else None
        r0 = None

    u_ds, r_rms, it = mg_solve_ds_rp(
        u_ds, f_ds, tolf, ny, nx, h, c, niters,
        cfg=cfg, inner_cycles=inner_cycles, apply_bcs=apply_bcs, r0=r0, tol=tol,
        fmg=fmg,
    )
    # the rp core is the NS fast loop's inner solver (warnings there would
    # fire per step inside a while_loop) — warn only at this user-facing
    # entry
    _warn_unconverged("mg_solve_ds", r_rms, tolf, it, niters, apply_bcs)
    if return_pair:
        # skip the f64 exit combine: the hi/lo pair IS the framework's
        # native ~48-bit result representation
        hi = pallas2d.unpad2d(u_ds[0], ny, nx)
        lo = pallas2d.unpad2d(u_ds[1], ny, nx)
        return (hi, lo), r_rms, it
    u = dsm.from_ds(
        pallas2d.unpad2d(u_ds[0], ny, nx),
        pallas2d.unpad2d(u_ds[1], ny, nx),
        dtype=f.dtype,
    )
    return u, r_rms.astype(f.dtype), it


@functools.partial(
    jax.jit,
    static_argnames=("h", "tol", "niters", "cfg", "inner_cycles", "return_pair",
                     "fmg"),
)
def mg_solve_ds_jit(
    f, h, c, tol, niters, cfg=MGConfig(), inner_cycles=None, return_pair=False,
    fmg=False,
):
    """Jitted zero-initial-guess mg_solve_ds (the benchmark entry point)."""
    return mg_solve_ds(
        None, f, h, c, tol, niters,
        cfg=cfg, inner_cycles=inner_cycles, return_pair=return_pair, fmg=fmg,
    )
