"""Fused Navier-Stokes operator pass — all per-step 2D operators at once.

The reference evaluates each NS term with a separate device kernel
(compute_velocity!, compute_Ra_dTdx!, compute_diffusion2d!,
compute_advection2d_{x,y}!, part2.jl:90-137) plus a BC mutator
(part2_utils.jl:22-39) and the Euler / rhs update — 8+ full-array passes
per timestep.  This pass computes the whole operator pipeline as one
elementwise expression that XLA fuses:

    T <- BCs(T)                      (Dirichlet bottom/top, Neumann sides,
                                      Neumann wins at corners)
    vx =  dS/dy, vy = -dS/dx         (central diff, recomputed from S)
    B  = Ra dT/dx                    (buoyancy forcing)
    dT2 = k  lap T,  dW2 = Pr lap W  (diffusion)
    dTx/dTy/dWx/dWy                  (first-order upwind advection)
    mode "explicit":  T' = T + dt (dT2 - dTx - dTy)
                      W' = W + dt (dW2 - dWx - dWy - Pr B)
    mode "rhs":       T' = -cT (T + dt ((1-beta) dT2 - dTx - dTy))
                      W' = -cW (W + dt ((1-beta) dW2 - dWx - dWy - Pr B))

dt, cT, cW are runtime scalars (dt is adaptive, part2.jl:76-87);
everything else is compile-time.

Layout: row-padded operands (see fpr_tpu.ops.pallas2d) with T and W
STACKED into one (2, total, nxp) array — the explicit pass's output is
exactly the next step's input, so the time loop never repacks.  S arrives
as a separate plane (it is produced by the multigrid solve each step).

Boundary semantics match the jnp tier exactly (ns_step,
fpr_tpu/models/navier_stokes.py): T' carries the BC'd boundary (terms are
zero there), W' keeps its original boundary; in rhs mode the boundary rows
carry -c*(field) with zero terms.  Everything outside the physical domain
is zero, so rms reductions over the padded array equal physical-domain
rms.
"""

from __future__ import annotations

import jax.numpy as jnp

from fpr_tpu.ops.ds import _is_pow2, curl_maxima, defect_sumsq, ds_defect
from fpr_tpu.ops.pallas2d import (
    block_sumsq,
    global_coords,
    interior_mask,
    shift_cols,
    shift_rows,
)


def ns_fused_rp(tw_rp, s_rp, dt, ny, nx, br, h, Pr, Ra, k=1.0, beta=0.0,
                mode="explicit", cT=None, cW=None, with_sumsq=False,
                row_off=0, ny_mask=None, with_defect=False):
    """Fused NS operator pass on row-padded operands.

    tw_rp: (2, total, nxp) stacked T/W; s_rp: (total, nxp) streamfunction.
    dt (and cT, cW in rhs mode) are runtime scalars.  Returns the stacked
    (2, total, nxp) result: (T', W') in explicit mode, (T_rhs, W_rhs) in
    rhs mode.  with_sumsq=True additionally returns the two output fields'
    sums of squares (the multigrid tolerances tol*rms(field) then need no
    separate reduction pass).  On a row-sharded mesh ny is the local row
    count, ny_mask the global one and row_off the global index of local
    physical row 0; the sums then cover this shard's rows.

    with_defect=True (explicit only): s_rp must be the FULL (2, total,
    nxp) ds streamfunction pair; additionally returns the next step's
    warm-S-solve inputs, in place of its initial ds.defect_pass: (out,
    (t_ss, w_ss), r0, extras0) with r0 = (r32_rp, r_rms of A S - W') and
    extras0 = (max|vx|, max|vy|, 0.0) of the current S — feed to
    mg_solve_ds_rp(r0=..., extras0=...).  The arithmetic is ds.defect_pass
    with scale=0, c=0 and an exactly-f32 rhs.
    """
    dtype = tw_rp.dtype
    if with_defect:
        if s_rp.ndim != 3:
            raise ValueError("with_defect needs the (2, total, nxp) ds S pair")
        if mode != "explicit":
            raise ValueError("with_defect is explicit-mode only")
        if not _is_pow2(1.0 / (h * h)):
            raise ValueError(f"1/h^2 = {1.0 / (h * h)} must be a power of two")
    ny_g = ny_mask if ny_mask is not None else ny
    T, W = tw_rp[0], tw_rp[1]
    S = s_rp[0] if with_defect else s_rp
    gy, gx = global_coords(T.shape, row_off)
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)
    dt = jnp.asarray(dt, dtype)

    # T boundary conditions (part2_utils.jl:22-39): Dirichlet rows first,
    # Neumann column copies second (Neumann wins at the corners, matching
    # bc.ns_temperature_bcs); applied everywhere so the stencils below see
    # BC'd neighbours
    T = jnp.where(gy == 0, one, jnp.where(gy == ny_g - 1, zero, T))
    T = jnp.where(gx == 0, shift_cols(T, 1),
                  jnp.where(gx == nx - 1, shift_cols(T, -1), T))

    _2h = jnp.asarray(0.5 / h, dtype)
    _h = jnp.asarray(1.0 / h, dtype)
    _h2 = jnp.asarray(1.0 / (h * h), dtype)

    # velocity = curl of S (part2.jl:90-96)
    vx = (shift_rows(S, 1) - shift_rows(S, -1)) * _2h
    vy = -(shift_cols(S, 1) - shift_cols(S, -1)) * _2h

    # buoyancy Ra dT/dx (part2.jl:98-104)
    B = jnp.asarray(Ra, dtype) * (shift_cols(T, 1) - shift_cols(T, -1)) * _2h

    def lap(F):
        return (shift_rows(F, -1) + shift_rows(F, 1) + shift_cols(F, -1)
                + shift_cols(F, 1) - 4.0 * F) * _h2

    # diffusion (part2.jl:106-113) — skipped entirely when fully implicit
    # (beta == 1 zeroes its weight; the reference skips the kernels too,
    # part2.jl:205-208)
    if abs(beta - 1.0) > 1e-8:
        dT2 = jnp.asarray(k, dtype) * lap(T)
        dW2 = jnp.asarray(Pr, dtype) * lap(W)
    else:
        dT2 = dW2 = zero

    # first-order upwind advection (part2.jl:116-137)
    def upwind_x(F):
        back = (F - shift_cols(F, -1)) * _h
        fwd = (shift_cols(F, 1) - F) * _h
        return vx * jnp.where(vx > 0, back, fwd)

    def upwind_y(F):
        back = (F - shift_rows(F, -1)) * _h
        fwd = (shift_rows(F, 1) - F) * _h
        return vy * jnp.where(vy > 0, back, fwd)

    dTx, dTy = upwind_x(T), upwind_y(T)
    dWx, dWy = upwind_x(W), upwind_y(W)

    interior = interior_mask(gy, gx, ny_g, nx)
    phys = (gy >= 0) & (gy < ny_g) & (gx < nx)
    PrB = jnp.asarray(Pr, dtype) * B

    if mode == "explicit":
        termT = dT2 - dTx - dTy
        termW = dW2 - dWx - dWy - PrB
        T_out = jnp.where(phys, jnp.where(interior, T + dt * termT, T), zero)
        W_out = jnp.where(phys, jnp.where(interior, W + dt * termW, W), zero)
    elif mode == "rhs":  # Helmholtz right-hand sides (part2.jl:219-226)
        cT = jnp.asarray(cT, dtype)
        cW = jnp.asarray(cW, dtype)
        wdif = jnp.asarray(1.0 - beta, dtype)
        termT = jnp.where(interior, wdif * dT2 - dTx - dTy, zero)
        termW = jnp.where(interior, wdif * dW2 - dWx - dWy - PrB, zero)
        T_out = jnp.where(phys, -cT * (T + dt * termT), zero)
        W_out = jnp.where(phys, -cW * (W + dt * termW), zero)
    else:
        raise ValueError(f"mode must be 'explicit' or 'rhs' (got {mode!r})")

    out = jnp.stack([T_out, W_out])
    sums = (block_sumsq(T_out), block_sumsq(W_out))
    if with_defect:
        # ds residual of the (unchanged) streamfunction against the NEW
        # vorticity: r = A S - W', the initial defect of the next step's
        # warm S solve, plus the curl maxima of the current S
        r = ds_defect(S, s_rp[1], W_out, None, 1.0 / (h * h))
        r = jnp.where(interior, r, zero)
        r_rms = jnp.sqrt(defect_sumsq(r, interior) / (nx * ny_g))
        ax, ay = curl_maxima(S, interior, 0.5 / h)
        return out, sums, (r, r_rms), (ax, ay, zero)
    if with_sumsq:
        return out, sums
    return out
