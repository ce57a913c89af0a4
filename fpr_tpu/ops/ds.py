"""Double-single (two-float32) arithmetic and the fused defect pass of the
mixed-precision multigrid.

Why this exists: plain f32 cannot evaluate the residual r = A u - f on
fine grids — the 5-point numerator cancels catastrophically and the f32
rounding floor eps*8|u|/h^2 sits orders of magnitude above tol*rms(f).  A
double-single representation u ~ hi + lo with |lo| <= ulp(hi)/2 carries
~48 mantissa bits — enough for tol 1e-6 at the reference's largest grid
(16385^2, h^2 = 3.7e-9) — while every operation stays in f32.

The error-free transformations are the classical ones (Dekker 1971, Knuth
TAOCP v2): two_sum, quick_two_sum, Veltkamp split + Dekker product.  They
rely on IEEE-exact single operations with no reassociation or contraction
into fused multiply-adds; tests/test_ds.py checks exactness on the CPU and
chip_smoke.py on the GPU.

The defect pass (one pass per outer defect-correction iteration):

    u'  = u - scale * e          (ds update; e is the f32 V-cycle output)
    r   = (u'_E + u'_W + u'_N + u'_S - C u') / h^2 - f    (ds stencil)
    acc = sum(r_hi^2)            (the TRUE defect norm, not an estimate)
    out: u' (hi, lo planes), r_hi (the next V-cycle's rhs)

Reference provenance: the outer loop this accelerates is MGsolve_2DPoisson!
(multigrid.jl:41-84); the residual definition matches residual_2DPoisson!
(multigrid.jl:173-188) with C = 4 + c h^2.
"""

from __future__ import annotations

import jax.numpy as jnp

from fpr_tpu.ops.pallas2d import (
    block_rows,
    block_sumsq,
    global_coords,
    interior_mask,
    shift_cols,
    shift_rows,
)

# ---------------------------------------------------------------------------
# error-free transformations
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + err == a + b exactly (6 flops, no magnitude precondition)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err == a + b exactly, REQUIRES |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def ds_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl), renormalized."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def ds_neg(xh, xl):
    return -xh, -xl


_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split constant for f32 (24-bit mantissa)


def split(a):
    """Veltkamp split: a == hi + lo with hi, lo 12-bit-mantissa halves."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly (Dekker product; no FMA assumed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_mul_f1(xh, xl, c):
    """(xh, xl) * c for a plain f32 scalar/array c."""
    p, e = two_prod(xh, c)
    e = e + xl * c
    return quick_two_sum(p, e)


def ds_mul_ds(xh, xl, yh, yl):
    """(xh, xl) * (yh, yl) (drops the xl*yl term, below 2^-48)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def to_ds(x):
    """f64 array -> (hi, lo) f32 pair (requires x64 enabled)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def from_ds(hi, lo, dtype=jnp.float64):
    return hi.astype(dtype) + lo.astype(dtype)


def f32_pair(x: float):
    """Split a Python float into (hi, lo) f32 constants (trace-time ds
    scalar) — shared by the ds3d kernel constants and the NS fast loop's
    double-single sim-time accumulator."""
    import numpy as np

    hi = float(np.float32(x))
    return hi, float(np.float32(x - hi))


def _is_pow2(x: float) -> bool:
    import math

    m, _ = math.frexp(x)
    return m == 0.5


# ---------------------------------------------------------------------------
# defect pass
# ---------------------------------------------------------------------------


def ds_defect(uh, ul, fh, fl, inv_h2: float, C=None):
    """r_hi of A u - f in ds arithmetic on whole rp planes: the neighbour
    sum with a two_sum cascade (the three exact addition errors and the
    four lo parts collected in plain f32 — their magnitudes are ~2^-24 of
    the operands, so accumulating them naively costs < 2^-48 relative),
    C u as a ds product (exact x4 when C is None, i.e. c == 0), exact
    power-of-two 1/h^2 scaling, and the final subtraction of f (fl None:
    an exactly-f32 rhs).  Not interior-masked."""
    s1, e1 = two_sum(shift_rows(uh, -1), shift_rows(uh, 1))
    s2, e2 = two_sum(shift_cols(uh, -1), shift_cols(uh, 1))
    sh_, e3 = two_sum(s1, s2)
    sl_ = ((e1 + e2) + e3) + (
        (shift_rows(ul, -1) + shift_rows(ul, 1))
        + (shift_cols(ul, -1) + shift_cols(ul, 1))
    )
    if C is None:
        cuh, cul = uh * 4.0, ul * 4.0
    else:
        cuh, cul = ds_mul_ds(uh, ul, C[0], C[1])
    th, tl = ds_add(sh_, sl_, -cuh, -cul)
    th, tl = th * inv_h2, tl * inv_h2
    # only the hi part is consumed (rhs of the f32 V-cycle and the norm),
    # so the final renormalization's lo output is skipped
    rs, re = two_sum(th, -fh)
    if fl is None:
        return rs + (re + tl)
    return rs + (re + (tl - fl))


def defect_sumsq(r, owned):
    """sum(r^2) over the owned cells of the block rows."""
    return block_sumsq(jnp.where(owned, r, jnp.zeros((), r.dtype)))


def curl_maxima(uh, owned, inv2h: float):
    """(max|du/dy|, max|du/dx|) over the owned cells of the block rows —
    the NS adaptive-dt inputs (part2.jl:76-87) for u = the streamfunction."""
    i2h = jnp.asarray(inv2h, uh.dtype)
    zero = jnp.zeros((), uh.dtype)
    vx = jnp.abs((shift_rows(uh, 1) - shift_rows(uh, -1)) * i2h)
    vy = jnp.abs((shift_cols(uh, 1) - shift_cols(uh, -1)) * i2h)
    return (jnp.max(block_rows(jnp.where(owned, vx, zero))),
            jnp.max(block_rows(jnp.where(owned, vy, zero))))


def _c_pair(c, h):
    """C = 4 + c h^2 as a ds pair: in f64 at trace time if c is a Python
    scalar; via f64 rounding if c is a traced f64; via error-free
    transformations if c is a traced f32 (h^2 = 2^-2k is exact in f32, so
    two_prod/two_sum keep all ~48 bits of C, which the residual's C*u term
    needs to stay below tol).  None when c == 0 (exact x4 path)."""
    if isinstance(c, (int, float)):
        if float(c) == 0.0:
            return None
        C = 4.0 + float(c) * float(h) * float(h)
        hi, lo = f32_pair(C)
        return jnp.asarray(hi, jnp.float32), jnp.asarray(lo, jnp.float32)
    if c.dtype == jnp.float32:
        h2 = jnp.asarray(float(h) * float(h), jnp.float32)
        p, pe = two_prod(c, h2)
        s, se = two_sum(jnp.asarray(4.0, jnp.float32), p)
        return quick_two_sum(s, se + pe)
    C64 = 4.0 + c * (h * h)  # traced; x64 if enabled
    C_hi = C64.astype(jnp.float32)
    return C_hi, (C64 - C_hi.astype(C64.dtype)).astype(jnp.float32)


def defect_pass(u_ds, f_ds, e_rp, scale, ny, nx, br, h, c, with_update=True,
                apply_bcs=False, f_single=False, velocity_max=False,
                field_sumsq=False, row_off=0, ny_mask=None, raw_sumsq=False,
                col_off=0, nx_mask=None, own_lanes=None):
    """Fused: u' = u - scale*e (ds), [BCs(u')], r = A u' - f (ds), sumsq(r_hi).

    u_ds: (2, padded_rows, padded_cols) f32 hi/lo stack; f_ds likewise, or
    (1, padded_rows, padded_cols) for an exactly-f32 rhs (the layout is the
    contract: a 1-plane f_ds means f_single, whatever the flag says).
    e_rp: row-padded f32 correction (ignored when with_update=False).
    apply_bcs: the NS temperature BCs (Dirichlet bottom/top, Neumann sides,
    Neumann winning at corners — part2_utils.jl:22-25) applied to u' before
    the residual, mirroring mg_solve_mixed's per-outer-iteration BCs.
    Distributed: ny/nx are the local layout, ny_mask/nx_mask the global
    grid, row_off/col_off the global row of local physical row 0 and the
    global column of lane 0; own_lanes=(lo, hi) restricts every reduction
    to the lanes this shard owns (a 2D mesh's ghost lanes belong to the x
    neighbour); raw_sumsq returns the raw local sum for a psum.
    Returns (u_ds', r32_rp, r_rms) with r_rms = sqrt(sumsq / (nx*ny)), plus
    (max|vx|, max|vy|, sumsq(u'_hi)) when velocity_max or field_sumsq
    (zeros for the ones not asked for).
    """
    inv_h2 = 1.0 / (float(h) * float(h))
    if not _is_pow2(inv_h2):
        raise ValueError(f"1/h^2 = {inv_h2} must be a power of two (h = 1/2^k)")
    if f_ds.shape[0] not in (1, 2):
        raise ValueError(f"f_ds must be (1|2, rows, cols), got {f_ds.shape}")
    ny_g = ny_mask if ny_mask is not None else ny
    nx_g = nx_mask if nx_mask is not None else nx
    f32 = jnp.float32
    uh, ul = u_ds[0], u_ds[1]
    gy, gx = global_coords(uh.shape, row_off, col_off)

    if with_update:
        ph, pe = two_prod(e_rp, jnp.asarray(scale, f32))
        uh, ul = ds_add(uh, ul, -ph, -pe)

    if apply_bcs:
        one, zero = jnp.asarray(1.0, f32), jnp.asarray(0.0, f32)
        drow = (gy == 0) | (gy == ny_g - 1)
        uh = jnp.where(gy == 0, one, jnp.where(gy == ny_g - 1, zero, uh))
        ul = jnp.where(drow, zero, ul)

        def sides(v):
            return jnp.where(gx == 0, shift_cols(v, 1),
                             jnp.where(gx == nx_g - 1, shift_cols(v, -1), v))

        uh, ul = sides(uh), sides(ul)

    fl = None if f_ds.shape[0] == 1 else f_ds[1]
    r = ds_defect(uh, ul, f_ds[0], fl, inv_h2, _c_pair(c, h))
    interior = interior_mask(gy, gx, ny_g, nx_g)
    r = jnp.where(interior, r, jnp.asarray(0.0, f32))
    if own_lanes is not None:
        lane = gx - jnp.asarray(col_off, jnp.int32)
        lane_win = (lane >= own_lanes[0]) & (lane < own_lanes[1])
        owned = interior & lane_win
        dom = (gy < ny_g) & (gx >= 0) & (gx < nx_g) & lane_win
    else:
        owned = interior
        dom = (gy < ny_g) & (gx < nx_g)

    sumsq = defect_sumsq(r, owned)
    r_rms = sumsq if raw_sumsq else jnp.sqrt(sumsq / (nx * ny))
    u_out = jnp.stack([uh, ul])
    if not (velocity_max or field_sumsq):
        return u_out, r, r_rms
    zero = jnp.asarray(0.0, f32)
    ax, ay = curl_maxima(uh, owned, 0.5 / float(h)) if velocity_max else (zero, zero)
    # field_sumsq covers the whole PHYSICAL domain (boundary ring included)
    ss = block_sumsq(jnp.where(dom, uh, zero)) if field_sumsq else zero
    return u_out, r, r_rms, (ax, ay, ss)


def defect_pass_stk(u_ds, f_ds, L, scale, ny, nx, br, h, c,
                    apply_bcs=False, f_single=False, velocity_max=False,
                    field_sumsq=False, row_off=0, ny_mask=None,
                    raw_sumsq=False, with_update=True, col_off=0,
                    nx_mask=None, own_lanes=None):
    """defect_pass on the stacked level state: e = L[0], and the new
    defect is written into plane 1 of L.  Returns (u_ds', L', r_rms[,
    extras]) where L'[1] is the new defect and L'[0] is left as it was
    (the next V-cycle's zero_u leg never reads it)."""
    out = defect_pass(
        u_ds, f_ds, L[0], scale, ny, nx, br, h, c, with_update=with_update,
        apply_bcs=apply_bcs, velocity_max=velocity_max,
        field_sumsq=field_sumsq, row_off=row_off, ny_mask=ny_mask,
        raw_sumsq=raw_sumsq, col_off=col_off, nx_mask=nx_mask,
        own_lanes=own_lanes,
    )
    return (out[0], L.at[1].set(out[1])) + tuple(out[2:])
