"""Double-single (two-f32) 3D dual-time diffusion step.

Part 1's work-precision experiments sweep the solver tolerance down to
1e-10 at 128^3 (part1_error_vs_tolerance_experiments.jl:25-26) — far below
the f32 residual floor eps*(|H|/dt + D|H|/h^2).  This step runs the SAME
pseudo-time iteration on ~48-bit double-single state in f32 arithmetic:

    dHdtau = (Htau - Ht)/dt - D lap(Htau)      (all in ds arithmetic)
    Htau' = Htau - dtau * dHdtau               (interior; passthrough else)
    sumsq = sum(dHdtau_hi^2)                   (f32 — dH^2 ~ 1e-19 at
                                                tol 1e-10, well inside f32)

Layout mirrors fpr_tpu.ops.pallas3d: hi/lo planes stacked ahead of the
ghost-padded (nz+2, ny8, nx128) state.  Constants (1/dt, D/dx^2, dtau) are
ds scalars split from f64 at trace time, so non-power-of-two grid spacings
(dx = 10/127) keep full precision.  Error-free transforms from
fpr_tpu.ops.ds (Dekker/Knuth).
"""

from __future__ import annotations

import jax.numpy as jnp

from fpr_tpu.ops.ds import ds_add, ds_mul_ds, f32_pair, two_sum
from fpr_tpu.ops.pallas3d import _interior, _pad_yx, _shift


def pad3d_ds(hi, lo):
    """(nz, ny, nx) hi/lo -> (2, nz+2, ny8, nx128) stacked ghost-padded
    state with zero ghost planes (the step returns them unchanged)."""
    _, ny, nx = hi.shape
    ny8, nx128 = _pad_yx(ny, nx)
    pads = ((1, 1), (0, ny8 - ny), (0, nx128 - nx))
    return jnp.stack([jnp.pad(hi, pads), jnp.pad(lo, pads)])


def to_ds_padded(H):
    """f64 physical field -> stacked ds ghost-padded state."""
    hi = H.astype(jnp.float32)
    lo = (H - hi.astype(H.dtype)).astype(jnp.float32)
    return pad3d_ds(hi, lo)


def from_ds_padded(Hds, shape, dtype=jnp.float64):
    """Physical field from a ds-padded state (interior planes only)."""
    nz, ny, nx = shape
    return (
        Hds[0, 1 : 1 + nz, :ny, :nx].astype(dtype)
        + Hds[1, 1 : 1 + nz, :ny, :nx].astype(dtype)
    )


def dual_time_step_ds_padded(
    Ht_ds, Htau_ds, shape, dt, dtau, dx, dy, dz, D, z_bounds=None,
):
    """One ds pseudo-time iteration on stacked hi/lo ghost-padded state.

    Ht_ds: (2, nz, ny8, nx128); Htau_ds: (2, nz+2, ny8, nx128).
    Returns (Htau_ds', sumsq of dHdtau_hi over the updateable cells, f32).
    """
    nz, ny, nx = shape
    f32 = jnp.float32

    def c_(x):
        hi, lo = f32_pair(x)
        return jnp.asarray(hi, f32), jnp.asarray(lo, f32)

    inv_dt, dtau_ = c_(1.0 / dt), c_(dtau)
    bx, by, bz = c_(D / (dx * dx)), c_(D / (dy * dy)), c_(D / (dz * dz))

    uh, ul = Htau_ds[0], Htau_ds[1]
    ch, cl = uh[1 : nz + 1], ul[1 : nz + 1]

    def second_diff(ph, pl_, mh, ml):
        """(p + m) - 2c in ds (exact up to the final lo accumulation)."""
        s, e1 = two_sum(ph, mh)
        t, e2 = two_sum(s, -2.0 * ch)
        return t, (e1 + e2) + ((pl_ + ml) - 2.0 * cl)

    ddz = second_diff(uh[2 : nz + 2], ul[2 : nz + 2], uh[0:nz], ul[0:nz])
    ddy = second_diff(_shift(ch, 1, 1), _shift(cl, 1, 1),
                      _shift(ch, 1, -1), _shift(cl, 1, -1))
    ddx = second_diff(_shift(ch, 2, 1), _shift(cl, 2, 1),
                      _shift(ch, 2, -1), _shift(cl, 2, -1))

    lap = ds_mul_ds(*ddx, *bx)
    lap = ds_add(*lap, *ds_mul_ds(*ddy, *by))
    lap = ds_add(*lap, *ds_mul_ds(*ddz, *bz))

    s, e = two_sum(ch, -Ht_ds[0])
    term = ds_mul_ds(s, e + (cl - Ht_ds[1]), *inv_dt)
    dh_h, dh_l = ds_add(*term, -lap[0], -lap[1])

    if z_bounds is None:
        z_bounds = (1, nz - 2)
    interior = _interior(ch.shape, 0, jnp.asarray(z_bounds[0], jnp.int32),
                         jnp.asarray(z_bounds[1], jnp.int32), ny, nx)
    zero = jnp.asarray(0.0, f32)
    dh_h = jnp.where(interior, dh_h, zero)
    dh_l = jnp.where(interior, dh_l, zero)

    ph, pe = ds_mul_ds(dh_h, dh_l, *dtau_)
    nh, nl = ds_add(ch, cl, -ph, -pe)
    out = Htau_ds.at[:, 1 : nz + 1].set(jnp.stack([nh, nl]))
    return out, jnp.sum(dh_h * dh_h)
