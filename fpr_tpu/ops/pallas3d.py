"""Fused 3D dual-time diffusion step on ghost-padded state.

The analog of the reference's kernel tiers
(diffusion_3D_step_tau[_shared_memory], part1_kernel_programming.jl:46-97).
One call performs

    dHdtau = (Htau - Ht)/dt - D * nabla^2 Htau      (7-point stencil)
    Htau'  = Htau - dtau * dHdtau                    (interior cells only)
    sumsq  = sum(dHdtau^2 over interior)             (the convergence norm)

as one elementwise expression plus its reduction, which XLA fuses into one
or two passes over the state.  The K-step variants run K pseudo-time
iterations per call on state with a K-deep z halo (the norm is the LAST
iteration's; the driver checks every K iterations,
DiffusionConfig.check_every=K).

Layouts:

- ``pad3d``/``unpad3d``: (nz+2, ny8, nx128) — one ghost plane on each
  side of z, y/x padded up to multiples of 8/128 (the pad cells are masked
  out of every update and norm); ``ghosts=(gy, gx)`` adds ghost blocks on
  both sides of y/x for meshes that decompose those dimensions (refreshed
  by parallel.halo.refresh_ghosts_padded).  ``pad_ht`` is the matching
  ghost-free Ht layout.
- ``pad3dk``/``pad_htk``: K-deep z halo for the K-step variant; on a
  z-sharded mesh one K-plane halo exchange feeds K iterations, which
  recompute the halo planes locally (parallel.halo.refresh_ghosts_zk).
- ``stack_state_k``: Htau (plane-set 0) and Ht (plane-set 1) in one
  (2, nz+2K, ny8, nx128) array, the single-device production carry.

Ghost planes only feed cells masked as physical boundary (Dirichlet faces
keep their values, matching the reference's interior guard,
part1_kernel_programming.jl:47) and every call returns them unchanged.
Numerics are identical to fpr_tpu.ops.stencil3d up to reassociation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pad_yx(ny: int, nx: int) -> tuple[int, int]:
    """Stored (y, x) extents: y rounded up to 8, x to 128."""
    return -(-ny // 8) * 8, -(-nx // 128) * 128


def pad3d(H, ghosts=(0, 0)):
    """Physical (nz, ny, nx) -> (nz+2, gy+ny8+gy, gx+nx128+gx): one z-ghost
    plane on each side, y/x padded up to the stored extents, plus
    ``ghosts=(gy, gx)`` ghost rows/columns on both sides of y/x for meshes
    that decompose those dimensions (the stencil then reads neighbour
    values from padded row/lane gy-1 / gx-1 and gy+ny / gx+nx)."""
    nz, ny, nx = H.shape
    gy, gx = ghosts
    ny8, nx128 = _pad_yx(ny, nx)
    return jnp.pad(
        H, ((1, 1), (gy, gy + ny8 - ny), (gx, gx + nx128 - nx))
    )


def pad_ht(H, ghosts=(0, 0)):
    """Physical Ht -> (nz, ...) with pad3d's y/x layout (no z ghosts)."""
    nz, ny, nx = H.shape
    gy, gx = ghosts
    ny8, nx128 = _pad_yx(ny, nx)
    return jnp.pad(H, ((0, 0), (gy, gy + ny8 - ny), (gx, gx + nx128 - nx)))


def unpad3d(Hp, shape=None, ghosts=(0, 0)):
    """Padded -> physical view."""
    if shape is None:
        return Hp[1:-1, :, :]
    nz, ny, nx = shape
    gy, gx = ghosts
    return Hp[1 : 1 + nz, gy : gy + ny, gx : gx + nx]


def pad3dk(H, K=2):
    """Physical -> K-deep-z-ghost-padded (nz+2K, ny8, nx128) for the
    K-iteration step."""
    nz, ny, nx = H.shape
    ny8, nx128 = _pad_yx(ny, nx)
    return jnp.pad(H, ((K, K), (0, ny8 - ny), (0, nx128 - nx)))


def pad_htk(H, K=2):
    """Physical Ht -> (K-1)-deep-z-ghost-padded (nz+2K-2, ...): the first
    of K sweeps updates K-1 planes beyond the physical ones, so it reads
    Ht there too (ghost planes only feed masked cells)."""
    nz, ny, nx = H.shape
    ny8, nx128 = _pad_yx(ny, nx)
    return jnp.pad(H, ((K - 1, K - 1), (0, ny8 - ny), (0, nx128 - nx)))


def unpad3dk(Hp, shape, K=2):
    nz, ny, nx = shape
    return Hp[K : K + nz, :ny, :nx]


# K=2 aliases (the original two-iteration entry points)
def pad3d2(H):
    return pad3dk(H, 2)


def pad_ht2(H):
    return pad_htk(H, 2)


def unpad3d2(Hp, shape):
    return unpad3dk(Hp, shape, 2)


def _shift(a, axis: int, d: int):
    """a at index-1 (d=-1) or index+1 (d=+1) along ``axis``, edge planes
    duplicated (the duplicates only feed masked cells)."""
    n = a.shape[axis]
    if d < 0:
        parts = (jax.lax.slice_in_dim(a, 0, 1, axis=axis),
                 jax.lax.slice_in_dim(a, 0, n - 1, axis=axis))
    else:
        parts = (jax.lax.slice_in_dim(a, 1, n, axis=axis),
                 jax.lax.slice_in_dim(a, n - 1, n, axis=axis))
    return jnp.concatenate(parts, axis=axis)


def _sweep(center, zm, zp, ht, interior, dt, dtau, dx, dy, dz, D):
    """One masked dual-time update of ``center`` (z neighbours given, y/x
    neighbours by in-plane shifts).  Returns (updated, dHdtau)."""
    dtype = center.dtype
    lap = (
        (_shift(center, 2, 1) - 2.0 * center + _shift(center, 2, -1))
        * jnp.asarray(1.0 / (dx * dx), dtype)
        + (_shift(center, 1, 1) - 2.0 * center + _shift(center, 1, -1))
        * jnp.asarray(1.0 / (dy * dy), dtype)
        + (zp - 2.0 * center + zm) * jnp.asarray(1.0 / (dz * dz), dtype)
    )
    dH = (center - ht) * jnp.asarray(1.0 / dt, dtype) - jnp.asarray(D, dtype) * lap
    dH = jnp.where(interior, dH, jnp.zeros((), dtype))
    return center - jnp.asarray(dtau, dtype) * dH, dH


def _interior(shape, gz0, z_lo, z_hi, ny, nx, gy_off=0, gx_off=0,
              yx_bounds=None):
    """Updateable cells of a (planes, y, x) window whose first plane is
    physical z = gz0.  y/x bounds default to the single-device interior."""
    gz = gz0 + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    gy = jax.lax.broadcasted_iota(jnp.int32, shape, 1) - gy_off
    gx = jax.lax.broadcasted_iota(jnp.int32, shape, 2) - gx_off
    ylo, yhi, xlo, xhi = yx_bounds or (1, ny - 2, 1, nx - 2)
    return ((gz >= z_lo) & (gz <= z_hi) & (gy >= ylo) & (gy <= yhi)
            & (gx >= xlo) & (gx <= xhi))


def _k_sweeps(Htau_k, ht_of, K, shape, z_bounds, kw):
    """K chained sweeps on a K-deep-z-ghost-padded window: sweep j updates
    the nz + 2(K-j) planes with physical base -(K-j) from sweep j-1's
    window (ht_of(j, m) gives the matching Ht planes), so the final window
    is exactly the physical planes.  Returns (Htau_k', sumsq of the LAST
    sweep's dHdtau)."""
    nz, ny, nx = shape
    if z_bounds is None:
        z_bounds = (1, nz - 2)
    z_lo = jnp.asarray(z_bounds[0], jnp.int32)
    z_hi = jnp.asarray(z_bounds[1], jnp.int32)
    u = Htau_k
    dH = None
    for j in range(1, K + 1):
        m = nz + 2 * (K - j)
        center = u[1 : 1 + m]
        inter = _interior(center.shape, -(K - j), z_lo, z_hi, ny, nx)
        u, dH = _sweep(center, u[0:m], u[2 : 2 + m], ht_of(j, m), inter, **kw)
    return Htau_k.at[K : K + nz].set(u), jnp.sum(dH * dH)


def dual_time_stepk_padded(
    Ht_paddedk, Htau_paddedk, shape, dt, dtau, dx, dy, dz, D,
    K=2, z_bounds=None,
):
    """K pseudo-time iterations on K-deep-ghost-padded state.

    Ht_paddedk is ``pad_htk``-shaped (nz+2K-2, ny8, nx128); Htau_paddedk is
    ``pad3dk``-shaped (nz+2K, ny8, nx128).  z_bounds: inclusive physical z
    range of updateable planes (default the single-device interior; a
    z-sharded caller extends it into the ghost planes to recompute the
    halo).  Returns (Htau_paddedk', sumsq of the LAST iteration's
    dHdtau).
    """
    kw = dict(dt=dt, dtau=dtau, dx=dx, dy=dy, dz=dz, D=D)
    return _k_sweeps(
        Htau_paddedk, lambda j, m: Ht_paddedk[j - 1 : j - 1 + m], K, shape,
        z_bounds, kw,
    )


def dual_time_step2_padded(
    Ht_padded2, Htau_padded2, shape, dt, dtau, dx, dy, dz, D, z_bounds=None,
):
    """Two pseudo-time iterations (the K=2 case of
    ``dual_time_stepk_padded``, kept as the original entry point)."""
    return dual_time_stepk_padded(
        Ht_padded2, Htau_padded2, shape, dt, dtau, dx, dy, dz, D,
        K=2, z_bounds=z_bounds,
    )


def stack_state_k(Ht, Htau, K=3):
    """Physical Ht/Htau -> the stacked state (2, nz+2K, ny8, nx128):
    plane-set 0 = Htau, plane-set 1 = Ht, both K-ghost-padded alike."""
    return jnp.stack([pad3dk(Htau, K), pad3dk(Ht, K)])


def unstack_state_k(state, shape, K=3):
    """Stacked state -> physical Htau."""
    return unpad3dk(state[0], shape, K)


def dual_time_stepk_stacked(
    state, shape, dt, dtau, dx, dy, dz, D, K=3, z_bounds=None,
):
    """K pseudo-time iterations on the stacked (Htau, Ht) state.

    Returns (state', sumsq of the LAST iteration's dHdtau); the Ht planes
    and every ghost plane come back unchanged."""
    kw = dict(dt=dt, dtau=dtau, dx=dx, dy=dy, dz=dz, D=D)
    Htau_k, sumsq = _k_sweeps(
        state[0], lambda j, m: state[1, j : j + m], K, shape, z_bounds, kw
    )
    return state.at[0].set(Htau_k), sumsq


def dual_time_step_padded(
    Ht_padded, Htau_padded, shape, dt, dtau, dx, dy, dz, D,
    z_bounds=None, bounds=None, ghosts=(0, 0),
):
    """One pseudo-time iteration on ghost-padded state.

    shape is the logical (nz, ny, nx); Ht_padded is ``pad_ht``-shaped and
    Htau_padded ``pad3d``-shaped (both with matching ``ghosts``).
    Bounds are inclusive local ranges of updateable cells per axis:
    ``bounds`` = (zlo, zhi, ylo, yhi, xlo, xhi), or ``z_bounds`` =
    (zlo, zhi) with full-interior y/x.  Defaults to the single-device
    global-Dirichlet interior; sharded callers pass shard-dependent values
    (parallel.halo.mask_bounds).  Returns (Htau_padded', sumsq of dHdtau
    over the updateable cells).
    """
    nz, ny, nx = shape
    gy, gx = ghosts
    if bounds is None:
        if z_bounds is None:
            z_bounds = (1, nz - 2)
        bounds = (z_bounds[0], z_bounds[1], 1, ny - 2, 1, nx - 2)
    b = [jnp.asarray(v, jnp.int32) for v in bounds]
    center = Htau_padded[1 : 1 + nz]
    inter = _interior(center.shape, 0, b[0], b[1], ny, nx, gy, gx,
                      yx_bounds=tuple(b[2:]))
    new, dH = _sweep(center, Htau_padded[0:nz], Htau_padded[2 : 2 + nz],
                     Ht_padded, inter, dt=dt, dtau=dtau, dx=dx, dy=dy, dz=dz,
                     D=D)
    return Htau_padded.at[1 : 1 + nz].set(new), jnp.sum(dH * dH)


def dual_time_step(Ht, Htau, dt, dtau, dx, dy, dz, D, with_norm=True):
    """Drop-in replacement for stencil3d.dual_time_step on physical arrays
    (pads/unpads around the step — use the padded variants inside
    iteration loops)."""
    out_p, sumsq = dual_time_step_padded(
        pad_ht(Ht), pad3d(Htau), Ht.shape, dt, dtau, dx, dy, dz, D
    )
    return unpad3d(out_p, Ht.shape), (sumsq if with_norm else None)
