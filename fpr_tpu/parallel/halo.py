"""Halo exchange over the device mesh via ppermute.

The replacement for ImplicitGlobalGrid's ``update_halo!``
(part1_kernel_programming.jl:182,187): inside a shard_map, each shard sends
its boundary face planes to the +/-1 neighbors along a mesh axis.
Non-periodic edges receive zeros (``lax.ppermute`` zero-fills unlisted
destinations), which is exactly right for the Dirichlet problems here: the
values only ever feed cells masked as global physical boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_faces(local: jnp.ndarray, axis_name: str, dim: int):
    """Exchange one-cell faces of a local block along array dimension `dim`
    decomposed over mesh axis `axis_name`.

    Returns (ghost_lo, ghost_hi): neighbor faces for local index -1 and n
    (zeros at the global edges).
    """
    n = lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    lo_face = jax.lax.slice_in_dim(local, local.shape[dim] - 1, local.shape[dim], axis=dim)
    hi_face = jax.lax.slice_in_dim(local, 0, 1, axis=dim)
    ghost_lo = lax.ppermute(lo_face, axis_name, fwd)
    ghost_hi = lax.ppermute(hi_face, axis_name, bwd)
    return ghost_lo, ghost_hi


def refresh_ghosts_ext(ext: jnp.ndarray, sharded: dict[int, str]):
    """Refresh the ghost shells of a fully ghost-padded (n+2 per dim) local
    block: ppermute for the sharded dims (dim index -> mesh axis name);
    unsharded dims keep their zero ghosts (global Dirichlet outside)."""
    inner = ext[1:-1, 1:-1, 1:-1]
    for dim, axis_name in sharded.items():
        lo, hi = exchange_faces(inner, axis_name, dim)
        pad = [(1, 1)] * 3
        pad[dim] = (0, 0)
        lo = jnp.pad(lo, pad)
        hi = jnp.pad(hi, pad)
        idx_lo = [slice(None)] * 3
        idx_lo[dim] = slice(0, 1)
        idx_hi = [slice(None)] * 3
        idx_hi[dim] = slice(ext.shape[dim] - 1, ext.shape[dim])
        ext = ext.at[tuple(idx_lo)].set(lo)
        ext = ext.at[tuple(idx_hi)].set(hi)
    return ext


def mask_bounds(axis_name: str | None, n_local: int):
    """(lo, hi): local index range (inclusive) of updateable cells along one
    dimension — interior shards update everything; the global-edge shards
    exclude the physical boundary layer.  axis_name=None means unsharded
    (both edges are global)."""
    if axis_name is None:
        return jnp.asarray(1), jnp.asarray(n_local - 2)
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    lo = jnp.where(idx == 0, 1, 0)
    hi = jnp.where(idx == n - 1, n_local - 2, n_local - 1)
    return lo, hi


def exchange_faces_z(local: jnp.ndarray, axis_name: str):
    """Exchange one-plane z-faces of a local (nz_l, ny, nx) block."""
    return exchange_faces(local, axis_name, 0)


def set_ghost_planes_z(padded: jnp.ndarray, axis_name: str):
    """Refresh the z ghost planes of a z-ghost-padded (nz_l+2, ny, nx) block
    from the neighbors' current boundary planes."""
    inner = padded[1:-1, :, :]
    below, above = exchange_faces_z(inner, axis_name)
    padded = padded.at[0:1, :, :].set(below)
    padded = padded.at[-1:, :, :].set(above)
    return padded


def refresh_ghosts_zk(Hp, nz: int, axis_name: str, K: int, base: int | None = None):
    """Refresh K-deep z ghost planes of a K-ghost-padded local block
    (fpr_tpu.ops.pallas3d.pad3dk layout: physical planes at [base, base+nz),
    base defaulting to K) — the communication-avoiding halo exchange for
    the K-iteration step: ONE K-plane message per direction feeds K
    pseudo-time iterations (the deep halo absorbs them by local
    recomputation), vs K one-plane exchanges on the unfused path.  Fewer,
    bigger messages — the scaled analog of @hide_communication
    (part1_kernel_programming.jl:185-188)."""
    base = K if base is None else base
    if K == 0:
        return Hp
    n = lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    lo_face = Hp[base + nz - K : base + nz]   # my last K physical planes
    hi_face = Hp[base : base + K]             # my first K physical planes
    ghost_lo = lax.ppermute(lo_face, axis_name, fwd)
    ghost_hi = lax.ppermute(hi_face, axis_name, bwd)
    Hp = Hp.at[base - K : base].set(ghost_lo)
    Hp = Hp.at[base + nz : base + nz + K].set(ghost_hi)
    return Hp


def refresh_ghosts_padded(Hp, shape, sharded, ghosts):
    """Refresh every sharded dimension's ghost layer of a padded-layout
    (nz+2, gy+ny8+gy, gx+nx128+gx) block (fpr_tpu.ops.pallas3d.pad3d).

    sharded: dim index (0/1/2) -> mesh axis name.  The one-cell faces are
    ppermuted in full padded width; a face's own ghost/pad cells carry
    stale values but only ever feed masked (non-updateable) cells — the
    7-point stencil never reads diagonal corners.
    """
    nz, ny, nx = shape
    gy, gx = ghosts
    for dim, axis_name in sharded.items():
        if dim == 0:
            lo_face = Hp[nz : nz + 1, :, :]      # last physical plane
            hi_face = Hp[1:2, :, :]              # first physical plane
            dst_lo, dst_hi = 0, nz + 1
        elif dim == 1:
            lo_face = Hp[:, gy + ny - 1 : gy + ny, :]
            hi_face = Hp[:, gy : gy + 1, :]
            dst_lo, dst_hi = gy - 1, gy + ny
        else:
            lo_face = Hp[:, :, gx + nx - 1 : gx + nx]
            hi_face = Hp[:, :, gx : gx + 1]
            dst_lo, dst_hi = gx - 1, gx + nx
        n = lax.axis_size(axis_name)
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        ghost_lo = lax.ppermute(lo_face, axis_name, fwd)
        ghost_hi = lax.ppermute(hi_face, axis_name, bwd)
        idx_lo = [slice(None)] * 3
        idx_lo[dim] = slice(dst_lo, dst_lo + 1)
        idx_hi = [slice(None)] * 3
        idx_hi[dim] = slice(dst_hi, dst_hi + 1)
        Hp = Hp.at[tuple(idx_lo)].set(ghost_lo)
        Hp = Hp.at[tuple(idx_hi)].set(ghost_hi)
    return Hp


