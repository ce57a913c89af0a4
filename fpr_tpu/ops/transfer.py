"""Multigrid inter-grid transfer operators: restriction and prolongation.

Restriction is injection at coincident (odd) fine points
(reference restrict!, multigrid.jl:330-337).

Prolongation is bilinear interpolation.  The reference implements it as a
*scatter* from each interior coarse point with weights {1, 1/2, 1/4} and
needs GPU atomics because neighboring coarse points write overlapping fine
points (multigrid.jl:403-420).  We re-derive it as a *gather*, which needs
no atomics: scattering weight w from every (zero-boundary)
coarse point is identical to upsampling the coarse grid by 2 (zeros in
between) and convolving with the separable kernel

        [[1/4, 1/2, 1/4],
         [1/2,  1 , 1/2],
         [1/4, 1/2, 1/4]]

which we evaluate with shifted adds.  Linearity makes the two forms exactly
equal (unit-tested against a numpy scatter oracle in tests/test_ops2d.py).

Both transfers zero the target boundary and then optionally apply the
Neumann left/right copy, exactly as restrict_wrapper!/prolongate_wrapper!
(multigrid.jl:344-358, 451-472).
"""

from __future__ import annotations

import jax.numpy as jnp

from fpr_tpu.core import bc

def restrict(fine: jnp.ndarray, apply_bcs: bool = False) -> jnp.ndarray:
    """Injection restriction (ny, nx) -> ((ny-1)//2+1, (nx-1)//2+1)."""
    coarse_full = fine[::2, :][:, ::2]
    coarse = bc.zero_boundary_2d(coarse_full)
    if apply_bcs:
        coarse = bc.neumann_left_right(coarse)
    return coarse


def restrict_full_weighting(fine: jnp.ndarray, apply_bcs: bool = False) -> jnp.ndarray:
    """Full-weighting restriction: 9-point average with weights
    {1/4 center, 1/8 faces, 1/16 corners} — the adjoint of the bilinear
    prolongation (scaled by 1/4).

    Not present in the reference (which only has injection); needed for the
    red-black Gauss-Seidel smoother, whose post-sweep residual lives on a
    checkerboard that pure injection aliases (it samples only one color),
    and preferred for the MG-preconditioned-CG composition where an
    (almost) symmetric V-cycle improves robustness.
    """
    # separable blur (1/4, 1/2, 1/4) in each axis, then two-pass stride-2
    def blur_x(a):
        l = jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)
        r = jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
        return 0.25 * l + 0.5 * a + 0.25 * r

    def blur_y(a):
        u = jnp.concatenate([a[:1, :], a[:-1, :]], axis=0)
        d = jnp.concatenate([a[1:, :], a[-1:, :]], axis=0)
        return 0.25 * u + 0.5 * a + 0.25 * d

    blurred = blur_y(blur_x(fine))
    coarse = bc.zero_boundary_2d(blurred[::2, :][:, ::2])
    if apply_bcs:
        coarse = bc.neumann_left_right(coarse)
    return coarse


def restrict_rp(
    res_rp: jnp.ndarray, ny: int, nx: int, apply_bcs: bool = False
) -> jnp.ndarray:
    """Injection restriction straight from a row/col-padded fine array (see
    fpr_tpu.ops.pallas2d) to a *physical* coarse array."""
    from fpr_tpu.ops.pallas2d import PAD

    return restrict(res_rp[PAD : PAD + ny, :nx], apply_bcs=apply_bcs)


def restrict_ps(
    res_ps: jnp.ndarray, ny: int, nx: int, br: int, apply_bcs: bool = False
) -> jnp.ndarray:
    """Injection restriction from a PARITY-SPLIT residual plane (the
    smooth2r_split_rp output: per block of br rows, [even rows; odd rows])
    to a physical coarse array.  The row pass already happened in-kernel;
    this is only the column pass + boundary handling.
    """
    from fpr_tpu.ops.pallas2d import PAD

    nyc, nxc = (ny - 1) // 2 + 1, (nx - 1) // 2 + 1
    nxp = res_ps.shape[1]
    n_blocks = (res_ps.shape[0] - 2 * PAD) // br
    even = (
        res_ps[PAD : PAD + n_blocks * br]
        .reshape(n_blocks, br, nxp)[:, : br // 2]
        .reshape(n_blocks * (br // 2), nxp)
    )
    coarse = even[:nyc, :nx][:, ::2]
    coarse = bc.zero_boundary_2d(coarse)
    if apply_bcs:
        coarse = bc.neumann_left_right(coarse)
    return coarse


def prolongate_rp(
    coarse: jnp.ndarray,
    fine_shape: tuple[int, int],
    rp_shape: tuple[int, int],
    apply_bcs: bool = False,
) -> jnp.ndarray:
    """Bilinear prolongation from a physical coarse array directly into the
    row/col-padded fine layout (pad cells zero)."""
    from fpr_tpu.ops.pallas2d import PAD

    fine = prolongate(coarse, fine_shape, apply_bcs=apply_bcs)
    ny, nx = fine_shape
    return (
        jnp.zeros(rp_shape, fine.dtype).at[PAD : PAD + ny, :nx].set(fine)
    )


def _shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with zero fill: out[i, j] = a[i - dy, j - dx] (0 outside)."""
    ny, nx = a.shape
    out = jnp.zeros_like(a)
    src_y = slice(max(0, -dy), ny - max(0, dy))
    src_x = slice(max(0, -dx), nx - max(0, dx))
    dst_y = slice(max(0, dy), ny - max(0, -dy))
    dst_x = slice(max(0, dx), nx - max(0, -dx))
    return out.at[dst_y, dst_x].set(a[src_y, src_x])


def prolongate(
    coarse: jnp.ndarray, fine_shape: tuple[int, int], apply_bcs: bool = False
) -> jnp.ndarray:
    """Bilinear prolongation, gather form (== reference's atomic scatter),
    built by parity: the four fine-point classes are the coarse values and
    their x/y/xy midpoint averages, interleaved with stack+reshape.
    """
    ny_f, nx_f = fine_shape
    c = bc.zero_boundary_2d(coarse)
    nyc, nxc = c.shape
    cx = (c[:, :-1] + c[:, 1:]) * 0.5        # x midpoints   (nyc, nxc-1)
    cy = (c[:-1, :] + c[1:, :]) * 0.5        # y midpoints   (nyc-1, nxc)
    cxy = (cy[:, :-1] + cy[:, 1:]) * 0.5     # cell centers  (nyc-1, nxc-1)

    even = jnp.stack([c[:, :-1], cx], axis=2).reshape(nyc, 2 * (nxc - 1))
    even = jnp.concatenate([even, c[:, -1:]], axis=1)       # rows 2i
    odd = jnp.stack([cy[:, :-1], cxy], axis=2).reshape(nyc - 1, 2 * (nxc - 1))
    odd = jnp.concatenate([odd, cy[:, -1:]], axis=1)        # rows 2i+1
    fine = jnp.stack([even[:-1], odd], axis=1).reshape(2 * (nyc - 1), nx_f)
    fine = jnp.concatenate([fine, even[-1:]], axis=0)
    assert fine.shape == tuple(fine_shape), (fine.shape, fine_shape)
    if apply_bcs:
        fine = bc.neumann_left_right(fine)
    return fine


def prolongate_shifts(
    coarse: jnp.ndarray, fine_shape: tuple[int, int], apply_bcs: bool = False
) -> jnp.ndarray:
    """Shift-based prolongation (kept as an independent implementation for
    the conv == shifts == numpy-scatter cross-check in tests)."""
    ny_f, nx_f = fine_shape
    c0 = bc.zero_boundary_2d(coarse)  # only interior coarse points scatter
    up = jnp.zeros(fine_shape, dtype=coarse.dtype)
    up = up.at[::2, ::2].set(c0)
    half = 0.5 * (
        _shift(up, 1, 0) + _shift(up, -1, 0) + _shift(up, 0, 1) + _shift(up, 0, -1)
    )
    quarter = 0.25 * (
        _shift(up, 1, 1) + _shift(up, 1, -1) + _shift(up, -1, 1) + _shift(up, -1, -1)
    )
    fine = up + half + quarter
    if apply_bcs:
        fine = bc.neumann_left_right(fine)
    return fine
