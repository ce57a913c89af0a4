"""Fused 2D stencil legs of the multigrid V-cycle on the row-padded layout.

The analog of the reference's shared-memory 2D kernels
(residual_2DPoisson_shmem!, multigrid.jl:191-220; matvec shmem,
krylov.jl:16-34).  One damped-Jacobi smooth is

    res  = (u_E + u_W + u_N + u_S - C u)/h^2 - f
    u'   = u + alpha h^2/C * res         (interior only)
    acc  = sum(res^2 over interior)      (only when the norm is consumed)

and the V-cycle legs chain several sweeps with the post-smooth residual
(downward leg) or with the prolongated correction (upward leg).  The
bodies are plain ``jax.numpy``; XLA fuses each sweep into one pass.  The
reference runs a residual kernel, a separate device reduction and a
broadcast update per smooth (multigrid.jl:245-258).

Row-padded ("rp") layout
------------------------
Operands carry PAD ghost rows above the physical rows and padding below
up to ``padded_rows(ny, br) = PAD + blocks*br + PAD`` rows, with columns
padded to a multiple of LANE (``pad2d`` / ``unpad2d``); physical row y
sits at padded row y + PAD.  ``layout_br`` gives the block-row count; the
downward leg's residual comes back parity-split per block of br rows
([even rows; odd rows]), so injection restriction reads the even halves
only (``transfer.restrict_ps``).  On a row-sharded mesh the PAD ghost rows
hold the neighbours' boundary rows (fpr_tpu.solvers.dist_mg_ds) and every
leg recomputes up to PAD-2 sweeps inside that halo, so a shard reproduces
the single-device arithmetic on its own rows.  Ghost and pad cells only
ever feed cells masked as outside the physical interior.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PAD = 8  # ghost rows above (and below) the block rows; halo depth on a mesh
LANE = 128  # columns are padded to a multiple of this


def layout_br(ny: int) -> int:
    """Block rows of the rp layout for an ny-row level: ny rounded up to a
    multiple of 16, i.e. one block.  Multiples of 16 keep the fine/coarse
    row parity of the upward leg's interpolation fixed; a row-sharded
    level's local row count is already such a multiple and is its own
    block."""
    return -(-ny // 16) * 16


def padded_rows(ny: int, br: int) -> int:
    blocks = -(-ny // br)
    return PAD + blocks * br + PAD


def padded_cols(nx: int) -> int:
    return -(-nx // LANE) * LANE


def pad2d(a, br: int):
    """Physical (ny, nx) -> row/col-padded (padded_rows, padded_cols),
    zeros elsewhere."""
    ny, nx = a.shape
    total = padded_rows(ny, br)
    return jnp.pad(a, ((PAD, total - ny - PAD), (0, padded_cols(nx) - nx)))


def unpad2d(ap, ny: int, nx: int | None = None):
    nx = ap.shape[1] if nx is None else nx
    return ap[PAD : PAD + ny, :nx]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def shift_rows(v, d: int):
    """v at row-1 (d=-1) or row+1 (d=+1), edge rows duplicated (the
    duplicates only feed masked cells)."""
    if d < 0:
        return jnp.concatenate([v[:1], v[:-1]], axis=0)
    return jnp.concatenate([v[1:], v[-1:]], axis=0)


def shift_cols(v, d: int):
    """v at column-1 (d=-1) or column+1 (d=+1), edge columns duplicated."""
    if d < 0:
        return jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)
    return jnp.concatenate([v[:, 1:], v[:, -1:]], axis=1)


def global_coords(shape, row_off=0, col_off=0):
    """(gy, gx): global physical row/column of every rp cell.  row_off is
    the global index of the first physical row (0 single-device; a traced
    shard offset on a mesh), col_off the global column of lane 0 (negative
    on a 2D mesh's left-edge shards, whose ghost lanes sit before the
    domain)."""
    gy = (jnp.asarray(row_off, jnp.int32) - PAD
          + jax.lax.broadcasted_iota(jnp.int32, shape, 0))
    gx = (jnp.asarray(col_off, jnp.int32)
          + jax.lax.broadcasted_iota(jnp.int32, shape, 1))
    return gy, gx


def interior_mask(gy, gx, ny: int, nx: int):
    return (gy > 0) & (gy < ny - 1) & (gx > 0) & (gx < nx - 1)


def block_rows(x):
    """The rows a leg owns: everything but the PAD ghost rows at both ends
    (a shard's own rows on a mesh).  Reductions run over these only."""
    return x[..., PAD : x.shape[-2] - PAD, :]


def block_sumsq(x):
    return jnp.sum(jnp.square(block_rows(x)))


def _smoother_consts(c, h: float, alpha: float, dtype):
    hh = jnp.asarray(h * h, dtype)
    C = jnp.asarray(4.0, dtype) + jnp.asarray(c, dtype) * hh
    h2 = jnp.asarray(1.0 / (h * h), dtype)
    w = jnp.asarray(alpha, dtype) * (hh / C)
    return C, h2, w


class _Level:
    """Per-call stencil context: masks and constants of one rp level."""

    def __init__(self, shape, dtype, ny, nx, h, c, alpha, row_off=0,
                 col_off=0):
        self.gy, self.gx = global_coords(shape, row_off, col_off)
        self.nx = nx
        self.interior = interior_mask(self.gy, self.gx, ny, nx)
        self.C, self.h2, self.w = _smoother_consts(c, h, alpha, dtype)
        self.zero = jnp.zeros((), dtype)

    def res(self, V, F):
        nbr = (shift_rows(V, -1) + shift_rows(V, 1) + shift_cols(V, -1)
               + shift_cols(V, 1))
        return jnp.where(self.interior, (nbr - self.C * V) * self.h2 - F,
                         self.zero)

    def elim(self, V):
        """Eliminated-BC smoothing step (apply_bcs correction cycles): the
        side columns become copies of their interior neighbour, so the
        cycle relaxes the same Neumann-constrained operator the outer
        defect measures (see multigrid._ELIM_BC_SMOOTH).  The true defect
        pass is untouched, so converged results keep reference
        semantics."""
        V = jnp.where(self.gx == 0, shift_cols(V, 1), V)
        return jnp.where(self.gx == self.nx - 1, shift_cols(V, -1), V)

    def sweeps(self, u, f, ns: int, elim: bool, zero_u: bool = False):
        """ns damped-Jacobi sweeps.  Returns (u', residual that fed the
        last sweep).  zero_u: u == 0 structurally, so the first residual
        is -f on the interior (bitwise what the generic sweep gives)."""
        if not 1 <= ns <= PAD - 2:
            raise ValueError(f"1 <= ns <= {PAD - 2} sweeps per leg (got {ns})")
        if zero_u:
            r = jnp.where(self.interior, -f, self.zero)
            u = self.w * r
        else:
            r = self.res(u, f)
            u = u + self.w * r
        if elim:
            u = self.elim(u)
        for _ in range(ns - 1):
            r = self.res(u, f)
            u = u + self.w * r
            if elim:
                u = self.elim(u)
        return u, r


def _parity_split(res, br: int):
    """Per block of br rows: [even rows; odd rows].  br is even, so local
    row parity equals global parity and the even halves are the
    injection-restricted rows."""
    total, nxp = res.shape
    nb = (total - 2 * PAD) // br
    body = res[PAD : PAD + nb * br].reshape(nb, br // 2, 2, nxp)
    body = jnp.swapaxes(body, 1, 2).reshape(nb * br, nxp)
    return jnp.concatenate([res[:PAD], body, res[PAD + nb * br :]], axis=0)


# ---------------------------------------------------------------------------
# downward leg: ns smooths + residual
# ---------------------------------------------------------------------------


def smooth2r_rp(u_rp, f_rp, ny, nx, br, h, c, alpha=0.8):
    """Two smooths plus the resulting residual.  Returns (u_rp'', res_rp)
    — smooth2_rp followed by residual_rp."""
    lv = _Level(u_rp.shape, u_rp.dtype, ny, nx, h, c, alpha)
    u, _ = lv.sweeps(u_rp, f_rp, 2, False)
    return u, lv.res(u, f_rp)


def smooth2r_split_rp(u_rp, f_rp, ny, nx, br, h, c, alpha=0.8, zero_u=False,
                      row_off=0, ny_mask=None, ns=2, col_off=0, nx_mask=None,
                      elim=False):
    """``ns`` smooths plus the residual, parity-split per block — the
    V-cycle's downward leg.  Returns (u_rp'', res_ps) where res_ps feeds
    transfer.restrict_ps (the even halves ARE the injected coarse rows).

    zero_u=True: the caller guarantees u == 0 (coarse corrections, the
    defect-correction top level); u_rp is not read.

    Distributed: ny/nx are this shard's LOCAL layout (nx including ghost
    columns on a 2D mesh), ny_mask/nx_mask the GLOBAL grid, row_off the
    global index of local physical row 0 and col_off the global column of
    lane 0.  The shard's PAD ghost rows must hold the neighbours' boundary
    rows (fpr_tpu.solvers.dist_mg_ds refreshes them via ppermute)."""
    lv = _Level(f_rp.shape, f_rp.dtype, ny_mask or ny, nx_mask or nx, h, c,
                alpha, row_off, col_off)
    u, _ = lv.sweeps(u_rp, f_rp, ns, elim, zero_u=zero_u)
    return u, _parity_split(lv.res(u, f_rp), br)


def smooth2r_stk(L, ny, nx, br, h, c, alpha=0.8, zero_u=False, row_off=0,
                 ny_mask=None, ns=2, elim=False):
    """Downward leg on the stacked (2, total, nxp) level state L = [u | f].

    Returns (L', res_ps): plane 0 = u after ``ns`` smooths, plane 1 = f
    unchanged; res_ps the parity-split residual.  Identical to
    smooth2r_split_rp on (L[0], L[1])."""
    u, res_ps = smooth2r_split_rp(
        L[0], L[1], ny, nx, br, h, c, alpha, zero_u=zero_u, row_off=row_off,
        ny_mask=ny_mask, ns=ns, elim=elim,
    )
    return L.at[0].set(u), res_ps


# ---------------------------------------------------------------------------
# upward leg: prolongate + correct + ns smooths
# ---------------------------------------------------------------------------


def x_interleave_coarse(coarse, apply_bcs=False):
    """Bilinear-interpolate the (zero-boundary-masked) coarse correction
    along x only, producing fine-width rows at coarse-row resolution; the
    upward leg interpolates in y."""
    from fpr_tpu.core import bc as _bc

    c0 = _bc.zero_boundary_2d(coarse)
    nyc, nxc = c0.shape
    cx = (c0[:, :-1] + c0[:, 1:]) * 0.5
    rows = jnp.stack([c0[:, :-1], cx], axis=2).reshape(nyc, 2 * (nxc - 1))
    rows = jnp.concatenate([rows, c0[:, -1:]], axis=1)  # (nyc, nx_fine)
    if apply_bcs:
        rows = _bc.neumann_left_right(rows)
    return rows


def corr_rows_needed(ny: int, br: int) -> int:
    """Rows of the x-interleaved correction buffer the upward leg reads."""
    total = padded_rows(ny, br)
    n_blocks = (total - 2 * PAD) // br
    return n_blocks * (br // 2) + 2 * PAD


def _y_interleave(corrx_rp, total: int):
    """Fine-row correction from the x-interleaved coarse buffer (coarse
    row j at buffer row PAD + j): even padded rows R take buffer row
    R/2 + PAD/2, odd rows the midpoint of that row and the next."""
    half = PAD // 2
    rowpair = corrx_rp[half : half + total // 2]
    rowmid = (rowpair + corrx_rp[half + 1 : half + 1 + total // 2]) * 0.5
    return jnp.stack([rowpair, rowmid], axis=1).reshape(total, -1)


def corr_smooth2_raw(
    u_rp, f_rp, corrx_rp, ny, nx, br, h, c,
    alpha=0.8, with_norm=False, row_off=0, ny_mask=None, raw_acc=False, ns=2,
    col_off=0, nx_mask=None, elim=False,
):
    """Upward leg on a PREBUILT x-interleaved correction buffer: local
    coarse row j (fine-width, x-interleaved) at buffer row PAD + j, with
    rows [PAD-4, PAD) / [PAD+nyc_local, ...) holding neighbour halo rows in
    the distributed layout (zeros single-device).  u -= y-interp(corr),
    then ``ns`` smooths.  Returns (u_rp'', acc) where acc is None without
    with_norm, else sum(res^2) of the residual that fed the last smooth
    over the block rows (raw_acc) or that sum's r_rms over the GLOBAL
    (ny_mask or ny) x (nx_mask or nx) cell count."""
    if br % 16:
        raise ValueError(f"the upward leg needs br % 16 == 0 (got {br})")
    lv = _Level(u_rp.shape, u_rp.dtype, ny_mask or ny, nx_mask or nx, h, c,
                alpha, row_off, col_off)
    u = u_rp - _y_interleave(corrx_rp, u_rp.shape[0])
    if elim:
        u = lv.elim(u)
    u, r = lv.sweeps(u, f_rp, ns, elim)
    if not with_norm:
        return u, None
    acc = block_sumsq(r)
    if raw_acc:
        return u, acc
    return u, jnp.sqrt(acc / ((nx_mask or nx) * (ny_mask or ny)))


def corr_smooth2_rp(
    u_rp, f_rp, corr_phys, ny, nx, br, h, c,
    alpha=0.8, apply_bcs=False, with_norm=False, ns=2, elim=False,
):
    """Upward leg: u -= prolongate(corr); ``ns`` smooths; optional norm.

    corr_phys is the coarse level's PHYSICAL array.  Requires br % 16 == 0.
    Returns (u_rp'', r_rms or None).
    """
    corrx = x_interleave_coarse(corr_phys, apply_bcs=apply_bcs)
    corrx_rp = jnp.zeros((corr_rows_needed(ny, br), padded_cols(nx)),
                         corrx.dtype)
    corrx_rp = corrx_rp.at[PAD : PAD + corrx.shape[0], :nx].set(corrx)
    return corr_smooth2_raw(
        u_rp, f_rp, corrx_rp, ny, nx, br, h, c,
        alpha=alpha, with_norm=with_norm, ns=ns, elim=elim,
    )


def corr_smooth2_stk(L, corrx_rp, ny, nx, br, h, c, alpha=0.8,
                     with_norm=False, row_off=0, ny_mask=None, ns=2,
                     elim=False):
    """Upward leg on the stacked level state and a PREBUILT x-interleaved
    correction buffer (see corr_smooth2_raw).  Returns (L', r_rms or None)
    with plane 0 = corrected+smoothed u, plane 1 unchanged."""
    u, r_rms = corr_smooth2_raw(
        L[0], L[1], corrx_rp, ny, nx, br, h, c, alpha=alpha,
        with_norm=with_norm, row_off=row_off, ny_mask=ny_mask, ns=ns,
        elim=elim,
    )
    return L.at[0].set(u), r_rms


# ---------------------------------------------------------------------------
# single sweeps, residual and matvec on rp operands
# ---------------------------------------------------------------------------


def smooth_rp(u_rp, f_rp, ny, nx, br, h, c, alpha=0.8, with_norm=True):
    """One damped-Jacobi smooth on row-padded operands.

    Returns (u_rp', r_rms or None); r_rms matches the reference convention
    sqrt(sum(res^2)/(nx*ny)) with res = 0 on the boundary ring
    (multigrid.jl:245-258).
    """
    lv = _Level(u_rp.shape, u_rp.dtype, ny, nx, h, c, alpha)
    u, r = lv.sweeps(u_rp, f_rp, 1, False)
    return u, (jnp.sqrt(block_sumsq(r) / (nx * ny)) if with_norm else None)


def smooth2_rp(u_rp, f_rp, ny, nx, br, h, c, alpha=0.8, with_norm=True):
    """Two chained damped-Jacobi smooths.  Returns (u_rp'', r_rms of the
    second sweep's pre-update residual) — the value two consecutive
    ``smooth_rp`` calls would report."""
    lv = _Level(u_rp.shape, u_rp.dtype, ny, nx, h, c, alpha)
    u, r = lv.sweeps(u_rp, f_rp, 2, False)
    return u, (jnp.sqrt(block_sumsq(r) / (nx * ny)) if with_norm else None)


def residual_rp(u_rp, f_rp, ny, nx, br, h, c):
    """res = (nabla^2 - c)u - f, row-padded in and out."""
    return _Level(u_rp.shape, u_rp.dtype, ny, nx, h, c, 0.0).res(u_rp, f_rp)


def matvec_rp(x_rp, ny, nx, br, h, c, with_dot=False):
    """Row-padded (nabla^2 - c) x.  with_dot additionally returns the
    interior dot sum(x * Ax) — the PCG curvature p.Ap (reference matvec:
    krylov.jl:7-34, which computes no dot; the host-summed sum(p.*p_hat)
    there is krylov.jl:69)."""
    dtype = x_rp.dtype
    gy, gx = global_coords(x_rp.shape)
    nbr = (shift_rows(x_rp, -1) + shift_rows(x_rp, 1) + shift_cols(x_rp, -1)
           + shift_cols(x_rp, 1))
    val = ((nbr - 4.0 * x_rp) * jnp.asarray(1.0 / (h * h), dtype)
           - jnp.asarray(c, dtype) * x_rp)
    out = jnp.where(interior_mask(gy, gx, ny, nx), val, jnp.zeros((), dtype))
    if with_dot:
        return out, jnp.sum(block_rows(x_rp * out))
    return out


def matvec_dot_rp(x_rp, ny, nx, br, h, c):
    """sum(x * (nabla^2 - c) x) over the interior (the PCG curvature)."""
    return matvec_rp(x_rp, ny, nx, br, h, c, with_dot=True)[1]


# ---------------------------------------------------------------------------
# physical-layout drop-ins (parity tests, ExecutionPolicy.PALLAS, CG)
# ---------------------------------------------------------------------------


def residual(u, f, h, c):
    ny, nx = u.shape
    br = layout_br(ny)
    out = residual_rp(pad2d(u, br), pad2d(f, br), ny, nx, br, h, c)
    return unpad2d(out, ny, nx)


def jacobi_step(u, f, h, c, alpha=0.8, with_norm=True):
    ny, nx = u.shape
    br = layout_br(ny)
    out, r_rms = smooth_rp(
        pad2d(u, br), pad2d(f, br), ny, nx, br, h, c, alpha, with_norm
    )
    return unpad2d(out, ny, nx), r_rms


def matvec(x, hx, hy, c):
    """(nabla^2 - c) x; requires hx == hy (true everywhere in this code)."""
    if hx != hy:
        raise ValueError(f"matvec needs hx == hy (got {hx}, {hy})")
    ny, nx = x.shape
    br = layout_br(ny)
    return unpad2d(matvec_rp(pad2d(x, br), ny, nx, br, hx, c), ny, nx)
