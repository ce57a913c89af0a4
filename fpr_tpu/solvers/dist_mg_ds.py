"""Production-tier distributed multigrid: ``mg_solve_ds`` sharded over a
device mesh with per-shard fused legs and ppermute halo exchange.

This is the multi-device form of the framework's fastest 2D solver (the
double-single defect-correction MG, fpr_tpu/solvers/multigrid.py) — the
capability the reference cannot reach at all: its part-2 multigrid runs on
exactly one GPU (multigrid.jl:41-170), while grids at k >= 15 (32769^2:
~21 GB of f32 solver state) outgrow one card.  The layer composition
mirrors the reference's part-1 distribution design (init_global_grid +
update_halo!, part1_kernel_programming.jl:100-101,182): shard_map over a
1D mesh axis, 8-row halo slots (the rp layout's PAD rows double as ghost
buffers), psum norms, and a replicated coarse subtree.

Layout
------
Rows are decomposed.  Each device owns ``ny_l`` contiguous global rows at
the fine level, ``ny_l`` a multiple of ``16 * 2**(s-1)`` so that every one
of the ``s`` sharded levels keeps even, 16-aligned local row counts (the
rp layout's block rule) and shard offsets preserve fine/coarse row parity.
The last shard's tail rows beyond the global grid are dead: the interior
masks (driven by the *global* row index ``off + row``) never update them,
and halo exchange never reads them.

Per sharded level and V-cycle leg the shard runs the SAME fused legs as
the single-device solver (`smooth2r_split_rp`, `corr_smooth2_raw`,
`ds.defect_pass`) with a traced global-row offset; the PAD=8 ghost rows are
refreshed by one (8, nxp)-face ppermute pair per array per leg — the halo
recomputation inside the legs then reproduces the single-device arithmetic
on every shard.  Below ``replicate_below`` global rows the residual is
assembled on every device (a psum of zero-padded slabs, typed replicated)
and every device runs the identical coarse subtree (jnp V-cycle + DST
coarse solve) redundantly — at <= 513^2 the subtree is latency-, not
compute-bound, and redundancy beats collectives.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fpr_tpu.core.config import ExecutionPolicy, MGConfig, Smoother
from fpr_tpu.core.grid import mg_levels
from fpr_tpu.ops import pallas2d
from fpr_tpu.ops.pallas2d import PAD, padded_cols, padded_rows


def _elim(apply_bcs: bool) -> bool:
    """Eliminated-BC smoothing gate — delegates to multigrid._elim (single
    source of truth) so the sharded tier stays iteration-parity with the
    single-device solver under A/B flips (lazy import avoids a cycle)."""
    from fpr_tpu.solvers import multigrid

    return multigrid._elim(apply_bcs)


# ---------------------------------------------------------------------------
# static shard plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    ny: int                   # global rows (2^k + 1)
    nx: int                   # global cols
    ndev: int
    s: int                    # number of sharded levels (>= 1)
    ny_l: int                 # local rows at the fine level
    brs: tuple[int, ...]      # rp block rows per sharded level

    def level(self, m: int):
        """(ny_l_m, ny_g_m, nx_g_m, br_m) for sharded level m."""
        return (
            self.ny_l >> m,
            ((self.ny - 1) >> m) + 1,
            ((self.nx - 1) >> m) + 1,
            self.brs[m],
        )


def plan_shards(
    ny: int, nx: int, ndev: int, cfg: MGConfig, replicate_below: int = 1025
) -> ShardPlan:
    levels = mg_levels(nx, ny, cfg.coarse_size)  # [(nx_m, ny_m), ...]
    s = 0
    for m, (nxm, nym) in enumerate(levels):
        if nym >= replicate_below and m < len(levels) - 1:
            s += 1
        else:
            break
    if s < 1:
        raise ValueError(
            f"grid {ny}x{nx} too small to shard (replicate_below="
            f"{replicate_below}); use the single-device solver"
        )
    align = 16 * (1 << (s - 1))
    ny_l = -(-ny // (ndev * align)) * align
    brs = tuple(pallas2d.layout_br(ny_l >> m) for m in range(s))
    return ShardPlan(ny=ny, nx=nx, ndev=ndev, s=s, ny_l=ny_l, brs=brs)


# ---------------------------------------------------------------------------
# shard-local helpers (used inside shard_map)
# ---------------------------------------------------------------------------


def _refresh(a, ny_l: int, axis: str):
    """Refresh the PAD-row ghost slots of a local rp array (leading dims
    allowed, rows at axis -2) from the +-1 neighbors; global edges get
    zeros (the single-device pad value).  Also overwrites the unspecified
    ghost rows of fresh leg outputs."""
    n = lax.axis_size(axis)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    top_face = a[..., PAD : 2 * PAD, :]          # my first PAD physical rows
    bot_face = a[..., ny_l : ny_l + PAD, :]      # my last PAD physical rows
    from_up = lax.ppermute(bot_face, axis, fwd)
    from_dn = lax.ppermute(top_face, axis, bwd)
    a = a.at[..., 0:PAD, :].set(from_up)
    a = a.at[..., PAD + ny_l : PAD + ny_l + PAD, :].set(from_dn)
    return a


def _restrict_ps_cols(res_ps, ny_l: int, br: int, nx: int,
                      apply_bcs: bool = False):
    """Injection restriction of a parity-split local residual: extract the
    per-block even halves (the leg's row pass) and stride the columns.
    Returns the local PHYSICAL coarse slab (ny_l//2, nxc).  No boundary-row
    zeroing: global-boundary residual rows are already masked to zero by
    the leg; columns 0 / nxc-1 are zeroed (global in every shard).
    apply_bcs: the Neumann left/right column copies of transfer.restrict_ps
    — a lane-dim operation, identical in every shard."""
    nxp = res_ps.shape[-1]
    n_blocks = ny_l // br
    even = (
        res_ps[PAD : PAD + ny_l]
        .reshape(n_blocks, br, nxp)[:, : br // 2]
        .reshape(ny_l // 2, nxp)
    )
    nxc = (nx - 1) // 2 + 1
    coarse = even[:, :nx][:, ::2]
    coarse = coarse.at[:, 0].set(0.0)
    coarse = coarse.at[:, nxc - 1].set(0.0)
    if apply_bcs:
        coarse = coarse.at[:, 0].set(coarse[:, 1])
        coarse = coarse.at[:, nxc - 1].set(coarse[:, nxc - 2])
    return coarse


def _x_interleave_cols(slab, nxc: int, apply_bcs: bool = False):
    """x_interleave_coarse minus the boundary-ROW zeroing (rows here are a
    local window mid-grid; global boundary rows are structurally zero in
    every coarse correction).  slab: (rows, nxc) physical columns."""
    c0 = slab.at[:, 0].set(0.0).at[:, nxc - 1].set(0.0)
    rows = c0.shape[0]
    cx = (c0[:, :-1] + c0[:, 1:]) * 0.5
    out = jnp.stack([c0[:, :-1], cx], axis=2).reshape(rows, 2 * (nxc - 1))
    out = jnp.concatenate([out, c0[:, -1:]], axis=1)  # (rows, nx_fine)
    if apply_bcs:  # Neumann columns, as x_interleave_coarse(apply_bcs=True)
        out = out.at[:, 0].set(out[:, 1])
        out = out.at[:, -1].set(out[:, -2])
    return out


def _pack_local(phys, ny_l: int, br: int, nx: int):
    """Local physical (ny_l, nx) -> rp layout (ny_l + 2*PAD, nxp), zeros in
    ghost/pad cells (br divides ny_l by construction)."""
    total = padded_rows(ny_l, br)
    nxp = padded_cols(nx)
    return jnp.pad(
        phys, ((PAD, total - ny_l - PAD), (0, nxp - nx))
    )


# ---------------------------------------------------------------------------
# the sharded V-cycle
# ---------------------------------------------------------------------------


def _vcycle_dist(e_rp, r_rp, plan: ShardPlan, h: float, c, tol: float,
                 cfg: MGConfig, axis: str, off0, assume_zero_u: bool,
                 apply_bcs: bool = False):
    """One V-cycle on shard-local rp operands (trace-time unrolled).

    e_rp/r_rp: this shard's level-0 correction / rhs in rp layout.
    off0: traced global row offset of local row 0 (d * ny_l).
    Returns the updated local e_rp.  Norms are not computed (the ds defect
    pass provides the true convergence signal).
    """
    alpha = cfg.jacobi_damping
    assert cfg.smoother is Smoother.JACOBI
    # one 8-row halo exchange per leg supports up to PAD-2 sweeps of
    # in-leg halo recomputation — same bound as the single-device legs,
    # so the deep-smoothed production configs
    # (V(3,3)..V(5,5)) shard without extra communication
    assert 1 <= cfg.pre_smooth <= 6 and 1 <= cfg.post_smooth <= 6

    d = lax.axis_index(axis)
    down = []  # (u_rp, f_rp, level meta) per sharded level
    u, f = e_rp, r_rp
    zero_u = assume_zero_u
    for m in range(plan.s):
        ny_lm, ny_gm, nx_gm, br_m = plan.level(m)
        h_m = h * (2.0 ** m)
        off_m = d * ny_lm
        f = _refresh(f, ny_lm, axis)
        if not zero_u:
            u = _refresh(u, ny_lm, axis)
        u, res_ps = pallas2d.smooth2r_split_rp(
            u, f, ny_lm, nx_gm, br_m, h_m, c, alpha,
            zero_u=zero_u, row_off=off_m, ny_mask=ny_gm, ns=cfg.pre_smooth,
            elim=_elim(apply_bcs),
        )
        down.append((u, f, (ny_lm, ny_gm, nx_gm, br_m, h_m, off_m)))
        res_c = _restrict_ps_cols(res_ps, ny_lm, br_m, nx_gm,
                                  apply_bcs=apply_bcs)
        if m + 1 < plan.s:
            ny_ln, _, nx_gn, br_n = plan.level(m + 1)
            f = _pack_local(res_c, ny_ln, br_n, nx_gn)
            u = jnp.zeros_like(f)
            zero_u = True
        else:
            # ---- replicated coarse subtree ----
            from fpr_tpu.solvers.multigrid import vcycle

            nyc_l = ny_lm // 2
            ny_gs = ((plan.ny - 1) >> (m + 1)) + 1
            nx_gs = ((plan.nx - 1) >> (m + 1)) + 1
            # placed into a zero global array and psum'd (x + 0 is exact):
            # the result is typed replicated, so every device runs the
            # identical subtree
            gathered = lax.psum(lax.dynamic_update_slice(
                jnp.zeros((plan.ndev * nyc_l, res_c.shape[1]), res_c.dtype),
                res_c, (d * nyc_l, jnp.int32(0))), axis)
            res_glob = gathered[:ny_gs, :]
            sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
            corr_glob = jnp.zeros_like(res_glob)
            corr_glob, _ = vcycle(
                corr_glob, res_glob, h_m * 2.0, c, tol, sub_cfg,
                apply_bcs=apply_bcs, elim=_elim(apply_bcs),
            )

    # ---- up sweep ----
    # deepest sharded level consumes the replicated global correction
    for m in reversed(range(plan.s)):
        u, f, (ny_lm, ny_gm, nx_gm, br_m, h_m, off_m) = down[m]
        nyc_l = ny_lm // 2
        nxc = (nx_gm - 1) // 2 + 1
        rows_needed = pallas2d.corr_rows_needed(ny_lm, br_m)
        nxp_m = padded_cols(nx_gm)
        if m == plan.s - 1:
            # corr_glob is replicated: every shard slices its own window
            # (incl. 4 halo coarse rows each side) out of the global
            # x-interleaved correction
            from fpr_tpu.ops.pallas2d import x_interleave_coarse

            corrx_g = x_interleave_coarse(corr_glob, apply_bcs=apply_bcs)
            L = rows_needed - (PAD - 4)
            G = jnp.pad(
                corrx_g,
                ((4, plan.ndev * nyc_l + L), (0, nxp_m - corrx_g.shape[1])),
            )
            win = lax.dynamic_slice(
                G, (d * nyc_l, jnp.int32(0)), (L, nxp_m)
            )
            corrx_rp = jnp.zeros((rows_needed, nxp_m), win.dtype)
            corrx_rp = corrx_rp.at[PAD - 4 :, :].set(win)
        else:
            # corr is the sharded up-result of level m+1 (rp layout):
            # refresh its ghosts, take the +-4-row extended physical slab
            corr_rp = _refresh(corr_rp_next, nyc_l, axis)
            ext = corr_rp[PAD - 4 : PAD + nyc_l + 4, :nxc]
            corrx = _x_interleave_cols(ext, nxc, apply_bcs=apply_bcs)
            corrx_rp = jnp.zeros((rows_needed, nxp_m), corrx.dtype)
            corrx_rp = corrx_rp.at[
                PAD - 4 : PAD + nyc_l + 4, : corrx.shape[1]
            ].set(corrx)

        u = _refresh(u, ny_lm, axis)
        u, _ = pallas2d.corr_smooth2_raw(
            u, f, corrx_rp, ny_lm, nx_gm, br_m, h_m, c, alpha,
            with_norm=False, row_off=off_m, ny_mask=ny_gm,
            ns=cfg.post_smooth, elim=_elim(apply_bcs),
        )
        corr_rp_next = u
    return u


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def mg_solve_ds_sharded(
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    mesh: Mesh,
    axis: str = "y",
    cfg: MGConfig = MGConfig(),
    inner_cycles: int | None = None,
    replicate_below: int = 1025,
    gather_result: bool = True,
    apply_bcs: bool = False,
):
    """Distributed double-single defect-correction MG, zero initial guess.

    f: GLOBAL (ny, nx) float32 rhs (zero boundary ring, as every caller in
    this framework provides).  Semantics match ``mg_solve_ds(None, f, ...)``
    (same legs, same per-cell arithmetic; reductions are psum'd so
    rounding of the norm may differ at the last bit).  Returns
    ((hi, lo), r_rms, iters) with hi/lo global (gather_result=True) or the
    raw sharded per-device stack (ndev, 2, total, nxp).

    apply_bcs: the NS temperature BCs (Dirichlet bottom/top, Neumann
    left/right — part2_utils.jl:22-25), applied inside the per-shard
    defect pass against GLOBAL row indices (the pass takes the
    shard's traced row offset) and as shard-local Neumann column copies
    in every transfer; the sharded Helmholtz solves of the semi-implicit
    NS path build on this.
    """
    if f.dtype != jnp.float32:
        raise ValueError("sharded ds solver takes an exactly-f32 rhs")
    ny, nx = f.shape
    if inner_cycles is None:
        from fpr_tpu.solvers.multigrid import _auto_inner_cycles
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    ndev = mesh.shape[axis]
    plan = plan_shards(ny, nx, ndev, cfg, replicate_below)
    solve = _build_sharded(
        plan, mesh, axis, float(h), float(tol), int(niters), cfg,
        int(inner_cycles), bool(gather_result), bool(apply_bcs),
    )
    return solve(f, jnp.asarray(c, jnp.float32))


# ---------------------------------------------------------------------------
# 2D (y, x) mesh decomposition
#
# Rows shard as above; columns shard in CPAD=128-column slabs, each side of
# a shard carrying one ghost slab refreshed by a single ppermute pair per
# array per leg — 128 ghost columns absorb any smooth depth the 8 ghost
# ROWS allow (ns <= 6), so the communication cadence is identical to the
# 1D solver.  The fused legs take a traced global column offset (column 0
# of the layout maps to col_off = d_x*nx_l - CPAD, negative on the left
# edge) and mask against the GLOBAL nx, so per-shard arithmetic stays
# equal to the single-device legs.  This is the part-2 analog of part 1's full
# Cartesian decomposition (part1_kernel_programming.jl:100-101).
# ---------------------------------------------------------------------------

CPAD = 128  # ghost columns per side (the rp layout's column quantum)


@dataclasses.dataclass(frozen=True)
class ShardPlan2D:
    ny: int
    nx: int
    ndev_y: int
    ndev_x: int
    s: int                    # sharded levels
    ny_l: int                 # local rows at the fine level
    nx_l: int                 # local cols at the fine level
    brs: tuple[int, ...]

    def level(self, m: int):
        """(ny_l_m, nx_l_m, ny_g_m, nx_g_m, br_m) for sharded level m."""
        return (
            self.ny_l >> m,
            self.nx_l >> m,
            ((self.ny - 1) >> m) + 1,
            ((self.nx - 1) >> m) + 1,
            self.brs[m],
        )


def plan_shards_2d(
    ny: int, nx: int, ndev_y: int, ndev_x: int, cfg: MGConfig,
    replicate_below: int = 1025,
) -> ShardPlan2D:
    levels = mg_levels(nx, ny, cfg.coarse_size)
    s = 0
    for m, (nxm, nym) in enumerate(levels):
        if (
            nym >= replicate_below
            and nxm >= max(replicate_below, 2 * CPAD * ndev_x)
            and m < len(levels) - 1
        ):
            s += 1
        else:
            break
    if s < 1:
        raise ValueError(
            f"grid {ny}x{nx} too small to 2D-shard over {ndev_y}x{ndev_x} "
            f"(replicate_below={replicate_below}, column shards need "
            f">= {2 * CPAD} cols each at every sharded level); use the "
            "1D row solver or fewer column shards"
        )
    align_y = 16 * (1 << (s - 1))
    ny_l = -(-ny // (ndev_y * align_y)) * align_y
    align_x = CPAD * (1 << (s - 1))
    nx_l = -(-nx // (ndev_x * align_x)) * align_x
    brs = tuple(pallas2d.layout_br(ny_l >> m) for m in range(s))
    return ShardPlan2D(ny=ny, nx=nx, ndev_y=ndev_y, ndev_x=ndev_x, s=s,
                       ny_l=ny_l, nx_l=nx_l, brs=brs)


def _refresh_x(a, nx_l: int, axis: str):
    """Refresh the CPAD-lane ghost slabs from the +-1 x-neighbors; global
    edges get zeros (ppermute's unmatched-destination fill), matching the
    single-device zero lane pads."""
    n = lax.axis_size(axis)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    left_face = a[..., :, CPAD : 2 * CPAD]
    right_face = a[..., :, nx_l : nx_l + CPAD]
    from_left = lax.ppermute(right_face, axis, fwd)
    from_right = lax.ppermute(left_face, axis, bwd)
    a = a.at[..., :, 0:CPAD].set(from_left)
    a = a.at[..., :, CPAD + nx_l : CPAD + nx_l + CPAD].set(from_right)
    return a


def _refresh2d(a, ny_l: int, nx_l: int, ay: str, ax: str):
    """Columns first, then full-width rows: the row faces then carry the
    y-neighbor's freshly-exchanged ghost lanes, so the corner ghost cells
    hold the diagonal neighbor's values (every shard runs the same
    program, so the x-exchange is globally complete before any row face
    is built)."""
    a = _refresh_x(a, nx_l, ax)
    return _refresh(a, ny_l, ay)


def _pack_local_2d(phys, ny_l: int, br: int, nx_l: int):
    """Local physical (ny_l, nx_l) -> 2D-shard layout
    (ny_l + pad rows, CPAD + nx_l + CPAD), zeros in ghosts/pads."""
    total = padded_rows(ny_l, br)
    return jnp.pad(phys, ((PAD, total - ny_l - PAD), (CPAD, CPAD)))


def _vcycle_dist_2d(e_rp, r_rp, plan: ShardPlan2D, h: float, c, tol: float,
                    cfg: MGConfig, ay: str, ax: str, assume_zero_u: bool):
    """One V-cycle on 2D-shard-local operands (trace-time unrolled).
    Mirrors _vcycle_dist with the column passes shard-aware; apply_bcs is
    not supported on the 2D mesh (the 1D row solver covers the NS tier)."""
    alpha = cfg.jacobi_damping
    assert cfg.smoother is Smoother.JACOBI
    assert 1 <= cfg.pre_smooth <= 6 and 1 <= cfg.post_smooth <= 6
    GC = 4  # coarse ghost cols interleaved for the upward leg (8 fine)

    dy = lax.axis_index(ay)
    dx = lax.axis_index(ax)
    down = []
    u, f = e_rp, r_rp
    zero_u = assume_zero_u
    for m in range(plan.s):
        ny_lm, nx_lm, ny_gm, nx_gm, br_m = plan.level(m)
        h_m = h * (2.0 ** m)
        roff = dy * ny_lm
        coff = dx * nx_lm - CPAD
        nxloc = nx_lm + 2 * CPAD
        f = _refresh2d(f, ny_lm, nx_lm, ay, ax)
        if not zero_u:
            u = _refresh2d(u, ny_lm, nx_lm, ay, ax)
        u, res_ps = pallas2d.smooth2r_split_rp(
            u, f, ny_lm, nxloc, br_m, h_m, c, alpha,
            zero_u=zero_u, row_off=roff, ny_mask=ny_gm, ns=cfg.pre_smooth,
            col_off=coff, nx_mask=nx_gm,
        )
        down.append((u, f, (ny_lm, nx_lm, ny_gm, nx_gm, br_m, h_m, roff, coff)))
        # injection: even block-halves (the leg's row pass) + local column
        # decimation (offsets are even at every level, so local parity ==
        # global parity); global-boundary/dead-tail residuals are already
        # masked to zero by the leg
        nxp_loc = res_ps.shape[-1]
        n_blocks = ny_lm // br_m
        even = (
            res_ps[PAD : PAD + ny_lm]
            .reshape(n_blocks, br_m, nxp_loc)[:, : br_m // 2]
            .reshape(ny_lm // 2, nxp_loc)
        )
        res_c = even[:, CPAD : CPAD + nx_lm][:, ::2]   # (ny_l/2, nx_l/2)
        if m + 1 < plan.s:
            ny_ln, nx_ln, _, _, br_n = plan.level(m + 1)
            f = _pack_local_2d(res_c, ny_ln, br_n, nx_ln)
            u = jnp.zeros_like(f)
            zero_u = True
        else:
            # ---- replicated coarse subtree ----
            from fpr_tpu.solvers.multigrid import vcycle

            ny_gs = ((plan.ny - 1) >> (m + 1)) + 1
            nx_gs = ((plan.nx - 1) >> (m + 1)) + 1
            nyc_l, nxc_l = res_c.shape
            gathered = lax.psum(lax.dynamic_update_slice(
                jnp.zeros((plan.ndev_y * nyc_l, plan.ndev_x * nxc_l),
                          res_c.dtype),
                res_c, (dy * nyc_l, dx * nxc_l)), (ay, ax))
            res_glob = gathered[:ny_gs, :nx_gs]
            sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
            corr_glob = jnp.zeros_like(res_glob)
            corr_glob, _ = vcycle(
                corr_glob, res_glob, h_m * 2.0, c, tol, sub_cfg,
            )

    for m in reversed(range(plan.s)):
        u, f, (ny_lm, nx_lm, ny_gm, nx_gm, br_m, h_m, roff, coff) = down[m]
        nyc_l, nxc_l = ny_lm // 2, nx_lm // 2
        rows_needed = pallas2d.corr_rows_needed(ny_lm, br_m)
        nxp_loc = nx_lm + 2 * CPAD
        if m == plan.s - 1:
            # replicated global correction: every shard slices its own
            # (rows +-4 coarse, cols +-CPAD fine) window out of the
            # x-interleaved global array
            from fpr_tpu.ops.pallas2d import x_interleave_coarse

            corrx_g = x_interleave_coarse(corr_glob)
            L = rows_needed - (PAD - 4)
            G = jnp.pad(
                corrx_g,
                ((4, plan.ndev_y * nyc_l + L),
                 (CPAD, CPAD + plan.ndev_x * nx_lm)),
            )
            win = lax.dynamic_slice(
                G, (dy * nyc_l, dx * nx_lm), (L, nxp_loc)
            )
            corrx_rp = jnp.zeros((rows_needed, nxp_loc), win.dtype)
            corrx_rp = corrx_rp.at[PAD - 4 :, :].set(win)
        else:
            corr_rp = _refresh2d(corr_rp_next, nyc_l, nxc_l, ay, ax)
            # +-4 coarse ghost rows AND +-GC coarse ghost cols (+1 for the
            # interpolation midpoint) -> the interleaved window carries
            # 2*GC >= ns valid fine ghost columns for the in-leg sweeps
            ext = corr_rp[PAD - 4 : PAD + nyc_l + 4,
                          CPAD - GC : CPAD + nxc_l + GC + 1]
            rows = ext.shape[0]
            cx = (ext[:, :-1] + ext[:, 1:]) * 0.5
            inter = jnp.stack([ext[:, :-1], cx], axis=2).reshape(
                rows, 2 * (nxc_l + 2 * GC)
            )
            corrx_rp = jnp.zeros((rows_needed, nxp_loc), inter.dtype)
            corrx_rp = corrx_rp.at[
                PAD - 4 : PAD - 4 + rows,
                CPAD - 2 * GC : CPAD - 2 * GC + inter.shape[1],
            ].set(inter)

        u = _refresh2d(u, ny_lm, nx_lm, ay, ax)
        u, _ = pallas2d.corr_smooth2_raw(
            u, f, corrx_rp, ny_lm, nxloc_of(nx_lm), br_m, h_m, c, alpha,
            with_norm=False, row_off=roff, ny_mask=ny_gm,
            ns=cfg.post_smooth, col_off=coff, nx_mask=nx_gm,
        )
        corr_rp_next = u
    return u


def nxloc_of(nx_l: int) -> int:
    """Local layout width of a 2D shard (ghost slabs included)."""
    return nx_l + 2 * CPAD


def mg_solve_ds_sharded_2d(
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    mesh: Mesh,
    axes: tuple[str, str] = ("y", "x"),
    cfg: MGConfig = MGConfig(),
    inner_cycles: int | None = None,
    replicate_below: int = 1025,
    gather_result: bool = True,
):
    """Distributed ds MG over a 2D (y, x) device mesh, zero initial guess.

    Semantics match ``mg_solve_ds(None, f, ...)`` — same fused legs,
    same per-cell arithmetic (per-shard bitwise; the psum'd norm may
    differ in the last bit).  Avoids the 1D solver's thin-slab limit:
    an 8-device slice can run 4x2 or 2x4 instead of 8x1, so per-shard
    rows stay deep enough for the rp block rule at more
    devices.  apply_bcs is not supported here (the NS tier shards 1D).
    Returns ((hi, lo), r_rms, iters) global, or the raw sharded stack.
    """
    if f.dtype != jnp.float32:
        raise ValueError("sharded ds solver takes an exactly-f32 rhs")
    ny, nx = f.shape
    if inner_cycles is None:
        from fpr_tpu.solvers.multigrid import _auto_inner_cycles
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    ay, ax = axes
    plan = plan_shards_2d(ny, nx, mesh.shape[ay], mesh.shape[ax], cfg,
                          replicate_below)
    solve = _build_sharded_2d(
        plan, mesh, ay, ax, float(h), float(tol), int(niters), cfg,
        int(inner_cycles), bool(gather_result),
    )
    return solve(f, jnp.asarray(c, jnp.float32))


@functools.lru_cache(maxsize=32)
def _build_sharded_2d(plan, mesh, ay, ax, h, tol, niters, cfg, inner_cycles,
                      gather_result):
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import stencil2d

    ny, nx = plan.ny, plan.nx
    ndev_y, ndev_x = plan.ndev_y, plan.ndev_x
    ny_l, nx_l, br0 = plan.ny_l, plan.nx_l, plan.brs[0]
    total0 = padded_rows(ny_l, br0)
    nxp_loc = nx_l + 2 * CPAD

    def shard_body(f_blk, f_rms, c):
        f_rp = f_blk[0, 0]
        dy = lax.axis_index(ay)
        dx = lax.axis_index(ax)
        roff = dy * ny_l
        coff = dx * nx_l - CPAD
        tolf = jnp.asarray(tol, jnp.float32) * f_rms

        u_ds = lax.pcast(jnp.zeros((2, total0, nxp_loc), jnp.float32),
                         (ay, ax), to="varying")
        f_ds = f_rp[None]
        r32 = -f_rp
        r_rms0 = f_rms

        def cond(carry):
            _, _, r_rms, it = carry
            return jnp.logical_and(it < niters, r_rms >= tolf)

        def body(carry):
            u_ds, r32, _, it = carry
            e = jnp.zeros((total0, nxp_loc), jnp.float32)
            for cyc in range(inner_cycles):
                e = _vcycle_dist_2d(
                    e, r32, plan, h, c, tol, cfg, ay, ax,
                    assume_zero_u=(cyc == 0),
                )
            u_ds = _refresh2d(u_ds, ny_l, nx_l, ay, ax)
            e = _refresh2d(e, ny_l, nx_l, ay, ax)
            u_ds, r32, sumsq = dsm.defect_pass(
                u_ds, f_ds, e, 1.0, ny_l, nxp_loc, br0, h, c,
                row_off=roff, ny_mask=ny, raw_sumsq=True,
                col_off=coff, nx_mask=nx,
                own_lanes=(CPAD, CPAD + nx_l),
            )
            sumsq = lax.psum(sumsq, (ay, ax))
            r_rms = jnp.sqrt(sumsq / (nx * ny))
            return u_ds, r32, r_rms, it + 1

        u_ds, r32, r_rms, it = lax.while_loop(
            cond, body,
            (u_ds, r32, r_rms0, jnp.asarray(0, jnp.int32)),
        )
        return u_ds[None, None], r_rms, it

    spec_f = P(ay, ax, None, None)
    spec_u = P(ay, ax, None, None, None)
    kwargs = dict(
        mesh=mesh,
        in_specs=(spec_f, P(), P()),
        out_specs=(spec_u, P(), P()),
    )
    body = shard_map(shard_body, **kwargs)

    @jax.jit
    def solve(f, c):
        f_rms = stencil2d.rms(f).astype(jnp.float32)
        fp = jnp.pad(
            f, ((0, ndev_y * ny_l - ny), (0, ndev_x * nx_l - nx))
        )
        blocks = (
            fp.reshape(ndev_y, ny_l, ndev_x, nx_l).transpose(0, 2, 1, 3)
        )
        f_blk = jnp.pad(
            blocks,
            ((0, 0), (0, 0), (PAD, total0 - ny_l - PAD), (CPAD, CPAD)),
        )
        f_blk = lax.with_sharding_constraint(
            f_blk, NamedSharding(mesh, spec_f)
        )
        u_st, r_rms, it = body(f_blk, f_rms, c)
        from fpr_tpu.solvers.multigrid import _warn_unconverged

        _warn_unconverged("mg_solve_ds_sharded_2d", r_rms, tol * f_rms, it,
                          niters)
        if not gather_result:
            return u_st, r_rms, it
        blk = u_st[:, :, :, PAD : PAD + ny_l, CPAD : CPAD + nx_l]
        glob = (
            blk.transpose(2, 0, 3, 1, 4)
            .reshape(2, ndev_y * ny_l, ndev_x * nx_l)[:, :ny, :nx]
        )
        return (glob[0], glob[1]), r_rms, it

    return solve


@functools.lru_cache(maxsize=32)
def _build_sharded(plan, mesh, axis, h, tol, niters, cfg, inner_cycles,
                   gather_result, apply_bcs=False):
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import stencil2d

    ny, nx, ndev = plan.ny, plan.nx, plan.ndev
    ny_l, br0 = plan.ny_l, plan.brs[0]
    total0 = padded_rows(ny_l, br0)
    nxp = padded_cols(nx)

    def shard_body(f_blk, f_rms, c):
        f_rp = f_blk[0]  # (total0, nxp), my rows at [PAD, PAD+ny_l)
        d = lax.axis_index(axis)
        off0 = d * ny_l
        tolf = jnp.asarray(tol, jnp.float32) * f_rms

        u_ds = lax.pcast(jnp.zeros((2, total0, nxp), jnp.float32), axis,
                         to="varying")
        f_ds = f_rp[None]  # single-plane (exactly-f32) rhs
        if apply_bcs:
            # BCs make u_bc != 0: the initial defect must run through the
            # pass (scale=0 folds in the BCs exactly, as the single-
            # device entry does)
            u_ds, r32, sumsq0 = dsm.defect_pass(
                u_ds, f_ds, jnp.zeros((total0, nxp), jnp.float32), 0.0,
                ny_l, nx, br0, h, c, row_off=off0, ny_mask=ny,
                raw_sumsq=True, apply_bcs=True,
            )
            r_rms0 = jnp.sqrt(lax.psum(sumsq0, axis) / (nx * ny))
        else:
            r32 = -f_rp    # zero guess: r = A*0 - f
            r_rms0 = f_rms

        def cond(carry):
            _, _, r_rms, it = carry
            return jnp.logical_and(it < niters, r_rms >= tolf)

        def body(carry):
            u_ds, r32, _, it = carry
            e = jnp.zeros((total0, nxp), jnp.float32)
            for cyc in range(inner_cycles):
                e = _vcycle_dist(
                    e, r32, plan, h, c, tol, cfg, axis, off0,
                    assume_zero_u=(cyc == 0), apply_bcs=apply_bcs,
                )
            u_ds = _refresh(u_ds, ny_l, axis)
            e = _refresh(e, ny_l, axis)
            u_ds, r32, sumsq = dsm.defect_pass(
                u_ds, f_ds, e, 1.0, ny_l, nx, br0, h, c,
                row_off=off0, ny_mask=ny, raw_sumsq=True,
                apply_bcs=apply_bcs,
            )
            sumsq = lax.psum(sumsq, axis)
            r_rms = jnp.sqrt(sumsq / (nx * ny))
            return u_ds, r32, r_rms, it + 1

        u_ds, r32, r_rms, it = lax.while_loop(
            cond, body,
            (u_ds, r32, r_rms0, jnp.asarray(0, jnp.int32)),
        )
        return u_ds[None], r_rms, it

    spec_f = P(axis, None, None)
    spec_u = P(axis, None, None, None)
    kwargs = dict(
        mesh=mesh,
        in_specs=(spec_f, P(), P()),
        out_specs=(spec_u, P(), P()),
    )
    body = shard_map(shard_body, **kwargs)

    @jax.jit
    def solve(f, c):
        f_rms = stencil2d.rms(f).astype(jnp.float32)
        pad_rows = ndev * ny_l - ny
        fp = jnp.pad(f, ((0, pad_rows), (0, 0))).reshape(ndev, ny_l, nx)
        f_blk = jnp.pad(
            fp, ((0, 0), (PAD, total0 - ny_l - PAD), (0, nxp - nx))
        )
        f_blk = lax.with_sharding_constraint(
            f_blk, NamedSharding(mesh, spec_f)
        )
        u_st, r_rms, it = body(f_blk, f_rms, c)
        from fpr_tpu.solvers.multigrid import _warn_unconverged

        _warn_unconverged("mg_solve_ds_sharded", r_rms, tol * f_rms, it,
                          niters, apply_bcs)
        if not gather_result:
            return u_st, r_rms, it
        # assemble the global hi/lo pair from the sharded stack
        blocks = u_st[:, :, PAD : PAD + ny_l, :nx]      # (ndev, 2, ny_l, nx)
        glob = jnp.swapaxes(blocks, 0, 1).reshape(2, ndev * ny_l, nx)[:, :ny]
        return (glob[0], glob[1]), r_rms, it

    return solve
