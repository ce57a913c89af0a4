"""2D streamfunction-vorticity Navier-Stokes (thermal convection).

A rebuild of the reference NS driver (navier_stokes_2D,
part2.jl:140-262): Rayleigh-Benard-style convection in a rectangular box,
hot bottom / cold top, with

    dT/dt = nabla^2 T            - (v . grad) T
    dW/dt = Pr nabla^2 W         - (v . grad) W + Pr Ra dT/dx
    nabla^2 S = W,   (vx, vy) = (dS/dy, -dS/dx)

All linear solves (streamfunction each step; Helmholtz solves for T and W
when beta > 0) go through the matrix-free geometric multigrid of
fpr_tpu.solvers.multigrid.

Design: one jitted ``step`` function per config — the MG convergence loops
are on-device lax.while_loops; the only host sync per step is the adaptive
dt scalar (the reference syncs the same way, part2.jl:196, plus a host
reduction per smooth that we eliminate).  The physical time loop runs on
host because the step count is data-dependent through dt.

Timestepping parity (part2.jl:216-231):
- explicit (beta = 0):       forward-Euler with upwind advection;
- semi-implicit (beta=0.5) / implicit (beta=1): solve
      (nabla^2 - c) T_new = -c (T + dt ((1-beta) dT2 - dTx - dTy)),
  c = 1/(beta dt), and the analogous W solve with c/Pr and the
  -Pr*Ra*dT/dx forcing folded into the rhs.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fpr_tpu.core import bc
from fpr_tpu.core.config import InitScheme, NSConfig
from fpr_tpu.ops import stencil2d as ops
from fpr_tpu.solvers.multigrid import mg_solve, mg_solve_ds_rp, mg_solve_mixed


@dataclasses.dataclass
class NSResult:
    """Output fields (reference SimOut_t, part2.jl:49-55)."""

    T: np.ndarray
    W: np.ndarray
    S: np.ndarray
    t_elapsed: float
    timed_iters: int
    steps: int
    sim_time: float
    snapshots: Optional[list] = None
    # simulate_fast only: exact-resume payload (the f32/ds state verbatim,
    # incl. the in-kernel w_sumsq accumulator and the ds sim-time pair) —
    # feed back as simulate_fast(state0=result.state) for a bitwise
    # continuation; checkpoint-able via utils.checkpoint.save(**state)
    state: Optional[dict] = None


def init_field(cfg: NSConfig, scheme: InitScheme, key=None, array=None, dtype=jnp.float64):
    """Initial condition builder (init_array!, part2.jl:58-73)."""
    ny, nx = cfg.ny, cfg.nx
    if scheme is InitScheme.COSINE:
        ix = np.arange(nx)
        row = 0.5 * (1.0 + np.cos(3.0 * np.pi * ix * cfg.h / cfg.width))
        return jnp.asarray(np.broadcast_to(row, (ny, nx)), dtype=dtype)
    if scheme is InitScheme.RANDOM:
        key = key if key is not None else jax.random.PRNGKey(0)
        return jax.random.uniform(key, (ny, nx), dtype=dtype)
    if scheme is InitScheme.FROM_ARRAY:
        if array is None:
            raise ValueError("InitScheme.FROM_ARRAY requires an array")
        return jnp.asarray(array, dtype=dtype)
    raise ValueError(scheme)


def compute_dt(vx, vy, cfg: NSConfig):
    """Adaptive timestep (compute_dt, part2.jl:76-87), on device."""
    vmax2 = jnp.max(vx * vx + vy * vy)
    ax = jnp.max(jnp.abs(vx))
    ay = jnp.max(jnp.abs(vy))
    dt_adv = cfg.a_adv * jnp.minimum(cfg.h / ax, cfg.h / ay)  # inf when v=0
    dt = dt_adv if cfg.beta >= 0.5 else jnp.minimum(cfg.dt_dif, dt_adv)
    return jnp.where(vmax2 == 0.0, cfg.dt_dif, dt)


def _semi_implicit(beta: float) -> bool:
    # the reference tests beta != 1 with isapprox (part2.jl:205)
    return beta > 0.0


def _needs_diffusion_term(beta: float) -> bool:
    return abs(beta - 1.0) > 1e-8


def ns_step(T, W, S, cfg: NSConfig, constrain=None):
    """One NS timestep; returns (T, W, S, dt).  Pure; jit with cfg static.

    constrain: optional GSPMD sharding hook (see multigrid.vcycle) — the
    distributed NS path threads per-level placement through every solve;
    requires mg_solver="direct" (the mixed/ds tiers are Pallas-based and
    single-device).
    """
    h = cfg.h
    if constrain is not None:
        if cfg.mg_solver != "direct":
            raise ValueError("sharded ns_step requires mg_solver='direct'")
        solve = functools.partial(mg_solve, constrain=constrain)
        T, W, S = constrain(T), constrain(W), constrain(S)
    elif cfg.mg_solver == "mixed":
        solve = mg_solve_mixed
    elif cfg.mg_solver == "direct":
        solve = mg_solve
    else:
        # "fast"/"ds" etc. are simulate_fast-level choices; falling through
        # to the f64 direct solver silently would be a benchmarking trap
        raise ValueError(
            f"unknown mg_solver {cfg.mg_solver!r} for ns_step "
            "(expected 'direct' or 'mixed'; use simulate_fast for the "
            "fused double-single path)"
        )

    # 1. streamfunction solve  nabla^2 S = W, Dirichlet 0 (part2.jl:187)
    S, _, _ = solve(S, W, h, 0.0, cfg.tol, cfg.niters, apply_bcs=False, cfg=cfg.mg)

    # 2. velocity from S (part2.jl:190-193)
    vx, vy = ops.velocity(S, h, h)

    # 3. adaptive dt (part2.jl:196)
    dt = compute_dt(vx, vy, cfg)

    # 4. temperature BCs (part2.jl:199)
    T = bc.ns_temperature_bcs(T)

    # 5. buoyancy term (part2.jl:202)
    Ra_dTdx = ops.buoyancy(T, cfg.Ra, h)

    # 6. diffusion terms, skipped for fully implicit (part2.jl:205-208)
    if _needs_diffusion_term(cfg.beta):
        dT2 = ops.diffusion(T, cfg.k, h, h)
        dW2 = ops.diffusion(W, cfg.Pr, h, h)
    else:
        dT2 = jnp.zeros_like(T)
        dW2 = jnp.zeros_like(W)

    # 7. upwind advection (part2.jl:211-214)
    dTx = ops.advection_x(T, vx, h)
    dTy = ops.advection_y(T, vy, h)
    dWx = ops.advection_x(W, vx, h)
    dWy = ops.advection_y(W, vy, h)

    # 8. Euler / Helmholtz update (part2.jl:216-231)
    if _semi_implicit(cfg.beta):
        c = 1.0 / (cfg.beta * dt)
        T_rhs = -c * (T + dt * ((1.0 - cfg.beta) * dT2 - dTx - dTy))
        T, _, _ = solve(T, T_rhs, h, c, cfg.tol, cfg.niters, apply_bcs=True, cfg=cfg.mg)
        cW = c / cfg.Pr
        W_rhs = -cW * (W + dt * ((1.0 - cfg.beta) * dW2 - dWx - dWy - cfg.Pr * Ra_dTdx))
        W, _, _ = solve(W, W_rhs, h, cW, cfg.tol, cfg.niters, apply_bcs=False, cfg=cfg.mg)
    else:
        T = T + dt * (dT2 - dTx - dTy)
        W = W + dt * (dW2 - dWx - dWy - cfg.Pr * Ra_dTdx)

    return T, W, S, dt


@functools.partial(jax.jit, static_argnames=("cfg",))
def ns_step_jit(T, W, S, cfg: NSConfig):
    return ns_step(T, W, S, cfg)


def simulate(
    cfg: NSConfig = NSConfig(),
    W0=None,
    T0=None,
    max_steps: Optional[int] = None,
    verbose: bool = False,
    snapshot_every: int = 0,
    dtype=jnp.float64,
    seed: int = 0,
    mesh=None,
    shard_axis: str = "y",
) -> NSResult:
    """Run the simulation until sim_time >= ttot (part2.jl:181-250).

    max_steps=1 reproduces the reference's testmode (single full step).
    snapshot_every > 0 stores (T, W, S) every that-many steps (the
    reference's do_vis JLD snapshots, part2.jl:236-245).
    mesh: optional jax.sharding.Mesh — run the whole step (all multigrid
    solves included) row-sharded over the mesh via GSPMD (jnp tier,
    mg_solver="direct"); beyond-reference: the reference's part 2 is
    strictly single-GPU.
    """
    key = jax.random.PRNGKey(seed)
    T = init_field(cfg, cfg.T_init, key=key, dtype=dtype) if T0 is None else jnp.asarray(T0, dtype)
    W = init_field(cfg, cfg.W_init, key=key, dtype=dtype) if W0 is None else jnp.asarray(W0, dtype)
    S = jnp.zeros((cfg.ny, cfg.nx), dtype=dtype)

    if mesh is not None:
        from fpr_tpu.solvers.dist_multigrid import _make_constrain

        con = _make_constrain(mesh, shard_axis, replicate_below=257)
        step_fn = jax.jit(
            functools.partial(ns_step, cfg=cfg, constrain=con)
        )
    else:
        step_fn = functools.partial(ns_step_jit, cfg=cfg)

    snapshots = [] if snapshot_every else None
    sim_time = 0.0
    step = 0
    tic = time.time()
    while sim_time < cfg.ttot:
        if step == 3:  # warmup exclusion (part2.jl:182-184)
            tic = time.time()
        T, W, S, dt = step_fn(T, W, S)
        sim_time += float(dt)  # the one host sync per step
        step += 1
        if snapshot_every and (step - 1) % snapshot_every == 0:
            snapshots.append((np.asarray(T), np.asarray(W), np.asarray(S)))
        if verbose and (step - 1) % 20 == 0:
            print(f"time, step: {sim_time} {step}")
        if max_steps is not None and step >= max_steps:
            break
    jax.block_until_ready(T)
    t_elapsed = time.time() - tic

    return NSResult(
        T=np.asarray(T),
        W=np.asarray(W),
        S=np.asarray(S),
        t_elapsed=t_elapsed,
        timed_iters=max(step - 3, 0),
        steps=step,
        sim_time=sim_time,
        snapshots=snapshots,
    )


# ---------------------------------------------------------------------------
# Fused fast path: the whole simulation as ONE on-device while_loop
# ---------------------------------------------------------------------------
#
# The host loop above syncs once per step (the adaptive-dt scalar) and pays
# the per-jit-call dispatch overhead 8k+ times on the explicit path.  The
# fast path keeps EVERYTHING on device:
#
# - state lives row-padded: T/W stacked f32 (the fused operator pass's
#   native format, fpr_tpu.ops.pallas_ns), S as a double-single hi/lo pair
#   (warm start + ~48-bit residual evaluation for the per-step multigrid
#   solve — plain f32 cannot reach tol*rms(W) on fine grids);
# - every linear solve is mg_solve_ds_rp (fused ds defect passes around f32
#   fused-leg V-cycles), warm-started from the previous field;
# - sim_time accumulates in double-single so 10^4-10^5 f32 dt additions
#   cannot drift the step count;
# - the reference's per-step host work (compute_dt device->host maxima,
#   part2.jl:196) becomes an on-device reduction feeding the dt scalar.
#
# One jitted function runs the loop up to a traced step limit, so warmup
# separation (steps 1-3 excluded from timing, part2.jl:182-184) reuses the
# same executable.


def fast_mg_default(cfg: NSConfig) -> NSConfig:
    """Production MG ladder for the f32 fast path.

    A default ``MGConfig()`` is upgraded to the DST-truncated ladder with
    coarse_size 257 and deep V(3,3) smoothing: the small-level subtree
    below the coarse size is pure sequential dispatch (~30-50 ops per
    V-cycle), and one exact sine-transform solve replaces it; the extra
    sweep per leg contracts the warm solves hard enough to drop 1-2 outer
    defect iterations per step, with exact step parity (8739/40 explicit
    steps at 2049x513).  The ladder was chosen on earlier hardware and
    awaits re-measurement on the GPU (ROADMAP).
    An explicitly provided cfg.mg always wins; cfg.mg_auto=False opts out
    entirely (the true default ladder then runs on the fast path); grids
    with min(ny, nx) <= 129 are left alone (the subtree is the whole solve
    there, and the sharded path could no longer decompose it); and on
    grids with 129 < min(ny, nx) <= 257 the coarse size is clamped to the
    next ladder level below the min dimension, so the upgraded config
    never swallows the whole ladder (simulate_fast_sharded's planner
    needs at least one shardable level; a full-grid DST on the fine level
    would also lose the V-cycle's O(N) scaling).
    """
    from fpr_tpu.core.config import CoarseSolver, MGConfig

    if not cfg.mg_auto or cfg.mg != MGConfig() or min(cfg.ny, cfg.nx) <= 129:
        return cfg
    coarse = 257
    while coarse >= min(cfg.ny, cfg.nx):
        coarse = (coarse - 1) // 2 + 1
    return dataclasses.replace(
        cfg, mg=MGConfig(coarse_size=coarse, coarse_solver=CoarseSolver.DST,
                         pre_smooth=3, post_smooth=3)
    )


def _fast_step(TW, S_ds, w_sumsq, cfg: NSConfig, br, defect=None):
    """One fused NS step on row-padded f32 state.

    w_sumsq carries sum(W^2) over the physical domain, computed by the
    previous step's operator pass (the S-solve tolerance tol*rms(W) then
    needs no reduction pass of its own); the velocity maxima for the
    adaptive dt come out of the S-solve's defect pass the same way.

    defect (explicit path): (r32, r_rms, ax, ay) — the S-solve's initial
    defect and curl maxima, produced by the PREVIOUS step's fused operator
    pass (pallas_ns with_defect), replacing the solve's own initial
    ds.defect_pass (one whole pass over the state per step).

    Returns (TW', S_ds', w_sumsq', dt) — plus the next step's defect tuple
    on the explicit path.
    """
    from fpr_tpu.ops import pallas_ns

    ny, nx, h = cfg.ny, cfg.nx, cfg.h
    f32 = jnp.float32
    n_cells = jnp.asarray(float(nx * ny), f32)

    # 1. streamfunction solve  nabla^2 S = W (part2.jl:187), warm-started;
    # the defect pass computes max|dS/dy|, max|dS/dx| of the final S
    tolf = (cfg.tol * cfg.s_tol_factor) * jnp.sqrt(w_sumsq / n_cells)
    solve_kw = {}
    if defect is not None:
        r32, r_rms, ax0, ay0 = defect
        solve_kw = dict(
            r0=(r32, r_rms), extras0=(ax0, ay0, jnp.asarray(0.0, f32))
        )
    S_ds, _, _, (ax, ay, _) = mg_solve_ds_rp(
        S_ds, TW[1:2], tolf, ny, nx, h, 0.0, cfg.niters,
        cfg=cfg.mg, inner_cycles=1, tol=cfg.tol, velocity_max=True,
        **solve_kw,
    )

    # 2.-3. adaptive dt (part2.jl:76-87, on device)
    dt_adv = jnp.asarray(cfg.a_adv, f32) * jnp.minimum(h / ax, h / ay)
    if cfg.beta >= 0.5:
        dt = dt_adv
    else:
        dt = jnp.minimum(jnp.asarray(cfg.dt_dif, f32), dt_adv)
    dt = jnp.where((ax == 0.0) & (ay == 0.0), jnp.asarray(cfg.dt_dif, f32), dt)

    # 4.-8. fused operator pass + (semi-implicit) Helmholtz solves
    if _semi_implicit(cfg.beta):
        cT = 1.0 / (jnp.asarray(cfg.beta, f32) * dt)
        cW = cT / jnp.asarray(cfg.Pr, f32)
        rhs, (trhs_ss, wrhs_ss) = pallas_ns.ns_fused_rp(
            TW, S_ds[0], dt, ny, nx, br, h, cfg.Pr, cfg.Ra,
            k=cfg.k, beta=cfg.beta, mode="rhs", cT=cT, cW=cW,
            with_sumsq=True,
        )
        zeros = jnp.zeros_like(TW[0])
        tolT = cfg.tol * jnp.sqrt(trhs_ss / n_cells)
        T_ds, _, _ = mg_solve_ds_rp(
            jnp.stack([TW[0], zeros]), rhs[0:1], tolT, ny, nx, h, cT,
            cfg.niters, cfg=cfg.mg, inner_cycles=1, apply_bcs=True,
            tol=cfg.tol,
        )
        tolW = cfg.tol * jnp.sqrt(wrhs_ss / n_cells)
        W_ds, _, _ = mg_solve_ds_rp(
            jnp.stack([TW[1], zeros]), rhs[1:2], tolW, ny, nx, h, cW,
            cfg.niters, cfg=cfg.mg, inner_cycles=1, tol=cfg.tol,
        )
        TW = jnp.stack([T_ds[0], W_ds[0]])
        # next step's S-solve tolerance: one reduction here instead of the
        # field_sumsq extra on EVERY defect pass of the two solves
        from fpr_tpu.ops.pallas2d import PAD

        w = TW[1, PAD : PAD + ny, :nx]
        w_sumsq = jnp.sum(w * w)
    else:
        # the operator pass also emits the NEXT step's S-solve inputs
        # (initial ds defect of S against the new W + curl maxima of S):
        # the warm solve above then skips its own initial defect pass
        TW, (_, w_sumsq), r0n, ex0n = pallas_ns.ns_fused_rp(
            TW, S_ds, dt, ny, nx, br, h, cfg.Pr, cfg.Ra,
            k=cfg.k, beta=cfg.beta, mode="explicit", with_defect=True,
        )
        return TW, S_ds, w_sumsq, dt, (r0n[0], r0n[1], ex0n[0], ex0n[1])
    return TW, S_ds, w_sumsq, dt


@functools.partial(jax.jit, static_argnames=("cfg", "br"))
def _fast_loop(TW, S_ds, w_ss, th, tl, step, limit, cfg: NSConfig, br):
    """Run fused steps while sim_time < ttot and step < limit (traced)."""
    from fpr_tpu.ops import ds as dsm

    from fpr_tpu.ops.ds import f32_pair

    tt_hi, tt_lo = f32_pair(cfg.ttot)

    def cond(carry):
        th, tl, step = carry[-3:]
        dh, dl = dsm.ds_add(th, tl, jnp.float32(-tt_hi), jnp.float32(-tt_lo))
        return (dh < 0.0) & (step < limit)

    if _semi_implicit(cfg.beta):
        def body(carry):
            TW, S_ds, w_ss, th, tl, step = carry
            TW, S_ds, w_ss, dt = _fast_step(TW, S_ds, w_ss, cfg, br)
            th, tl = dsm.ds_add(th, tl, dt, jnp.float32(0.0))
            return TW, S_ds, w_ss, th, tl, step + 1

        return jax.lax.while_loop(cond, body, (TW, S_ds, w_ss, th, tl, step))

    # explicit: every step's operator pass already emits the next step's
    # initial S defect + curl maxima; carry them so the warm S solve never
    # pays a standalone initial defect pass.  The preamble pass here runs
    # once per chunk entry (identical arithmetic to the in-solve initial
    # pass, so chunked/resumed runs stay bitwise-equal to uninterrupted
    # ones).
    S_ds, r32, r_rms, ex = dsm.defect_pass(
        S_ds, TW[1:2], jnp.zeros_like(TW[0]), 0.0, cfg.ny, cfg.nx, br,
        cfg.h, 0.0, velocity_max=True,
    )
    dfc = (r32, r_rms, ex[0], ex[1])

    def body(carry):
        TW, S_ds, dfc, w_ss, th, tl, step = carry
        TW, S_ds, w_ss, dt, dfc = _fast_step(
            TW, S_ds, w_ss, cfg, br, defect=dfc
        )
        th, tl = dsm.ds_add(th, tl, dt, jnp.float32(0.0))
        return TW, S_ds, dfc, w_ss, th, tl, step + 1

    TW, S_ds, _, w_ss, th, tl, step = jax.lax.while_loop(
        cond, body, (TW, S_ds, dfc, w_ss, th, tl, step)
    )
    return TW, S_ds, w_ss, th, tl, step


def simulate_fast(
    cfg: NSConfig = NSConfig(),
    W0=None,
    T0=None,
    max_steps: Optional[int] = None,
    verbose: bool = False,
    seed: int = 0,
    chunk_steps: int = 20_000,
    snapshot_steps: int = 0,
    state0: Optional[dict] = None,
) -> NSResult:
    """Fused-pass, on-device-loop simulation (f32 state, ds solves).

    Same contract as ``simulate``; the physical time loop runs inside
    lax.while_loop, so the host syncs exactly twice (after the 3-step
    warmup and at the end) plus once per ``chunk_steps`` on very long runs
    (chunking bounds one device execution while reusing the same
    executable; the sync is one scalar read per chunk).

    snapshot_steps > 0: store (T, W, S, sim_time, step) every that-many
    steps (the reference's do_vis cadence, part2.jl:236-245) — the chunk
    boundary IS the device->host sync, so snapshots reuse it rather than
    adding per-step transfers.

    state0: exact-resume payload from a previous run's ``result.state``
    (or utils.checkpoint.load of one).  The continuation is BITWISE
    identical to an uninterrupted run: the payload carries the f32 T/W,
    the ds S pair, the carried w_sumsq, the double-single
    sim-time pair, and the step count.  max_steps remains the TOTAL step
    budget including the resumed-from steps.
    """
    from fpr_tpu.ops import pallas2d

    cfg = fast_mg_default(cfg)
    ny, nx = cfg.ny, cfg.nx
    f32 = jnp.float32
    br = pallas2d.layout_br(ny)

    if state0 is not None:
        if "S_hi" not in state0:
            raise ValueError(
                "state0 is a host-loop checkpoint (T/W/S/t), not a "
                "fast-path payload; resume it with simulate() (no --fast)"
            )
        TW = jnp.stack([
            pallas2d.pad2d(jnp.asarray(state0["T"], f32), br),
            pallas2d.pad2d(jnp.asarray(state0["W"], f32), br),
        ])
        S_ds = jnp.stack([
            pallas2d.pad2d(jnp.asarray(state0["S_hi"], f32), br),
            pallas2d.pad2d(jnp.asarray(state0["S_lo"], f32), br),
        ])
        w_ss = jnp.asarray(state0["w_sumsq"], f32)
        th = jnp.asarray(state0["t_hi"], f32)
        tl = jnp.asarray(state0["t_lo"], f32)
        step = jnp.asarray(int(state0["step"]), jnp.int32)
        start_step = int(state0["step"])
    else:
        key = jax.random.PRNGKey(seed)
        T = init_field(cfg, cfg.T_init, key=key, dtype=f32) if T0 is None else jnp.asarray(T0, f32)
        W = init_field(cfg, cfg.W_init, key=key, dtype=f32) if W0 is None else jnp.asarray(W0, f32)
        TW = jnp.stack([pallas2d.pad2d(T, br), pallas2d.pad2d(W, br)])
        S_ds = jnp.zeros((2,) + TW.shape[1:], f32)
        w_ss = jnp.sum(W * W).astype(f32)  # once; carried in-kernel thereafter
        th = jnp.asarray(0.0, f32)
        tl = jnp.asarray(0.0, f32)
        step = jnp.asarray(0, jnp.int32)
        start_step = 0
    hard_cap = jnp.asarray(
        max_steps if max_steps is not None else 1_000_000, jnp.int32
    )
    snapshots = [] if snapshot_steps else None

    def host_fields():
        T = np.asarray(pallas2d.unpad2d(TW[0], ny, nx), np.float64)
        W = np.asarray(pallas2d.unpad2d(TW[1], ny, nx), np.float64)
        S = np.asarray(
            pallas2d.unpad2d(S_ds[0], ny, nx), np.float64
        ) + np.asarray(pallas2d.unpad2d(S_ds[1], ny, nx), np.float64)
        return T, W, S

    if start_step == 0:
        # warmup chunk (steps 1-3 excluded from timing, part2.jl:182-184)
        warm = jnp.minimum(jnp.asarray(3, jnp.int32), hard_cap)
        TW, S_ds, w_ss, th, tl, step = _fast_loop(
            TW, S_ds, w_ss, th, tl, step, warm, cfg, br
        )
        jax.block_until_ready((TW, S_ds, th))
    tic = time.time()
    while True:
        limit = jnp.minimum(step + jnp.asarray(chunk_steps, jnp.int32), hard_cap)
        if snapshot_steps:
            # land chunk boundaries ON snapshot multiples so the cadence
            # holds even when snapshot_steps > chunk_steps
            snap = jnp.asarray(snapshot_steps, jnp.int32)
            limit = jnp.minimum(limit, (step // snap + 1) * snap)
        TW, S_ds, w_ss, th, tl, step = _fast_loop(
            TW, S_ds, w_ss, th, tl, step, limit, cfg, br
        )
        sim_time = float(th) + float(tl)  # the sync that stops the clock
        done = sim_time >= cfg.ttot or int(step) >= int(hard_cap)
        if not done and int(step) < int(limit):
            # the device loop stopped short of the chunk limit, so its own
            # time test (against the ~48-bit split of ttot) is done even if
            # the f64 host comparison disagrees in the last bits — avoid a
            # zero-progress spin
            done = True
        if snapshots is not None and (done or int(step) % snapshot_steps == 0):
            # snapshot on cadence boundaries (chunk limits are aligned to
            # them above); the final partial chunk contributes the end state
            Th, Wh, Sh = host_fields()
            snapshots.append((Th, Wh, Sh, sim_time, int(step)))
        if done:
            break
        if verbose:
            print(f"time, steps: {sim_time} {int(step)}")
    t_elapsed = time.time() - tic

    steps = int(step)
    if verbose:
        print(f"time, steps: {sim_time} {steps}")
    T, W, S = host_fields()
    state = dict(
        T=np.asarray(pallas2d.unpad2d(TW[0], ny, nx)),
        W=np.asarray(pallas2d.unpad2d(TW[1], ny, nx)),
        S_hi=np.asarray(pallas2d.unpad2d(S_ds[0], ny, nx)),
        S_lo=np.asarray(pallas2d.unpad2d(S_ds[1], ny, nx)),
        w_sumsq=np.asarray(w_ss),
        t_hi=np.asarray(th),
        t_lo=np.asarray(tl),
        step=np.asarray(steps),
    )
    return NSResult(
        T=T, W=W, S=S,
        t_elapsed=t_elapsed,
        timed_iters=max(steps - start_step - (3 if start_step == 0 else 0), 0),
        steps=steps,
        sim_time=sim_time,
        snapshots=snapshots,
        state=state,
    )
