"""Distributed Navier-Stokes fast path: the fused simulation
row-sharded over a device mesh.

Completes the production-tier distribution story (VERDICT round-2 item 1):
the same per-step pipeline as ``navier_stokes.simulate_fast`` — warm-started
double-single multigrid for the streamfunction (with the velocity maxima
from its defect pass), the fused NS operator pass, on-device adaptive dt and ds
sim-time — but every array is a shard-local rp block, halos ride 8-row
ppermute faces, norms/maxima are psum/pmax, and the multigrid V-cycle is
the sharded production tier of fpr_tpu.solvers.dist_mg_ds.

Scope: every beta tier.  Explicit (beta = 0): one streamfunction solve
per step.  Semi-implicit/implicit (beta >= 0.5): the rhs-mode operator
pass plus two further warm-started sharded Helmholtz solves per step —
the T solve with the NS temperature BCs (dist_mg_ds apply_bcs: Dirichlet
rows against global indices in the defect pass, shard-local Neumann columns in
the transfers).

Numerics: per-cell arithmetic is IDENTICAL to the single-device fast path
(same passes, traced row offsets); only the reduction order differs
(per-shard partials + psum/pmax), so the adaptive dt can differ in the
last ulp and trajectories drift apart at the f32 rounding level over many
steps — the parity test pins a short window.

Reference lineage: the simulated physics/stepping is scripts-part2/
part2.jl:150-257 (operators, adaptive dt, streamfunction solve); the
reference has no distributed part-2 analog at all (its MPI layer,
ImplicitGlobalGrid via part1_kernel_programming.jl:100-101, covers only
part 1), so the sharding design here follows the mesh/ppermute model of
fpr_tpu.parallel instead.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fpr_tpu.core.config import NSConfig
from fpr_tpu.ops.pallas2d import PAD, padded_cols, padded_rows
from fpr_tpu.solvers.dist_mg_ds import ShardPlan, _refresh, _vcycle_dist, plan_shards


def _solve_sharded(u_ds, f_rp, tolf, plan: ShardPlan, h, c, cfg, axis, off0,
                   niters, tol, inner_cycles=1, apply_bcs=False,
                   velocity_max=False):
    """Warm-started sharded ds solve of (lap - c) u = f — the distributed
    mg_solve_ds_rp of the NS fast step.

    velocity_max: compute max|du/dy|, max|du/dx| in the defect pass
    (the streamfunction solve; the adaptive dt needs the maxima of the
    returned iterate).  apply_bcs: NS temperature BCs (the semi-implicit
    T Helmholtz solve).  Returns u_ds' — plus (max_vx, max_vy) pmax'd
    when velocity_max."""
    from fpr_tpu.ops import ds as dsm

    ny, nx = plan.ny, plan.nx
    ny_l, br0 = plan.ny_l, plan.brs[0]
    kw = dict(row_off=off0, ny_mask=ny, raw_sumsq=True,
              velocity_max=velocity_max, apply_bcs=apply_bcs)

    zero_e = jnp.zeros_like(f_rp)
    u_ds = _refresh(u_ds, ny_l, axis)
    out = dsm.defect_pass(
        u_ds, f_rp[None], zero_e, 0.0, ny_l, nx, br0, h, c, **kw
    )
    if velocity_max:
        u_ds, r32, sumsq, ex = out
        ax = lax.pmax(ex[0], axis)
        ay = lax.pmax(ex[1], axis)
    else:
        u_ds, r32, sumsq = out
        ax = ay = jnp.float32(0.0)
    r_rms = jnp.sqrt(lax.psum(sumsq, axis) / (nx * ny))

    def cond(carry):
        _, _, r_rms, _, _, it = carry
        return jnp.logical_and(it < niters, r_rms >= tolf)

    def body(carry):
        u_ds, r32, _, _, _, it = carry
        e = zero_e
        for cyc in range(inner_cycles):
            e = _vcycle_dist(
                e, r32, plan, h, c, tol, cfg, axis, off0,
                assume_zero_u=(cyc == 0), apply_bcs=apply_bcs,
            )
        u_ds = _refresh(u_ds, ny_l, axis)
        e = _refresh(e, ny_l, axis)
        out = dsm.defect_pass(
            u_ds, f_rp[None], e, 1.0, ny_l, nx, br0, h, c, **kw
        )
        if velocity_max:
            u_ds, r32, sumsq, ex = out
            ax = lax.pmax(ex[0], axis)
            ay = lax.pmax(ex[1], axis)
        else:
            u_ds, r32, sumsq = out
            ax = ay = jnp.float32(0.0)
        r_rms = jnp.sqrt(lax.psum(sumsq, axis) / (nx * ny))
        return u_ds, r32, r_rms, ax, ay, it + 1

    u_ds, _, _, ax, ay, _ = lax.while_loop(
        cond, body, (u_ds, r32, r_rms, ax, ay, jnp.asarray(0, jnp.int32))
    )
    if velocity_max:
        return u_ds, ax, ay
    return u_ds


def _solve_s_sharded(S_ds, w_rp, tolf, plan, h, cfg, axis, off0,
                     niters, tol, inner_cycles=1):
    """Streamfunction solve: lap S = W with the defect pass's velocity
    maxima."""
    return _solve_sharded(
        S_ds, w_rp, tolf, plan, h, 0.0, cfg, axis, off0, niters, tol,
        inner_cycles=inner_cycles, velocity_max=True,
    )


@functools.lru_cache(maxsize=16)
def _build_ns_loop(plan: ShardPlan, mesh, axis, cfg: NSConfig):
    """Jitted sharded chunk loop: runs fused NS steps while sim_time < ttot
    and step < limit."""
    from fpr_tpu.models.navier_stokes import _semi_implicit
    from fpr_tpu.ops import ds as dsm
    from fpr_tpu.ops import pallas_ns
    from fpr_tpu.ops.ds import f32_pair

    semi = _semi_implicit(cfg.beta)
    ny, nx = plan.ny, plan.nx
    ny_l, br0 = plan.ny_l, plan.brs[0]
    h = cfg.h
    f32 = jnp.float32
    n_cells = float(nx * ny)
    tt_hi, tt_lo = f32_pair(cfg.ttot)

    def shard_loop(TW, S_ds, w_ss, th, tl, step, limit):
        TW, S_ds = TW[0], S_ds[0]
        d = lax.axis_index(axis)
        off0 = d * ny_l

        def cond(carry):
            _, _, _, th, tl, step = carry
            dh, dl = dsm.ds_add(th, tl, jnp.float32(-tt_hi), jnp.float32(-tt_lo))
            return (dh < 0.0) & (step < limit)

        def body(carry):
            TW, S_ds, w_ss, th, tl, step = carry
            tolf = jnp.asarray(cfg.tol, f32) * jnp.sqrt(w_ss / n_cells)
            S_ds, ax, ay = _solve_s_sharded(
                S_ds, TW[1], tolf, plan, h, cfg.mg, axis, off0,
                cfg.niters, cfg.tol,
            )
            dt_adv = jnp.asarray(cfg.a_adv, f32) * jnp.minimum(h / ax, h / ay)
            if cfg.beta >= 0.5:
                dt = dt_adv
            else:
                dt = jnp.minimum(jnp.asarray(cfg.dt_dif, f32), dt_adv)
            dt = jnp.where((ax == 0.0) & (ay == 0.0),
                           jnp.asarray(cfg.dt_dif, f32), dt)
            TW = _refresh(TW, ny_l, axis)
            S = _refresh(S_ds[0], ny_l, axis)
            if semi:
                # rhs pass + two warm-started sharded Helmholtz solves
                # (mirrors _fast_step's semi branch; T gets the BCs)
                cT = 1.0 / (jnp.asarray(cfg.beta, f32) * dt)
                cW = cT / jnp.asarray(cfg.Pr, f32)
                rhs, (trhs_l, wrhs_l) = pallas_ns.ns_fused_rp(
                    TW, S, dt, ny_l, nx, br0, h, cfg.Pr, cfg.Ra,
                    k=cfg.k, beta=cfg.beta, mode="rhs", cT=cT, cW=cW,
                    with_sumsq=True, row_off=off0, ny_mask=ny,
                )
                zeros = jnp.zeros_like(TW[0])
                tolT = jnp.asarray(cfg.tol, f32) * jnp.sqrt(
                    lax.psum(trhs_l, axis) / n_cells)
                T_ds = _solve_sharded(
                    jnp.stack([TW[0], zeros]), rhs[0], tolT, plan, h, cT,
                    cfg.mg, axis, off0, cfg.niters, cfg.tol, apply_bcs=True,
                )
                tolW = jnp.asarray(cfg.tol, f32) * jnp.sqrt(
                    lax.psum(wrhs_l, axis) / n_cells)
                W_ds = _solve_sharded(
                    jnp.stack([TW[1], zeros]), rhs[1], tolW, plan, h, cW,
                    cfg.mg, axis, off0, cfg.niters, cfg.tol,
                )
                TW = jnp.stack([T_ds[0], W_ds[0]])
                # shard-local W sumsq over VALID physical rows only (the
                # last shard's rp rows beyond global ny are padding)
                w = TW[1, PAD : PAD + ny_l, :nx]
                valid = (off0 + jnp.arange(ny_l)) < ny
                w = jnp.where(valid[:, None], w, 0.0)
                w_ss = lax.psum(jnp.sum(w * w), axis)
            else:
                TW, (_, w_local) = pallas_ns.ns_fused_rp(
                    TW, S, dt, ny_l, nx, br0, h, cfg.Pr, cfg.Ra,
                    k=cfg.k, beta=cfg.beta, mode="explicit", with_sumsq=True,
                    row_off=off0, ny_mask=ny,
                )
                w_ss = lax.psum(w_local, axis)
            th, tl = dsm.ds_add(th, tl, dt, jnp.float32(0.0))
            return TW, S_ds, w_ss, th, tl, step + 1

        TW, S_ds, w_ss, th, tl, step = lax.while_loop(
            cond, body, (TW, S_ds, w_ss, th, tl, step)
        )
        return TW[None], S_ds[None], w_ss, th, tl, step

    sp = P(axis, None, None, None)
    kwargs = dict(
        mesh=mesh,
        in_specs=(sp, sp, P(), P(), P(), P(), P()),
        out_specs=(sp, sp, P(), P(), P(), P()),
    )
    body = shard_map(shard_loop, **kwargs)
    return jax.jit(body)


def simulate_fast_sharded(
    cfg: NSConfig,
    mesh: Mesh,
    axis: str = "y",
    W0=None,
    T0=None,
    max_steps: Optional[int] = None,
    seed: int = 0,
    chunk_steps: int = 20_000,
    replicate_below: int = 257,
    verbose: bool = False,
    snapshot_steps: int = 0,
    state0: Optional[dict] = None,
):
    """``simulate_fast`` over a device mesh (all beta tiers).

    Same contract as simulate_fast, including chunk-synced snapshots and
    exact resume: the ``state`` payload uses the same global-field schema
    as the single-device path, so checkpoints interoperate between the
    tiers (a single-device run can resume sharded and vice versa — bitwise
    on the same tier, f32-reduction-noise across tiers).
    """
    from fpr_tpu.models.navier_stokes import (
        NSResult, fast_mg_default, init_field,
    )

    cfg = fast_mg_default(cfg)  # same production ladder as simulate_fast
    ny, nx = cfg.ny, cfg.nx
    ndev = mesh.shape[axis]
    plan = plan_shards(ny, nx, ndev, cfg.mg, replicate_below)
    ny_l, br0 = plan.ny_l, plan.brs[0]
    total = padded_rows(ny_l, br0)
    nxp = padded_cols(nx)
    f32 = jnp.float32

    def shard_pack(a):
        pad_rows = ndev * ny_l - ny
        ap = jnp.pad(a, ((0, pad_rows), (0, 0))).reshape(ndev, ny_l, nx)
        return jnp.pad(ap, ((0, 0), (PAD, total - ny_l - PAD), (0, nxp - nx)))

    sp = NamedSharding(mesh, P(axis, None, None, None))
    if state0 is not None:
        if "S_hi" not in state0:
            raise ValueError(
                "state0 is a host-loop checkpoint (T/W/S/t), not a "
                "fast-path payload; resume it with simulate() (no --fast)"
            )
        T = jnp.asarray(state0["T"], f32)
        W = jnp.asarray(state0["W"], f32)
        S_ds = lax.with_sharding_constraint(
            jnp.stack([shard_pack(jnp.asarray(state0["S_hi"], f32)),
                       shard_pack(jnp.asarray(state0["S_lo"], f32))],
                      axis=1), sp,
        )
        w_ss = jnp.asarray(state0["w_sumsq"], f32)
        th = jnp.asarray(state0["t_hi"], f32)
        tl = jnp.asarray(state0["t_lo"], f32)
        step = jnp.asarray(int(state0["step"]), jnp.int32)
        start_step = int(state0["step"])
    else:
        key = jax.random.PRNGKey(seed)
        T = init_field(cfg, cfg.T_init, key=key, dtype=f32) if T0 is None else jnp.asarray(T0, f32)
        W = init_field(cfg, cfg.W_init, key=key, dtype=f32) if W0 is None else jnp.asarray(W0, f32)
        S_ds = lax.with_sharding_constraint(
            jnp.zeros((ndev, 2, total, nxp), f32), sp
        )
        w_ss = jnp.sum(W * W).astype(f32)
        th = jnp.asarray(0.0, f32)
        tl = jnp.asarray(0.0, f32)
        step = jnp.asarray(0, jnp.int32)
        start_step = 0
    TW = lax.with_sharding_constraint(
        jnp.stack([shard_pack(T), shard_pack(W)], axis=1), sp
    )
    hard_cap = jnp.asarray(
        max_steps if max_steps is not None else 1_000_000, jnp.int32
    )
    snapshots = [] if snapshot_steps else None

    def gather(stack, plane, dtype=np.float64):
        blocks = stack[:, plane, PAD : PAD + ny_l, :nx]
        return np.asarray(blocks, dtype).reshape(ndev * ny_l, nx)[:ny]

    loop = _build_ns_loop(plan, mesh, axis, cfg)

    if start_step == 0:
        # warmup chunk (timing parity with simulate_fast)
        warm = jnp.minimum(jnp.asarray(3, jnp.int32), hard_cap)
        TW, S_ds, w_ss, th, tl, step = loop(TW, S_ds, w_ss, th, tl, step, warm)
        float(th)
    tic = time.time()
    while True:
        limit = jnp.minimum(step + jnp.asarray(chunk_steps, jnp.int32), hard_cap)
        if snapshot_steps:
            # align chunk boundaries to snapshot multiples (cadence holds
            # even when snapshot_steps > chunk_steps)
            snap = jnp.asarray(snapshot_steps, jnp.int32)
            limit = jnp.minimum(limit, (step // snap + 1) * snap)
        TW, S_ds, w_ss, th, tl, step = loop(TW, S_ds, w_ss, th, tl, step, limit)
        sim_time = float(th) + float(tl)
        done = sim_time >= cfg.ttot or int(step) >= int(hard_cap)
        if not done and int(step) < int(limit):
            done = True  # device loop hit its own ttot test
        if snapshots is not None and (done or int(step) % snapshot_steps == 0):
            snapshots.append((
                gather(TW, 0), gather(TW, 1),
                gather(S_ds, 0) + gather(S_ds, 1),
                sim_time, int(step),
            ))
        if done:
            break
        if verbose:
            print(f"time, steps: {sim_time} {int(step)}")
    t_elapsed = time.time() - tic
    steps = int(step)

    S = gather(S_ds, 0) + gather(S_ds, 1)
    state = dict(
        T=gather(TW, 0, np.float32),
        W=gather(TW, 1, np.float32),
        S_hi=gather(S_ds, 0, np.float32),
        S_lo=gather(S_ds, 1, np.float32),
        w_sumsq=np.asarray(w_ss),
        t_hi=np.asarray(th),
        t_lo=np.asarray(tl),
        step=np.asarray(steps),
    )
    return NSResult(
        T=gather(TW, 0), W=gather(TW, 1), S=S,
        t_elapsed=t_elapsed,
        timed_iters=max(steps - start_step - (3 if start_step == 0 else 0), 0),
        steps=steps,
        sim_time=float(th) + float(tl),
        snapshots=snapshots,
        state=state,
    )
