"""Distributed 2D multigrid: the V-cycle sharded over a device mesh.

Scales part 2's solver past one card's memory (the reference runs multigrid
on exactly one GPU; its multi-rank layer covers part 1 only — this is a
beyond-reference capability, the 2D analog of the reference's 3D domain
decomposition, part1_kernel_programming.jl:100-101).

Design — GSPMD, not hand-rolled shard_map: every multigrid building block
is pure jnp (stencils, injection restriction, gather-form prolongation,
reductions), so the idiomatic treatment is to shard the GLOBAL arrays
by rows over the mesh and let XLA's partitioner insert the halo exchanges
(collective-permutes of one-row faces) and psum the norms.  The
only guidance XLA needs is per-level placement, injected through
``vcycle``'s ``constrain`` hook:

- fine levels (rows >= replicate_below): sharded P(axis, None) — each
  smooth/residual/transfer runs on local rows + a 1-row halo permute;
- coarse levels: fully replicated — below a few hundred rows the
  collective latency dominates the arithmetic, so every device solves the
  (tiny) coarse problem redundantly and identically, which also keeps the
  recursion deterministic.

Row (not column) decomposition: rows are the outer (strided) dimension,
so a shard is one contiguous block and a halo face is one contiguous row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fpr_tpu.core.config import MGConfig
from fpr_tpu.solvers import multigrid


def _make_constrain(mesh: Mesh, axis: str, replicate_below: int):
    shard = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P(None, None))

    def constrain(a):
        want = shard if a.shape[0] >= replicate_below else repl
        return jax.lax.with_sharding_constraint(a, want)

    return constrain


def mg_solve_sharded(
    u0,
    f,
    h: float,
    c,
    tol: float,
    niters: int,
    mesh: Mesh,
    axis: str = "y",
    apply_bcs: bool = False,
    cfg: MGConfig = MGConfig(),
    replicate_below: int = 257,
):
    """``mg_solve`` on row-sharded global arrays.

    Semantics identical to mg_solve (same V-cycle, same convergence test);
    u0/f may live anywhere — they are placed onto the mesh here.  Returns
    (u, r_rms, iterations) with u sharded P(axis, None) over the mesh.
    """
    # the 2^k+1 grid sides are never divisible by the mesh extent, which
    # rules out explicit IO shardings (device_put rejects uneven splits);
    # in-jit sharding constraints instead let GSPMD pad each dimension
    # internally and partition every level the same way.  c is a traced
    # argument so varying Helmholtz shifts (the NS solves) reuse the
    # executable.
    solve = _build_solve(
        mesh, axis, replicate_below, float(h), float(tol), int(niters),
        bool(apply_bcs), cfg,
    )
    return solve(u0, f, jnp.asarray(c))


@functools.lru_cache(maxsize=64)
def _build_solve(mesh, axis, replicate_below, h, tol, niters, apply_bcs, cfg):
    """Jitted sharded solve, cached per (mesh, placement, solver statics) —
    a fresh jax.jit per call would recompile the whole partitioned V-cycle
    every invocation."""
    from fpr_tpu.core import bc
    from fpr_tpu.ops import stencil2d

    constrain = _make_constrain(mesh, axis, replicate_below)

    @jax.jit
    def solve(u0, f, c):
        f = constrain(f)
        f_rms = stencil2d.rms(f)
        tolf = tol * f_rms

        def cond(carry):
            _, r_rms, it = carry
            return jnp.logical_and(it < niters, r_rms >= tolf)

        def body(carry):
            u, _, it = carry
            if apply_bcs:
                u = bc.ns_temperature_bcs(u)
            u = constrain(u)
            u, r_rms = multigrid.vcycle(
                u, f, h, c, tol, cfg, apply_bcs=apply_bcs, constrain=constrain
            )
            return constrain(u), r_rms, it + 1

        return jax.lax.while_loop(
            cond,
            body,
            (constrain(u0), jnp.asarray(jnp.inf, u0.dtype), jnp.asarray(0, jnp.int32)),
        )

    return solve
