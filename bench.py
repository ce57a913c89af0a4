"""Headline benchmark on one GPU: prints ONE JSON line.

Primary: 3D dual-time diffusion at 512^3 in f32 through the production
step (K=3 stacked state), reported as ms per pseudo-time iteration and as
the reference's counted effective throughput T_eff
(part1_kernel_programming.jl:208-217, shared-memory-kernel model: 6+1
words/cell/iteration at our word size) against the reference's best
single-GPU T_eff of 63.5 GB/s (Titan X, f64 — BASELINE.md).

Extras: MG 4097^2 Poisson time-to-tol 1e-6 via the double-single defect
correction with the DST-513 ladder and V(5,5) (reference: 0.154 s on a
V100, BASELINE.md), and Navier-Stokes 2049x513 at Pr=0.01, tol=1e-7 —
explicit to ttot=0.005 (8736 timed steps in the reference, 1314 s) and
semi-implicit (37 steps, 25.5 s on the V100).

Every timing ends in ``block_until_ready``; each row is a median over
repetitions with its interquartile range, compilation excluded.  The card
line (``nvidia-smi`` name and power limit) is part of the output.  The
benchmark refuses to run without a GPU.

Usage: python bench.py [--quick]   (--quick: small shapes, smoke only)
"""

import argparse
import dataclasses
import json

import jax
import numpy as np


def bench_diffusion(n: int, iters: int):
    """ms per iteration of the K=3 stacked step at n^3 (f32)."""
    import jax.numpy as jnp

    from fpr_tpu.core import bc
    from fpr_tpu.core.grid import Grid3D, pseudo_timestep
    from fpr_tpu.ops import pallas3d, stencil3d
    from fpr_tpu.utils.timing import diffusion_bench_results, timed_stats

    grid = Grid3D(n, n, n)
    dtau = pseudo_timestep(grid.dx, grid.dy, grid.dz, 1.0)
    kw = dict(dt=0.2, dtau=dtau, dx=grid.dx, dy=grid.dy, dz=grid.dz, D=1.0)
    Ht = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, dtype=jnp.float32))
    shape = (n, n, n)
    K = 3  # pseudo-time iterations per step call (the production config)

    @jax.jit
    def iterate(state, k):
        def body(i, carry):
            st, acc = carry
            st, sumsq = pallas3d.dual_time_stepk_stacked(st, shape, K=K, **kw)
            return st, acc + sumsq
        return jax.lax.fori_loop(0, k, body, (state, jnp.float32(0)))

    state = pallas3d.stack_state_k(Ht, Ht, K)
    jax.block_until_ready(iterate(state, 5))  # compile + warm up

    stats = timed_stats(
        lambda: jax.block_until_ready(iterate(state, iters // K)), reps=3)
    res = diffusion_bench_results(
        stats.median_s, K * (iters // K), n, n, n, word_bytes=4, model="shmem"
    )
    return res, stats


def bench_mg(n: int, tol: float):
    """Time-to-tolerance of the double-single defect-correction MG with the
    DST truncated ladder; the reported residual is the TRUE defect,
    verified against an f64 residual after timing."""
    import jax.numpy as jnp

    from fpr_tpu.core.config import CoarseSolver, MGConfig
    from fpr_tpu.ops import stencil2d
    from fpr_tpu.solvers.multigrid import mg_solve_ds_jit
    from fpr_tpu.utils.timing import timed_stats

    cfg = MGConfig(coarse_size=min(513, n), coarse_solver=CoarseSolver.DST,
                   pre_smooth=5, post_smooth=5)
    h = 1.0 / (n - 1)
    key = jax.random.PRNGKey(0)
    b = (
        jnp.zeros((n, n), jnp.float32)
        .at[1:-1, 1:-1]
        .set(jax.random.uniform(key, (n - 2, n - 2), jnp.float32))
    )

    def solve():
        return jax.block_until_ready(
            mg_solve_ds_jit(b, h, 0.0, tol, 30, cfg=cfg, return_pair=True))

    (uh, ul), r, it = solve()  # compile + converge once
    stats = timed_stats(solve, reps=5)

    u64 = uh.astype(jnp.float64) + ul.astype(jnp.float64)
    b64 = b.astype(jnp.float64)
    res = stencil2d.residual(u64, b64, h, 0.0)
    rel_true = float(stencil2d.rms(res)) / float(stencil2d.rms(b64))
    return stats, int(it), rel_true


def bench_ns():
    """Explicit NS at the reference's full 2049x513 scale (Pr=0.01,
    ttot=0.005, tol=1e-7) through simulate_fast, in two rows: reference
    tolerance semantics (s_tol_factor=1) and the relaxed-S configuration
    (s_tol_factor=100: the S solve to 100*tol*rms(W), reported only while
    its timed step count equals the reference-semantics row's); plus the
    semi-implicit tier (beta=0.5) at the same scale."""
    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models.navier_stokes import simulate_fast

    cfg = NSConfig(nx=2049, ny=513, ttot=0.005, beta=0.0, Pr=0.01,
                   tol=1e-7, niters=50)

    def runs(c, reps=3):
        outs = [simulate_fast(c, seed=0) for _ in range(reps + 1)]
        return outs[-1], [o.t_elapsed for o in outs[1:]]  # first compiles

    out, times = runs(cfg)
    relaxed, relaxed_times = runs(dataclasses.replace(cfg, s_tol_factor=100.0))
    semi, semi_times = runs(dataclasses.replace(cfg, beta=0.5))
    parity = relaxed.timed_iters == out.timed_iters
    return {
        "explicit_seconds": float(np.median(times)),
        "rep_seconds": times,
        "timed_steps": out.timed_iters,
        "relaxed_s_seconds": float(np.median(relaxed_times)) if parity else None,
        "relaxed_s_rep_seconds": relaxed_times if parity else None,
        "relaxed_s_timed_steps": relaxed.timed_iters,
        "semi_seconds": float(np.median(semi_times)),
        "semi_rep_seconds": semi_times,
        "semi_timed_steps": semi.timed_iters,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-mg", action="store_true")
    ap.add_argument("--skip-ns", action="store_true")
    args = ap.parse_args()

    from fpr_tpu.utils.runtime import card_line, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu()
    jax.config.update("jax_enable_x64", True)  # the f64 residual check
    card = card_line()

    n_diff = 128 if args.quick else 512
    iters = 99 if args.quick else 300  # multiple of the K=3 step
    res, stats = bench_diffusion(n_diff, iters)
    extras = {
        "card": card,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "timing": "median of reps (3; 5 for MG), block_until_ready, "
                  "compilation excluded; iqr_s carries the spread",
        "dtype": "float32",
        "counting_model": "shmem (6+1 words/cell/iter), reference parity",
        "diffusion_grid": f"{n_diff}^3",
        "diffusion_ms_per_iter": stats.median_s / iters * 1e3,
        "diffusion_gflops": res.performance / 1e9,
        "diffusion_iqr_s": stats.iqr_s,
    }

    if not args.skip_mg:
        n_mg = 1025 if args.quick else 4097
        mg_stats, it, rel = bench_mg(n_mg, 1e-6)
        extras.update({
            "mg_grid": f"{n_mg}^2",
            "mg_solver": "ds defect correction + DST-513 ladder, V(5,5) "
                         "(mg_solve_ds)",
            "mg_seconds_to_tol1e-6": mg_stats.median_s,
            "mg_iqr_s": mg_stats.iqr_s,
            "mg_outer_iterations": it,
            "mg_true_f64_rel_residual": rel,
        })

    if not (args.skip_ns or args.quick):
        ns = bench_ns()
        extras.update({
            "ns_explicit_2049x513_Pr0.01_seconds": ns["explicit_seconds"],
            "ns_rep_seconds": ns["rep_seconds"],
            "ns_timed_steps": ns["timed_steps"],
            "ns_explicit_relaxed_s_seconds": ns["relaxed_s_seconds"],
            "ns_relaxed_s_rep_seconds": ns["relaxed_s_rep_seconds"],
            "ns_relaxed_s_timed_steps": ns["relaxed_s_timed_steps"],
            "ns_semi_implicit_seconds": ns["semi_seconds"],
            "ns_semi_rep_seconds": ns["semi_rep_seconds"],
            "ns_semi_timed_steps": ns["semi_timed_steps"],
        })

    teff = res.throughput / 1e9
    print(json.dumps({
        "metric": f"3D dual-time diffusion T_eff (counted 6+1 model) at "
                  f"{n_diff}^3, f32, {card}",
        "value": teff,
        "unit": "GB/s",
        "vs_baseline": teff / 63.5,
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
