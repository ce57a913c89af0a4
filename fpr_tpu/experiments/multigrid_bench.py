"""Multigrid benchmark sweep — the analog of multigrid_bench.jl: time
MGsolve to tol=1e-6 over k x l x coarse-solver x solver-tier, CSV with
resume, try/except continue per config (multigrid_bench.jl:41-62).

Adds the work-precision comparison the BASELINE north star asks for:
MG-as-solver vs unpreconditioned CG vs MG-preconditioned CG.

    python -m fpr_tpu.experiments.multigrid_bench --max-k 12
    python -m fpr_tpu.experiments.multigrid_bench --workprec --max-k 10
"""

from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-k", type=int, default=4)
    ap.add_argument("--max-k", type=int, default=12)
    ap.add_argument("--max-l", type=int, default=3)
    ap.add_argument("--solvers", default="direct,mixed,ds")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workprec", action="store_true",
                    help="MG vs CG vs MG-PCG comparison instead of the k/l sweep")
    ap.add_argument("--f64-iter-max-k", type=int, default=12,
                    help="largest k for the per-iteration-f64 solvers (mg, cg) "
                         "in workprec mode")
    ap.add_argument("--wp-solvers", default=None,
                    help="comma list restricting the workprec solver set "
                         "(resume aid)")
    ap.add_argument("--mg64-max-k", type=int, default=11,
                    help="largest k for the plain-f64 mg solver specifically")
    ap.add_argument("--dst", action="store_true",
                    help="add truncated-ladder DST coarse-solver configs "
                         "(coarse='dst' rows) to the k/l sweep")
    ap.add_argument("--smooths", type=int, default=2,
                    help="pre/post smooth count for the ds tier's stk "
                         "V-cycle legs (deeper smoothing contracts harder; "
                         "rows are labeled ds_vNN when != 2)")
    ap.add_argument("--platform", choices=["cpu", "gpu"], default=None,
                    help="force the backend (cpu rows feed the "
                         "CPU<->accelerator crossover analysis, "
                         "docs/part2.md — the reference's "
                         "bench_multigrid_cpu.csv analog)")
    args = ap.parse_args()
    if args.out is None:  # the two modes have different schemas
        args.out = (
            "benchmark-results/mg_workprecision.csv"
            if args.workprec
            else "benchmark-results/bench_multigrid.csv"
        )

    import jax

    if args.platform:
        from fpr_tpu.cli import PLATFORMS

        jax.config.update("jax_platforms", PLATFORMS[args.platform])
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fpr_tpu.core.config import CoarseSolver, MGConfig
    from fpr_tpu.solvers import krylov, multigrid
    from fpr_tpu.utils.io import append_csv_row, csv_has_row

    backend = jax.default_backend()
    key = jax.random.PRNGKey(0)

    def rhs(n, dtype):
        return (
            jnp.zeros((n, n), dtype)
            .at[1:-1, 1:-1]
            .set(jax.random.uniform(key, (n - 2, n - 2), dtype))
        )

    from fpr_tpu.utils.timing import timed_stats

    def timed(fn, reps=3):
        """Median-of-reps wall time of one solve, block_until_ready
        included (the BenchmarkTools-median analog)."""
        r = jax.block_until_ready(fn())  # compile + warm up

        def run():
            jax.block_until_ready(fn())

        return timed_stats(run, reps=reps), r

    if args.workprec:
        for k in range(args.min_k, args.max_k + 1):
            n = 2**k + 1
            h = 1.0 / (n - 1)
            # solver entry-point factories; the rhs/u0 arrays are built
            # PER SOLVER below (not hoisted): at k=14 the f64 b/u0 pair
            # alone is 4.2 GB of device ballast that OOMs the ds tier
            # (which only needs the 1.07 GB f32 rhs)
            # the ds tier runs its production configuration (DST-513
            # ladder + deep V(5,5) smoothing — bench.py's headline
            # config); mg/mixed/cg stay at reference-parity V(2,2)
            ds_cfg = MGConfig(coarse_size=min(513, n),
                              coarse_solver=CoarseSolver.DST,
                              pre_smooth=5, post_smooth=5)
            configs = {
                "mg": lambda u0, b, _: (
                    lambda: multigrid.mg_solve_jit(u0, b, h, 0.0, args.tol, 30)),
                "mixed": lambda u0, b, _: (
                    lambda: multigrid.mg_solve_mixed_jit(u0, b, h, 0.0, args.tol, 30)),
                "ds": lambda u0, b, b32: (
                    lambda: multigrid.mg_solve_ds_jit(
                        b32, h, 0.0, args.tol, 30, return_pair=True, cfg=ds_cfg)),
                "cg": lambda u0, b, _: (
                    lambda: krylov.cg(b, h, h, 0.0, args.tol, 40000)),
                "mg_pcg": lambda u0, b, _: (
                    lambda: krylov.mg_preconditioned_cg(b, h, 0.0, args.tol, 100)),
                # the production-tier north star: ds PCG preconditioned by
                # the stk V-cycle, true-residual replacement (round 4)
                "mg_pcg_ds": lambda u0, b, b32: (
                    lambda: krylov.mg_pcg_ds_jit(
                        b32, h, 0.0, args.tol, 60, return_pair=True,
                        cfg=ds_cfg)),
            }
            for name, mk_fn in configs.items():
                if args.wp_solvers and name not in args.wp_solvers.split(","):
                    continue
                if name == "mg" and k > args.mg64_max_k:
                    continue
                if name in ("mg", "cg") and k > args.f64_iter_max_k:
                    # emulated-f64 per-iteration paths: CG needs O(n)
                    # iterations and plain f64 MG ~10 full f64 cycles —
                    # hours at k=14.  mixed/mg_pcg amortize f64 to a few
                    # passes; ds has none at all.
                    continue
                if csv_has_row(args.out, dict(k=k, solver=name, backend=backend)):
                    continue
                try:
                    # only the arrays THIS solver consumes go to the
                    # device; NOT jax.jit(fn): the solver entry points are
                    # already jitted, and an outer jit of a zero-arg
                    # closure would bake b/u0 into the program as
                    # constants (~4.3 GB at k=13)
                    if name in ("ds", "mg_pcg_ds"):
                        u0 = b = None
                        b32 = rhs(n, jnp.float32)
                    else:
                        b32 = None
                        b = rhs(n, jnp.float64)
                        u0 = (jnp.zeros((n, n), jnp.float64)
                              if name in ("mg", "mixed") else None)
                    fn = mk_fn(u0, b, b32)
                    st, (u, r, it) = timed(fn)
                except Exception as exc:
                    msg = str(exc).splitlines()[0][:200] if str(exc) else ""
                    print(f"k={k} {name}: FAILED {type(exc).__name__}: {msg}")
                    jax.clear_caches()
                    continue
                row = dict(k=k, solver=name, backend=backend,
                           seconds=round(st.median_s, 4), iters=int(it),
                           iqr_s=round(st.iqr_s, 5), reps=st.reps)
                append_csv_row(args.out, row, key_fields=("k", "solver", "backend"))
                print(row)
                del fn, u, r
                u0 = b = b32 = None
                if k >= 13:
                    # >1 GB buffers: drop cached executables between configs
                    jax.clear_caches()
        return

    for k in range(args.min_k, args.max_k + 1):
        combos = [
            (l, coarse)
            for l in range(2, min(k - 2, args.max_l + 1))
            for coarse in (CoarseSolver.JACOBI, CoarseSolver.CG)
        ]
        if args.dst:
            # truncated ladders: solve the whole subtree at 2^l+1 exactly
            # with sine-transform matmuls (fpr_tpu.solvers.dst); l=min(k,9)
            # collapses small grids to pure defect-corrected DST
            combos += [(l, CoarseSolver.DST) for l in sorted({6, min(k, 9)})
                       if l <= k]
        for l, coarse in combos:
            for solver in args.solvers.split(","):
                ns = args.smooths
                label = solver
                if solver == "ds" and ns != 2:
                    label = f"ds_v{ns}{ns}"
                if csv_has_row(args.out, dict(k=k, l=l, coarse=coarse.value,
                                              solver=label, backend=backend)):
                    continue
                n = 2**k + 1
                h = 1.0 / (n - 1)
                cfg = MGConfig(coarse_size=2**l + 1, coarse_solver=coarse)
                if solver == "ds":
                    # deep smoothing rides the stk legs (ds tier only; the
                    # direct/mixed parity tiers keep the reference's 2+2)
                    cfg = MGConfig(coarse_size=2**l + 1, coarse_solver=coarse,
                                   pre_smooth=ns, post_smooth=ns)
                try:
                    if solver == "ds":
                        # double-single defect correction; rhs created
                        # directly in f32 (an f64 rhs at k=14 is 2.1 GB
                        # of pure conversion ballast), result as the
                        # native hi/lo pair — no emulated f64 anywhere
                        b32 = rhs(n, jnp.float32)
                        fn = lambda: multigrid.mg_solve_ds_jit(
                            b32, h, 0.0, args.tol, 30, cfg=cfg,
                            return_pair=True,
                        )
                    elif solver == "mixed":
                        b = rhs(n, jnp.float64)
                        u0 = jnp.zeros((n, n), jnp.float64)
                        fn = lambda: multigrid.mg_solve_mixed_jit(
                            u0, b, h, 0.0, args.tol, 30, cfg=cfg
                        )
                    else:
                        b = rhs(n, jnp.float64)
                        u0 = jnp.zeros((n, n), jnp.float64)
                        fn = lambda: multigrid.mg_solve_jit(
                            u0, b, h, 0.0, args.tol, 30, cfg=cfg
                        )
                    st, (u, r, it) = timed(fn)
                except Exception as exc:
                    print(f"k={k} l={l} {coarse.value} {solver}: FAILED {type(exc).__name__}")
                    # drop cached executables and go on with the next config
                    jax.clear_caches()
                    continue
                row = dict(
                    k=k, l=l, coarse=coarse.value, solver=label,
                    backend=backend, seconds=round(st.median_s, 4),
                    iters=int(it), iqr_s=round(st.iqr_s, 5), reps=st.reps,
                )
                append_csv_row(
                    args.out, row,
                    key_fields=("k", "l", "coarse", "solver", "backend"),
                )
                print(row)
                del fn, u, r
                if k >= 13:
                    jax.clear_caches()


if __name__ == "__main__":
    main()
