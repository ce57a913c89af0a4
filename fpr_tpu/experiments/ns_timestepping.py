"""Semi-implicit vs explicit NS timestepping experiment — the analog of
part2_semi_implicit_vs_explicit_experiments.jl: sweep Pr in 10^(-3..1) x
beta in {0, 0.5, 1} on a 2049x513 grid, ttot=0.005, tol=1e-7, recording
steps and wall time (the reference's headline 51x semi-implicit speedup at
Pr=0.01, BASELINE.md).

    python -m fpr_tpu.experiments.ns_timestepping            # full grid
    python -m fpr_tpu.experiments.ns_timestepping --small    # 513x129 smoke
"""

from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default="benchmark-results/ns_semi_implicit_vs_explicit.csv")
    ap.add_argument("--ttot", type=float, default=0.005)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument(
        "--solver", choices=["direct", "mixed", "fast"], default="direct",
        help="'fast' = simulate_fast (fused operator pass, on-device "
        "while_loop, double-single MG solves — the production path)",
    )
    ap.add_argument("--Pr", type=float, default=None, help="single-Pr run")
    ap.add_argument(
        "--betas", type=str, default=None, metavar="B0,B1",
        help="comma list restricting the beta sweep (e.g. '0.5,1.0' to "
        "skip the long explicit rows; note every beta solves the "
        "streamfunction Poisson problem each step, so MG-ladder options "
        "affect explicit rows too)")
    ap.add_argument(
        "--mg-dst", type=int, default=None, metavar="COARSE",
        help="truncate the fast tier's MG ladder at COARSE (= 2^l+1) and "
        "solve that subtree exactly with the DST matmul solver — fewer "
        "sequential levels per V-cycle (the dominant per-step latency). "
        "NOTE: DST-257 is now the fast tier's DEFAULT at production sizes "
        "(navier_stokes.fast_mg_default); this flag overrides it")
    ap.add_argument(
        "--s-tol-factor", type=float, default=None,
        help="fast tier only: relax the streamfunction solve tolerance to "
        "FACTOR*tol*rms(W) (NSConfig.s_tol_factor — measured to preserve "
        "exact explicit step parity to factor 1000; see "
        "benchmark-results/ns_s_tol_factor.json)")
    ap.add_argument(
        "--label", type=str, default=None,
        help="override the CSV solver label (resume-by-key tier name), "
        "e.g. 'fast_r5' to record a new sweep generation without "
        "clobbering committed rows")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed repetitions (median + iqr recorded). "
                    "Default: 3 for the jit-cached fast tier, 1 for the "
                    "host-loop tiers (a single mixed row runs 4+ min)")
    args = ap.parse_args()

    import jax

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import navier_stokes as ns
    from fpr_tpu.utils.io import append_csv_row, csv_has_row

    nx, ny = (513, 129) if args.small else (2049, 513)
    backend = jax.default_backend()
    if args.solver == "mixed":
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    else:
        dtype = jnp.float64 if args.f64 else jnp.float32
    if args.solver == "fast" and args.f64:
        raise SystemExit("--solver fast is the f32 production path (no --f64)")

    pr_values = [args.Pr] if args.Pr is not None else [1e-3, 1e-2, 1e-1, 1.0, 10.0]
    # --mg-dst rows are a distinct tier in the CSV (else resume-by-key
    # would silently skip them in favor of the cached plain-fast rows).
    solver_label = args.label or (
        f"fast_dst{args.mg_dst}" if args.mg_dst else args.solver
    )
    if args.s_tol_factor and not args.label:
        # relaxed-tolerance rows must never share a tier name (and thus a
        # resume key) with reference-semantics rows
        solver_label = f"{solver_label}_stol{args.s_tol_factor:g}"

    betas = (
        tuple(float(b) for b in args.betas.split(","))
        if args.betas else (0.0, 0.5, 1.0)
    )
    for Pr in pr_values:
        for beta in betas:
            key = dict(Pr=Pr, beta=beta, nx=nx, backend=backend,
                       solver=solver_label)
            if csv_has_row(args.out, key):
                print(f"skip (cached): {key}")
                continue
            mg_kw = {}
            if args.mg_dst:
                if args.solver != "fast":
                    raise SystemExit("--mg-dst applies to the fast tier only")
                from fpr_tpu.core.config import CoarseSolver, MGConfig

                mg_kw["mg"] = MGConfig(
                    coarse_size=args.mg_dst, coarse_solver=CoarseSolver.DST
                )
            if args.s_tol_factor:
                if args.solver != "fast":
                    raise SystemExit("--s-tol-factor applies to the fast tier")
                mg_kw["s_tol_factor"] = args.s_tol_factor
            cfg = NSConfig(
                nx=nx, ny=ny, Pr=Pr, beta=beta, ttot=args.ttot, tol=args.tol,
                niters=50, mg_solver=args.solver, **mg_kw,
            )
            reps = args.reps if args.reps else (3 if args.solver == "fast" else 1)
            try:
                outs = []
                for _ in range(max(1, reps)):  # first rep pays the compile
                    if args.solver == "fast":
                        outs.append(ns.simulate_fast(cfg, max_steps=args.max_steps))
                    else:
                        outs.append(ns.simulate(cfg, dtype=dtype,
                                                max_steps=args.max_steps))
            except Exception as exc:
                print(f"Pr={Pr} beta={beta}: FAILED {type(exc).__name__}: {exc}")
                continue
            import numpy as np

            ts = sorted(o.t_elapsed for o in outs)
            out = outs[-1]
            row = dict(
                Pr=Pr, beta=beta, nx=nx, ny=ny, backend=backend,
                solver=solver_label, steps=out.steps,
                timed_steps=out.timed_iters,
                seconds=round(float(np.median(ts)), 3),
                iqr_s=round(float(np.subtract(*np.percentile(ts, [75, 25]))), 4),
                reps=len(ts),
            )
            append_csv_row(
                args.out, row, key_fields=("Pr", "beta", "nx", "backend", "solver")
            )
            print(row)


if __name__ == "__main__":
    main()
