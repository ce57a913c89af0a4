"""Work-precision experiments for the 3D diffusion solver — the analogs of
part1_error_vs_grid_size_experiments.jl (grid sweep 2^(4:0.5:7), ttot=2,
tol=1e-6, probe at (4.5,4.5,4.5)) and
part1_error_vs_tolerance_experiments.jl (tol sweep 1e-3..1e-10 at a fixed
grid).

    python -m fpr_tpu.experiments.part1_error_experiments --mode grid
    python -m fpr_tpu.experiments.part1_error_experiments --mode tol --n 128
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["grid", "tol"], required=True)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--max-e", type=float, default=7.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.core.grid import Grid3D
    from fpr_tpu.models import diffusion3d
    from fpr_tpu.utils.io import append_csv_row

    dtype = jnp.float64 if args.f64 else jnp.float32
    policy = ExecutionPolicy.JNP if args.f64 else ExecutionPolicy.PALLAS
    if args.mode == "tol" and not args.f64:
        # the sweep reaches tol=1e-10 (part1_error_vs_tolerance_experiments
        # .jl:25), far below the f32 residual floor: use the double-single
        # tier (f64-class accuracy in f32 arithmetic)
        jax.config.update("jax_enable_x64", True)
        policy = ExecutionPolicy.PALLAS_DS

    if args.mode == "grid":
        out_csv = args.out or "benchmark-results/error_vs_grid_size.csv"
        for e in np.arange(4.0, args.max_e + 0.25, 0.5):
            n = int(round(2**e))
            cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=2.0, tol=1e-6, policy=policy)
            res = diffusion3d.solve(cfg, dtype=dtype)
            g = Grid3D(n, n, n)
            row = dict(
                nx=n,
                val=diffusion3d.probe_nearest(res.H, g),
                interp_val=diffusion3d.probe_trilinear(res.H, g),
            )
            append_csv_row(out_csv, row, key_fields=("nx",))
            print(row)
    else:
        out_csv = args.out or "benchmark-results/error_vs_tolerance.csv"
        n = args.n
        g = Grid3D(n, n, n)
        for tol in [10.0**-p for p in range(3, 11)]:
            cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=2.0, tol=tol, policy=policy)
            res = diffusion3d.solve(cfg, dtype=dtype)
            row = dict(
                nx=n,
                tol=tol,
                val=diffusion3d.probe_nearest(res.H, g),
                interp_val=diffusion3d.probe_trilinear(res.H, g),
            )
            # grid size IS part of the key: a stale 64^3 row must not block
            # the reference-scale 128^3 re-run (round-1 defect)
            append_csv_row(out_csv, row, key_fields=("nx", "tol"))
            print(row)


if __name__ == "__main__":
    main()
