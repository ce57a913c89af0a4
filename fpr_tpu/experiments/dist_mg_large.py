"""Beyond-one-card multigrid: a grid too large for one card's memory,
solved by sharding the production ds solver over the devices present.

The motivation row for the distributed production tier (dist_mg_ds.py): at
k = 15 the 32769^2 solver state is ~21 GB of f32, and k = 16 four times
that, so the reference's single-GPU part-2 design (multigrid.jl:41-170)
runs out of memory where ``mg_solve_ds_sharded`` spreads the state over a
row (or 2D) mesh.  The run needs at least --devices devices; to rehearse
the sharded program without cards, give the CPU virtual devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N, JAX_PLATFORMS=cpu).

    python -m fpr_tpu.experiments.dist_mg_large --k 15 --devices 4

Appends one row to benchmark-results/dist_mg_large.csv with the iteration
count, converged relative residual (true f64 residual of the returned
hi+lo iterate, computed on the host), wall time, and per-shard state size.
"""

from __future__ import annotations

import argparse
import resource
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--mesh", type=str, default=None, metavar="YxX",
                    help="decompose over a 2D (y, x) mesh instead of "
                         "rows-only, e.g. --devices 8 --mesh 4x2")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--coarse", type=int, default=513)
    ap.add_argument("--out", default="benchmark-results/dist_mg_large.csv")
    args = ap.parse_args()

    import jax

    if len(jax.devices()) < args.devices:
        raise SystemExit(
            f"--devices {args.devices} needs that many devices; JAX sees "
            f"{len(jax.devices())} ({jax.devices()[0].platform})"
        )
    import jax.numpy as jnp
    import numpy as np

    from fpr_tpu.core.config import CoarseSolver, MGConfig
    from fpr_tpu.parallel.mesh import make_mesh
    from fpr_tpu.solvers import dist_mg_ds

    n = 2**args.k + 1
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(0)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2), np.float32)
    b = jnp.asarray(b)

    cfg = MGConfig(coarse_size=args.coarse, coarse_solver=CoarseSolver.DST)

    t0 = time.perf_counter()
    if args.mesh:
        ndy, ndx = (int(v) for v in args.mesh.lower().split("x"))
        assert ndy * ndx == args.devices, (args.mesh, args.devices)
        mesh = make_mesh((ndy, ndx), ("y", "x"))
        (hi, lo), r_rms, iters = dist_mg_ds.mg_solve_ds_sharded_2d(
            b, h, 0.0, args.tol, 20, mesh, cfg=cfg,
        )
    else:
        mesh = make_mesh((args.devices,), ("y",))
        (hi, lo), r_rms, iters = dist_mg_ds.mg_solve_ds_sharded(
            b, h, 0.0, args.tol, 20, mesh, axis="y", cfg=cfg,
        )
    hi, lo = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
    wall = time.perf_counter() - t0

    # true residual of the returned iterate, f64 on the host (numpy keeps
    # peak memory bounded; jnp f64 would double-buffer through XLA)
    u = hi + lo
    del hi, lo
    res = np.zeros_like(u)
    res[1:-1, 1:-1] = (
        u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
        - 4.0 * u[1:-1, 1:-1]
    ) / h**2 - np.asarray(b, np.float64)[1:-1, 1:-1]
    rel = float(np.sqrt((res**2).mean()) / np.sqrt((np.asarray(b, np.float64) ** 2).mean()))

    # fine-level per-shard solver state (u_ds + f + E/r temporaries), the
    # number that must fit one card's memory
    state_gb = round(n * n * 4 * 5 / args.devices / 2**30, 2)
    peak_gb = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 1
    )

    from fpr_tpu.utils.io import append_csv_row

    row = dict(
        k=args.k, n=n, devices=args.devices,
        mesh=args.mesh or f"{args.devices}x1", iters=int(iters),
        claimed_rms=float(r_rms), true_rel_residual=rel,
        wall_s=round(wall, 1), shard_state_gb=state_gb,
        host_peak_gb=peak_gb, backend=jax.default_backend(),
    )
    print(row, flush=True)
    assert rel < 2 * args.tol, f"not converged: {rel}"
    append_csv_row(args.out, row)


if __name__ == "__main__":
    main()
