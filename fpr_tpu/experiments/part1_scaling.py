"""Strong/weak scaling of the distributed 3D diffusion solver — the analog
of part1_scaling_experiments.jl (strong: fixed 128^3 global grid split over
shards; weak: 128^3 per shard with physical-size scaling; SOLVER_TOL=1e-6).

Runs the production (fused, PALLAS) tier on the devices present; with
--virtual N it runs on N virtual CPU devices instead (validates the
sharding, not the performance).

    python -m fpr_tpu.experiments.part1_scaling --mode weak --devices 4
"""

from __future__ import annotations

import argparse
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["strong", "weak"], default="weak")
    ap.add_argument("--n", type=int, default=128, help="base edge length")
    ap.add_argument("--devices", type=int, default=0, help="0 = all available")
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (testing)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--ttot", type=float, default=1.0)
    ap.add_argument("--out", default="benchmark-results/diffusion_scaling.csv")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.parallel import dist_diffusion
    from fpr_tpu.parallel.mesh import make_mesh
    from fpr_tpu.utils.io import append_csv_row

    n_dev = args.devices or len(jax.devices())
    mesh = make_mesh((n_dev,), ("z",))
    backend = jax.default_backend()
    policy = ExecutionPolicy.PALLAS

    if args.mode == "strong":
        if args.n % n_dev:
            ap.error(f"strong mode: --n {args.n} must be divisible by the "
                     f"device count {n_dev} (the global grid would shrink)")
        nz_local = args.n // n_dev
        scale = False
    else:
        nz_local = args.n
        scale = True
    cfg = DiffusionConfig(
        nx=args.n, ny=args.n, nz=nz_local, ttot=args.ttot, tol=args.tol,
        scale_physical_size=scale, policy=policy,
    )
    out = dist_diffusion.solve_distributed(cfg, mesh, dtype=jnp.float32)
    row = dict(
        mode=args.mode, n=args.n, devices=n_dev, backend=backend,
        # virtual CPU devices share host cores: such rows validate the
        # sharding, they are NOT scaling measurements — mark them so
        virtual=bool(args.virtual),
        policy=policy.value, iters=out.timed_iters,
        seconds=round(out.bench.delta_t, 4),
        throughput_gbs=round(out.bench.throughput / 1e9, 2),
        performance_gflops=round(out.bench.performance / 1e9, 2),
    )
    append_csv_row(args.out, row, key_fields=("mode", "n", "devices", "backend"))
    print(row)


if __name__ == "__main__":
    main()
