"""Command-line interface.

The structured replacement for the reference's positional-ARGS entry points
(part1.jl:25-60: ``julia --project part1.jl [cpu/gpu] [array/kernel]
[nx ny nz] [bench]``; part2.jl __main__ demo :264-272):

    python -m fpr_tpu diffusion3d --n 128 --policy pallas --ttot 2 --bench
    python -m fpr_tpu ns --nx 1025 --ny 257 --beta 0.5 --Pr 0.1 --tol 1e-7
    python -m fpr_tpu mg --k 12 --l 2 --coarse jacobi --solver mixed
    python -m fpr_tpu bench

``--platform cpu|gpu`` picks the backend (the reference's cpu/gpu switch);
without it JAX uses its default backend, the GPU where one is present.
"""

from __future__ import annotations

import argparse
import json
import sys


# --platform value -> JAX platforms; the CPU stays available beside the GPU
# for host callbacks (jax.debug.print in the non-convergence warnings)
PLATFORMS = {"cpu": "cpu", "gpu": "cuda,cpu"}


def _force_platform(platform: str | None):
    import jax

    if platform:
        jax.config.update("jax_platforms", PLATFORMS[platform])


def _add_common(p):
    p.add_argument("--platform", choices=sorted(PLATFORMS), default=None)
    p.add_argument("--f64", action="store_true", help="use float64")


def cmd_diffusion3d(args):
    _force_platform(args.platform)
    import jax

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.core.grid import Grid3D
    from fpr_tpu.models import diffusion3d
    from fpr_tpu.parallel import dist_diffusion
    from fpr_tpu.parallel.mesh import make_mesh

    policy = ExecutionPolicy(args.policy)
    if policy is ExecutionPolicy.PALLAS_DS:
        jax.config.update("jax_enable_x64", True)
    cfg = DiffusionConfig(
        nx=args.n, ny=args.n, nz=args.n, ttot=args.ttot, tol=args.tol,
        policy=policy, check_every=args.check_every,
        scale_physical_size=args.scale_physical_size,
    )
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.devices > 1:
        if policy is ExecutionPolicy.PALLAS_DS:
            raise SystemExit(
                "--devices > 1 supports --policy jnp/pallas (the ds tier "
                "is a single-device path)"
            )
        if args.check_every > 1 and policy is not ExecutionPolicy.PALLAS:
            raise SystemExit("--check-every > 1 over a mesh needs --policy pallas")
        mesh = make_mesh((args.devices,), ("z",))
        out = dist_diffusion.solve_distributed(cfg, mesh, dtype=dtype, verbose=args.verbose)
    else:
        out = diffusion3d.solve(cfg, dtype=dtype, verbose=args.verbose)
    g = Grid3D(args.n, args.n, args.n)
    print(f"iterations: {out.iters_total} (converged: {out.converged})")
    if hasattr(out, "H") and out.H.shape[0] == args.n:
        print(f"probe H(4.5,4.5,4.5): {diffusion3d.probe_nearest(out.H, g):.7f}")
    if args.bench:
        print(json.dumps(out.bench.row()))


def cmd_ns(args):
    _force_platform(args.platform)
    import jax

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fpr_tpu.core.config import ExecutionPolicy, MGConfig, NSConfig
    from fpr_tpu.models import navier_stokes as ns

    # --fast ignores --policy (the fast tier's solver is mg_solve_ds_rp on
    # the fused legs): leave cfg.mg at the default so fast_mg_default can
    # upgrade it to the production DST-257/V(3,3) ladder.  Setting
    # MGConfig(policy=...) here would make it look explicitly provided.
    mg = MGConfig() if args.fast else MGConfig(policy=ExecutionPolicy(args.policy))
    cfg = NSConfig(
        nx=args.nx, ny=args.ny, Ra=args.Ra, Pr=args.Pr, beta=args.beta,
        ttot=args.ttot, tol=args.tol, niters=args.niters,
        mg=mg, mg_auto=not args.no_mg_auto,
    )
    dtype = jnp.float64 if args.f64 else jnp.float32
    state0 = None
    if args.resume:
        from fpr_tpu.utils import checkpoint

        state0 = checkpoint.load(args.resume)
    if args.fast:
        # simulate_fast is f32-only (mirrors ns_timestepping's guard)
        if args.f64:
            raise SystemExit("--fast is f32-only; drop --f64 or drop --fast")
        if args.devices > 1:
            # row-sharded production tier (models/dist_ns; all beta
            # tiers, same checkpoint schema as single-device --fast)
            from fpr_tpu.models import dist_ns
            from fpr_tpu.parallel.mesh import make_mesh

            mesh = make_mesh((args.devices,), ("y",))
            out = dist_ns.simulate_fast_sharded(
                cfg, mesh, verbose=args.verbose, max_steps=args.max_steps,
                snapshot_steps=args.snapshot_every, state0=state0,
            )
        else:
            out = ns.simulate_fast(
                cfg, verbose=args.verbose, max_steps=args.max_steps,
                snapshot_steps=args.snapshot_every, state0=state0,
            )
    else:
        if state0 is not None and "t_hi" in state0:
            raise SystemExit(
                "this checkpoint holds fast-path state; resume with --fast"
            )
        out = ns.simulate(
            cfg, verbose=args.verbose, max_steps=args.max_steps, dtype=dtype,
            snapshot_every=args.snapshot_every,
            T0=state0.get("T") if state0 else None,
            W0=state0.get("W") if state0 else None,
        )
    print(
        f"steps: {out.steps}  sim_time: {out.sim_time:.6f}  "
        f"timed: {out.t_elapsed:.3f}s  T in [{out.T.min():.3f}, {out.T.max():.3f}]"
    )
    if args.save:
        from fpr_tpu.utils import checkpoint

        if args.fast:
            # the exact-resume payload (bitwise continuation via --resume)
            checkpoint.save(args.save, **out.state)
        else:
            checkpoint.save(args.save, T=out.T, W=out.W, S=out.S, t=out.sim_time)
        print(f"saved fields to {args.save}")


def cmd_mg(args):
    _force_platform(args.platform)
    import jax

    jax.config.update("jax_enable_x64", True)
    import time

    import jax.numpy as jnp

    from fpr_tpu.core.config import CoarseSolver, ExecutionPolicy, MGConfig
    from fpr_tpu.solvers import multigrid

    if args.devices > 1 and args.solver != "ds":
        raise SystemExit("--devices>1 requires --solver ds (the sharded "
                         "production tier)")
    if args.smooths < 1:
        raise SystemExit("--smooths must be >= 1 (the convergence check "
                         "reads the final post-smooth's residual norm)")
    if args.solver == "ds" and args.smooths > 6:
        raise SystemExit("--solver ds supports --smooths 1..6 (the fused "
                         "legs recompute at most PAD-2 = 6 sweeps "
                         "inside one 8-row halo; deeper smoothing would "
                         "silently fall off the fused path"
                         + (", and the sharded tier's one-exchange-per-leg "
                            "design has the same bound)" if args.devices > 1
                            else ")"))
    n = 2**args.k + 1
    h = 1.0 / (n - 1)
    cfg = MGConfig(
        coarse_size=2**args.l + 1,
        coarse_solver=CoarseSolver(args.coarse),
        policy=ExecutionPolicy.JNP,
        pre_smooth=args.smooths,
        post_smooth=args.smooths,
    )
    key = jax.random.PRNGKey(0)
    dtype = jnp.float64 if (args.f64 or args.solver == "mixed") else jnp.float32
    b = (
        jnp.zeros((n, n), dtype)
        .at[1:-1, 1:-1]
        .set(jax.random.uniform(key, (n - 2, n - 2), dtype))
    )
    u0 = jnp.zeros((n, n), dtype)

    if args.solver == "mixed":
        solve = lambda: multigrid.mg_solve_mixed_jit(u0, b, h, 0.0, args.tol, 30, cfg=cfg)
    elif args.solver == "ds":
        b = b.astype(jnp.float32)
        if args.devices > 1:
            from fpr_tpu.parallel.mesh import make_mesh
            from fpr_tpu.solvers import dist_mg_ds

            if args.mesh:
                ndy, ndx = (int(v) for v in args.mesh.lower().split("x"))
                if ndy * ndx != args.devices:
                    raise SystemExit(
                        f"--mesh {args.mesh} needs {ndy * ndx} devices, "
                        f"--devices says {args.devices}")
                mesh2 = make_mesh((ndy, ndx), ("y", "x"))
                _orig = lambda: dist_mg_ds.mg_solve_ds_sharded_2d(
                    b, h, 0.0, args.tol, 30, mesh2, cfg=cfg
                )
            else:
                mesh = make_mesh((args.devices,), ("y",))
                _orig = lambda: dist_mg_ds.mg_solve_ds_sharded(
                    b, h, 0.0, args.tol, 30, mesh, cfg=cfg
                )
        else:
            _orig = lambda: multigrid.mg_solve_ds_jit(
                b, h, 0.0, args.tol, 30, cfg=cfg, return_pair=True
            )
        solve = lambda: (lambda pair, r, it: (pair[0], r, it))(*_orig())
    else:
        solve = lambda: multigrid.mg_solve_jit(u0, b, h, 0.0, args.tol, 30, cfg=cfg)
    u, r, it = solve()
    float(r)  # compile + converge
    t0 = time.time()
    u, r, it = solve()
    float(r)
    dt = time.time() - t0
    f_rms = float(jnp.sqrt(jnp.mean(b * b)))
    print(
        f"{n}^2 -> coarse {cfg.coarse_size}^2 [{args.solver}]: {dt*1e3:.1f} ms, "
        f"{int(it)} iterations, r_rms/f_rms = {float(r)/f_rms:.2e}"
    )


def cmd_bench(args):
    import subprocess

    cmd = [sys.executable, "bench.py"] + (["--quick"] if args.quick else [])
    raise SystemExit(subprocess.call(cmd))


def main(argv=None):
    from fpr_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="fpr_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diffusion3d", help="3D pseudo-transient diffusion (part 1)")
    _add_common(p)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--ttot", type=float, default=1.0)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument(
        "--policy", choices=["jnp", "pallas", "pallas_ds"], default="pallas",
        help="pallas_ds: double-single (~48-bit) tier for tolerances below "
        "the f32 floor",
    )
    p.add_argument(
        "--check-every", type=int, default=1,
        help="pallas only: K pseudo-time iterations per step call "
        "(convergence checked every K); K=3 is the 512^3 headline config",
    )
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--scale-physical-size", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_diffusion3d)

    p = sub.add_parser("ns", help="2D Navier-Stokes thermal convection (part 2)")
    _add_common(p)
    p.add_argument("--nx", type=int, default=257)
    p.add_argument("--ny", type=int, default=65)
    p.add_argument("--Ra", type=float, default=1e6)
    p.add_argument("--Pr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--ttot", type=float, default=0.1)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--niters", type=int, default=50)
    p.add_argument("--policy", choices=["jnp", "pallas"], default="jnp")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument(
        "--fast", action="store_true",
        help="fused on-device-loop path (simulate_fast): f32 state, "
        "double-single multigrid — the production configuration",
    )
    p.add_argument(
        "--no-mg-auto", action="store_true",
        help="with --fast: do NOT upgrade the default MG ladder to the "
        "measured production config (DST-257, V(3,3)); run the true "
        "default ladder instead",
    )
    p.add_argument(
        "--devices", type=int, default=1,
        help="with --fast: row-shard the simulation over a 1D device mesh "
        "(models/dist_ns; explicit and semi-implicit tiers)",
    )
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from (--fast checkpoints resume "
                        "bitwise; host-loop ones restore T/W)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_ns)

    p = sub.add_parser("mg", help="2D Poisson/Helmholtz multigrid solve")
    _add_common(p)
    p.add_argument("--k", type=int, default=10, help="grid is (2^k+1)^2")
    p.add_argument("--l", type=int, default=2, help="coarse grid is (2^l+1)^2")
    p.add_argument(
        "--coarse", choices=["jacobi", "cg", "dst"], default="jacobi",
        help="coarse-grid solver; 'dst' = exact sine-transform solve "
        "(pair with --l 9 for the DST-513 truncated ladder, the benchmark "
        "headline configuration)",
    )
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument(
        "--solver", choices=["direct", "mixed", "ds"], default="direct",
        help="direct: single-precision-path mg_solve; mixed: f64 defect "
        "correction around f32 fused V-cycles; ds: all-f32 double-single "
        "defect correction (the benchmark headline path)",
    )
    p.add_argument(
        "--devices", type=int, default=1,
        help="with --solver ds: row-shard the solve over a 1D device mesh "
        "(solvers/dist_mg_ds — grids beyond one card's memory)",
    )
    p.add_argument(
        "--mesh", type=str, default=None, metavar="YxX",
        help="with --devices N: decompose over a 2D (y, x) device mesh "
        "instead of rows-only, e.g. --devices 8 --mesh 4x2 (128-column "
        "ghost slabs; avoids the thin-slab limit at high device counts)",
    )
    p.add_argument(
        "--smooths", type=int, default=2,
        help="pre/post smooth sweeps per V-cycle leg (deeper smoothing "
        "cuts outer iterations; 5 is the benchmark's ds-tier choice, 2 the "
        "reference parity)",
    )
    p.set_defaults(fn=cmd_mg)

    p = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    p.add_argument("--quick", action="store_true")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
