"""Smoke test of the three workloads on the card, at the benchmark's sizes.

    python chip_smoke.py                # one GPU: every single-card phase
    python chip_smoke.py --four-cards   # four GPUs: the sharded phases only

Single card: (1) exactness of the error-free transformations the
double-single tier rests on; (2) 3D diffusion at 512^3 through
``diffusion3d.solve`` plus one K=3 stacked step against three f64
``stencil3d`` steps; (3) double-single multigrid at 4097^2 (DST-513 ladder,
V(5,5)) with its true f64 residual; (4) Navier-Stokes 2049x513, explicit
and semi-implicit, ``simulate_fast`` against the f64 host-loop
``simulate`` after the same steps.  Four cards: the sharded diffusion,
multigrid and Navier-Stokes tiers against one card on the same problem.

Every tolerance below states its reason.  A failed check raises, so the
exit code is non-zero and the closing JSON line is not printed.  The
script refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

F32_EPS = float(np.finfo(np.float32).eps)


def _say(msg: str) -> None:
    print(msg, flush=True)


def _check(name: str, value: float, limit: float, why: str) -> None:
    ok = value <= limit
    _say(f"  {name}: {value:.3e} <= {limit:.3e} ({why}) "
         f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {limit:.3e}")


def _memory(label: str, compiled) -> None:
    _say(f"  memory_analysis[{label}]: {compiled.memory_analysis()}")


def _rel_max(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != reference {ref.shape}")
    if not np.isfinite(got).all():
        raise AssertionError("non-finite values")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------


def phase_eft(n: int, seed: int) -> None:
    """two_sum / two_prod exact on n random f32 pairs, checked in f64.  The
    double-single defect pass is only as good as these: a compiler that
    contracted the Dekker product into fused multiply-adds, or
    reassociated the sums, would break exactness here first."""
    import jax
    import jax.numpy as jnp

    from fpr_tpu.ops import ds

    rng = np.random.default_rng(seed)

    def draw():
        # magnitudes 2^-10..2^11: f64 holds every sum and product exactly
        mant = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return (mant * 2.0 ** rng.integers(-10, 11, n)).astype(np.float32)

    a, b = draw(), draw()
    s, e = jax.jit(ds.two_sum)(jnp.asarray(a), jnp.asarray(b))
    p, q = jax.jit(ds.two_prod)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    bad_sum = int((np.asarray(s, np.float64) + np.asarray(e, np.float64)
                   != a64 + b64).sum())
    bad_prod = int((np.asarray(p, np.float64) + np.asarray(q, np.float64)
                    != a64 * b64).sum())
    _say(f"  two_sum inexact pairs: {bad_sum} of {n}; "
         f"two_prod inexact pairs: {bad_prod} of {n}")
    if bad_sum or bad_prod:
        raise AssertionError("error-free transformations are not exact")


def phase_diffusion(n: int, steps: int, iter_max: int, tol: float,
                    seed: int) -> None:
    """A few physical steps of the production config (PALLAS, K=3) through
    ``diffusion3d.solve``, then one K=3 stacked step against three f64
    stencil3d steps on the same f32 inputs."""
    import jax
    import jax.numpy as jnp

    from fpr_tpu.core import bc
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.core.grid import Grid3D, pseudo_timestep
    from fpr_tpu.models import diffusion3d
    from fpr_tpu.ops import pallas3d, stencil3d

    K = 3
    cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=steps * 0.2, tol=tol,
                          iter_max=iter_max, policy=ExecutionPolicy.PALLAS,
                          check_every=K)
    grid = Grid3D(n, n, n)
    step, _ = diffusion3d._step_fn(cfg, grid, grid.n)
    state = jax.ShapeDtypeStruct((2, n + 2 * K, *pallas3d._pad_yx(n, n)),
                                 jnp.float32)
    _memory("diffusion physical step", step.lower(state, state).compile())
    t0 = time.perf_counter()
    out = diffusion3d.solve(cfg, dtype=jnp.float32)
    wall = time.perf_counter() - t0
    if out.H.shape != (n, n, n) or not np.isfinite(out.H).all():
        raise AssertionError("diffusion field has the wrong shape or NaNs")
    if out.iters_total <= 0 or out.iters_total % K:
        raise AssertionError(f"iteration count {out.iters_total}")
    _say(f"  solve {n}^3 x {steps} steps: {out.iters_total} iterations, "
         f"converged={out.converged}, wall {wall:.2f} s incl. compile")

    dtau = pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D)
    kw = dict(dt=cfg.dt, dtau=dtau, dx=grid.dx, dy=grid.dy, dz=grid.dz,
              D=cfg.D)
    Ht = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, jnp.float32))
    noise = np.random.default_rng(seed).standard_normal((n, n, n))
    Htau = bc.dirichlet_faces_3d(Ht + jnp.asarray(1e-2 * noise, jnp.float32))
    got, ss = jax.jit(lambda s: pallas3d.dual_time_stepk_stacked(
        s, (n, n, n), K=K, **kw))(pallas3d.stack_state_k(Ht, Htau, K))
    got = pallas3d.unstack_state_k(got, (n, n, n), K)
    ref = Htau.astype(jnp.float64)
    ref_step = jax.jit(lambda a, b: stencil3d.dual_time_step(
        a, b, **kw))
    for _ in range(K):
        ref, ss_ref = ref_step(Ht.astype(jnp.float64), ref)
    # each f32 update rounds a few operations of size |H| and dtau*D/h^2
    # is ~1/6, so no rounding is amplified: 0.4-0.5 ulp measured on the
    # CPU at 32^3 and 64^3, bounded at 4 ulps per step
    _check("K=3 step vs 3 f64 steps, max|diff|/max|H|", _rel_max(got, ref),
           K * 4 * F32_EPS, "4 f32 ulps per step")
    # dHdtau is a difference of O(|H|/h^2) terms, so its f32 value carries
    # a relative error far above eps; 4e-6..1.4e-5 measured on the CPU,
    # bounded at 1e-3
    _check("K=3 sumsq vs f64", abs(float(ss) - float(ss_ref))
           / float(ss_ref), 1e-3, "f32 cancellation in dHdtau")


def phase_mg(k: int, tol: float, seed: int) -> None:
    """Double-single MG to tol on (2^k+1)^2 with the DST-513 ladder and
    V(5,5) (the benchmark's solver), then its true residual in f64."""
    import jax
    import jax.numpy as jnp

    from fpr_tpu.core.config import CoarseSolver, MGConfig
    from fpr_tpu.ops import stencil2d
    from fpr_tpu.solvers.multigrid import mg_solve_ds_jit

    n = 2**k + 1
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=min(513, n), coarse_solver=CoarseSolver.DST,
                   pre_smooth=5, post_smooth=5)
    rng = np.random.default_rng(seed)
    b_np = np.zeros((n, n), np.float32)
    b_np[1:-1, 1:-1] = rng.random((n - 2, n - 2), np.float32)
    b = jnp.asarray(b_np)
    _memory("mg_solve_ds_jit", mg_solve_ds_jit.lower(
        b, h, 0.0, tol, 30, cfg=cfg, return_pair=True).compile())
    (uh, ul), r_rms, it = mg_solve_ds_jit(b, h, 0.0, tol, 30, cfg=cfg,
                                          return_pair=True)
    with jax.default_matmul_precision("highest"):
        u64 = uh.astype(jnp.float64) + ul.astype(jnp.float64)
        b64 = b.astype(jnp.float64)
        true_rel = float(stencil2d.rms(stencil2d.residual(u64, b64, h, 0.0))
                         / stencil2d.rms(b64))
    claimed = float(r_rms) / float(stencil2d.rms(b64))
    _say(f"  {n}^2: {int(it)} outer iterations, claimed r/f {claimed:.3e}")
    if int(it) >= 30:
        raise AssertionError("MG did not converge within 30 outers")
    _check("true f64 relative residual", true_rel, tol,
           "the solver's own tolerance")


def _ns_inputs(cfg, seed):
    import jax
    import jax.numpy as jnp

    from fpr_tpu.core.config import InitScheme
    from fpr_tpu.models.navier_stokes import init_field

    T0 = init_field(cfg, InitScheme.COSINE, dtype=jnp.float32)
    W0 = init_field(cfg, InitScheme.RANDOM, key=jax.random.PRNGKey(seed),
                    dtype=jnp.float32)
    return np.asarray(T0), np.asarray(W0)


def _ns_fast_loop_memory(cfg, T0, W0) -> None:
    import jax.numpy as jnp

    from fpr_tpu.models import navier_stokes as nsm
    from fpr_tpu.ops import pallas2d

    fcfg = nsm.fast_mg_default(cfg)
    br = pallas2d.layout_br(cfg.ny)
    f32 = jnp.float32
    TW = jnp.stack([pallas2d.pad2d(jnp.asarray(T0), br),
                    pallas2d.pad2d(jnp.asarray(W0), br)])
    S_ds = jnp.zeros_like(TW)
    zero = jnp.asarray(0.0, f32)
    i0 = jnp.asarray(0, jnp.int32)
    _memory(f"NS fast loop beta={cfg.beta}", nsm._fast_loop.lower(
        TW, S_ds, zero, zero, zero, i0, i0, cfg=fcfg, br=br).compile())


def phase_ns(nx: int, ny: int, beta: float, steps: int, Pr: float,
             tol: float, seed: int) -> None:
    """``simulate_fast`` (f32 state, double-single solves) against the f64
    host-loop ``simulate`` after the same number of steps, from the same
    f32 initial fields."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models.navier_stokes import (
        fast_mg_default, simulate, simulate_fast,
    )

    cfg = NSConfig(nx=nx, ny=ny, ttot=1.0, beta=beta, Pr=Pr, tol=tol,
                   niters=50)
    T0, W0 = _ns_inputs(cfg, seed)
    _ns_fast_loop_memory(cfg, T0, W0)
    fast = simulate_fast(cfg, W0=W0, T0=T0, max_steps=steps)
    if beta > 0:
        # the plain f64 mg_solve stalls on the T solve's Neumann side
        # columns (the reference-parity cold-BC stagnation, 5e-3 field
        # error at 2049x513); the f64 defect correction with the
        # production ladder stalls far lower, so it is the reference here
        ref_cfg = dataclasses.replace(fast_mg_default(cfg), mg_solver="mixed")
        # its T solve still stops near 4e-5 relative residual (it warns),
        # and Ra dT/dx carries that into W: 4.7e-5 (T) and 1.5e-5 (W)
        # measured at this size on the CPU, bounded at 1e-3
        field_bound, why = 1e-3, "f64 reference T solve stalls near 4e-5"
    else:
        ref_cfg = cfg
        # both sides solve every system to tol*rms; the f32 state adds ~1
        # ulp per step and the adaptive dt follows the velocity maxima:
        # 8e-7 (T) and 7e-6 (W) measured after 20 steps, bounded at
        # steps x (tol + f32 eps) x 10
        field_bound = 10 * steps * (tol + F32_EPS)
        why = "steps x (solver tol + f32 eps) x 10"
    with jax.default_matmul_precision("highest"):
        ref = simulate(ref_cfg, W0=W0.astype(np.float64),
                       T0=T0.astype(np.float64), max_steps=steps,
                       dtype=jnp.float64)
    if fast.steps != steps or ref.steps != steps:
        raise AssertionError(f"steps {fast.steps} / {ref.steps} != {steps}")
    _say(f"  {nx}x{ny} beta={beta}: {steps} steps, sim_time "
         f"{fast.sim_time:.6e} (f64 host loop {ref.sim_time:.6e})")
    # dt follows the velocity maxima of converged S solves: 4e-8..1.2e-7
    # relative measured
    _check("sim_time rel diff", abs(fast.sim_time - ref.sim_time)
           / ref.sim_time, 10 * steps * (tol + F32_EPS),
           "steps x (solver tol + f32 eps) x 10")
    _check("T max rel diff", _rel_max(fast.T, ref.T), field_bound, why)
    _check("W max rel diff", _rel_max(fast.W, ref.W), field_bound, why)


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _spans(x, ndev: int, what: str) -> None:
    got = len(x.sharding.device_set)
    _say(f"  {what} spans {got} devices")
    if got != ndev:
        raise AssertionError(f"{what} spans {got} devices, not {ndev}")


def _allocs(devices):
    return [(d.memory_stats() or {}).get("num_allocs") for d in devices]


def _all_devices_worked(devices, before, what: str) -> None:
    """Print each device's memory_stats and require that every device
    allocated during the phase (a sharded program that quietly ran on one
    device would leave the others idle)."""
    after = _allocs(devices)
    for d in devices:
        st = d.memory_stats() or {}
        _say(f"  {d}: peak_bytes_in_use={st.get('peak_bytes_in_use')} "
             f"bytes_in_use={st.get('bytes_in_use')} "
             f"num_allocs={st.get('num_allocs')}")
    if None in before or None in after:
        _say(f"  {what}: memory_stats unavailable on this backend")
        return
    idle = [str(d) for d, b, a in zip(devices, before, after) if a <= b]
    if idle:
        raise AssertionError(f"{what}: devices {idle} did no work")
    _say(f"  {what} spans {len(devices)} devices")


def phase_dist_diffusion(n: int, ndev: int, iter_max: int, tol: float) -> None:
    """The reference's weak-scaling run: n^3 per card over a z mesh of ndev
    cards (domain scaled with the mesh), against one card solving the same
    (ndev*n) x n x n global grid."""
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.models import diffusion3d
    from fpr_tpu.parallel import dist_diffusion
    from fpr_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((ndev,), ("z",))
    devices = list(mesh.devices.flat)
    base = dict(ttot=0.2, tol=tol, iter_max=iter_max,
                policy=ExecutionPolicy.PALLAS, check_every=3)
    before = _allocs(devices)
    dist = dist_diffusion.solve_distributed(
        DiffusionConfig(nx=n, ny=n, nz=n, scale_physical_size=True, **base),
        mesh)
    _all_devices_worked(devices, before, "sharded diffusion")
    one = diffusion3d.solve(
        DiffusionConfig(nx=n, ny=n, nz=ndev * n, lz=10.0 * ndev, **base))
    _say(f"  {ndev}x{n}^3: {dist.iters_total} iterations sharded, "
         f"{one.iters_total} on one card")
    if dist.iters_total != one.iters_total:
        raise AssertionError("sharded and single-card iteration counts differ")
    # same arithmetic per cell; only the psum'd norm's summation order
    # differs, so the fields agree to f32 rounding of the update
    _check("sharded vs single-card field", _rel_max(dist.H, one.H),
           64 * F32_EPS, "per-cell arithmetic identical; 64 ulps")


def phase_dist_mg(k: int, ndev: int, tol: float, seed: int,
                  coarse: int = 513, replicate_below: int = 1025) -> None:
    """mg_solve_ds_sharded over a row mesh against mg_solve_ds on one card:
    same outer count, true residual within tol."""
    import jax.numpy as jnp

    from fpr_tpu.core.config import CoarseSolver, MGConfig
    from fpr_tpu.ops import stencil2d
    from fpr_tpu.ops.pallas2d import PAD
    from fpr_tpu.parallel.mesh import make_mesh
    from fpr_tpu.solvers import dist_mg_ds
    from fpr_tpu.solvers.multigrid import mg_solve_ds_jit

    n = 2**k + 1
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=coarse, coarse_solver=CoarseSolver.DST,
                   pre_smooth=5, post_smooth=5)
    rng = np.random.default_rng(seed)
    b_np = np.zeros((n, n), np.float32)
    b_np[1:-1, 1:-1] = rng.random((n - 2, n - 2), np.float32)
    b = jnp.asarray(b_np)
    mesh = make_mesh((ndev,), ("y",))
    devices = list(mesh.devices.flat)
    before = _allocs(devices)
    u_st, r_d, it_d = dist_mg_ds.mg_solve_ds_sharded(
        b, h, 0.0, tol, 30, mesh, cfg=cfg, replicate_below=replicate_below,
        gather_result=False)
    _spans(u_st, ndev, "sharded ds iterate")
    _all_devices_worked(devices, before, "sharded multigrid")
    ny_l = dist_mg_ds.plan_shards(n, n, ndev, cfg, replicate_below).ny_l
    blocks = jnp.swapaxes(u_st[:, :, PAD : PAD + ny_l, :n], 0, 1)
    hi, lo = blocks.reshape(2, ndev * ny_l, n)[:, :n]
    _, r_1, it_1 = mg_solve_ds_jit(b, h, 0.0, tol, 30, cfg=cfg,
                                   return_pair=True)
    _say(f"  {n}^2: {int(it_d)} outers sharded, {int(it_1)} on one card")
    if int(it_d) != int(it_1):
        raise AssertionError("sharded and single-card outer counts differ")
    u64 = hi.astype(jnp.float64) + lo.astype(jnp.float64)
    b64 = b.astype(jnp.float64)
    true_rel = float(stencil2d.rms(stencil2d.residual(u64, b64, h, 0.0))
                     / stencil2d.rms(b64))
    _check("sharded true f64 relative residual", true_rel, tol,
           "the solver's own tolerance")


def phase_dist_ns(nx: int, ny: int, ndev: int, steps: int, Pr: float,
                  tol: float, seed: int, replicate_below: int = 257) -> None:
    """simulate_fast_sharded (explicit) against simulate_fast on one card
    after the same steps."""
    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models import dist_ns
    from fpr_tpu.models.navier_stokes import simulate_fast
    from fpr_tpu.parallel.mesh import make_mesh

    cfg = NSConfig(nx=nx, ny=ny, ttot=1.0, beta=0.0, Pr=Pr, tol=tol,
                   niters=50)
    T0, W0 = _ns_inputs(cfg, seed)
    mesh = make_mesh((ndev,), ("y",))
    devices = list(mesh.devices.flat)
    before = _allocs(devices)
    dist = dist_ns.simulate_fast_sharded(cfg, mesh, W0=W0, T0=T0,
                                         max_steps=steps,
                                         replicate_below=replicate_below)
    _all_devices_worked(devices, before, "sharded NS")
    one = simulate_fast(cfg, W0=W0, T0=T0, max_steps=steps)
    _say(f"  {nx}x{ny}: {dist.steps} steps sharded, {one.steps} on one "
         f"card, sim_time {dist.sim_time:.6e} vs {one.sim_time:.6e}")
    if dist.steps != one.steps:
        raise AssertionError("step counts differ")
    # per-cell arithmetic identical; the psum/pmax'd reductions round
    # differently, so dt drifts by ulps per step
    bound = 10 * steps * (tol + F32_EPS)
    _check("sim_time rel diff", abs(dist.sim_time - one.sim_time)
           / one.sim_time, bound, "reduction order only, x10")
    _check("T max rel diff", _rel_max(dist.T, one.T), bound,
           "reduction order only, x10")
    _check("W max rel diff", _rel_max(dist.W, one.W), bound,
           "reduction order only, x10")


# ---------------------------------------------------------------------------


def _run(name, fn, *args) -> None:
    _say(f"phase {name}")
    t0 = time.perf_counter()
    fn(*args)
    _say(f"phase {name} passed in {time.perf_counter() - t0:.1f} s "
         "(wall, compile included)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded phases on four GPUs instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from fpr_tpu.utils.runtime import card_line, enable_compile_cache, require_gpu

    enable_compile_cache()
    devices = require_gpu()
    jax.config.update("jax_enable_x64", True)
    _say(f"card: {card_line()}")
    _say(f"device_kind: {devices[0].device_kind}, devices: {len(devices)}")
    seed = args.seed

    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
        _run("sharded diffusion 4x512^3", phase_dist_diffusion, 512, 4,
             3000, 1e-6)
        _run("sharded multigrid 8193^2", phase_dist_mg, 13, 4, 1e-6, seed)
        _run("sharded NS explicit 2049x513", phase_dist_ns, 2049, 513, 4, 50,
             0.01, 1e-7, seed)
    else:
        _run("EFT exactness", phase_eft, 1_000_000, seed)
        _run("diffusion 512^3", phase_diffusion, 512, 3, 600, 1e-6, seed)
        _run("multigrid 4097^2", phase_mg, 12, 1e-6, seed)
        _run("NS explicit 2049x513", phase_ns, 2049, 513, 0.0, 20, 0.01,
             1e-7, seed)
        _run("NS semi-implicit 2049x513", phase_ns, 2049, 513, 0.5, 5, 0.01,
             1e-7, seed)

    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
