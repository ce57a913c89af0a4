"""3D pseudo-transient ("dual-time") diffusion to steady state.

A rebuild of the reference part 1
(diffusion_3D_kernel_programming / _array_programming,
part1_kernel_programming.jl:99-228): each physical backward-Euler step of

    dH/dt = D nabla^2 H,  H = 0 on all faces, Gaussian initial condition

is solved by pseudo-time iteration H_tau' = H_tau - dtau * R(H_tau) with
R = (H_tau - H_t)/dt - D nabla^2 H_tau, iterated until
||R * dt||_2 / sqrt(N_total) < tol.

Design vs the reference:
- the inner pseudo-time loop is an on-device ``lax.while_loop`` whose
  convergence norm is computed by the same fused step that does the
  update — the reference launches a kernel, then a separate device-wide
  reduction + host sync *every iteration* (part1_kernel_programming.jl:191);
- one host sync per *physical* step (to read the iteration count), which is
  also where the reference syncs for timing;
- the "array" vs "kernel(+shmem)" variants of the reference map to the
  ExecutionPolicy: JNP (stencil3d on the physical array) vs PALLAS (the
  fused step of fpr_tpu.ops.pallas3d on ghost-padded state, K iterations
  per call with check_every=K).  Both share this driver and agree in f64.

The distributed (multi-device) variant lives in
fpr_tpu.parallel.dist_diffusion and shards this exact step over a device
mesh with ppermute halo exchange.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from fpr_tpu.core import bc
from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu.ops import stencil3d
from fpr_tpu.utils.timing import BenchResults, diffusion_bench_results


@dataclasses.dataclass
class DiffusionResult:
    x: np.ndarray            # global cell-center x coordinates
    H: np.ndarray            # final field (nz, ny, nx)
    iters_total: int         # pseudo-time iterations, all physical steps
    timed_iters: int         # iterations inside the timed window
    bench: BenchResults
    converged: bool


def _step_fn(cfg: DiffusionConfig, grid: Grid3D, total_n: int):
    """Build the jitted one-physical-step function."""
    dtau = pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D)
    kw = dict(dt=cfg.dt, dtau=dtau, dx=grid.dx, dy=grid.dy, dz=grid.dz, D=cfg.D)
    pallas = cfg.policy == ExecutionPolicy.PALLAS
    ds_tier = cfg.policy == ExecutionPolicy.PALLAS_DS
    K = cfg.check_every if pallas else 1
    fused2 = pallas and K >= 2  # K iterations per step call
    shape = (cfg.nz, cfg.ny, cfg.nx)
    if ds_tier:
        from fpr_tpu.ops import ds3d

        def step(Ht_ds, Hp_ds):
            return ds3d.dual_time_step_ds_padded(Ht_ds, Hp_ds, shape, **kw)
    elif fused2:
        from fpr_tpu.ops import pallas3d

        # stacked-state variant: Htau (plane-set 0) and Ht (plane-set 1) in
        # one array, updated in place; Ht and the ghost planes persist
        def step(Ht_unused, state):
            return pallas3d.dual_time_stepk_stacked(state, shape, K=K, **kw)
    elif pallas:
        from fpr_tpu.ops import pallas3d

        def step(Ht_pad, Hp):
            return pallas3d.dual_time_step_padded(Ht_pad, Hp, shape, **kw)
    else:
        step = functools.partial(stencil3d.dual_time_step, **kw)

    sqrt_n = float(np.sqrt(total_n))
    iters_per_call = K if fused2 else 1

    def physical_step(Ht, Htau):
        # Htau is ghost-padded under the PALLAS policies (the fused step's
        # state layout), physical-shaped otherwise; under
        # PALLAS_DS both carries are stacked hi/lo pairs already in layout
        if pallas and not fused2:
            from fpr_tpu.ops import pallas3d

            Ht_in = pallas3d.pad_ht(Ht)
        else:
            Ht_in = Ht  # unused in the stacked (fused2) and ds tiers

        def cond(carry):
            _, err, it = carry
            return jnp.logical_and(err > cfg.tol, it < cfg.iter_max)

        def body(carry):
            Htau, _, it = carry
            Htau, sumsq = step(Ht_in, Htau)
            err = jnp.sqrt(sumsq) * cfg.dt / sqrt_n
            return Htau, err.astype(Htau.dtype), it + iters_per_call

        Htau, err, iters = jax.lax.while_loop(
            cond,
            body,
            (Htau, jnp.asarray(jnp.inf, jnp.float32 if ds_tier else Htau.dtype),
             jnp.asarray(0, jnp.int32)),
        )
        if ds_tier:
            Ht_new = Htau[:, 1 : 1 + cfg.nz]  # ds pair, Ht layout
        elif fused2:
            # commit Ht <- Htau inside the stacked state (one copy per
            # physical step); both carries are the committed state
            Htau = Htau.at[1].set(Htau[0])
            Ht_new = Htau
        elif pallas:
            from fpr_tpu.ops import pallas3d

            Ht_new = pallas3d.unpad3d(Htau, shape)
        else:
            Ht_new = Htau
        return Ht_new, Htau, err, iters  # Ht' = Htau (commit, ref :203)

    return jax.jit(physical_step), (pallas, fused2, ds_tier, K)


def solve(
    cfg: DiffusionConfig = DiffusionConfig(),
    dtype=jnp.float32,
    verbose: bool = False,
) -> DiffusionResult:
    """Single-device solve; mirrors the reference driver loop
    (part1_kernel_programming.jl:166-204) incl. the 3-step timing warmup."""
    grid = Grid3D(cfg.nx, cfg.ny, cfg.nz, cfg.lx, cfg.ly, cfg.lz)
    total_n = grid.n
    nt = outer_steps(cfg.ttot, cfg.dt)

    step, (pallas, fused2, ds_tier, K) = _step_fn(cfg, grid, total_n)
    if ds_tier and not jax.config.jax_enable_x64:
        raise ValueError(
            "ExecutionPolicy.PALLAS_DS needs x64 enabled for the entry/exit "
            "conversions (the iteration itself is all-f32)"
        )
    init_dtype = jnp.float64 if ds_tier else dtype
    Ht = stencil3d.init_gaussian(grid, dtype=init_dtype)
    Ht = bc.dirichlet_faces_3d(Ht)

    if ds_tier:
        from fpr_tpu.ops import ds3d

        Htau = ds3d.to_ds_padded(Ht)
        Ht = Htau[:, 1 : 1 + cfg.nz]  # Ht layout, ds pair
    elif fused2:
        from fpr_tpu.ops import pallas3d

        Htau = pallas3d.stack_state_k(Ht, Ht, K)
        Ht = Htau
    elif pallas:
        from fpr_tpu.ops import pallas3d

        Htau = pallas3d.pad3d(Ht)
    else:
        Htau = Ht

    iters_total = 0
    timed_iters = 0
    converged = True
    tic = time.time()
    for it_outer in range(nt):
        if it_outer == 3:  # manual warmup (ref :170-176)
            jax.block_until_ready(Ht)
            tic = time.time()
            timed_iters = 0
        Ht, Htau, err, iters = step(Ht, Htau)
        n_it = int(iters)  # host sync, once per physical step
        iters_total += n_it
        timed_iters += n_it
        # convergence is err <= tol, NOT the iteration count: with K
        # iterations per call the loop can exit past iter_max
        # having actually converged on its final fused call
        if not (float(err) <= cfg.tol):
            converged = False
        if verbose:
            print(f"step {it_outer}: {n_it} iters, err={float(err):.3e}")
    jax.block_until_ready(Ht)
    delta_t = time.time() - tic

    if ds_tier:
        H_out = np.asarray(
            Ht[0, :, : cfg.ny, : cfg.nx].astype(jnp.float64)
            + Ht[1, :, : cfg.ny, : cfg.nx].astype(jnp.float64)
        )
    elif fused2:
        from fpr_tpu.ops import pallas3d

        H_out = np.asarray(pallas3d.unstack_state_k(Ht, (cfg.nz, cfg.ny, cfg.nx), K))
    else:
        H_out = np.asarray(Ht)

    model = "plain" if cfg.policy == ExecutionPolicy.JNP else "fused"
    bench = diffusion_bench_results(
        delta_t, timed_iters, cfg.nx, cfg.ny, cfg.nz,
        word_bytes=8 if ds_tier else jnp.dtype(dtype).itemsize, model=model,
    )
    return DiffusionResult(
        x=grid.coords1d("x"),
        H=H_out,
        iters_total=iters_total,
        timed_iters=timed_iters,
        bench=bench,
        converged=converged,
    )


def probe_nearest(H: np.ndarray, grid: Grid3D, point=(4.5, 4.5, 4.5)) -> float:
    """Rounded-cell sample H[round(p/d)] — this is the `val` column of the
    reference's work-precision CSVs (probe index round(p/dx) + 1 in 1-based
    Julia, part1_error_vs_grid_size_experiments.jl:36), and the quantity
    behind the BASELINE anchors (e.g. 0.0799870 at 128^3, ttot=2, tol=1e-6).
    (The CSVs' `interp_val` column instead floors the index and mostly falls
    back to that cell's raw value — the reference's trilinear interpolator
    bails out on a singular system; ``probe_trilinear`` below is a correct
    interpolator instead.)"""
    px, py, pz = point
    ix = int(round(px / grid.dx))
    iy = int(round(py / grid.dy))
    iz = int(round(pz / grid.dz))
    return float(H[iz, iy, ix])


def probe_trilinear(H: np.ndarray, grid: Grid3D, point=(4.5, 4.5, 4.5)) -> float:
    """Trilinear interpolation of H at a physical point (the work-precision
    probe at LOCATION_OF_INTEREST, part1_utils.jl:42-71), on cell centers."""
    px, py, pz = point

    def locate(p, d, n):
        # cell centers at (i + 1/2) d; clamp to the valid interpolation range
        s = p / d - 0.5
        i0 = int(np.clip(np.floor(s), 0, n - 2))
        w = s - i0
        return i0, np.clip(w, 0.0, 1.0)

    ix, wx = locate(px, grid.dx, grid.nx)
    iy, wy = locate(py, grid.dy, grid.ny)
    iz, wz = locate(pz, grid.dz, grid.nz)

    c = H[iz : iz + 2, iy : iy + 2, ix : ix + 2]
    w = (
        np.asarray([1 - wz, wz]).reshape(2, 1, 1)
        * np.asarray([1 - wy, wy]).reshape(1, 2, 1)
        * np.asarray([1 - wx, wx]).reshape(1, 1, 2)
    )
    return float((c * w).sum())
