"""Multi-device 3D pseudo-transient diffusion: shard_map over a device mesh.

The rebuild of the reference's multi-XPU path
(diffusion_3D_kernel_programming, part1_kernel_programming.jl:99-228):

- Cartesian decomposition of the global grid over a 1D/2D/3D device mesh
  (axis names 'z'/'y'/'x' map to array dims 0/1/2), mirroring the
  reference's 3D MPI rank grid (init_global_grid);
- ``update_halo!`` -> ``lax.ppermute`` of face planes per sharded dim over
  the interconnect (parallel.halo); ``MPI.Allreduce`` -> ``lax.psum``;
- per-rank local grids of (cfg.nz, cfg.ny, cfg.nx), with optional
  physical-size scaling for weak-scaling runs (part1_kernel_programming.jl:106-114);
- the whole inner pseudo-time loop (stencil + halo exchange + global norm)
  runs on-device inside shard_map; the host syncs once per physical step.

Operator tiers: both ExecutionPolicy.PALLAS (fused step on the
ghost-padded layout — decomposed y/x dims get ghost blocks, mirroring the
reference's 3D Cartesian rank grid, part1_kernel_programming.jl:100-101)
and ExecutionPolicy.JNP (fully ghost-padded ext3 step) support 1D/2D/3D
meshes.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu.ops import reductions, stencil3d
from fpr_tpu.parallel import halo
from fpr_tpu.utils.timing import BenchResults, diffusion_bench_results

AXIS_DIM = {"z": 0, "y": 1, "x": 2}


@dataclasses.dataclass
class DistDiffusionResult:
    H: np.ndarray            # gathered global field (nz_g, ny_g, nx_g)
    iters_total: int
    timed_iters: int
    bench: BenchResults
    converged: bool
    n_devices: int


def _mesh_extent(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1

def _global_grid(cfg: DiffusionConfig, mesh: Mesh) -> Grid3D:
    ez, ey, ex = (_mesh_extent(mesh, a) for a in ("z", "y", "x"))
    s = cfg.scale_physical_size
    return Grid3D(
        cfg.nx * ex, cfg.ny * ey, cfg.nz * ez,
        cfg.lx * (ex if s else 1), cfg.ly * (ey if s else 1), cfg.lz * (ez if s else 1),
    )


def _partition_spec(mesh: Mesh) -> P:
    return P(*(a if a in mesh.axis_names else None for a in ("z", "y", "x")))


def build_step(cfg: DiffusionConfig, mesh: Mesh, axis: str = "z"):
    """Build the jitted distributed physical step over `mesh`.

    Takes/returns globally-sharded (nz_g, ny_g, nx_g) arrays; internally each
    shard ghost-pads once, then iterates (halo exchange -> stencil -> psum
    norm) in an on-device while_loop.
    """
    del axis  # decomposition is read off the mesh axis names
    grid = _global_grid(cfg, mesh)
    dtau = pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D)
    sqrt_n = float(np.sqrt(grid.n))
    kw = dict(dt=cfg.dt, dtau=dtau, dx=grid.dx, dy=grid.dy, dz=grid.dz, D=cfg.D)
    use_pallas = cfg.policy == ExecutionPolicy.PALLAS
    all_axes = tuple(mesh.axis_names)
    local_shape = (cfg.nz, cfg.ny, cfg.nx)
    sharded = {AXIS_DIM[a]: a for a in mesh.axis_names}
    # padded layout: ghost blocks only on decomposed y/x dims (8 rows /
    # 128 columns per side); z always ghost-padded
    ghosts = (8 if 1 in sharded else 0, 128 if 2 in sharded else 0)

    # K iterations per call over the mesh (check_every=K): one K-plane halo
    # message per direction feeds K iterations that recompute the halo
    # locally (the communication-avoiding exchange; z-decomposed meshes
    # only)
    Kf = cfg.check_every
    use_kfused = use_pallas and Kf > 1 and set(sharded) <= {0}
    if use_pallas and Kf > 1 and not use_kfused:
        raise ValueError(
            "check_every > 1 over a mesh needs a z-only decomposition"
        )
    if use_kfused and cfg.nz < Kf:
        raise ValueError(f"local nz={cfg.nz} must be >= check_every={Kf}")

    overlap = cfg.overlap_comm and not use_pallas and set(sharded) <= {0}
    # fused-tier overlap (@hide_communication analog,
    # part1_kernel_programming.jl:185-188): the fused step updates the shard's
    # z-interior while the face ppermute is in flight; the two z-edge
    # planes are then recomputed in XLA from the fresh ghosts.  The edge
    # planes are ~2/nz of the work, so the interior pass hides the collective.
    pallas_overlap = (
        cfg.overlap_comm and use_pallas and set(sharded) <= {0} and cfg.nz >= 2
    )

    def shard_body(Ht_l, Htau_l):
        bounds = [
            halo.mask_bounds(
                {0: "z", 1: "y", 2: "x"}[d] if d in sharded else None,
                local_shape[d],
            )
            for d in range(3)
        ]
        (zlo, zhi), (ylo, yhi), (xlo, xhi) = bounds

        if overlap:
            # @hide_communication analog: the per-iteration state stays
            # unpadded; each iteration starts the ppermute and computes the
            # shard interior while the faces travel
            def cond_o(carry):
                _, err, it = carry
                return jnp.logical_and(err > cfg.tol, it < cfg.iter_max)

            def body_o(carry):
                Hl, _, it = carry
                if 0 in sharded:
                    ghost_lo, ghost_hi = halo.exchange_faces(Hl, sharded[0], 0)
                else:
                    ghost_lo = jnp.zeros_like(Hl[:1])
                    ghost_hi = jnp.zeros_like(Hl[:1])
                Hl, sumsq = stencil3d.dual_time_step_overlap_z(
                    Ht_l, Hl, ghost_lo, ghost_hi, zlo=zlo, zhi=zhi, **kw
                )
                sumsq = reductions.dist_sumsq(sumsq, all_axes)
                err = jnp.sqrt(sumsq) * cfg.dt / sqrt_n
                return Hl, err.astype(Hl.dtype), it + 1

            Hl, err, iters = jax.lax.while_loop(
                cond_o,
                body_o,
                (Htau_l, jnp.asarray(jnp.inf, Htau_l.dtype), jnp.asarray(0, jnp.int32)),
            )
            return Hl, Hl, err, iters

        if use_kfused:
            from fpr_tpu.ops import pallas3d

            nzl = cfg.nz
            Hp = pallas3d.pad3dk(Htau_l, Kf)
            Ht_in = pallas3d.pad_htk(Ht_l, Kf)
            if 0 in sharded:
                # Ht is constant through pseudo-time: its (K-1)-deep ghost
                # planes are exchanged once per physical step
                Ht_in = halo.refresh_ghosts_zk(
                    Ht_in, nzl, sharded[0], Kf - 1, base=Kf - 1
                )
                idx = jax.lax.axis_index(sharded[0])
                nsh = jax.lax.axis_size(sharded[0])
                # interior shard edges extend into the ghost planes: the
                # fused sweeps recompute them locally (the values the
                # neighbor computes for those planes, bitwise)
                zb = (
                    jnp.where(idx == 0, 1, -Kf),
                    jnp.where(idx == nsh - 1, nzl - 2, nzl - 1 + Kf),
                )
            else:
                zb = (jnp.asarray(1), jnp.asarray(nzl - 2))

            def cond_k(carry):
                _, err, it = carry
                return jnp.logical_and(err > cfg.tol, it < cfg.iter_max)

            def body_k(carry):
                Hp, _, it = carry
                if 0 in sharded:
                    Hp = halo.refresh_ghosts_zk(Hp, nzl, sharded[0], Kf)
                Hp, sumsq = pallas3d.dual_time_stepk_padded(
                    Ht_in, Hp, local_shape, K=Kf, z_bounds=zb, **kw
                )
                sumsq = reductions.dist_sumsq(sumsq, all_axes)
                err = jnp.sqrt(sumsq) * cfg.dt / sqrt_n
                return Hp, err.astype(Hp.dtype), it + Kf

            Hp, err, iters = jax.lax.while_loop(
                cond_k,
                body_k,
                (Hp, jnp.asarray(jnp.inf, Hp.dtype), jnp.asarray(0, jnp.int32)),
            )
            Ht_new = pallas3d.unpad3dk(Hp, local_shape, Kf)
            return Ht_new, Ht_new, err, iters

        if use_pallas:
            from fpr_tpu.ops import pallas3d

            Hp = pallas3d.pad3d(Htau_l, ghosts)
            Ht_in = pallas3d.pad_ht(Ht_l, ghosts)
        else:
            Hp = jnp.pad(Htau_l, 1)
            Ht_in = Ht_l

        if pallas_overlap:
            from fpr_tpu.ops import pallas3d

            nzl = cfg.nz
            # constants in the fused step's exact arithmetic form (multiplies by
            # trace-time reciprocals) so the edge planes match it ulp-for-ulp
            _dx2, _dy2 = 1.0 / (kw["dx"] ** 2), 1.0 / (kw["dy"] ** 2)
            _dz2, _dt = 1.0 / (kw["dz"] ** 2), 1.0 / kw["dt"]

            def edge_dH(center, zm, zp, ht):
                ym = jnp.concatenate([center[:1, :], center[:-1, :]], axis=0)
                yp = jnp.concatenate([center[1:, :], center[-1:, :]], axis=0)
                xm = jnp.concatenate([center[:, :1], center[:, :-1]], axis=1)
                xp = jnp.concatenate([center[:, 1:], center[:, -1:]], axis=1)
                lap = (
                    (xp - 2.0 * center + xm) * _dx2
                    + (yp - 2.0 * center + ym) * _dy2
                    + (zp - 2.0 * center + zm) * _dz2
                )
                dH = (center - ht) * _dt - kw["D"] * lap
                gy = jax.lax.broadcasted_iota(jnp.int32, center.shape, 0)
                gx = jax.lax.broadcasted_iota(jnp.int32, center.shape, 1)
                m = (gy > 0) & (gy < cfg.ny - 1) & (gx > 0) & (gx < cfg.nx - 1)
                return jnp.where(m, dH, jnp.asarray(0.0, center.dtype))

            def cond_po(carry):
                _, err, it = carry
                return jnp.logical_and(err > cfg.tol, it < cfg.iter_max)

            def body_po(carry):
                Hp, _, it = carry
                # start the face exchange; the interior pass below
                # has no data dependence on it, so XLA overlaps them
                gl, gh = halo.exchange_faces(Hp[1 : 1 + nzl], "z", 0)
                out, sumsq = pallas3d.dual_time_step_padded(
                    Ht_in, Hp, local_shape,
                    bounds=(
                        jnp.maximum(zlo, 1), jnp.minimum(zhi, nzl - 2),
                        ylo, yhi, xlo, xhi,
                    ),
                    ghosts=ghosts, **kw,
                )
                dtau_ = jnp.asarray(kw["dtau"], Hp.dtype)
                # z-edge planes from the fresh ghosts (skipped at the global
                # faces, where the plane is Dirichlet and stays put)
                c0 = Hp[1]
                dH0 = edge_dH(c0, gl[0], Hp[2], Ht_in[0])
                do0 = zlo <= 0
                new0 = jnp.where(do0, c0 - dtau_ * dH0, c0)
                s0 = jnp.where(do0, jnp.sum(dH0 * dH0), 0.0)
                cl = Hp[nzl]
                dHl = edge_dH(cl, Hp[nzl - 1], gh[0], Ht_in[nzl - 1])
                dol = zhi >= nzl - 1
                newl = jnp.where(dol, cl - dtau_ * dHl, cl)
                sl = jnp.where(dol, jnp.sum(dHl * dHl), 0.0)
                out = out.at[1].set(new0).at[nzl].set(newl)
                sumsq = reductions.dist_sumsq(sumsq + s0 + sl, all_axes)
                err = jnp.sqrt(sumsq) * cfg.dt / sqrt_n
                return out, err.astype(out.dtype), it + 1

            Hp, err, iters = jax.lax.while_loop(
                cond_po,
                body_po,
                (Hp, jnp.asarray(jnp.inf, Hp.dtype), jnp.asarray(0, jnp.int32)),
            )
            Ht_new = pallas3d.unpad3d(Hp, local_shape, ghosts)
            return Ht_new, Ht_new, err, iters

        def cond(carry):
            _, err, it = carry
            return jnp.logical_and(err > cfg.tol, it < cfg.iter_max)

        def body(carry):
            Hp, _, it = carry
            if use_pallas:
                from fpr_tpu.ops import pallas3d

                if sharded:
                    Hp = halo.refresh_ghosts_padded(
                        Hp, local_shape, sharded, ghosts
                    )
                Hp, sumsq = pallas3d.dual_time_step_padded(
                    Ht_in, Hp, local_shape,
                    bounds=(zlo, zhi, ylo, yhi, xlo, xhi), ghosts=ghosts, **kw
                )
            else:
                Hp = halo.refresh_ghosts_ext(Hp, sharded)
                Hp, sumsq = stencil3d.dual_time_step_ext3(
                    Ht_in, Hp, zlo=zlo, zhi=zhi, ylo=ylo, yhi=yhi,
                    xlo=xlo, xhi=xhi, **kw
                )
            sumsq = reductions.dist_sumsq(sumsq, all_axes)
            err = jnp.sqrt(sumsq) * cfg.dt / sqrt_n
            return Hp, err.astype(Hp.dtype), it + 1

        Hp, err, iters = jax.lax.while_loop(
            cond,
            body,
            (Hp, jnp.asarray(jnp.inf, Hp.dtype), jnp.asarray(0, jnp.int32)),
        )
        if use_pallas:
            from fpr_tpu.ops import pallas3d

            Ht_new = pallas3d.unpad3d(Hp, local_shape, ghosts)
        else:
            Ht_new = Hp[1:-1, 1:-1, 1:-1]
        return Ht_new, Ht_new, err, iters

    spec = _partition_spec(mesh)
    kwargs = dict(
        mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec, P(), P())
    )
    step = shard_map(shard_body, **kwargs)
    return jax.jit(step), grid


def solve_distributed(
    cfg: DiffusionConfig = DiffusionConfig(),
    mesh: Mesh | None = None,
    axis: str = "z",
    dtype=jnp.float32,
    verbose: bool = False,
) -> DistDiffusionResult:
    """Distributed solve mirroring the reference driver loop
    (part1_kernel_programming.jl:166-204), one host sync per physical step."""
    from fpr_tpu.parallel.mesh import make_mesh

    del axis
    mesh = make_mesh() if mesh is None else mesh
    n_shards = int(np.prod(list(mesh.shape.values())))
    step, grid = build_step(cfg, mesh)
    nt = outer_steps(cfg.ttot, cfg.dt)

    from fpr_tpu.core import bc

    Ht_host = stencil3d.init_gaussian(grid, dtype=dtype)
    Ht_host = bc.dirichlet_faces_3d(Ht_host)
    sharding = NamedSharding(mesh, _partition_spec(mesh))
    Ht = jax.device_put(Ht_host, sharding)
    Htau = Ht

    iters_total = 0
    timed_iters = 0
    converged = True
    tic = time.time()
    for it_outer in range(nt):
        if it_outer == 3:  # warmup (ref :170-176)
            jax.block_until_ready(Ht)
            tic = time.time()
            timed_iters = 0
        Ht, Htau, err, iters = step(Ht, Htau)
        n_it = int(iters)
        iters_total += n_it
        timed_iters += n_it
        if n_it >= cfg.iter_max:
            converged = False
        if verbose:
            print(f"step {it_outer}: {n_it} iters, err={float(err):.3e}")
    jax.block_until_ready(Ht)
    delta_t = time.time() - tic

    model = "fused" if cfg.policy == ExecutionPolicy.PALLAS else "plain"
    bench = diffusion_bench_results(
        delta_t, timed_iters, cfg.nx, cfg.ny, cfg.nz,
        word_bytes=jnp.dtype(dtype).itemsize, model=model, n_devices=n_shards,
    )
    return DistDiffusionResult(
        H=np.asarray(Ht),  # gather! analog (part1_kernel_programming.jl:223)
        iters_total=iters_total,
        timed_iters=timed_iters,
        bench=bench,
        converged=converged,
        n_devices=n_shards,
    )
