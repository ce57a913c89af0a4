"""Distributed (shard_map) tests on the 8-virtual-device CPU mesh — real CI
coverage of the halo/psum paths the reference never had (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from jax import shard_map

from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu.models import diffusion3d
from fpr_tpu.parallel import dist_diffusion, halo
from fpr_tpu.parallel.mesh import make_mesh


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_halo_exchange_roundtrip(rng):
    mesh = make_mesh((4,), ("z",))
    a = jnp.asarray(rng.random((16, 4, 8)))

    def body(local):
        below, above = halo.exchange_faces_z(local, "z")
        return below, above

    below, above = jax.jit(
        shard_map(
            body, mesh=mesh,
            in_specs=(P("z", None, None),),
            out_specs=(P("z", None, None), P("z", None, None)),
        )
    )(a)
    below, above = np.asarray(below), np.asarray(above)
    an = np.asarray(a)
    # shard k's ghost-below = shard k-1's last plane; shard 0 gets zeros
    assert np.all(below[0] == 0)
    for k in range(1, 4):
        np.testing.assert_array_equal(below[k], an[4 * k - 1])
    # shard k's ghost-above = shard k+1's first plane; last shard gets zeros
    assert np.all(above[3] == 0)
    for k in range(0, 3):
        np.testing.assert_array_equal(above[k], an[4 * (k + 1)])


@pytest.mark.parametrize(
    "mesh_shape,axes",
    [
        ((2,), ("z",)),
        ((8,), ("z",)),
        ((2, 4), ("z", "y")),
        ((2, 2, 2), ("z", "y", "x")),
    ],
)
def test_distributed_matches_single_device(mesh_shape, axes):
    # strong-scaling setup: same 32^3 global grid, sharded vs single device,
    # over 1D/2D/3D Cartesian decompositions (the reference's 3D rank grid)
    cfg_single = DiffusionConfig(
        nx=32, ny=32, nz=32, ttot=0.4, tol=1e-7, policy=ExecutionPolicy.JNP
    )
    single = diffusion3d.solve(cfg_single, dtype=jnp.float64)

    mesh = make_mesh(mesh_shape, axes)
    ext = {a: s for a, s in zip(axes, mesh_shape)}
    cfg_dist = DiffusionConfig(
        nx=32 // ext.get("x", 1),
        ny=32 // ext.get("y", 1),
        nz=32 // ext.get("z", 1),
        ttot=0.4, tol=1e-7, policy=ExecutionPolicy.JNP,
    )
    dist = dist_diffusion.solve_distributed(cfg_dist, mesh, dtype=jnp.float64)

    assert dist.n_devices == int(np.prod(mesh_shape))
    assert dist.iters_total == single.iters_total
    np.testing.assert_allclose(dist.H, single.H, atol=1e-13)


@pytest.mark.parametrize(
    "mesh_shape,axes",
    [
        ((2,), ("z",)),
        ((2, 4), ("z", "y")),
        ((2, 2, 2), ("z", "y", "x")),
    ],
)
def test_distributed_pallas_policy_matches(mesh_shape, axes):
    # the fused step inside shard_map on 1D/2D/3D Cartesian
    # decompositions — the padded layout's y/x ghost blocks mirror the
    # reference's 3D rank grid
    # (part1_kernel_programming.jl:100-101)
    single = diffusion3d.solve(
        DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7,
                        policy=ExecutionPolicy.JNP),
        dtype=jnp.float64,
    )
    mesh = make_mesh(mesh_shape, axes)
    ext = {a: s for a, s in zip(axes, mesh_shape)}
    dist = dist_diffusion.solve_distributed(
        DiffusionConfig(nx=16 // ext.get("x", 1),
                        ny=16 // ext.get("y", 1),
                        nz=16 // ext.get("z", 1),
                        ttot=0.4, tol=1e-7,
                        policy=ExecutionPolicy.PALLAS),
        mesh, dtype=jnp.float64,
    )
    assert dist.iters_total == single.iters_total
    np.testing.assert_allclose(dist.H, single.H, atol=1e-13)


@pytest.mark.parametrize(
    "policy", [ExecutionPolicy.JNP, ExecutionPolicy.PALLAS]
)
def test_overlap_comm_matches_plain(policy):
    # @hide_communication analog: interior-first compute with in-flight
    # ppermute must be numerically identical to the ghost-padded step —
    # on the jnp tier AND the fused tier (fused step over the shard
    # interior, edge-plane fixup from the fresh ghosts)
    mesh = make_mesh((4,), ("z",))
    base = dict(nx=16, ny=16, nz=8, ttot=0.4, tol=1e-7, policy=policy)
    plain = dist_diffusion.solve_distributed(
        DiffusionConfig(**base), mesh, dtype=jnp.float64
    )
    over = dist_diffusion.solve_distributed(
        DiffusionConfig(overlap_comm=True, **base), mesh, dtype=jnp.float64
    )
    assert over.iters_total == plain.iters_total
    np.testing.assert_allclose(over.H, plain.H, atol=1e-13)


def test_distributed_weak_scaling_physical_size():
    # scale_physical_size keeps dx constant so per-shard work is invariant
    # (part1_kernel_programming.jl:106-114)
    mesh = make_mesh((4,), ("z",))
    cfg = DiffusionConfig(
        nx=16, ny=16, nz=8, ttot=0.2, tol=1e-6,
        scale_physical_size=True, policy=ExecutionPolicy.JNP,
    )
    out = dist_diffusion.solve_distributed(cfg, mesh, dtype=jnp.float64)
    g = dist_diffusion._global_grid(cfg, mesh)
    assert g.lz == pytest.approx(4 * 10.0)
    # dz is invariant vs the single-shard run (10/8), so per-shard work is too
    assert g.dz == pytest.approx(10.0 / 8)
    assert out.converged
    assert np.isfinite(out.H).all()


def test_distributed_mg_matches_single_device(rng):
    """Row-sharded GSPMD multigrid == single-device mg_solve: identical
    iteration counts and 1e-12-level fields at 2049^2 on the 8-device
    virtual mesh (beyond-reference: the reference's MG is single-GPU)."""
    from fpr_tpu.solvers import multigrid
    from fpr_tpu.solvers.dist_multigrid import mg_solve_sharded

    n = 2049
    h = 1.0 / (n - 1)
    b = jnp.zeros((n, n))
    b = b.at[1:-1, 1:-1].set(rng.random((n - 2, n - 2)))
    mesh = make_mesh((8,), ("y",))

    u_ref, r_ref, it_ref = multigrid.mg_solve_jit(
        jnp.zeros((n, n)), b, h, 0.0, 1e-6, 20
    )
    u_d, r_d, it_d = mg_solve_sharded(
        jnp.zeros((n, n)), b, h, 0.0, 1e-6, 20, mesh
    )
    assert int(it_d) == int(it_ref)
    f_rms = float(jnp.sqrt(jnp.mean(b * b)))
    assert float(r_d) < 1e-6 * f_rms
    np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref), atol=1e-12)


def test_distributed_mg_helmholtz_with_bcs(rng):
    # the NS T-solve shape, sharded (Helmholtz shift + Dirichlet/Neumann BCs)
    from fpr_tpu.solvers import multigrid
    from fpr_tpu.solvers.dist_multigrid import mg_solve_sharded

    ny, nx = 513, 1025
    h = 1.0 / (ny - 1)
    c = 1e4
    b = jnp.asarray(rng.random((ny, nx)) * c)
    u0 = jnp.asarray(rng.random((ny, nx)))
    mesh = make_mesh((8,), ("y",))
    u_ref, _, it_ref = multigrid.mg_solve(u0, b, h, c, 1e-8, 30, apply_bcs=True)
    u_d, r_d, it_d = mg_solve_sharded(
        u0, b, h, c, 1e-8, 30, mesh, apply_bcs=True
    )
    assert int(it_d) == int(it_ref)
    np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref), atol=1e-10)


def test_distributed_ns_matches_single_device(rng):
    """GSPMD row-sharded NS (all multigrid solves included) == the
    single-device host-loop simulation, 3 full steps at 513x129."""
    from fpr_tpu.core.config import NSConfig
    from fpr_tpu.models.navier_stokes import simulate

    cfg = NSConfig(nx=513, ny=129, ttot=1e-3, beta=0.5, Pr=0.1,
                   tol=1e-7, niters=50, mg_solver="direct")
    W0 = rng.standard_normal((129, 513)) * 10.0
    ref = simulate(cfg, W0=W0, max_steps=3)
    mesh = make_mesh((8,), ("y",))
    got = simulate(cfg, W0=W0, max_steps=3, mesh=mesh)
    assert got.steps == ref.steps
    assert got.sim_time == pytest.approx(ref.sim_time, rel=1e-12)
    np.testing.assert_allclose(got.T, ref.T, atol=1e-11)
    np.testing.assert_allclose(got.W, ref.W, atol=1e-9 * np.abs(ref.W).max())
    np.testing.assert_allclose(got.S, ref.S, atol=1e-11)


def test_dist_k_fused_halos_match_unfused_and_single():
    """check_every=K over the mesh (K-deep communication-avoiding halos):
    K=3 distributed == K=1 distributed == single-device K=3, at a fixed
    iteration budget (tol=0 so all paths run exactly iter_max iterations)."""
    import jax.numpy as jnp

    mesh = make_mesh((4,), ("z",))
    base = dict(nx=16, ny=16, nz=6, ttot=0.2, tol=0.0, iter_max=6,
                policy=ExecutionPolicy.PALLAS)
    out1 = dist_diffusion.solve_distributed(
        DiffusionConfig(**base, check_every=1), mesh, dtype=jnp.float32
    )
    out3 = dist_diffusion.solve_distributed(
        DiffusionConfig(**base, check_every=3), mesh, dtype=jnp.float32
    )
    assert out1.iters_total == out3.iters_total == 6
    np.testing.assert_array_equal(out3.H, out1.H)  # bitwise

    # single-device on the same global grid, same fusion depth
    ref = diffusion3d.solve(
        DiffusionConfig(nx=16, ny=16, nz=24, ttot=0.2, tol=0.0, iter_max=6,
                        policy=ExecutionPolicy.PALLAS, check_every=3),
        dtype=jnp.float32,
    )
    assert ref.iters_total == out3.iters_total
    np.testing.assert_array_equal(out3.H, ref.H)  # bitwise
