"""Fused 3D dual-time step parity vs the jnp tier (f64) — the analog of
the reference's cross-variant golden test (test/part1.jl compares array / kernel / kernel+shmem against one file)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.ops import pallas3d, stencil3d


@pytest.mark.parametrize(
    "shape", [(8, 8, 16), (16, 8, 32), (12, 20, 24), (16, 16, 16)]
)
def test_dual_time_step_parity(rng, shape):
    Ht = jnp.asarray(rng.random(shape))
    Htau = jnp.asarray(rng.random(shape))
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
    ref, s_ref = stencil3d.dual_time_step(Ht, Htau, **args)
    got, s_got = pallas3d.dual_time_step(Ht, Htau, **args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-14)
    assert abs(float(s_got) - float(s_ref)) / float(s_ref) < 1e-12


def test_pad_roundtrip(rng):
    H = jnp.asarray(rng.random((6, 6, 8)))
    np.testing.assert_array_equal(
        np.asarray(pallas3d.unpad3d(pallas3d.pad3d(H), H.shape)), np.asarray(H)
    )
    assert pallas3d.pad3d(H).shape == (8, 8, 128)  # tile-padded y/x
    assert pallas3d.pad_ht(H).shape == (6, 8, 128)


def test_iterated_padded_state_matches_jnp(rng):
    # several iterations feeding the ghost-padded state back in
    shape = (12, 12, 16)
    Ht = jnp.asarray(rng.random(shape))
    Htau_j = jnp.asarray(rng.random(shape))
    Htau_p = pallas3d.pad3d(Htau_j)
    Ht_p = pallas3d.pad_ht(Ht)
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.1, dz=0.1, D=1.0)
    for _ in range(5):
        Htau_j, s_j = stencil3d.dual_time_step(Ht, Htau_j, **args)
        Htau_p, s_p = pallas3d.dual_time_step_padded(Ht_p, Htau_p, shape, **args)
        assert abs(float(s_p) - float(s_j)) / max(float(s_j), 1e-300) < 1e-12
    np.testing.assert_allclose(
        np.asarray(pallas3d.unpad3d(Htau_p, shape)), np.asarray(Htau_j), atol=1e-14
    )


def test_fused2_matches_two_steps(rng):
    # the two-iteration step == two sequential iterations; the norm is the
    # second iteration's
    for shape in [(8, 8, 16), (12, 20, 24)]:
        Ht = jnp.asarray(rng.random(shape))
        Htau = jnp.asarray(rng.random(shape))
        args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
        r1, _ = stencil3d.dual_time_step(Ht, Htau, **args)
        r2, s2 = stencil3d.dual_time_step(Ht, r1, **args)
        got_p, sg = pallas3d.dual_time_step2_padded(
            pallas3d.pad_ht2(Ht), pallas3d.pad3d2(Htau), shape, **args
        )
        got = pallas3d.unpad3d2(got_p, shape)
        np.testing.assert_allclose(np.asarray(got), np.asarray(r2), atol=1e-14)
        assert abs(float(sg) - float(s2)) / float(s2) < 1e-12


def test_solver_fused2_policy(rng):
    # end-to-end solve with check_every=2 (K=2 step) == plain JNP solve;
    # iteration counts may differ by at most 1 (checks land every 2 iters)
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.models import diffusion3d

    base = dict(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7)
    o_j = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.JNP, **base), dtype=jnp.float64
    )
    o_2 = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.PALLAS, check_every=2, **base),
        dtype=jnp.float64,
    )
    assert abs(o_2.iters_total - o_j.iters_total) <= o_j.iters_total // 10 + 4
    # per-step overshoot by <=1 iteration shifts the field at the tol scale;
    # 1e-5 is the reference's own cross-variant golden bar (test/part1.jl)
    np.testing.assert_allclose(o_2.H, o_j.H, atol=1e-5)


def test_solver_with_pallas_policy(rng):
    # end-to-end solve with the PALLAS policy == JNP policy
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.models import diffusion3d

    base = dict(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7)
    o_j = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.JNP, **base), dtype=jnp.float64
    )
    o_p = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.PALLAS, **base), dtype=jnp.float64
    )
    assert o_j.iters_total == o_p.iters_total
    np.testing.assert_allclose(o_p.H, o_j.H, atol=1e-13)


@pytest.mark.parametrize("K", [3, 4])
def test_fusedk_matches_k_steps(rng, K):
    # the K-iteration step == K sequential iterations; the norm is the
    # LAST iteration's
    for shape in [(8, 8, 16), (12, 20, 24)]:
        Ht = jnp.asarray(rng.random(shape))
        Htau = jnp.asarray(rng.random(shape))
        args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
        r, s = Htau, None
        for _ in range(K):
            r, s = stencil3d.dual_time_step(Ht, r, **args)
        got_p, sg = pallas3d.dual_time_stepk_padded(
            pallas3d.pad_htk(Ht, K), pallas3d.pad3dk(Htau, K), shape, K=K, **args
        )
        got = pallas3d.unpad3dk(got_p, shape, K)
        np.testing.assert_allclose(np.asarray(got), np.asarray(r), atol=1e-14)
        assert abs(float(sg) - float(s)) / float(s) < 1e-12


def test_solver_fusedk_policy(rng):
    # end-to-end solve with check_every=4 == plain JNP solve
    from fpr_tpu.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu.models import diffusion3d

    base = dict(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7)
    o_j = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.JNP, **base), dtype=jnp.float64
    )
    o_4 = diffusion3d.solve(
        DiffusionConfig(policy=ExecutionPolicy.PALLAS, check_every=4, **base),
        dtype=jnp.float64,
    )
    assert abs(o_4.iters_total - o_j.iters_total) <= o_j.iters_total // 10 + 8
    np.testing.assert_allclose(o_4.H, o_j.H, atol=1e-5)


@pytest.mark.parametrize("K", [2, 3, 4])
def test_fusedk_stacked_matches_k_steps(rng, K):
    # stacked-state variant == K sequential iterations; ghosts/Ht persist
    # across calls (ny=40: y is not a multiple of the stored extent)
    shape = (12, 40, 24)
    Ht = jnp.asarray(rng.random(shape))
    Htau = jnp.asarray(rng.random(shape))
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
    state = pallas3d.stack_state_k(Ht, Htau, K)
    r = Htau
    for it in range(2):  # two calls: state must feed back correctly
        s = None
        for _ in range(K):
            r, s = stencil3d.dual_time_step(Ht, r, **args)
        state, sg = pallas3d.dual_time_stepk_stacked(state, shape, K=K, **args)
        np.testing.assert_allclose(
            np.asarray(pallas3d.unstack_state_k(state, shape, K)),
            np.asarray(r), atol=1e-14,
        )
        assert abs(float(sg) - float(s)) / float(s) < 1e-12
    # the Ht plane-set and every ghost plane come back unchanged
    ref = pallas3d.stack_state_k(Ht, Htau, K)
    np.testing.assert_array_equal(np.asarray(state[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(state[0, :K]), np.asarray(ref[0, :K]))
    np.testing.assert_array_equal(np.asarray(state[0, -K:]), np.asarray(ref[0, -K:]))
