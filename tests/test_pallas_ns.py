"""Fused NS operator pass parity vs the jnp tier (f64).

The pass must reproduce, bit-near-exactly, the jnp composition used by
ns_step (fpr_tpu/models/navier_stokes.py): BCs on T, velocity from S,
buoyancy, diffusion, upwind advection, and the explicit update or the
semi-implicit rhs build (reference part2.jl:90-137, 199-230).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.core import bc
from fpr_tpu.ops import pallas2d, pallas_ns
from fpr_tpu.ops import stencil2d as ops


def _jnp_reference(T, W, S, h, Pr, Ra, k, beta, dt, mode, cT=None, cW=None):
    """The exact jnp-tier composition from ns_step."""
    T = bc.ns_temperature_bcs(T)
    vx, vy = ops.velocity(S, h, h)
    Ra_dTdx = ops.buoyancy(T, Ra, h)
    if abs(beta - 1.0) > 1e-8:
        dT2 = ops.diffusion(T, k, h, h)
        dW2 = ops.diffusion(W, Pr, h, h)
    else:
        dT2 = jnp.zeros_like(T)
        dW2 = jnp.zeros_like(W)
    dTx = ops.advection_x(T, vx, h)
    dTy = ops.advection_y(T, vy, h)
    dWx = ops.advection_x(W, vx, h)
    dWy = ops.advection_y(W, vy, h)
    if mode == "explicit":
        T_out = T + dt * (dT2 - dTx - dTy)
        W_out = W + dt * (dW2 - dWx - dWy - Pr * Ra_dTdx)
    else:
        T_out = -cT * (T + dt * ((1.0 - beta) * dT2 - dTx - dTy))
        W_out = -cW * (W + dt * ((1.0 - beta) * dW2 - dWx - dWy - Pr * Ra_dTdx))
    return T_out, W_out


@pytest.mark.parametrize("shape", [(17, 33), (65, 257), (129, 129)])
@pytest.mark.parametrize(
    "mode,beta", [("explicit", 0.0), ("rhs", 0.5), ("rhs", 1.0)]
)
def test_fused_matches_jnp(rng, shape, mode, beta):
    ny, nx = shape
    h = 1.0 / (ny - 1)
    Pr, Ra, k = 0.01, 1e6, 1.0
    dt = 3.7e-6
    cT = 1.0 / (beta * dt) if beta > 0 else None
    cW = cT / Pr if beta > 0 else None

    T = jnp.asarray(rng.random(shape))
    W = jnp.asarray(rng.random(shape) * 100.0)
    S = jnp.asarray(rng.random(shape) * 1e-3)

    T_ref, W_ref = _jnp_reference(T, W, S, h, Pr, Ra, k, beta, dt, mode, cT, cW)

    br = pallas2d.layout_br(ny)
    tw = jnp.stack([pallas2d.pad2d(T, br), pallas2d.pad2d(W, br)])
    s_rp = pallas2d.pad2d(S, br)
    out = pallas_ns.ns_fused_rp(
        tw, s_rp, dt, ny, nx, br, h, Pr, Ra, k=k, beta=beta, mode=mode,
        cT=cT, cW=cW,
    )
    T_got = np.asarray(pallas2d.unpad2d(out[0], ny, nx))
    W_got = np.asarray(pallas2d.unpad2d(out[1], ny, nx))

    scale = 1.0 / h**2 * max(Ra, 1.0 / dt if mode == "rhs" else 1.0)
    np.testing.assert_allclose(T_got, np.asarray(T_ref), atol=1e-13 * scale, rtol=1e-12)
    np.testing.assert_allclose(W_got, np.asarray(W_ref), atol=1e-13 * scale, rtol=1e-12)

    # within the block rows, everything outside the physical domain must be
    # zero (the top/bottom PAD ghost rows are unspecified, like every other
    # rp output — consumers slice or mask)
    total, nxp = out[0].shape
    written = np.zeros((total, nxp), bool)
    written[pallas2d.PAD : total - pallas2d.PAD, :] = True
    written[pallas2d.PAD : pallas2d.PAD + ny, :nx] = False
    assert np.all(np.asarray(out[0])[written] == 0.0)
    assert np.all(np.asarray(out[1])[written] == 0.0)


def test_fused_f32_runs(rng):
    # the production dtype path
    ny, nx = 33, 129
    h = 1.0 / (ny - 1)
    T = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    W = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    S = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    br = pallas2d.layout_br(ny)
    tw = jnp.stack([pallas2d.pad2d(T, br), pallas2d.pad2d(W, br)])
    out = pallas_ns.ns_fused_rp(
        tw, pallas2d.pad2d(S, br), 1e-5, ny, nx, br, h, 0.1, 1e6
    )
    T_ref, W_ref = _jnp_reference(
        T.astype(jnp.float64), W.astype(jnp.float64), S.astype(jnp.float64),
        h, 0.1, 1e6, 1.0, 0.0, 1e-5, "explicit",
    )
    np.testing.assert_allclose(
        np.asarray(pallas2d.unpad2d(out[0], ny, nx)), np.asarray(T_ref),
        rtol=2e-4, atol=2e-3,
    )


def test_with_defect_matches_separate_passes(rng):
    """with_defect must equal the separate operator + ds.defect_pass pair
    bitwise on the physical domain: same T'/W', same r32 = A S - W' (ds
    residual arithmetic), same r_rms and curl-maxima extras.  This is the
    contract the explicit fast loop relies on (the operator pass of step
    n produces step n+1's warm-S-solve inputs)."""
    from fpr_tpu.ops import ds as dsm

    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    f32 = jnp.float32
    br = pallas2d.layout_br(ny)
    T = jnp.asarray(rng.standard_normal((ny, nx)), f32)
    W = jnp.asarray(rng.standard_normal((ny, nx)), f32)
    Sh = jnp.asarray(rng.standard_normal((ny, nx)), f32)
    Sl = jnp.asarray(rng.standard_normal((ny, nx)) * 1e-8, f32)
    TW = jnp.stack([pallas2d.pad2d(T, br), pallas2d.pad2d(W, br)])
    S_ds = jnp.stack([pallas2d.pad2d(Sh, br), pallas2d.pad2d(Sl, br)])
    dt = jnp.asarray(1e-4, f32)

    out_ref, (tss_ref, wss_ref) = pallas_ns.ns_fused_rp(
        TW, S_ds[0], dt, ny, nx, br, h, 0.01, 1e6,
        mode="explicit", with_sumsq=True,
    )
    _, r32_ref, rrms_ref, ex_ref = dsm.defect_pass(
        S_ds, out_ref[1:2], jnp.zeros_like(TW[0]), 0.0, ny, nx, br, h, 0.0,
        velocity_max=True,
    )

    out_f, (tss_f, wss_f), (r32_f, rrms_f), ex_f = pallas_ns.ns_fused_rp(
        TW, S_ds, dt, ny, nx, br, h, 0.01, 1e6,
        mode="explicit", with_defect=True,
    )

    PAD = pallas2d.PAD
    phys = np.s_[PAD : PAD + ny, :nx]
    assert np.array_equal(
        np.asarray(out_ref[:, *phys]), np.asarray(out_f[:, *phys])
    )
    assert float(tss_ref) == float(tss_f)
    assert float(wss_ref) == float(wss_f)
    assert np.array_equal(np.asarray(r32_ref[phys]), np.asarray(r32_f[phys]))
    assert float(rrms_ref) == float(rrms_f)
    assert float(ex_ref[0]) == float(ex_f[0])
    assert float(ex_ref[1]) == float(ex_f[1])
