"""2D stencil operators — plain-jnp tier ("array programming").

All operators act on (ny, nx) arrays, write only the interior, and keep a
zero (or caller-preserved) boundary, mirroring the reference kernels which
guard with ``1 < ix < nx && 1 < iy < ny``:

- residual:    reference residual_2DPoisson!   (multigrid.jl:173-188)
- matvec:      reference matrix_free_matvec_prod! (krylov.jl:7-13)
- jacobi step: reference iteration_2DPoisson!   (multigrid.jl:245-258)
- velocity/advection/diffusion/buoyancy: part2.jl:90-137

These are pure functions of their inputs; XLA fuses the elementwise chains.
The fused tier (fpr_tpu.ops.pallas2d) provides fused steps with identical
semantics.
"""

from __future__ import annotations

import jax.numpy as jnp


def _pad0(interior: jnp.ndarray) -> jnp.ndarray:
    """Pad an (ny-2, nx-2) interior result back to (ny, nx) with zeros."""
    return jnp.pad(interior, 1)


def laplacian_interior(u: jnp.ndarray, hx: float, hy: float) -> jnp.ndarray:
    """5-point Laplacian evaluated on the interior, shape (ny-2, nx-2)."""
    return (u[1:-1, 2:] - 2.0 * u[1:-1, 1:-1] + u[1:-1, :-2]) / (hx * hx) + (
        u[2:, 1:-1] - 2.0 * u[1:-1, 1:-1] + u[:-2, 1:-1]
    ) / (hy * hy)


def residual(u: jnp.ndarray, f: jnp.ndarray, h: float, c) -> jnp.ndarray:
    """res = (nabla^2 - c) u - f on the interior, 0 on the boundary.

    Uses the reference's fused form (u_E + u_W + u_N + u_S - C*u)/h^2 - f
    with C = 4 + c*h^2 (multigrid.jl:173-188).
    """
    c = jnp.asarray(c, u.dtype)  # a strong f64 shift must not promote f32 fields
    C = 4.0 + c * h * h
    inner = (
        u[1:-1, 2:] + u[1:-1, :-2] + u[2:, 1:-1] + u[:-2, 1:-1]
        - C * u[1:-1, 1:-1]
    ) / (h * h) - f[1:-1, 1:-1]
    return _pad0(inner)


def matvec(x: jnp.ndarray, hx: float, hy: float, c) -> jnp.ndarray:
    """(nabla^2 - c) x on the interior, 0 on the boundary (krylov.jl:7-13)."""
    c = jnp.asarray(c, x.dtype)
    inner = (
        (x[1:-1, 2:] - 2.0 * x[1:-1, 1:-1] + x[1:-1, :-2]) / (hx * hx)
        + (x[2:, 1:-1] - 2.0 * x[1:-1, 1:-1] + x[:-2, 1:-1]) / (hy * hy)
        - c * x[1:-1, 1:-1]
    )
    return _pad0(inner)


def jacobi_step(u, f, h, c, alpha=0.8, with_norm=True):
    """One damped-Jacobi iteration (multigrid.jl:245-258).

    Computes res = (nabla^2 - c)u - f, then u += alpha * h^2/(4 + c h^2) * res.
    Returns (u_new, r_rms) where r_rms = sqrt(mean(res^2)) over the FULL grid
    (boundary zeros included, as the reference divides by nx*ny) — or
    (u_new, None) when with_norm=False to avoid the reduction.
    """
    c = jnp.asarray(c, u.dtype)
    C = 4.0 + c * h * h
    res = residual(u, f, h, c)
    r_rms = rms(res) if with_norm else None
    u_new = u + (alpha * h * h / C) * res
    return u_new, r_rms


def red_black_gs_step(u, f, h, c, with_norm=True):
    """One red-black Gauss-Seidel sweep (two masked half-sweeps).

    Data-parallel GS: points with (ix+iy) even ("red") update first from the
    current u, then "black" points update from the half-updated u.  This is
    the parallel replacement for the reference's serial GS
    (multigrid.jl:269-297), with damping 1.0 as noted there.
    Returns (u_new, r_rms) with r_rms measured on entry (pre-sweep residual),
    matching the Jacobi smoother's convention.
    """
    ny, nx = u.shape
    iy = jnp.arange(ny).reshape(-1, 1)
    ix = jnp.arange(nx).reshape(1, -1)
    red = ((ix + iy) % 2 == 0).astype(u.dtype)
    c = jnp.asarray(c, u.dtype)
    C = 4.0 + c * h * h
    res0 = residual(u, f, h, c)
    r_rms = rms(res0) if with_norm else None
    u = u + (h * h / C) * res0 * red
    res1 = residual(u, f, h, c)
    u = u + (h * h / C) * res1 * (1.0 - red)
    return u, r_rms


def rms(a: jnp.ndarray):
    """sqrt(sum(a^2)/N) over the full array, accumulated in f32-or-wider."""
    acc = a.astype(jnp.float32) if a.dtype in (jnp.float16, jnp.bfloat16) else a
    return jnp.sqrt(jnp.sum(acc * acc) / a.size)


# ---------------------------------------------------------------------------
# Navier-Stokes operators (part2.jl:90-137)
# ---------------------------------------------------------------------------


def velocity(S: jnp.ndarray, hx: float, hy: float):
    """(vx, vy) = (dS/dy, -dS/dx) by central differences (part2.jl:90-96)."""
    vx = _pad0((S[2:, 1:-1] - S[:-2, 1:-1]) / (2.0 * hy))
    vy = _pad0(-(S[1:-1, 2:] - S[1:-1, :-2]) / (2.0 * hx))
    return vx, vy


def buoyancy(T: jnp.ndarray, Ra: float, hx: float):
    """Ra * dT/dx by central differences (part2.jl:98-104)."""
    return _pad0(Ra * (T[1:-1, 2:] - T[1:-1, :-2]) / (2.0 * hx))


def diffusion(T: jnp.ndarray, k, hx: float, hy: float):
    """k * nabla^2 T on the interior (part2.jl:106-113)."""
    return _pad0(k * laplacian_interior(T, hx, hy))


def advection_x(T: jnp.ndarray, vx: jnp.ndarray, hx: float):
    """First-order upwind vx * dT/dx (part2.jl:116-125)."""
    Ti = T[1:-1, 1:-1]
    up = (Ti - T[1:-1, :-2]) / hx  # backward difference, vx > 0
    dn = (T[1:-1, 2:] - Ti) / hx  # forward difference, vx <= 0
    v = vx[1:-1, 1:-1]
    return _pad0(v * jnp.where(v > 0, up, dn))


def advection_y(T: jnp.ndarray, vy: jnp.ndarray, hy: float):
    """First-order upwind vy * dT/dy (part2.jl:128-137)."""
    Ti = T[1:-1, 1:-1]
    up = (Ti - T[:-2, 1:-1]) / hy
    dn = (T[2:, 1:-1] - Ti) / hy
    v = vy[1:-1, 1:-1]
    return _pad0(v * jnp.where(v > 0, up, dn))
