"""Exact (∇² − c) solve via dense sine-transform matmuls — the coarse-grid
solver of the truncated multigrid ladders.

The reference's coarse solve is an up-to-20·coarse_size damped-Jacobi loop
with a per-iteration device norm, or CG (multigrid.jl:145-166) — dozens to
hundreds of *sequential* device ops, whose cost is dispatch, not
arithmetic.

The replacement: the 5-point Dirichlet Laplacian is diagonalized exactly
by the type-I discrete sine transform, and at coarse sizes the DST is just
a dense matmul.  For the operator used everywhere here,

    A u = (u_E + u_W + u_N + u_S - (4 + c h²) u) / h² ,

the 1D second-difference matrix on m interior points has eigenvectors
V[j,k] = sin((j+1)(k+1)π/(m+1)) and eigenvalues −λ_k with
λ_k = (2 − 2 cos((k+1)π/(m+1)))/h², so

    A = −(Λy ⊕ Λx) − c  in the V ⊗ V basis,
    u_int = −Vy ( (Vy f_int Vx) / (λy ⊕ λx + c) ) Vx .

Four small matmuls + one elementwise divide replace the entire coarse
iteration; c may be a *traced* scalar (the NS Helmholtz shifts), since it
only enters the elementwise denominator.  Solves with arbitrary (nonzero)
boundary values are handled in defect form: e = DST(res(u0)); u = u0 − e —
exact, and identical in contract to the converged Jacobi coarse solve
(which also leaves u's boundary ring untouched: smoothers update the
interior only, multigrid.jl:245-258).

Precision: matmuls run at Precision.HIGHEST — a default-precision f32
matmul may round its operands to a shorter mantissa (TF32 on the GPU);
HIGHEST keeps f32-class accuracy, which as an *inner* solver inside the
ds/mixed defect-correction loop is all that is needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _dst_consts(m: int, h: float):
    """(V, lam) for m interior points at spacing h, as f64 numpy.

    V is the symmetric orthonormal DST-I matrix (V == V^T == V^{-1});
    lam[k] = (2 - 2 cos((k+1)π/(m+1))) / h² > 0.
    """
    j = np.arange(1, m + 1, dtype=np.float64)
    V = np.sqrt(2.0 / (m + 1)) * np.sin(np.outer(j, j) * (np.pi / (m + 1)))
    lam = (2.0 - 2.0 * np.cos(j * np.pi / (m + 1))) / (h * h)
    return V, lam


def solve_interior(f_int, h: float, c):
    """u_int with A u = f_int under zero Dirichlet boundary.

    f_int: (my, mx) interior values; c: scalar (python or traced) >= 0.
    """
    my, mx = f_int.shape
    dtype = f_int.dtype
    Vy_np, ly_np = _dst_consts(my, float(h))
    Vx_np, lx_np = _dst_consts(mx, float(h))
    Vy = jnp.asarray(Vy_np, dtype)
    Vx = jnp.asarray(Vx_np, dtype)
    denom = jnp.asarray(ly_np[:, None] + lx_np[None, :], dtype) + jnp.asarray(
        c, dtype
    )
    hp = jax.lax.Precision.HIGHEST
    G = jnp.matmul(Vy, jnp.matmul(f_int, Vx, precision=hp), precision=hp)
    U = -G / denom
    return jnp.matmul(Vy, jnp.matmul(U, Vx, precision=hp), precision=hp)


def dst_solve(u0, f, h: float, c):
    """Drop-in coarse solve: returns (u, r_rms) like _coarse_solve.

    Solves in defect form so nonzero boundary values on u0 (the NS
    apply_bcs top-level case) are treated exactly: the correction is a
    zero-Dirichlet problem on res(u0) regardless of u0's boundary ring.
    r_rms is the true post-solve residual norm (one extra stencil pass,
    negligible at coarse sizes), matching the Jacobi path's contract.
    """
    from fpr_tpu.ops import stencil2d

    res0 = stencil2d.residual(u0, f, h, c)  # interior-masked by construction
    e_int = solve_interior(res0[1:-1, 1:-1], h, c)
    u = u0.at[1:-1, 1:-1].add(-e_int)
    r_rms = stencil2d.rms(stencil2d.residual(u, f, h, c))
    return u, r_rms
