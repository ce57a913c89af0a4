"""fpr_tpu — a stencil-PDE framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
ntselepidis/FinalProjectRepo.jl (a Julia multi-XPU PDE suite):

- ``fpr_tpu.models.diffusion3d``: 3D pseudo-transient (dual-time) diffusion to
  steady state, single- and multi-device (sharded halo exchange).
- ``fpr_tpu.models.navier_stokes``: 2D streamfunction-vorticity thermal
  convection with explicit / semi-implicit / implicit timestepping.
- ``fpr_tpu.solvers.multigrid``: matrix-free geometric multigrid V-cycle
  (damped Jacobi / red-black Gauss-Seidel smoothers, Jacobi or CG coarse solve).
- ``fpr_tpu.solvers.krylov``: matrix-free CG, optionally MG-preconditioned.
- ``fpr_tpu.ops``: the stencil operator tier — plain-jnp ("array programming")
  and fused steps on padded layouts ("kernel programming").
- ``fpr_tpu.parallel``: device mesh, shard_map halo exchange, collectives.

Everything is functional and jit-compatible: solvers keep convergence control
on-device (lax.while_loop) and sync with the host only at step boundaries.
"""

__version__ = "0.1.0"
