"""Static configuration for solvers and models.

These are the analogs of the reference's config surfaces:
``MGOpt`` (reference scripts-part2/multigrid.jl:16-22), ``SimIn_t``
(scripts-part2/part2.jl:30-46), the ``ExecutionPolicy_t`` /
``CoarseSolver_t`` enums (scripts-part2/part2_utils.jl:4-8,
multigrid.jl:10-13), and the positional CLI of part 1
(scripts-part1/part1.jl:25-60).

All configs are frozen dataclasses: they hold *static* (trace-time) values
only, so a config change triggers recompilation and a config is hashable as
part of a jit static argument.
"""

from __future__ import annotations

import dataclasses
import enum


class ExecutionPolicy(enum.Enum):
    """How the stencil operator tier executes.

    The reference's tiers (part2_utils.jl:4-8) are serial / parallel /
    parallel_shmem.  The analogous tiers here:

    - JNP: plain jitted jnp ops on the physical arrays ("array
      programming" tier).
    - PALLAS: the fused steps of fpr_tpu.ops.pallas2d/pallas3d on padded
      state (the "kernel programming" tier; the name is historical — the
      bodies are plain jnp that XLA fuses).
    - PALLAS_DS: the fused steps on double-single (two-f32, ~48-bit)
      state — f64-class tolerances in f32 arithmetic.
    """

    JNP = "jnp"
    PALLAS = "pallas"
    PALLAS_DS = "pallas_ds"


class CoarseSolver(enum.Enum):
    """Coarse-grid solver for the multigrid V-cycle (multigrid.jl:10-13).

    DST is beyond-reference: an *exact* solve by dense sine-transform
    matmuls (fpr_tpu.solvers.dst), replacing the
    reference's sequential Jacobi/CG coarse iteration — and, with a large
    ``coarse_size`` (129-513), the entire small-level subtree whose
    dispatch latency dominates small-grid MG solves.
    """

    JACOBI = "jacobi"
    CG = "cg"
    DST = "dst"


class Smoother(enum.Enum):
    """Multigrid smoother.

    The reference uses damped Jacobi (alpha=4/5) everywhere
    (multigrid.jl:245-258) and keeps a serial Gauss-Seidel for debugging
    (multigrid.jl:269-297).  We additionally provide red-black Gauss-Seidel,
    which parallelizes as two masked half-sweeps.
    """

    JACOBI = "jacobi"
    RED_BLACK_GS = "red_black_gs"


class Restriction(enum.Enum):
    """MG restriction operator.

    AUTO picks injection (reference parity, multigrid.jl:330-337) for the
    Jacobi smoother and full weighting for red-black GS (whose checkerboard
    residual aliases under injection — see fpr_tpu.ops.transfer).
    """

    AUTO = "auto"
    INJECTION = "injection"
    FULL_WEIGHTING = "full_weighting"


class InitScheme(enum.Enum):
    """Initial condition for NS fields (part2.jl:23-27)."""

    COSINE = "cosine"
    RANDOM = "random"
    FROM_ARRAY = "from_array"  # reference's W_from_file; caller passes the array


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid options (reference MGOpt, multigrid.jl:16-22).

    coarse_size: solve directly once min(nx, ny) <= coarse_size; must be
        2^l + 1 (reference asserts the same, multigrid.jl:45-46).
    pre_smooth/post_smooth: reference hard-codes 2+2 (multigrid.jl:124-143).
    """

    coarse_size: int = 5
    coarse_solver: CoarseSolver = CoarseSolver.JACOBI
    smoother: Smoother = Smoother.JACOBI
    policy: ExecutionPolicy = ExecutionPolicy.JNP
    pre_smooth: int = 2
    post_smooth: int = 2
    jacobi_damping: float = 0.8  # alpha = 4/5, multigrid.jl:242
    restriction: Restriction = Restriction.AUTO

    def resolved_restriction(self) -> Restriction:
        if self.restriction is Restriction.AUTO:
            return (
                Restriction.FULL_WEIGHTING
                if self.smoother is Smoother.RED_BLACK_GS
                else Restriction.INJECTION
            )
        return self.restriction


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Navier-Stokes simulation input (reference SimIn_t, part2.jl:30-46).

    Defaults mirror the reference constructor: k=1, Ra=1e6, Pr=1e-3,
    257x65 grid, ttot=0.1, beta=0 (explicit), niters=50, tol=1e-3,
    a_dif=0.15, a_adv=0.4, cosine T init, random W init.
    """

    k: float = 1.0
    Ra: float = 1.0e6
    Pr: float = 1.0e-3
    nx: int = 257
    ny: int = 65
    ttot: float = 0.1
    beta: float = 0.0  # 0 explicit, 0.5 semi-implicit, 1 implicit
    niters: int = 50
    tol: float = 1.0e-3
    a_dif: float = 0.15
    a_adv: float = 0.4
    T_init: InitScheme = InitScheme.COSINE
    W_init: InitScheme = InitScheme.RANDOM
    mg: MGConfig = MGConfig()
    # simulate_fast only: allow fast_mg_default to upgrade a default
    # ``mg`` to the measured production ladder (DST-257, V(3,3)).  Set
    # False to run the true default ladder (coarse 5, V(2,2)) on the fast
    # path — e.g. for reference-shaped A/B comparisons.  An explicitly
    # provided ``mg`` always wins regardless of this flag.
    mg_auto: bool = True
    # "direct": mg_solve in the simulation dtype; "mixed": f64 defect
    # correction around f32 fused V-cycles (tight tolerances on large
    # grids — f32 alone can't represent the residual)
    mg_solver: str = "direct"
    # simulate_fast only: relax the STREAMFUNCTION solve's tolerance to
    # s_tol_factor * tol * rms(W) (T/W Helmholtz solves keep tol).  The
    # S-solve's only observables are the velocity maxima (adaptive dt /
    # step count) and the advective fluxes; a measured factor that
    # preserves exact step parity trades unobservable S digits for 1 of
    # the 2 warm-solve outer defect iterations per step.  1.0 = the
    # reference's semantics (multigrid.jl:55, tolf = tol * f_rms).
    s_tol_factor: float = 1.0

    @property
    def h(self) -> float:
        # h = 1/(ny-1), part2.jl:144
        return 1.0 / (self.ny - 1.0)

    @property
    def width(self) -> float:
        # domain aspect, part2.jl:145
        return (self.nx - 1.0) / (self.ny - 1.0)

    @property
    def dt_dif(self) -> float:
        # diffusive timestep, part2.jl:146
        return self.a_dif * self.h**2 / max(self.k, self.Pr)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """3D pseudo-transient diffusion input (part1_kernel_programming.jl:99-131).

    nx/ny/nz are *local* (per-device) grid sizes, as in the reference where
    each MPI rank owns an nx*ny*nz block.  The physical domain is
    10x10x10 (scaled by the device grid when scale_physical_size, the weak
    scaling mode of part1_kernel_programming.jl:106-114).
    """

    nx: int = 128
    ny: int = 128
    nz: int = 128
    D: float = 1.0
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0
    ttot: float = 1.0
    dt: float = 0.2
    tol: float = 1.0e-8
    iter_max: int = 100_000
    scale_physical_size: bool = False
    policy: ExecutionPolicy = ExecutionPolicy.PALLAS
    # inner iterations fused between convergence checks; 1 reproduces the
    # reference's check-every-iteration behavior exactly
    check_every: int = 1
    # distributed only: compute the shard interior while the halo exchange
    # is in flight (the reference's @hide_communication,
    # part1_kernel_programming.jl:185-188); jnp tier, z decomposition
    overlap_comm: bool = False
