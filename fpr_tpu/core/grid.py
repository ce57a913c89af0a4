"""Grid abstractions.

Array layout convention (differs deliberately from the reference's Julia
column-major (ix, iy[, iz]) layout): arrays are row-major with **x last**, so

- 2D fields have shape ``(ny, nx)`` and are indexed ``[iy, ix]``;
- 3D fields have shape ``(nz, ny, nx)`` and are indexed ``[iz, iy, ix]``.

x-last keeps the widest dimension contiguous in memory (NS grids are wide in x,
e.g. 257x65 -> shape (65, 257)).

Multigrid grids are logically (2^k + 1) per side (reference
multigrid.jl:91-97); anisotropic rectangles (lambda*2^k + 1) are supported
exactly as in preallocate_buffers (multigrid.jl:25-38).
"""

from __future__ import annotations

import dataclasses
import math


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def is_mg_grid(n: int) -> bool:
    """True if n = lambda * 2^k + 1 for some integers (n-1 even-divisible)."""
    return n >= 3 and (n - 1) % 2 == 0


def mg_levels(nx: int, ny: int, coarse_size: int) -> list[tuple[int, int]]:
    """Level shapes (fine -> coarse) for a V-cycle on an (ny, nx) grid.

    Coarsening halves both dimensions until min(nx, ny) <= coarse_size
    (reference Vcycle_2DPoisson! recursion, multigrid.jl:121,133).
    Raises if a level is not halvable before reaching the coarse size.
    """
    if not _is_pow2(coarse_size - 1):
        raise ValueError(f"coarse_size must be 2^l + 1, got {coarse_size}")
    levels = [(nx, ny)]
    cx, cy = nx, ny
    while min(cx, cy) > coarse_size:
        if (cx - 1) % 2 or (cy - 1) % 2:
            raise ValueError(
                f"grid {cx}x{cy} not coarsenable: sides must be 2^k+1"
            )
        cx, cy = (cx - 1) // 2 + 1, (cy - 1) // 2 + 1
        levels.append((cx, cy))
    return levels


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Uniform cell-vertex 2D grid on [0, width] x [0, 1] with spacing h."""

    nx: int
    ny: int
    h: float

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def n(self) -> int:
        return self.nx * self.ny


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Uniform cell-centered 3D grid.

    Matches the reference's part-1 coordinates: cell i (0-based) sits at
    (i + 1/2) * dx (init_local_gaussian uses x_g + dx/2,
    part1_utils.jl:1-12 — x_g(ix) = (ix-1)*dx in 1-based indexing).
    """

    nx: int
    ny: int
    nz: int
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    @property
    def n(self) -> int:
        return self.nx * self.ny * self.nz

    def coords1d(self, axis: str):
        """Cell-center coordinates along an axis ('x', 'y' or 'z')."""
        import numpy as np

        n = {"x": self.nx, "y": self.ny, "z": self.nz}[axis]
        l = {"x": self.lx, "y": self.ly, "z": self.lz}[axis]
        d = l / n
        return (np.arange(n) + 0.5) * d


def pseudo_timestep(dx: float, dy: float, dz: float, D: float) -> float:
    """Pseudo-transient step dtau = min(d)^2 / D / 8.1
    (part1_kernel_programming.jl:128)."""
    return min(dx, dy, dz) ** 2 / D / 8.1


def outer_steps(ttot: float, dt: float) -> int:
    """Number of physical steps: the reference iterates t in 0:dt:ttot-dt
    (part1_kernel_programming.jl:166)."""
    return max(0, math.floor((ttot - dt) / dt + 1e-12) + 1)
