"""Counted-operation performance model.

The reference's analytic model (BenchResults, part1_kernel_programming.jl:22-29,
208-217): work and memory traffic are *counted* from the stencil definition,
not measured, giving an effective throughput T_eff = Memory / time that is
comparable across machines:

- 25 FLOP per interior cell per pseudo-time iteration for the fused dual-time
  step + 2 for the norm (docstrings part1_kernel_programming.jl:32-45,60-74);
- memory: (14+1) words/cell for the plain kernel (9 reads of Htau + read Ht +
  rw dHdtau + rw Htau2 + norm read), (6+1) for the shared-memory variant
  (single Htau read via the tile); a fused step moves (2 reads + 1 write +
  1 norm-read-equivalent) = the reference's "ideal" A_eff, counted as
  (2+1)+1 words.

``word_bytes`` follows the array dtype (the reference is f64-only; the
benchmark runs f32), so T_eff is a counted bytes/s for each precision —
not the traffic the device actually moved.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Robust repeated-measurement summary (the analog of the reference's
    BenchmarkTools medians, part1_benchmark.jl:59-65): every headline
    number is a median over >= 3 repetitions with the IQR as the
    dispersion column.
    """

    median_s: float
    iqr_s: float
    min_s: float
    reps: int

    def row(self) -> dict:
        return {
            "median_s": self.median_s,
            "iqr_s": self.iqr_s,
            "min_s": self.min_s,
            "reps": self.reps,
        }


def timed_stats(fn, reps: int = 3) -> TimingStats:
    """Time ``fn()`` ``reps`` times and summarize.  ``fn`` must end in
    ``jax.block_until_ready`` on its results (dispatch is asynchronous);
    the caller warms up/compiles before calling this."""
    import numpy as np

    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return TimingStats(
        median_s=float(np.median(t)),
        iqr_s=float(np.percentile(t, 75) - np.percentile(t, 25)),
        min_s=float(t.min()),
        reps=len(times),
    )


@dataclasses.dataclass(frozen=True)
class BenchResults:
    delta_t: float          # seconds of timed compute (warmup excluded)
    work: float             # FLOPs
    performance: float      # FLOP/s
    memory: float           # bytes
    intensity: float        # FLOP/byte
    throughput: float       # bytes/s (T_eff)

    def row(self) -> dict:
        return {
            "delta_t": self.delta_t,
            "work": self.work,
            "performance": self.performance,
            "memory": self.memory,
            "intensity": self.intensity,
            "throughput": self.throughput,
        }


# words moved per interior cell per iteration, by counting model
MEMORY_MODEL_WORDS = {
    "plain": 14 + 1,     # reference kernel without shared memory
    "shmem": 6 + 1,      # reference shared-memory kernel
    "fused": 3 + 1,      # fused step: read Ht, read Htau, write Htau'
}

FLOPS_PER_CELL = 25 + 2  # stencil + norm contribution


def diffusion_bench_results(
    delta_t: float,
    iters_total: int,
    nx: int,
    ny: int,
    nz: int,
    word_bytes: int,
    model: str = "fused",
    n_devices: int = 1,
) -> BenchResults:
    """Aggregate counted results over devices (the reference multiplies its
    local counts by the rank count, part1_kernel_programming.jl:208-217)."""
    cells = (nx - 2) * (ny - 2) * (nz - 2)
    work = n_devices * iters_total * FLOPS_PER_CELL * cells
    memory = n_devices * iters_total * MEMORY_MODEL_WORDS[model] * word_bytes * cells
    delta_t = max(delta_t, 1e-12)
    return BenchResults(
        delta_t=delta_t,
        work=work,
        performance=work / delta_t,
        memory=memory,
        intensity=work / memory,
        throughput=memory / delta_t,
    )
