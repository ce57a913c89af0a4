"""I/O utilities.

- ``load_fortran`` / ``save_fortran``: the reference's Fortran binary field
  format — int32 nx, int32 ny header then float64 data, column-major (nx, ny)
  (loader spec at part2_utils.jl:11-19).  Returned as our row-major (ny, nx)
  layout; round-trips bit-exactly.
- ``append_csv_row``: lock-protected CSV accumulation with resume-by-skip —
  the harness behavior of part1_benchmark.jl:83-94 (Pidfile lock) and
  run_all_benchmarks.sh:18-20 (skip when the result already exists).
"""

from __future__ import annotations

import csv
import fcntl
import os
from pathlib import Path

import numpy as np


def load_fortran(path) -> np.ndarray:
    """Read an (nx, ny) column-major f64 field -> (ny, nx) row-major array.

    Uses the native C++ reader (fpr_tpu.utils.native, bit-identical — see
    tests/test_native.py) when the library is available, else numpy.
    """
    from fpr_tpu.utils import native

    try:
        out = native.load_fortran_native(path)
        if out is not None:
            return out
    except IOError:
        raise
    except Exception as e:  # pragma: no cover - native-reader regression
        # only library-unavailable is a silent fallback; a native reader that
        # RAISES (shape/ABI regression) must be heard, or the bit-parity
        # guarantee the native tier provides is silently weakened
        import warnings

        warnings.warn(f"native Fortran reader failed ({e!r}); numpy fallback")
    with open(path, "rb") as f:
        nx = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        ny = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        data = np.fromfile(f, dtype=np.float64, count=nx * ny)
    if data.size != nx * ny:
        raise ValueError(f"{path}: expected {nx}x{ny} f64 payload, got {data.size}")
    # column-major (nx, ny) memory order == row-major (ny, nx)
    return data.reshape(ny, nx)


def save_fortran(path, arr: np.ndarray) -> None:
    """Write an (ny, nx) array in the reference's binary format."""
    ny, nx = arr.shape
    with open(path, "wb") as f:
        np.asarray([nx], dtype=np.int32).tofile(f)
        np.asarray([ny], dtype=np.int32).tofile(f)
        np.ascontiguousarray(arr, dtype=np.float64).tofile(f)


def append_csv_row(path, row: dict, key_fields=()) -> bool:
    """Append a row under an exclusive lock; skip if a row with the same
    key_fields values already exists (cheap resume).  Returns True if written.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a+", newline="") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.seek(0)
            existing = list(csv.DictReader(f))
            if key_fields:
                key = tuple(str(row[k]) for k in key_fields)
                for r in existing:
                    if tuple(r.get(k, "") for k in key_fields) == key:
                        return False
            f.seek(0, os.SEEK_END)
            if f.tell() == 0:
                writer = csv.DictWriter(f, fieldnames=list(row.keys()))
                writer.writeheader()
            else:
                # align with the existing header; a disjoint schema is a bug
                f.seek(0)
                header = next(csv.reader(f))
                missing = [k for k in row if k not in header]
                if missing:
                    raise ValueError(
                        f"{path}: row fields {missing} not in existing header {header}"
                    )
                f.seek(0, os.SEEK_END)
                writer = csv.DictWriter(f, fieldnames=header, restval="")
            writer.writerow(row)
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def csv_has_row(path, key: dict) -> bool:
    """True if a row matching all key fields already exists (check BEFORE
    running an expensive config — the resume-by-skip of
    run_all_benchmarks.sh:18-20)."""
    path = Path(path)
    if not path.exists():
        return False
    with open(path) as f:
        for r in csv.DictReader(f):
            if all(r.get(k, "") == str(v) for k, v in key.items()):
                return True
    return False


def csv_has_rows(path) -> bool:
    path = Path(path)
    if not path.exists():
        return False
    with open(path) as f:
        return len(list(csv.DictReader(f))) > 0
