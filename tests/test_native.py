"""Native C++ library: IO parity and the independent stencil oracle
(the cross-implementation-validation role the external Fortran solver plays
in the reference's tests)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from fpr_tpu.utils import native
from fpr_tpu.utils.io import load_fortran, save_fortran

FIX = os.path.join(os.path.dirname(__file__), "fixtures")

@pytest.fixture(autouse=True)
def lib():
    """Build/load the library at run time (never while the module is
    imported: every test worker must collect the same tests)."""
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no g++?)")
    return lib


def test_native_io_matches_numpy(tmp_path, rng):
    ref = load_fortran(os.path.join(FIX, "Winit.bin"))
    got = native.load_fortran_native(os.path.join(FIX, "Winit.bin"))
    np.testing.assert_array_equal(got, ref)

    a = rng.random((17, 33))
    p = tmp_path / "x.bin"
    assert native.save_fortran_native(p, a)
    np.testing.assert_array_equal(load_fortran(p), a)
    np.testing.assert_array_equal(native.load_fortran_native(p), a)


def test_cpp_oracle_residual_matches_jnp(rng):
    from fpr_tpu.ops import stencil2d

    u = rng.random((33, 65))
    f = rng.random((33, 65))
    h, c = 1.0 / 32, 2.5
    got = native.oracle_residual2d(u, f, h, c)
    ref = np.asarray(stencil2d.residual(jnp.asarray(u), jnp.asarray(f), h, c))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-10)


def test_cpp_oracle_jacobi_matches_jnp(rng):
    from fpr_tpu.ops import stencil2d

    u = rng.random((33, 65))
    f = rng.random((33, 65))
    h, c = 1.0 / 32, 0.0
    got_u, got_ss = native.oracle_jacobi2d(u, f, h, c)
    ref_u, ref_rms = stencil2d.jacobi_step(jnp.asarray(u), jnp.asarray(f), h, c)
    np.testing.assert_allclose(got_u, np.asarray(ref_u), atol=1e-13)
    assert np.sqrt(got_ss / u.size) == pytest.approx(float(ref_rms), rel=1e-12)


def test_cpp_oracle_dual_time_matches_jnp(rng):
    from fpr_tpu.ops import stencil3d

    shape = (10, 12, 14)
    ht = rng.random(shape)
    htau = rng.random(shape)
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
    got, got_ss = native.oracle_dual_time3d(ht, htau, **args)
    ref, ref_ss = stencil3d.dual_time_step(jnp.asarray(ht), jnp.asarray(htau), **args)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-13)
    assert got_ss == pytest.approx(float(ref_ss), rel=1e-12)
