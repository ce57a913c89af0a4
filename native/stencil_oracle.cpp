// Independent C++ double-precision stencil oracle.
//
// The reference validates its NS step against an external Fortran solver's
// field dumps (test/part2.jl); this library plays the same cross-language
// role for fpr_tpu's own tests: a from-scratch C++ implementation of
//   - the 2D Poisson/Helmholtz residual and damped-Jacobi sweep,
//   - one 3D pseudo-transient diffusion iteration,
// written without any shared code with the JAX path, invoked via ctypes.
// Agreement with the jnp/fused tiers at ~1e-15 is a strong independent
// correctness signal (tests/test_native.py).

#include <cstdint>
#include <cstring>

extern "C" {

// res = (u_E + u_W + u_N + u_S - (4 + c h^2) u)/h^2 - f on the interior of
// an (ny, nx) row-major grid; boundary ring zeroed.
void oracle_residual2d(const double* u, const double* f, double h, double c,
                       int32_t ny, int32_t nx, double* res) {
    const double C = 4.0 + c * h * h;
    const double inv_h2 = 1.0 / (h * h);
    std::memset(res, 0, sizeof(double) * static_cast<size_t>(ny) * nx);
    for (int32_t y = 1; y < ny - 1; ++y) {
        for (int32_t x = 1; x < nx - 1; ++x) {
            const size_t i = static_cast<size_t>(y) * nx + x;
            res[i] = (u[i + 1] + u[i - 1] + u[i + nx] + u[i - nx] - C * u[i]) *
                         inv_h2 -
                     f[i];
        }
    }
}

// One damped-Jacobi sweep: u += alpha h^2/(4 + c h^2) * res; returns
// sum(res^2) over the grid.
double oracle_jacobi2d(double* u, const double* f, double h, double c,
                       double alpha, int32_t ny, int32_t nx, double* scratch) {
    oracle_residual2d(u, f, h, c, ny, nx, scratch);
    const double w = alpha * h * h / (4.0 + c * h * h);
    double sumsq = 0.0;
    const size_t n = static_cast<size_t>(ny) * nx;
    for (size_t i = 0; i < n; ++i) {
        sumsq += scratch[i] * scratch[i];
        u[i] += w * scratch[i];
    }
    return sumsq;
}

// One pseudo-transient 3D diffusion iteration on (nz, ny, nx) row-major
// fields: htau_new = htau - dtau * ((htau - ht)/dt - D lap(htau)) in the
// interior; returns sum(dHdtau^2).
double oracle_dual_time3d(const double* ht, const double* htau, double dt,
                          double dtau, double dx, double dy, double dz,
                          double D, int32_t nz, int32_t ny, int32_t nx,
                          double* out) {
    const double ix2 = 1.0 / (dx * dx), iy2 = 1.0 / (dy * dy),
                 iz2 = 1.0 / (dz * dz), idt = 1.0 / dt;
    const size_t sy = nx, sz = static_cast<size_t>(nx) * ny;
    std::memcpy(out, htau, sizeof(double) * sz * nz);
    double sumsq = 0.0;
    for (int32_t z = 1; z < nz - 1; ++z) {
        for (int32_t y = 1; y < ny - 1; ++y) {
            for (int32_t x = 1; x < nx - 1; ++x) {
                const size_t i = z * sz + y * sy + x;
                const double lap =
                    (htau[i + 1] - 2.0 * htau[i] + htau[i - 1]) * ix2 +
                    (htau[i + sy] - 2.0 * htau[i] + htau[i - sy]) * iy2 +
                    (htau[i + sz] - 2.0 * htau[i] + htau[i - sz]) * iz2;
                const double d = (htau[i] - ht[i]) * idt - D * lap;
                sumsq += d * d;
                out[i] = htau[i] - dtau * d;
            }
        }
    }
    return sumsq;
}

}  // extern "C"
