// Native numerics for pycollo_tpu: high-precision quadrature tables and
// barycentric interpolation/integration matrix builders.
//
// Role: the reference delegates native numerics to its dependencies
// (IPOPT/MUMPS/CasADi C++); this package's solver is JAX/XLA on-device,
// and this library provides the *host-side* native runtime pieces: the
// collocation tables are generated with 80-bit long-double Newton
// iteration on the Legendre polynomials (numpy's companion-matrix root
// finding loses accuracy near order 20, cf. the reference's stability
// warning in pycollo/quadrature.py:5-9), and the barycentric matrix
// builders are the hot host-side kernels of the mesh-refinement loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Legendre polynomial P_n(x) and derivative via the standard recurrence,
// in long double.
void legendre_pd(int n, long double x, long double* p, long double* dp) {
    long double p0 = 1.0L, p1 = x;
    if (n == 0) { *p = p0; *dp = 0.0L; return; }
    for (int k = 2; k <= n; ++k) {
        long double p2 = ((2.0L * k - 1.0L) * x * p1 - (k - 1.0L) * p0) / k;
        p0 = p1;
        p1 = p2;
    }
    *p = p1;
    // dP_n/dx = n (x P_n - P_{n-1}) / (x^2 - 1)
    long double denom = x * x - 1.0L;
    if (denom == 0.0L) denom = 1e-30L;
    *dp = n * (x * p1 - p0) / denom;
}

}  // namespace

extern "C" {

// n Legendre-Gauss-Lobatto points and weights on [-1, 1].
// points/weights must hold n doubles. Returns 0 on success.
int lgl_nodes_weights(int n, double* points, double* weights) {
    if (n < 2) return 1;
    const int m = n - 1;  // interior points are roots of P'_{n-1}
    points[0] = -1.0;
    points[n - 1] = 1.0;
    // Interior: roots of P'_{n-1}; initial guesses from Chebyshev-like
    // distribution, polished by Newton on P'_{n-1} (derivative via the
    // second-derivative ODE relation).
    for (int i = 1; i <= n - 2; ++i) {
        long double x = cosl((long double)M_PI * (1.0L - (long double)i / m));
        for (int it = 0; it < 100; ++it) {
            long double p, dp;
            legendre_pd(m, x, &p, &dp);
            // P''_{m} from the Legendre ODE:
            // (1-x^2) P'' - 2x P' + m(m+1) P = 0.
            long double one_m_x2 = 1.0L - x * x;
            if (one_m_x2 == 0.0L) break;
            long double ddp =
                (2.0L * x * dp - (long double)m * (m + 1) * p) / one_m_x2;
            if (ddp == 0.0L) break;
            long double dx = dp / ddp;
            x -= dx;
            if (fabsl(dx) < 1e-19L) break;
        }
        points[i] = (double)x;
    }
    for (int i = 0; i < n; ++i) {
        long double p, dp;
        legendre_pd(m, (long double)points[i], &p, &dp);
        weights[i] = (double)(2.0L / ((long double)n * m * p * p));
    }
    return 0;
}

// m left-Radau collocation points (roots of P_{m-1} + P_m, includes -1)
// and weights. points/weights must hold m doubles.
int lgr_nodes_weights(int m, double* points, double* weights) {
    if (m < 1) return 1;
    points[0] = -1.0;
    weights[0] = 2.0 / ((double)m * m);
    if (m == 1) return 0;
    // Interior roots of q(x) = P_{m-1}(x) + P_m(x); initial guesses from
    // Chebyshev-Gauss-Radau, Newton-polished in long double.
    for (int i = 1; i < m; ++i) {
        long double x =
            -cosl(2.0L * (long double)M_PI * i / (2.0L * m - 1.0L));
        for (int it = 0; it < 100; ++it) {
            long double p1, dp1, p2, dp2;
            legendre_pd(m - 1, x, &p1, &dp1);
            legendre_pd(m, x, &p2, &dp2);
            long double q = p1 + p2;
            long double dq = dp1 + dp2;
            if (dq == 0.0L) break;
            long double dx = q / dq;
            x -= dx;
            if (fabsl(dx) < 1e-19L) break;
        }
        points[i] = (double)x;
        long double p, dp;
        legendre_pd(m - 1, x, &p, &dp);
        weights[i] = (double)((1.0L - x) / ((long double)m * m * p * p));
    }
    return 0;
}

// Barycentric interpolation matrix: L[i*nc + j] = ell_j(xq[i]) for the
// Lagrange basis on the nc nodes xc, evaluated at nq query points.
int barycentric_interp_matrix(const double* xc, int nc, const double* xq,
                              int nq, double* L) {
    // Barycentric weights in long double.
    long double w[64];
    if (nc > 64) return 1;
    for (int j = 0; j < nc; ++j) {
        long double prod = 1.0L;
        for (int k = 0; k < nc; ++k) {
            if (k != j) prod *= (long double)xc[j] - (long double)xc[k];
        }
        w[j] = 1.0L / prod;
    }
    for (int i = 0; i < nq; ++i) {
        long double x = (long double)xq[i];
        // Exact-node hit -> identity row.
        int hit = -1;
        for (int j = 0; j < nc; ++j) {
            if (x == (long double)xc[j]) { hit = j; break; }
        }
        if (hit >= 0) {
            for (int j = 0; j < nc; ++j) L[i * nc + j] = (j == hit);
            continue;
        }
        long double denom = 0.0L;
        for (int j = 0; j < nc; ++j) denom += w[j] / (x - (long double)xc[j]);
        for (int j = 0; j < nc; ++j) {
            L[i * nc + j] =
                (double)((w[j] / (x - (long double)xc[j])) / denom);
        }
    }
    return 0;
}

}  // extern "C"
