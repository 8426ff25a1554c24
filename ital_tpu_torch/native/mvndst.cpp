// Genz sequentially-conditioned QMC multivariate-normal orthant probabilities.
//
// The host-side cross-check of the orthant probabilities of
// ital_tpu_torch/ops/mvn.py: the same algorithm and the same Richtmyer
// lattice, in double precision on the CPU, so the two can be compared to
// tight tolerance.
//
// Built at first use by ital_tpu_torch/utils/native.py:
//   g++ -O3 -shared -fPIC -o libmvndst_<hash>.so mvndst.cpp

#include <cmath>
#include <cstdint>

namespace {

const double kSqrt2 = 1.4142135623730951;
const double kEps = 1e-12;

inline double phi(double x) { return 0.5 * erfc(-x / kSqrt2); }

// Acklam's inverse normal CDF (|err| ~ 1.2e-9) — same as the JAX fast_ndtri.
double ndtri(double p) {
  static const double a[6] = {-3.969683028665376e+01, 2.209460984245205e+02,
                              -2.759285104469687e+02, 1.383577518672690e+02,
                              -3.066479806614716e+01, 2.506628277459239e+00};
  static const double b[5] = {-5.447609879822406e+01, 1.615858368580409e+02,
                              -1.556989798598866e+02, 6.680131188771972e+01,
                              -1.328068155288572e+01};
  static const double c[6] = {-7.784894002430293e-03, -3.223964580411365e-01,
                              -2.400758277161838e+00, -2.549732539343734e+00,
                              4.374664141464968e+00,  2.938163982698783e+00};
  static const double d[4] = {7.784695709041462e-03, 3.224671290700398e-01,
                              2.445134137142996e+00, 3.754408661907416e+00};
  const double plow = 0.02425;
  if (p < kEps) p = kEps;
  if (p > 1.0 - kEps) p = 1.0 - kEps;
  if (p < plow) {
    double q = std::sqrt(-2.0 * std::log(p));
    return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) /
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0);
  }
  if (p > 1.0 - plow) {
    double q = std::sqrt(-2.0 * std::log(1.0 - p));
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) /
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0);
  }
  double q = p - 0.5, r = q * q;
  return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q /
         (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0);
}

const double kPrimes[32] = {2,  3,  5,  7,  11, 13, 17, 19, 23,  29,  31,
                            37, 41, 43, 47, 53, 59, 61, 67, 71,  73,  79,
                            83, 89, 97, 101, 103, 107, 109, 113, 127, 131};

}  // namespace

extern "C" {

// P(signs_i * z_i > 0 for all i), z ~ N(mu, L L^T), for each of n_cfg sign
// configurations sharing one Cholesky factor.
//
//   mu:    [m]           mean
//   chol:  [m*m]         lower Cholesky factor, row-major
//   signs: [n_cfg * m]   each row in {-1.0, +1.0}
//   out:   [n_cfg]       orthant probabilities
void mvn_orthant_batch(const double* mu, const double* chol, const double* signs,
                       int m, int n_cfg, int n_points, double* out) {
  // Richtmyer lattice directions (match ital_tpu_torch.ops.mvn.richtmyer_lattice).
  double alpha[31];
  for (int j = 0; j < m - 1 && j < 31; ++j) alpha[j] = std::sqrt(kPrimes[j]);

  for (int cfg = 0; cfg < n_cfg; ++cfg) {
    const double* s = signs + cfg * m;
    const double lim0 = -mu[0];
    double c00 = chol[0] > 1e-6 ? chol[0] : 1e-6;
    double p0 = phi(lim0 / c00);
    double d0 = s[0] > 0 ? p0 : 0.0;
    double e0 = s[0] > 0 ? 1.0 : p0;
    if (m == 1) {
      out[cfg] = e0 - d0;
      continue;
    }
    double sum = 0.0;
    double y[32];
    for (int k = 1; k <= n_points; ++k) {
      double d = d0, e = e0, f = e0 - d0;
      for (int i = 1; i < m; ++i) {
        double w = std::fmod(k * alpha[i - 1], 1.0);
        double u = d + w * (e - d);
        y[i - 1] = ndtri(u);
        double dot = 0.0;
        for (int j = 0; j < i; ++j) dot += chol[i * m + j] * y[j];
        double cii = chol[i * m + i] > 1e-6 ? chol[i * m + i] : 1e-6;
        double t = (-mu[i] - dot) / cii;
        double pi = phi(t);
        d = s[i] > 0 ? pi : 0.0;
        e = s[i] > 0 ? 1.0 : pi;
        f *= (e - d);
      }
      sum += f;
    }
    out[cfg] = sum / n_points;
  }
}

}  // extern "C"
