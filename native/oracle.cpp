// Native f64 verification oracle for safe_exploration_tpu.
//
// Role: an INDEPENDENT C++ implementation of the framework's load-bearing
// numerics — ellipsoid calculus, Lipschitz remainders, Cholesky/TRSM, the
// SDA Riccati solver, and the RBF GP posterior — used by the test suite as a
// cross-LANGUAGE oracle (tests/test_native_oracle.py). This mirrors the
// reference's cross-implementation equivalence strategy (numpy vs CasADi vs
// torch — SURVEY.md §4.1) with the reference's own native layer (LAPACK /
// CasADi C++ — SURVEY.md §2.10) replaced by first-party code. It is also the
// fp64 gold standard behind the "f64-equivalent tolerance" Cholesky gate
// (BASELINE.md): the f32 device code is validated against these values.
//
// Self-contained: no BLAS/LAPACK/Eigen; small-n dense routines only (n <= a
// few hundred in tests). Exported with a C ABI for ctypes.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline double &at(double *m, int n, int i, int j) { return m[i * n + j]; }
inline double cat(const double *m, int n, int i, int j) { return m[i * n + j]; }

// Dense LU solve with partial pivoting: X = A^{-1} B, A (n,n), B (n,m).
// Returns false on (numerically) singular A.
bool lu_solve(const double *a_in, const double *b_in, int n, int m, double *x) {
  std::vector<double> a(a_in, a_in + n * n);
  std::memcpy(x, b_in, sizeof(double) * n * m);
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int k = 0; k < n; ++k) {
    int p = k;
    double best = std::fabs(at(a.data(), n, k, k));
    for (int i = k + 1; i < n; ++i) {
      double v = std::fabs(at(a.data(), n, i, k));
      if (v > best) { best = v; p = i; }
    }
    if (best < 1e-300) return false;
    if (p != k) {
      for (int j = 0; j < n; ++j) std::swap(at(a.data(), n, k, j), at(a.data(), n, p, j));
      for (int j = 0; j < m; ++j) std::swap(x[k * m + j], x[p * m + j]);
    }
    const double pivot = at(a.data(), n, k, k);
    for (int i = k + 1; i < n; ++i) {
      const double f = at(a.data(), n, i, k) / pivot;
      at(a.data(), n, i, k) = f;
      for (int j = k + 1; j < n; ++j) at(a.data(), n, i, j) -= f * at(a.data(), n, k, j);
      for (int j = 0; j < m; ++j) x[i * m + j] -= f * x[k * m + j];
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    for (int j = 0; j < m; ++j) {
      double s = x[k * m + j];
      for (int i = k + 1; i < n; ++i) s -= at(a.data(), n, k, i) * x[i * m + j];
      x[k * m + j] = s / at(a.data(), n, k, k);
    }
  }
  return true;
}

void matmul(const double *a, const double *b, int n, int k, int m, double *out) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      double s = 0.0;
      for (int l = 0; l < k; ++l) s += a[i * k + l] * b[l * m + j];
      out[i * m + j] = s;
    }
}

}  // namespace

extern "C" {

// --- ellipsoid calculus (parity: ops/ellipsoid.py) --------------------------

void ellipsoid_sum(const double *p1, const double *q1, const double *p2,
                   const double *q2, int n, double *p_out, double *q_out) {
  const double eps = 1e-30;
  double t1 = eps, t2 = eps;
  for (int i = 0; i < n; ++i) { t1 += cat(q1, n, i, i); t2 += cat(q2, n, i, i); }
  const double c = std::sqrt(t1 / t2);
  for (int i = 0; i < n; ++i) p_out[i] = p1[i] + p2[i];
  for (int i = 0; i < n * n; ++i) q_out[i] = (1.0 + 1.0 / c) * q1[i] + (1.0 + c) * q2[i];
}

void ellipsoid_from_rect(const double *ub, int n, double *q_out) {
  std::memset(q_out, 0, sizeof(double) * n * n);
  for (int i = 0; i < n; ++i) at(q_out, n, i, i) = double(n) * ub[i] * ub[i];
}

// --- Lipschitz remainders (parity: ops/lipschitz.py) ------------------------

void remainder_overapprox(const double *q, const double *k_fb,
                          const double *l_mu, const double *l_sigma, int n_s,
                          int n_u, int n_out, int iters, double *u_mu,
                          double *u_sigma) {
  // B = S^T S with S = [I; k_fb];  M = Q B;  r^2 = lambda_max(M) by power iter
  std::vector<double> b(n_s * n_s), m(n_s * n_s);
  for (int i = 0; i < n_s; ++i)
    for (int j = 0; j < n_s; ++j) {
      double s = (i == j) ? 1.0 : 0.0;
      for (int k = 0; k < n_u; ++k) s += k_fb[k * n_s + i] * k_fb[k * n_s + j];
      b[i * n_s + j] = s;
    }
  matmul(q, b.data(), n_s, n_s, n_s, m.data());
  // identical start vector + iteration scheme as ops/lipschitz.py
  std::vector<double> v(n_s), w(n_s);
  double nrm = 0.0;
  for (int i = 0; i < n_s; ++i) { v[i] = 1.0 + 1e-3 * i; nrm += v[i] * v[i]; }
  nrm = std::sqrt(nrm);
  for (int i = 0; i < n_s; ++i) v[i] /= nrm;
  for (int it = 0; it < iters; ++it) {
    matmul(m.data(), v.data(), n_s, n_s, 1, w.data());
    double wn = 0.0;
    for (int i = 0; i < n_s; ++i) wn += w[i] * w[i];
    wn = std::sqrt(wn) + 1e-30;
    for (int i = 0; i < n_s; ++i) v[i] = w[i] / wn;
  }
  matmul(m.data(), v.data(), n_s, n_s, 1, w.data());
  double num = 0.0, den = 1e-30;
  for (int i = 0; i < n_s; ++i) { num += v[i] * w[i]; den += v[i] * v[i]; }
  double r_sqr = num / den;
  if (r_sqr < 0.0) r_sqr = 0.0;
  for (int d = 0; d < n_out; ++d) {
    u_mu[d] = 0.5 * l_mu[d] * r_sqr;
    u_sigma[d] = l_sigma[d] * std::sqrt(r_sqr);
  }
}

// --- dense Cholesky / triangular solves (parity: ops/pallas, jnp oracles) ---

int cholesky(const double *a, int n, double *l_out) {
  std::memset(l_out, 0, sizeof(double) * n * n);
  for (int j = 0; j < n; ++j) {
    double d = cat(a, n, j, j);
    for (int k = 0; k < j; ++k) d -= cat(l_out, n, j, k) * cat(l_out, n, j, k);
    if (d <= 0.0) return 1;  // not PD
    d = std::sqrt(d);
    at(l_out, n, j, j) = d;
    for (int i = j + 1; i < n; ++i) {
      double s = cat(a, n, i, j);
      for (int k = 0; k < j; ++k) s -= cat(l_out, n, i, k) * cat(l_out, n, j, k);
      at(l_out, n, i, j) = s / d;
    }
  }
  return 0;
}

// Solve L X = B (transpose == 0) or L^T X = B (transpose == 1); B is (n, m).
void trsm_lower(const double *l, const double *b, int n, int m, int transpose,
                double *x) {
  std::memcpy(x, b, sizeof(double) * n * m);
  if (!transpose) {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < m; ++j) {
        double s = x[i * m + j];
        for (int k = 0; k < i; ++k) s -= cat(l, n, i, k) * x[k * m + j];
        x[i * m + j] = s / cat(l, n, i, i);
      }
  } else {
    for (int i = n - 1; i >= 0; --i)
      for (int j = 0; j < m; ++j) {
        double s = x[i * m + j];
        for (int k = i + 1; k < n; ++k) s -= cat(l, n, k, i) * x[k * m + j];
        x[i * m + j] = s / cat(l, n, i, i);
      }
  }
}

// --- DARE via structure-preserving doubling (parity: ops/linalg.dare_sda) ---

int dare_sda(const double *a_in, const double *b_in, const double *q_in,
             const double *r_in, int n, int m, int iters, double *x_out) {
  std::vector<double> ak(a_in, a_in + n * n), gk(n * n), hk(q_in, q_in + n * n);
  // G0 = B R^{-1} B^T
  std::vector<double> rinv_bt(m * n);
  {
    std::vector<double> bt(m * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < m; ++j) bt[j * n + i] = b_in[i * m + j];
    if (!lu_solve(r_in, bt.data(), m, n, rinv_bt.data())) return 1;
    matmul(b_in, rinv_bt.data(), n, m, n, gk.data());
  }
  std::vector<double> igh(n * n), w(n * n), wg(n * n), tmp(n * n), tmp2(n * n);
  for (int it = 0; it < iters; ++it) {
    // igh = I + G H
    matmul(gk.data(), hk.data(), n, n, n, igh.data());
    for (int i = 0; i < n; ++i) igh[i * n + i] += 1.0;
    if (!lu_solve(igh.data(), ak.data(), n, n, w.data())) return 1;   // (I+GH)^-1 A
    if (!lu_solve(igh.data(), gk.data(), n, n, wg.data())) return 1;  // (I+GH)^-1 G
    // A' = A W ; G' = G + A WG A^T ; H' = H + A^T H W
    std::vector<double> a_next(n * n);
    matmul(ak.data(), w.data(), n, n, n, a_next.data());
    matmul(ak.data(), wg.data(), n, n, n, tmp.data());
    std::vector<double> at_(n * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) at_[i * n + j] = ak[j * n + i];
    matmul(tmp.data(), at_.data(), n, n, n, tmp2.data());
    for (int i = 0; i < n * n; ++i) gk[i] += tmp2[i];
    matmul(hk.data(), w.data(), n, n, n, tmp.data());
    matmul(at_.data(), tmp.data(), n, n, n, tmp2.data());
    for (int i = 0; i < n * n; ++i) hk[i] += tmp2[i];
    // symmetrize
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < i; ++j) {
        double g = 0.5 * (gk[i * n + j] + gk[j * n + i]);
        gk[i * n + j] = gk[j * n + i] = g;
        double h = 0.5 * (hk[i * n + j] + hk[j * n + i]);
        hk[i * n + j] = hk[j * n + i] = h;
      }
    ak.swap(a_next);
  }
  std::memcpy(x_out, hk.data(), sizeof(double) * n * n);
  return 0;
}

// --- RBF GP posterior (parity: models/gp.gp_predict, rbf kernel) ------------
//
// mean = k(z, X) . beta ; var = sf2 - || L^{-1} (mask * k(z, X)) ||^2
// with ARD lengthscales; masked columns contribute nothing.
void rbf_posterior(const double *x, const double *mask, const double *beta,
                   const double *chol_l, const double *z,
                   const double *lengthscales, double sf2, int n, int d,
                   double *mean_out, double *var_out) {
  std::vector<double> kv(n);
  for (int i = 0; i < n; ++i) {
    double d2 = 0.0;
    for (int j = 0; j < d; ++j) {
      const double dz = (z[j] - x[i * d + j]) / lengthscales[j];
      d2 += dz * dz;
    }
    kv[i] = sf2 * std::exp(-0.5 * d2) * mask[i];
  }
  double mean = 0.0;
  for (int i = 0; i < n; ++i) mean += kv[i] * beta[i];
  *mean_out = mean;
  std::vector<double> v(n);
  trsm_lower(chol_l, kv.data(), n, 1, 0, v.data());
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += v[i] * v[i];
  double var = sf2 - s;
  *var_out = var > 1e-12 ? var : 1e-12;
}

}  // extern "C"

// --- end-to-end one-step ellipsoidal reachability (parity: reachability/
// onestep.py::onestep_reachability) -----------------------------------------
//
// Composes the pieces above: RBF GP posterior (+ ANALYTIC mean Jacobian —
// independent of JAX's jacfwd), closed-loop linearization, Lipschitz
// remainders, confidence box, two Minkowski sums. Per output dim d the GP has
// its own ARD lengthscales ls[d*dim+j], signal variance sf2[d], noise noise[d],
// weights beta[d*n+i] and Cholesky chol[d*n*n+...]; shared inputs X (n, dim)
// and mask. z = (p, k_ff) is the query; dim = n_s + n_u.
extern "C" void onestep_reachability(
    const double *x, const double *mask, const double *beta,
    const double *chol, const double *ls, const double *sf2,
    const double *noise, const double *l_mu, const double *l_sigma,
    const double *p, const double *q, const double *k_ff, const double *k_fb,
    const double *a, const double *b, double c_safety, int n, int n_s,
    int n_u, double *p_out, double *q_out) {
  const int dim = n_s + n_u;
  std::vector<double> z(dim);
  for (int i = 0; i < n_s; ++i) z[i] = p[i];
  for (int i = 0; i < n_u; ++i) z[n_s + i] = k_ff[i];

  std::vector<double> mu(n_s), var(n_s), jmu(n_s * dim);
  std::vector<double> kv(n), v(n);
  for (int d = 0; d < n_s; ++d) {
    const double *lsd = ls + d * dim;
    for (int i = 0; i < n; ++i) {
      double d2 = 0.0;
      for (int j = 0; j < dim; ++j) {
        const double dz = (z[j] - x[i * dim + j]) / lsd[j];
        d2 += dz * dz;
      }
      kv[i] = sf2[d] * std::exp(-0.5 * d2) * mask[i];
    }
    double m = 0.0;
    for (int i = 0; i < n; ++i) m += kv[i] * beta[d * n + i];
    mu[d] = m;
    // analytic gradient: dmu/dz_j = sum_i beta_i k_i * (x_ij - z_j) / ls_j^2
    for (int j = 0; j < dim; ++j) {
      double g = 0.0;
      for (int i = 0; i < n; ++i)
        g += beta[d * n + i] * kv[i] * (x[i * dim + j] - z[j]) /
             (lsd[j] * lsd[j]);
      jmu[d * dim + j] = g;
    }
    trsm_lower(chol + d * n * n, kv.data(), n, 1, 0, v.data());
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += v[i] * v[i];
    double vv = sf2[d] - s;
    var[d] = vv > 1e-12 ? vv : 1e-12;
  }

  // p_next = a p + b k_ff + mu
  for (int i = 0; i < n_s; ++i) {
    double s = mu[i];
    for (int j = 0; j < n_s; ++j) s += a[i * n_s + j] * p[j];
    for (int j = 0; j < n_u; ++j) s += b[i * n_u + j] * k_ff[j];
    p_out[i] = s;
  }

  // H = a + J_x + (b + J_u) k_fb ; Q_lin = H Q H^T
  std::vector<double> h(n_s * n_s);
  for (int i = 0; i < n_s; ++i)
    for (int j = 0; j < n_s; ++j) {
      double s = a[i * n_s + j] + jmu[i * dim + j];
      for (int k = 0; k < n_u; ++k)
        s += (b[i * n_u + k] + jmu[i * dim + n_s + k]) * k_fb[k * n_s + j];
      h[i * n_s + j] = s;
    }
  std::vector<double> hq(n_s * n_s), q_lin(n_s * n_s);
  matmul(h.data(), q, n_s, n_s, n_s, hq.data());
  std::vector<double> ht(n_s * n_s);
  for (int i = 0; i < n_s; ++i)
    for (int j = 0; j < n_s; ++j) ht[i * n_s + j] = h[j * n_s + i];
  matmul(hq.data(), ht.data(), n_s, n_s, n_s, q_lin.data());

  // remainders + confidence box (same formulas as the exported pieces)
  std::vector<double> u_mu(n_s), u_sigma(n_s);
  remainder_overapprox(q, k_fb, l_mu, l_sigma, n_s, n_u, n_s, 30,
                       u_mu.data(), u_sigma.data());
  std::vector<double> conf(n_s), q_taylor(n_s * n_s), q_conf(n_s * n_s);
  for (int d = 0; d < n_s; ++d)
    conf[d] = c_safety * (std::sqrt(var[d] + noise[d]) + u_sigma[d]);
  ellipsoid_from_rect(u_mu.data(), n_s, q_taylor.data());
  ellipsoid_from_rect(conf.data(), n_s, q_conf.data());

  // Minkowski: (p_next, q_lin) (+) (0, q_conf) (+) (0, q_taylor)
  std::vector<double> zero(n_s, 0.0), p_tmp(n_s), q_tmp(n_s * n_s);
  ellipsoid_sum(p_out, q_lin.data(), zero.data(), q_conf.data(), n_s,
                p_tmp.data(), q_tmp.data());
  ellipsoid_sum(p_tmp.data(), q_tmp.data(), zero.data(), q_taylor.data(), n_s,
                p_out, q_out);
}
