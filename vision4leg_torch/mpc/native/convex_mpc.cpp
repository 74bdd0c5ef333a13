// Native convex-MPC core: condensed QP over contact forces.
//
// Rebuild of the reference's mpc_osqp.cc (MIT-style convex MPC: 13-dim
// single-rigid-body state, horizon-H condensed QP with friction-pyramid
// constraints) with a self-contained dense ADMM solver in place of the
// vendored OSQP/qpOASES libraries (not available here).  All linear
// algebra is hand-rolled (no Eigen): fixed-size matrix helpers, Pade-6
// scaling-and-squaring matrix exponential, dense Cholesky.
//
// Exposed via a C ABI consumed by vision4leg_tpu/mpc/native/mpc_osqp.py,
// which provides the reference's `mpc_osqp.ConvexMpc` Python surface
// (ctor signature and compute_contact_forces argument order match
// mpc_osqp.cc PYBIND11_MODULE :893-916).
//
// Build: make -C vision4leg_tpu/mpc/native

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kStateDim = 13;
constexpr int kConstraintDim = 5;
constexpr double kGravity = 9.8;
constexpr double kMaxScale = 10.0;

using Mat = std::vector<double>;  // row-major

inline double& at(Mat& m, int cols, int r, int c) { return m[r * cols + c]; }
inline double cat(const Mat& m, int cols, int r, int c) {
  return m[r * cols + c];
}

// C = A(mxk) * B(kxn)
void MatMul(const Mat& A, const Mat& B, Mat& C, int m, int k, int n) {
  C.assign(m * n, 0.0);
  for (int i = 0; i < m; ++i)
    for (int p = 0; p < k; ++p) {
      double a = A[i * k + p];
      if (a == 0.0) continue;
      const double* brow = &B[p * n];
      double* crow = &C[i * n];
      for (int j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
}

// C = A^T(kxm -> mxk) * B(kxn)
void MatTMul(const Mat& A, const Mat& B, Mat& C, int k, int m, int n) {
  C.assign(m * n, 0.0);
  for (int p = 0; p < k; ++p)
    for (int i = 0; i < m; ++i) {
      double a = A[p * m + i];
      if (a == 0.0) continue;
      const double* brow = &B[p * n];
      double* crow = &C[i * n];
      for (int j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
}

// Pade-6 scaling-and-squaring expm for an n x n matrix.
void Expm(Mat A, Mat& out, int n) {
  double norm = 0.0;
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += std::fabs(A[i * n + j]);
    norm = std::max(norm, s);
  }
  int squarings = 0;
  if (norm > 0.5) {
    squarings = std::max(0, (int)std::ceil(std::log2(norm / 0.5)));
    double scale = std::ldexp(1.0, -squarings);
    for (auto& v : A) v *= scale;
  }
  static const double c[7] = {1.0, 0.5, 5.0 / 44, 1.0 / 66, 1.0 / 792,
                              1.0 / 15840, 1.0 / 665280};
  Mat A2(n * n), A4(n * n), A6(n * n);
  MatMul(A, A, A2, n, n, n);
  MatMul(A2, A2, A4, n, n, n);
  MatMul(A4, A2, A6, n, n, n);
  Mat U(n * n, 0.0), V(n * n, 0.0);
  // U = A (c1 I + c3 A2 + c5 A4), V = c0 I + c2 A2 + c4 A4 + c6 A6
  Mat tmp(n * n, 0.0);
  for (int i = 0; i < n * n; ++i)
    tmp[i] = c[3] * A2[i] + c[5] * A4[i];
  for (int i = 0; i < n; ++i) tmp[i * n + i] += c[1];
  MatMul(A, tmp, U, n, n, n);
  for (int i = 0; i < n * n; ++i)
    V[i] = c[2] * A2[i] + c[4] * A4[i] + c[6] * A6[i];
  for (int i = 0; i < n; ++i) V[i * n + i] += c[0];
  // Solve (V - U) X = (V + U) by Gaussian elimination.
  Mat M(n * n), R(n * n);
  for (int i = 0; i < n * n; ++i) {
    M[i] = V[i] - U[i];
    R[i] = V[i] + U[i];
  }
  // Gaussian elimination with partial pivoting on [M | R]
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    int best = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(M[r * n + col]) > std::fabs(M[best * n + col])) best = r;
    if (best != col) {
      for (int j = 0; j < n; ++j) {
        std::swap(M[col * n + j], M[best * n + j]);
        std::swap(R[col * n + j], R[best * n + j]);
      }
    }
    double d = M[col * n + col];
    for (int j = 0; j < n; ++j) {
      M[col * n + j] /= d;
      R[col * n + j] /= d;
    }
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      double f = M[r * n + col];
      if (f == 0.0) continue;
      for (int j = 0; j < n; ++j) {
        M[r * n + j] -= f * M[col * n + j];
        R[r * n + j] -= f * R[col * n + j];
      }
    }
  }
  out = R;
  for (int s = 0; s < squarings; ++s) {
    MatMul(out, out, tmp, n, n, n);
    out = tmp;
  }
}

// In-place Cholesky (lower) of SPD n x n.
bool Cholesky(Mat& A, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      if (i == j) {
        if (s <= 0.0) return false;
        A[i * n + i] = std::sqrt(s);
      } else {
        A[i * n + j] = s / A[j * n + j];
      }
    }
  }
  return true;
}

void CholSolve(const Mat& L, const double* b, double* x, int n) {
  // forward
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * y[k];
    y[i] = s / L[i * n + i];
  }
  // backward (L^T)
  for (int i = n - 1; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

struct Mpc {
  double mass;
  double inertia[9];
  int num_legs;
  int horizon;
  double timestep;
  double qp_weights[kStateDim];
  double alpha;
};

}  // namespace

extern "C" {

void* mpc_create(double mass, const double* inertia, int num_legs,
                 int horizon, double timestep, const double* qp_weights,
                 double alpha) {
  Mpc* m = new Mpc();
  m->mass = mass;
  std::memcpy(m->inertia, inertia, 9 * sizeof(double));
  m->num_legs = num_legs;
  m->horizon = horizon;
  m->timestep = timestep;
  std::memcpy(m->qp_weights, qp_weights, kStateDim * sizeof(double));
  m->alpha = alpha;
  return m;
}

void mpc_destroy(void* h) { delete static_cast<Mpc*>(h); }

// Mirrors ConvexMpc::ComputeContactForces (mpc_osqp.cc:593-890).
// Outputs num_legs*3*horizon doubles (negated solution, like the
// reference); returns 0 on success.
int mpc_compute_contact_forces(
    void* h,
    const double* com_position, int com_position_len,
    const double* com_velocity, const double* com_rpy,
    const double* com_angular_velocity, const int* foot_contact_states,
    const double* foot_positions_body,  // num_legs * 3
    const double* foot_friction_coeffs,
    const double* desired_com_position, const double* desired_com_velocity,
    const double* desired_com_rpy, const double* desired_com_ang_vel,
    double* out_forces) {
  Mpc& m = *static_cast<Mpc*>(h);
  const int n = m.num_legs;
  const int H = m.horizon;
  const int adim = 3 * n;
  const int nu = adim * H;

  // rotation from rpy (extrinsic XYZ)
  double cr = std::cos(com_rpy[0]), sr = std::sin(com_rpy[0]);
  double cp = std::cos(com_rpy[1]), sp = std::sin(com_rpy[1]);
  double cy = std::cos(com_rpy[2]), sy = std::sin(com_rpy[2]);
  double R[9] = {
      cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
      sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
      -sp, cp * sr, cp * cr};

  // world-frame foot positions
  std::vector<double> foot_w(3 * n);
  for (int i = 0; i < n; ++i)
    for (int r = 0; r < 3; ++r)
      foot_w[i * 3 + r] = R[r * 3 + 0] * foot_positions_body[i * 3 + 0] +
                          R[r * 3 + 1] * foot_positions_body[i * 3 + 1] +
                          R[r * 3 + 2] * foot_positions_body[i * 3 + 2];

  double com_z;
  if (com_position_len == 3) {
    com_z = com_position[2];
  } else {
    double s = 0.0;
    int cnt = 0;
    for (int i = 0; i < n; ++i)
      if (foot_contact_states[i]) {
        s += foot_w[i * 3 + 2];
        ++cnt;
      }
    com_z = cnt ? std::fabs(s / cnt) : 0.0;
  }

  // A matrix (CalculateAMat)
  Mat A(kStateDim * kStateDim, 0.0);
  double cyaw = std::cos(com_rpy[2]), syaw = std::sin(com_rpy[2]);
  double cpitch = std::cos(com_rpy[1]), tpitch = std::tan(com_rpy[1]);
  at(A, kStateDim, 0, 6) = cyaw / cpitch;
  at(A, kStateDim, 0, 7) = syaw / cpitch;
  at(A, kStateDim, 1, 6) = -syaw;
  at(A, kStateDim, 1, 7) = cyaw;
  at(A, kStateDim, 2, 6) = cyaw * tpitch;
  at(A, kStateDim, 2, 7) = syaw * tpitch;
  at(A, kStateDim, 2, 8) = 1.0;
  at(A, kStateDim, 3, 9) = 1.0;
  at(A, kStateDim, 4, 10) = 1.0;
  at(A, kStateDim, 5, 11) = 1.0;
  at(A, kStateDim, 11, 12) = 1.0;

  // inv inertia world = R inv(I) R^T (3x3 inverse)
  double I[9];
  std::memcpy(I, m.inertia, sizeof(I));
  double det = I[0] * (I[4] * I[8] - I[5] * I[7]) -
               I[1] * (I[3] * I[8] - I[5] * I[6]) +
               I[2] * (I[3] * I[7] - I[4] * I[6]);
  double invI[9] = {
      (I[4] * I[8] - I[5] * I[7]) / det, (I[2] * I[7] - I[1] * I[8]) / det,
      (I[1] * I[5] - I[2] * I[4]) / det, (I[5] * I[6] - I[3] * I[8]) / det,
      (I[0] * I[8] - I[2] * I[6]) / det, (I[2] * I[3] - I[0] * I[5]) / det,
      (I[3] * I[7] - I[4] * I[6]) / det, (I[1] * I[6] - I[0] * I[7]) / det,
      (I[0] * I[4] - I[1] * I[3]) / det};
  double tmp3[9], invIw[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      tmp3[r * 3 + c] = R[r * 3 + 0] * invI[0 * 3 + c] +
                        R[r * 3 + 1] * invI[1 * 3 + c] +
                        R[r * 3 + 2] * invI[2 * 3 + c];
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      invIw[r * 3 + c] = tmp3[r * 3 + 0] * R[c * 3 + 0] +
                         tmp3[r * 3 + 1] * R[c * 3 + 1] +
                         tmp3[r * 3 + 2] * R[c * 3 + 2];

  // B matrix (CalculateBMat)
  Mat B(kStateDim * adim, 0.0);
  for (int i = 0; i < n; ++i) {
    double x = foot_w[i * 3], y = foot_w[i * 3 + 1], z = foot_w[i * 3 + 2];
    double skew[9] = {0, -z, y, z, 0, -x, -y, x, 0};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        double v = invIw[r * 3 + 0] * skew[0 * 3 + c] +
                   invIw[r * 3 + 1] * skew[1 * 3 + c] +
                   invIw[r * 3 + 2] * skew[2 * 3 + c];
        at(B, adim, 6 + r, i * 3 + c) = v;
      }
    at(B, adim, 9, i * 3 + 0) = 1.0 / m.mass;
    at(B, adim, 10, i * 3 + 1) = 1.0 / m.mass;
    at(B, adim, 11, i * 3 + 2) = 1.0 / m.mass;
  }

  // ZOH via expm of [[A, B],[0, 0]] * dt
  const int nd = kStateDim + adim;
  Mat AB(nd * nd, 0.0), ABe;
  for (int r = 0; r < kStateDim; ++r) {
    for (int c = 0; c < kStateDim; ++c)
      AB[r * nd + c] = cat(A, kStateDim, r, c) * m.timestep;
    for (int c = 0; c < adim; ++c)
      AB[r * nd + kStateDim + c] = cat(B, adim, r, c) * m.timestep;
  }
  Expm(AB, ABe, nd);
  Mat Ae(kStateDim * kStateDim), Be(kStateDim * adim);
  for (int r = 0; r < kStateDim; ++r) {
    for (int c = 0; c < kStateDim; ++c)
      Ae[r * kStateDim + c] = ABe[r * nd + c];
    for (int c = 0; c < adim; ++c)
      Be[r * adim + c] = ABe[r * nd + kStateDim + c];
  }

  // condensed matrices: a_qp (H*13 x 13), anb (H blocks of 13 x adim)
  Mat a_qp(H * kStateDim * kStateDim);
  Mat prev(Ae);
  std::memcpy(&a_qp[0], Ae.data(), Ae.size() * sizeof(double));
  for (int i = 1; i < H; ++i) {
    Mat next;
    MatMul(Ae, prev, next, kStateDim, kStateDim, kStateDim);
    std::memcpy(&a_qp[i * kStateDim * kStateDim], next.data(),
                next.size() * sizeof(double));
    prev = next;
  }
  std::vector<Mat> anb(H);
  anb[0] = Be;
  for (int i = 1; i < H; ++i)
    MatMul(Ae, anb[i - 1], anb[i], kStateDim, kStateDim, adim);

  // b_qp (H*13 x nu)
  Mat b_qp((size_t)H * kStateDim * nu, 0.0);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j <= i; ++j) {
      const Mat& blk = anb[i - j];
      for (int r = 0; r < kStateDim; ++r)
        for (int c = 0; c < adim; ++c)
          b_qp[(size_t)(i * kStateDim + r) * nu + j * adim + c] =
              blk[r * adim + c];
    }

  // state & reference trajectories
  std::vector<double> x0(kStateDim), xref(H * kStateDim);
  x0[0] = com_rpy[0];
  x0[1] = com_rpy[1];
  x0[2] = com_rpy[2];
  x0[3] = 0.0;
  x0[4] = 0.0;
  x0[5] = com_z;
  for (int i = 0; i < 3; ++i) x0[6 + i] = com_angular_velocity[i];
  for (int i = 0; i < 3; ++i) x0[9 + i] = com_velocity[i];
  x0[12] = -kGravity;
  for (int i = 0; i < H; ++i) {
    double* xr = &xref[i * kStateDim];
    xr[0] = desired_com_rpy[0];
    xr[1] = desired_com_rpy[1];
    xr[2] = com_rpy[2] + m.timestep * (i + 1) * desired_com_ang_vel[2];
    xr[3] = m.timestep * (i + 1) * desired_com_velocity[0];
    xr[4] = m.timestep * (i + 1) * desired_com_velocity[1];
    xr[5] = desired_com_position[2];
    xr[6] = desired_com_ang_vel[0];
    xr[7] = desired_com_ang_vel[1];
    xr[8] = desired_com_ang_vel[2];
    xr[9] = desired_com_velocity[0];
    xr[10] = desired_com_velocity[1];
    xr[11] = 0.0;
    xr[12] = -kGravity;
  }

  // P = 2 B^T L B + alpha I ; q = 2 B^T L (a_qp x0 - xref)
  std::vector<double> L((size_t)H * kStateDim);
  for (int i = 0; i < H; ++i)
    for (int r = 0; r < kStateDim; ++r)
      L[i * kStateDim + r] = m.qp_weights[r];
  std::vector<double> diff((size_t)H * kStateDim);
  for (int i = 0; i < H * kStateDim; ++i) {
    double s = 0.0;
    const int row = i;
    const int blk = row / kStateDim, r = row % kStateDim;
    for (int c = 0; c < kStateDim; ++c)
      s += a_qp[(size_t)(blk * kStateDim + r) * kStateDim + c] * x0[c];
    diff[i] = s - xref[i];
  }
  Mat LB((size_t)H * kStateDim * nu);
  for (size_t i = 0; i < (size_t)H * kStateDim; ++i)
    for (int j = 0; j < nu; ++j)
      LB[i * nu + j] = L[i] * b_qp[i * nu + j];
  Mat P;
  MatTMul(b_qp, LB, P, H * kStateDim, nu, nu);
  for (auto& v : P) v *= 2.0;
  for (int i = 0; i < nu; ++i) P[(size_t)i * nu + i] += m.alpha;
  std::vector<double> q(nu, 0.0);
  for (int i = 0; i < H * kStateDim; ++i) {
    double w = 2.0 * L[i] * diff[i];
    if (w == 0.0) continue;
    for (int j = 0; j < nu; ++j) q[j] += b_qp[(size_t)i * nu + j] * w;
  }

  // constraints: per (step, leg) block, 5 rows on 3 forces
  const int nc = H * n * kConstraintDim;
  double fz_max = m.mass * kGravity * kMaxScale;
  double mu = foot_friction_coeffs[0];

  // ADMM on: lb <= C u <= ub, with block-diagonal C.
  double cone[kConstraintDim][3] = {{-1, 0, mu},
                                    {1, 0, mu},
                                    {0, -1, mu},
                                    {0, 1, mu},
                                    {0, 0, 1}};

  // Jacobi equilibration (the dense-ADMM analog of OSQP's Ruiz step):
  // scale variables by d_i = 1/sqrt(P_ii), then constraint rows to unit
  // 2-norm.  Small SRB inertias (a1_sim.py's (0.017,0.057,0.064)*0.1)
  // put a ~1e7+ dynamic range on P's diagonal, and the unscaled splitting
  // barely moves off u=0 in 100 iterations; with scaling it converges to
  // the same fixed point as the x64 JAX solver.  Solution unscales as
  // u = D u_bar.
  std::vector<double> d(nu);
  for (int i = 0; i < nu; ++i)
    d[i] = 1.0 / std::sqrt(std::max(P[(size_t)i * nu + i], 1e-12));
  for (int i = 0; i < nu; ++i)
    for (int j = 0; j < nu; ++j) P[(size_t)i * nu + j] *= d[i] * d[j];
  for (int i = 0; i < nu; ++i) q[i] *= d[i];

  // per-(step,leg) scaled cone rows and their Gram blocks
  std::vector<double> coneb((size_t)H * n * kConstraintDim * 3);
  std::vector<double> erow((size_t)H * n * kConstraintDim);
  std::vector<double> Gb((size_t)H * n * 9, 0.0);
  for (int b = 0; b < H * n; ++b) {
    for (int k = 0; k < kConstraintDim; ++k) {
      double nrm2 = 0.0;
      double row[3];
      for (int c = 0; c < 3; ++c) {
        row[c] = cone[k][c] * d[b * 3 + c];
        nrm2 += row[c] * row[c];
      }
      double e = 1.0 / std::sqrt(std::max(nrm2, 1e-12));
      erow[(size_t)b * kConstraintDim + k] = e;
      for (int c = 0; c < 3; ++c)
        coneb[((size_t)b * kConstraintDim + k) * 3 + c] = row[c] * e;
    }
    for (int k = 0; k < kConstraintDim; ++k)
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          Gb[(size_t)b * 9 + r * 3 + c] +=
              coneb[((size_t)b * kConstraintDim + k) * 3 + r] *
              coneb[((size_t)b * kConstraintDim + k) * 3 + c];
  }

  double trace = 0.0;
  for (int i = 0; i < nu; ++i) trace += P[(size_t)i * nu + i];
  double rho = 0.1 * std::max(trace / nu, 1e-9);
  double sigma = 1e-6 * std::max(trace / nu, 1e-9);

  Mat K;
  auto factor = [&](double rho_v) {
    K = P;
    for (int i = 0; i < nu; ++i) K[(size_t)i * nu + i] += sigma;
    for (int b = 0; b < H * n; ++b)
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          K[(size_t)(b * 3 + r) * nu + b * 3 + c] +=
              rho_v * Gb[(size_t)b * 9 + r * 3 + c];
    return Cholesky(K, nu);
  };
  if (!factor(rho)) return -1;

  std::vector<double> lb(nc), ub(nc);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < n; ++j) {
      int row = (i * n + j) * kConstraintDim;
      double cs = foot_contact_states[j] ? 1.0 : 0.0;
      for (int k = 0; k < 4; ++k) {
        lb[row + k] = 0.0;
        ub[row + k] = (mu + 1.0) * fz_max * cs * erow[row + k];
      }
      lb[row + 4] = 0.0;
      ub[row + 4] = fz_max * cs * erow[row + 4];
    }

  std::vector<double> u(nu, 0.0), z(nc, 0.0), yv(nc, 0.0), rhs(nu),
      Cu(nc);
  auto apply_C = [&](const std::vector<double>& v, std::vector<double>& out) {
    for (int b = 0; b < H * n; ++b)
      for (int k = 0; k < kConstraintDim; ++k) {
        double s = 0.0;
        for (int c = 0; c < 3; ++c)
          s += coneb[((size_t)b * kConstraintDim + k) * 3 + c] * v[b * 3 + c];
        out[b * kConstraintDim + k] = s;
      }
  };
  // 300 iterations with OSQP-style adaptive-rho rebalancing every 50
  // (residual-ratio rule, OSQP sec. 5.2) — matches the JAX solver's
  // outer/inner structure; the dense refactorizations are <=120x120.
  const int iters = 300;
  const int adapt_every = 50;
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma u - q + C^T (rho z - y)
    for (int i = 0; i < nu; ++i) rhs[i] = sigma * u[i] - q[i];
    for (int b = 0; b < H * n; ++b)
      for (int k = 0; k < kConstraintDim; ++k) {
        double w = rho * z[b * kConstraintDim + k] -
                   yv[b * kConstraintDim + k];
        for (int c = 0; c < 3; ++c)
          rhs[b * 3 + c] +=
              coneb[((size_t)b * kConstraintDim + k) * 3 + c] * w;
      }
    CholSolve(K, rhs.data(), u.data(), nu);
    apply_C(u, Cu);
    for (int i = 0; i < nc; ++i) {
      double v = Cu[i] + yv[i] / rho;
      z[i] = std::min(std::max(v, lb[i]), ub[i]);
      yv[i] = yv[i] + rho * (Cu[i] - z[i]);
    }
    if ((it + 1) % adapt_every == 0 && it + 1 < iters) {
      double nAx = 0, nz = 0, rp2 = 0, rd2 = 0, nq = 0;
      for (int i = 0; i < nc; ++i) {
        nAx = std::max(nAx, std::abs(Cu[i]));
        nz = std::max(nz, std::abs(z[i]));
        double e = Cu[i] - z[i];
        rp2 += e * e;
      }
      // dual residual: P u + q + C^T y
      for (int i = 0; i < nu; ++i) {
        double s = q[i];
        for (int j = 0; j < nu; ++j) s += P[(size_t)i * nu + j] * u[j];
        rhs[i] = s;
        nq = std::max(nq, std::abs(q[i]));
      }
      for (int b = 0; b < H * n; ++b)
        for (int k = 0; k < kConstraintDim; ++k)
          for (int c = 0; c < 3; ++c)
            rhs[b * 3 + c] +=
                coneb[((size_t)b * kConstraintDim + k) * 3 + c] *
                yv[b * kConstraintDim + k];
      for (int i = 0; i < nu; ++i) rd2 += rhs[i] * rhs[i];
      double r_prim =
          std::sqrt(rp2) / std::max(std::max(nAx, nz), 1e-6);
      double r_dual = std::sqrt(rd2) / std::max(nq, 1e-6);
      double ratio = std::sqrt(r_prim / std::max(r_dual, 1e-12));
      ratio = std::min(std::max(ratio, 0.1), 10.0);
      double scale = std::max(trace / nu, 1e-9);
      double rho_new = std::min(std::max(rho * ratio, 1e-6 * scale),
                                1e6 * scale);
      if (rho_new != rho) {
        rho = rho_new;
        if (!factor(rho)) return -1;
      }
    }
  }

  // negated, unscaled solution, zeroed for non-contact legs
  // (mpc_osqp.cc:803-816)
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < n; ++j)
      for (int c = 0; c < 3; ++c) {
        int idx = (i * n + j) * 3 + c;
        int ui = i * adim + j * 3 + c;
        out_forces[idx] =
            foot_contact_states[j] ? -u[(size_t)ui] * d[ui] : 0.0;
      }
  return 0;
}

}  // extern "C"
