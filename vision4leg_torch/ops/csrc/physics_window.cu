// Physics window of the A1 quadruped: n_substeps of PD motors, rigid-body
// dynamics, penalty contacts and semi-implicit Euler for every env, plus
// the post-window contact read.  One CUDA thread per env.
//
// Replaces the TPU kernel vision4leg_tpu/ops/physics_kernel.py:122
// (robot_window_pallas, whose math is ops/physics_envlast.py:494 window),
// its hybrid-control mode included (physics_kernel.py:125-136, math at
// physics_envlast.py:534-535): with `hybrid` set, joint j's torque is
// (1 - m_j) PD_j + m_j tau_ff_j, with tau_ff and the mask m read from 24
// parameter rows after the spheres and fixed across the window (the MPC
// env: swing legs under PD, stance legs on the MPC's feedforward torque).
// Its plain PyTorch version is vision4leg_torch/ops/physics_envlast.py.
//
// What bounds it on an H100: neither bytes nor FLOPs.  A window at 1024
// envs must move 6.2 MB (1.9 us at 3.35 TB/s) and needs ~0.35 GFLOP on
// rollout states (5.2 us at the 67 TFLOP/s non-tensor f32 peak; the least
// the function needs, counted by ops/window_cost.py).  The work is a long
// dependent chain per env (16 substeps x [tree sweep -> 18x18 mass matrix
// -> 20 contact points -> 16 CG iterations]), and 1024 envs give only 32
// warps for 132 SMs, so the kernel runs at the latency of one thread's
// serial chain: 2.8-3.3 ms per window at 1024 envs on an H100 80GB HBM3
// at a 700 W power limit (chip_smoke.py).
//
// Design: env-last (structure-of-arrays) inputs, so the loads and stores
// of a warp's 32 envs coalesce; one block of 32 threads per warp of envs
// to spread the few warps over as many SMs as possible.  Per-thread
// working sets (13 body frames, the velocity recursion and the 18x18
// mass matrix: ~3 KB) do not fit in the 255-register budget, so they live
// in thread-local arrays that the compiler places in local memory and L1
// serves; the build prints ptxas's register and spill counts.  The
// substep loop, the CG loop and the per-body sweep are kept rolled
// (`#pragma unroll 1`) so the build takes seconds.  The mass matrix and
// bias forces are accumulated body by body over each body's active
// columns only (6 base dofs + at most 3 ancestor joints), not as full
// 3x18 Jacobian products.  Model constants (inertias, joint frames,
// contact points) come from one small device buffer that every thread
// reads at the same address; the tree topology is compile-time constant
// and the wrapper checks the model against it.  The kernel is a template
// on its scalar type: the float instantiation is the one the env runs,
// the double one lets the kernel be held against the plain version in
// float64, where rounding cannot hide a fault.
//
// Rounding: the source is built with -fmad=false (ops/nvcc.py
// EXTRA_FLAGS), so that each product and each sum is rounded on its own,
// as in the plain version and in the JAX package.  With nvcc's default
// contraction of a * b + c into one FMA, the float32 kernel departed from
// both in one env of tests/test_torch_kernel_cuda.py's sphere case: at its
// third substep a foot sphere's ground penetration rad - x.z came out
// -3.7e-9 m where the plain version, the host build of this source and
// the float64 run give +1e-8 m, so the penalty contact, whose damping
// term -150 v_n is already tens of newtons at first touch, stayed off for
// one substep, and joint velocities parted by 2.4 rad/s
// (tools/window_case_report.py --locate traces it).  Without contraction
// the kernel is one more float32 rounding of the same sums and stays
// within the env's own float32 spread.
#include <cuda_runtime.h>

#define NB 13          // bodies (0 = trunk)
#define NJ 12          // revolute joints; body b's joint is b - 1
#define NV 18          // generalized velocity: 6 base dofs + 12 joints
#define NCP 20         // collision spheres
#define HLEN 20        // observation-history depth
#define HDIM 31        // record: q(12) qd(12) quat(4) omega(3)

// state rows (each row holds E floats)
#define S_POS 0
#define S_QUAT 3
#define S_Q 7
#define S_ANG 19
#define S_LIN 22
#define S_QD 25
#define S_TAU 37
#define S_HIST 49
#define NS (S_HIST + HLEN * HDIM)   // rows; physics_kernel.NUM_STATE_ROWS

// parameter rows
#define P_CMD 0
#define P_PREV 12
#define P_KP 24
#define P_KD 36
#define P_STR 48
#define P_MFRIC 60
#define P_JFRIC 61
#define P_MS 62
#define P_IS 75
#define P_FG 88
#define P_FB 89
#define P_BOX 90       // K x 8 rows, then Q x 5 sphere rows, then (hybrid
                       // mode) 12 tau_ff and 12 mask rows

// model buffer offsets (floats)
#define M_AXIS 0       // 12 x 3
#define M_OFF 36       // 12 x 3
#define M_COM 72       // 13 x 3
#define M_MASS 111     // 13
#define M_INER 124     // 13 x 9
#define M_LO 241
#define M_HI 253
#define M_ARM 265
#define M_DAMP 277
#define M_FRIC 289
#define M_CPOFF 301    // 20 x 3
#define M_CPRAD 361    // 20
#define M_GRAV 381     // 3
#define M_SIZE 384     // floats; physics_kernel.MODEL_SIZE

#define STIFFNESS 5000
#define DAMPING 150
#define V_SLIP 0.02

__constant__ int c_parent[NB] = {-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11};
__constant__ int c_cp_body[NCP] = {3, 6, 9, 12, 3, 6, 9, 12, 1, 4, 7, 10,
                                   0, 0, 0, 0, 0, 0, 0, 0};

// Math overloads for both instantiations.
#define MATH1(name, f32, f64)                                              \
  __device__ __forceinline__ float name(float a) { return f32(a); }        \
  __device__ __forceinline__ double name(double a) { return f64(a); }
MATH1(Sqrt, sqrtf, sqrt)
MATH1(Cos, cosf, cos)
MATH1(Sin, sinf, sin)
MATH1(Tanh, tanhf, tanh)
MATH1(Fabs, fabsf, fabs)
__device__ __forceinline__ float Fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double Fmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float Fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double Fmin(double a, double b) { return fmin(a, b); }

template <typename T> struct V3 { T x, y, z; };

template <typename T>
__device__ __forceinline__ V3<T> v3(T x, T y, T z) {
  V3<T> r; r.x = x; r.y = y; r.z = z; return r;
}
template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
template <typename T>
__device__ __forceinline__ V3<T> scl(V3<T> a, T s) { return v3(a.x * s, a.y * s, a.z * s); }
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <typename T>
__device__ __forceinline__ V3<T> crs(V3<T> a, V3<T> b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* a) { return v3(a[0], a[1], a[2]); }
template <typename T>
__device__ __forceinline__ void st3(T* a, V3<T> v) { a[0] = v.x; a[1] = v.y; a[2] = v.z; }
// row-major 3x3 times vector
template <typename T>
__device__ __forceinline__ V3<T> mat_v(const T* R, V3<T> v) {
  return v3(R[0] * v.x + R[1] * v.y + R[2] * v.z,
            R[3] * v.x + R[4] * v.y + R[5] * v.z,
            R[6] * v.x + R[7] * v.y + R[8] * v.z);
}

// Penalty force on one sphere for penetration phi along unit normal n.
template <typename T>
__device__ __forceinline__ V3<T> contact_force(T phi, V3<T> n, V3<T> vel, T mu) {
  T v_n = dot(vel, n);
  T f_n = Fmax(STIFFNESS * phi - DAMPING * v_n, T(0.0)) * (phi > T(0.0) ? T(1.0) : T(0.0));
  V3<T> v_t = sub(vel, scl(n, v_n));
  T v_t_norm = Sqrt(dot(v_t, v_t) + T(V_SLIP) * T(V_SLIP));
  return sub(scl(n, f_n), scl(v_t, mu * f_n / v_t_norm));
}

// Sphere (center x, radius rad) against one yaw-oriented box; returns the
// force and writes the penetration (-1 for an invalid box).
template <typename T>
__device__ V3<T> box_force(V3<T> x, V3<T> vel, T rad, const T* bx, int E,
                        T mu, T* phi_out) {
  T cx = bx[0 * E], cy_ = bx[1 * E], cz = bx[2 * E];
  T hx = bx[3 * E], hy = bx[4 * E], hz = bx[5 * E];
  T yaw = bx[6 * E], valid = bx[7 * E];
  T cy = Cos(yaw), sy = Sin(yaw);
  V3<T> d = v3(x.x - cx, x.y - cy_, x.z - cz);
  V3<T> lp = v3(cy * d.x + sy * d.y, -sy * d.x + cy * d.y, d.z);
  V3<T> cl = v3(Fmax(Fmin(lp.x, hx), -hx), Fmax(Fmin(lp.y, hy), -hy),
             Fmax(Fmin(lp.z, hz), -hz));
  V3<T> delta = sub(lp, cl);
  T dist_out = Sqrt(dot(delta, delta));
  bool inside = dist_out <= T(1e-9);
  T g0 = hx - Fabs(lp.x), g1 = hy - Fabs(lp.y), g2 = hz - Fabs(lp.z);
  T min_gap = Fmin(Fmin(g0, g1), g2);
  T phi = inside ? rad + min_gap : rad - dist_out;
  V3<T> nl;
  if (inside) {
    // nearest face, first-min tie-break
    bool m0 = (g0 <= g1) && (g0 <= g2);
    bool m1 = !m0 && (g1 <= g2);
    T c0 = m0 ? lp.x : T(0.0), c1 = m1 ? lp.y : T(0.0);
    T c2 = (!m0 && !m1) ? lp.z : T(0.0);
    T s = c0 + c1 + c2;
    T sg = s > T(0.0) ? T(1.0) : (s < T(0.0) ? -T(1.0) : T(0.0));
    nl = v3(m0 ? sg : T(0.0), m1 ? sg : T(0.0), (!m0 && !m1) ? sg : T(0.0));
  } else {
    nl = scl(delta, T(1.0) / Fmax(dist_out, T(1e-9)));
  }
  V3<T> nw = v3(cy * nl.x - sy * nl.y, sy * nl.x + cy * nl.y, nl.z);
  if (!(valid > T(0.5))) phi = -T(1.0);
  *phi_out = phi;
  return contact_force(phi, nw, vel, mu);
}

template <typename T>
__device__ V3<T> sphere_force(V3<T> x, V3<T> vel, T rad, const T* sp, int E,
                           T mu, T* phi_out) {
  V3<T> d = v3(x.x - sp[0 * E], x.y - sp[1 * E], x.z - sp[2 * E]);
  T dist = Sqrt(dot(d, d));
  T phi = (rad + sp[3 * E]) - dist;
  if (!(sp[4 * E] > T(0.5))) phi = -T(1.0);
  *phi_out = phi;
  return contact_force(phi, scl(d, T(1.0) / Fmax(dist, T(1e-9))), vel, mu);
}

// Forward kinematics of the whole tree: R (row-major 3x3), origins p and
// world joint axes ax (ax[j] of joint j = body j + 1).
template <typename T>
__device__ void forward_kinematics(const T* __restrict__ mdl, V3<T> pos,
                                   const T* quat, const T* q,
                                   T (*R)[9], T (*p)[3],
                                   T (*ax)[3]) {
  T w = quat[0], x = quat[1], y = quat[2], z = quat[3];
  R[0][0] = 1 - 2 * (y * y + z * z); R[0][1] = 2 * (x * y - w * z); R[0][2] = 2 * (x * z + w * y);
  R[0][3] = 2 * (x * y + w * z); R[0][4] = 1 - 2 * (x * x + z * z); R[0][5] = 2 * (y * z - w * x);
  R[0][6] = 2 * (x * z - w * y); R[0][7] = 2 * (y * z + w * x); R[0][8] = 1 - 2 * (x * x + y * y);
  st3(p[0], pos);
#pragma unroll 1
  for (int b = 1; b < NB; ++b) {
    int j = b - 1, pb = c_parent[b];
    V3<T> a = ld3(mdl + M_AXIS + 3 * j);
    st3(p[b], add(ld3(p[pb]), mat_v(R[pb], ld3(mdl + M_OFF + 3 * j))));
    st3(ax[j], mat_v(R[pb], a));
    T c = Cos(q[j]), s = Sin(q[j]), oc = T(1.0) - c;
    T rot[9] = {c + oc * a.x * a.x, -s * a.z + oc * a.x * a.y, s * a.y + oc * a.x * a.z,
                    s * a.z + oc * a.y * a.x, c + oc * a.y * a.y, -s * a.x + oc * a.y * a.z,
                    -s * a.y + oc * a.z * a.x, s * a.x + oc * a.z * a.y, c + oc * a.z * a.z};
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        R[b][3 * r + k] = R[pb][3 * r] * rot[k] + R[pb][3 * r + 1] * rot[3 + k] +
                          R[pb][3 * r + 2] * rot[6 + k];
  }
}

// Ancestor joints of body b (joint of b first); returns their count.
__device__ __forceinline__ int ancestors(int b, int* anc) {
  int n = 0;
  while (b > 0) { anc[n++] = b - 1; b = c_parent[b]; }
  return n;
}

template <typename T>
__global__ void __launch_bounds__(32)
physics_window_kernel(const T* __restrict__ sin_, T* __restrict__ sout,
                      const T* __restrict__ par, const T* __restrict__ mdl,
                      T* __restrict__ pen_out, int E, int K, int Q,
                      int n_substeps, int interpolate, int hybrid, T dt) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const T* S = sin_ + e;
  const T* PP = par + e;
#define SIN(r) S[(size_t)(r) * E]
#define PAR(r) PP[(size_t)(r) * E]

  V3<T> pos = v3(SIN(S_POS), SIN(S_POS + 1), SIN(S_POS + 2));
  V3<T> ang = v3(SIN(S_ANG), SIN(S_ANG + 1), SIN(S_ANG + 2));
  V3<T> lin = v3(SIN(S_LIN), SIN(S_LIN + 1), SIN(S_LIN + 2));
  T quat[4], q[NJ], qd[NJ], tau[NJ];
  for (int i = 0; i < 4; ++i) quat[i] = SIN(S_QUAT + i);
  for (int j = 0; j < NJ; ++j) {
    q[j] = SIN(S_Q + j); qd[j] = SIN(S_QD + j); tau[j] = SIN(S_TAU + j);
  }
  T mass_e[NB], iscale[NB];
  for (int b = 0; b < NB; ++b) {
    mass_e[b] = mdl[M_MASS + b] * PAR(P_MS + b);
    iscale[b] = PAR(P_IS + b);
  }
  const T mfric = PAR(P_MFRIC), jfric = PAR(P_JFRIC);
  const T mu_g = PAR(P_FG), mu_b = PAR(P_FB);
  const T* boxes = PP + (size_t)P_BOX * E;
  const T* spheres = PP + (size_t)(P_BOX + 8 * K) * E;
  const T* hyb = PP + (size_t)(P_BOX + 8 * K + 5 * Q) * E;
  const V3<T> grav = ld3(mdl + M_GRAV);

  T R[NB][9], p[NB][3], ax[NJ][3];
  T om[NB][3], al[NB][3], ar[NB][3];
  T M[NV][NV], h[NV], tc[NV];
  int anc[3];

#pragma unroll 1
  for (int s = 0; s < n_substeps; ++s) {
    // --- PD motor torques (optionally interpolated command) ---
    T lerp = (T)(s + 1) / (T)n_substeps;
    for (int j = 0; j < NJ; ++j) {
      T cmd = PAR(P_CMD + j);
      if (interpolate) {
        T prev = PAR(P_PREV + j);
        cmd = prev + lerp * (cmd - prev);
      }
      tau[j] = PAR(P_STR + j) * (-PAR(P_KP + j) * (q[j] - cmd) - PAR(P_KD + j) * qd[j]);
      if (hybrid) {
        T m = hyb[(size_t)(NJ + j) * E];
        tau[j] = (T(1.0) - m) * tau[j] + m * hyb[(size_t)j * E];
      }
    }

    forward_kinematics(mdl, pos, quat, q, R, p, ax);

    // --- mass matrix and bias forces, body by body ---
    for (int i = 0; i < NV; ++i) {
      h[i] = T(0.0); tc[i] = T(0.0);
      for (int k = 0; k < NV; ++k) M[i][k] = T(0.0);
    }
#pragma unroll 1
    for (int b = 0; b < NB; ++b) {
      V3<T> omb, alb, arb;
      if (b == 0) {
        omb = ang; alb = v3(T(0.), T(0.), T(0.)); arb = alb;
      } else {
        int j = b - 1, pb = c_parent[b];
        V3<T> a = ld3(ax[j]);
        V3<T> omp = ld3(om[pb]), alp = ld3(al[pb]);
        V3<T> r = sub(ld3(p[b]), ld3(p[pb]));
        omb = add(omp, scl(a, qd[j]));
        alb = add(alp, scl(crs(omp, a), qd[j]));
        arb = add(add(ld3(ar[pb]), crs(alp, r)), crs(omp, crs(omp, r)));
      }
      st3(om[b], omb); st3(al[b], alb); st3(ar[b], arb);

      V3<T> pb3 = ld3(p[b]);
      V3<T> com_w = add(pb3, mat_v(R[b], ld3(mdl + M_COM + 3 * b)));
      V3<T> rc = sub(com_w, pb3);
      V3<T> a_com = add(add(arb, crs(alb, rc)), crs(omb, crs(omb, rc)));
      // world inertia Iw = R (I * scale) R^T
      const T* I0 = mdl + M_INER + 9 * b;
      T RI[9], Iw[9];
      for (int r = 0; r < 3; ++r)
        for (int k = 0; k < 3; ++k)
          RI[3 * r + k] = (R[b][3 * r] * I0[k] + R[b][3 * r + 1] * I0[3 + k] +
                           R[b][3 * r + 2] * I0[6 + k]) * iscale[b];
      for (int r = 0; r < 3; ++r)
        for (int k = 0; k < 3; ++k)
          Iw[3 * r + k] = RI[3 * r] * R[b][3 * k] + RI[3 * r + 1] * R[b][3 * k + 1] +
                          RI[3 * r + 2] * R[b][3 * k + 2];
      V3<T> F = scl(sub(a_com, grav), mass_e[b]);
      V3<T> Tb = add(mat_v(Iw, alb), crs(omb, mat_v(Iw, omb)));

      // active Jacobian columns: 6 base dofs + ancestor joints
      int na = ancestors(b, anc);
      int n_act = 6 + na;
      int col[9];
      T Jv[3][9], Jw[3][9];
      V3<T> r0 = sub(com_w, ld3(p[0]));
      for (int k = 0; k < 3; ++k) {
        // base angular dof k: Jv column e_k x r0, Jw column e_k
        V3<T> ek = v3<T>(k == 0, k == 1, k == 2);
        V3<T> c = crs(ek, r0);
        col[k] = k;
        Jv[0][k] = c.x; Jv[1][k] = c.y; Jv[2][k] = c.z;
        Jw[0][k] = ek.x; Jw[1][k] = ek.y; Jw[2][k] = ek.z;
        // base linear dof k
        col[3 + k] = 3 + k;
        Jv[0][3 + k] = ek.x; Jv[1][3 + k] = ek.y; Jv[2][3 + k] = ek.z;
        Jw[0][3 + k] = T(0.); Jw[1][3 + k] = T(0.); Jw[2][3 + k] = T(0.);
      }
      for (int i = 0; i < na; ++i) {
        int j = anc[i];
        V3<T> a = ld3(ax[j]);
        V3<T> c = crs(a, sub(com_w, ld3(p[j + 1])));
        col[6 + i] = 6 + j;
        Jv[0][6 + i] = c.x; Jv[1][6 + i] = c.y; Jv[2][6 + i] = c.z;
        Jw[0][6 + i] = a.x; Jw[1][6 + i] = a.y; Jw[2][6 + i] = a.z;
      }
      T IJ[3][9];
      for (int k = 0; k < n_act; ++k)
        for (int r = 0; r < 3; ++r)
          IJ[r][k] = Iw[3 * r] * Jw[0][k] + Iw[3 * r + 1] * Jw[1][k] + Iw[3 * r + 2] * Jw[2][k];
      for (int i = 0; i < n_act; ++i) {
        h[col[i]] += Jv[0][i] * F.x + Jv[1][i] * F.y + Jv[2][i] * F.z +
                     Jw[0][i] * Tb.x + Jw[1][i] * Tb.y + Jw[2][i] * Tb.z;
        for (int k = 0; k < n_act; ++k)
          M[col[i]][col[k]] +=
              mass_e[b] * (Jv[0][i] * Jv[0][k] + Jv[1][i] * Jv[1][k] + Jv[2][i] * Jv[2][k]) +
              Jw[0][i] * IJ[0][k] + Jw[1][i] * IJ[1][k] + Jw[2][i] * IJ[2][k];
      }
    }

    // --- contacts: flat ground + boxes + spheres, mapped to tau_c ---
    V3<T> p0 = ld3(p[0]);
#pragma unroll 1
    for (int c = 0; c < NCP; ++c) {
      int b = c_cp_body[c];
      T rad = mdl[M_CPRAD + c];
      V3<T> x = add(ld3(p[b]), mat_v(R[b], ld3(mdl + M_CPOFF + 3 * c)));
      int na = ancestors(b, anc);
      V3<T> vel = add(crs(ang, sub(x, p0)), lin);
      for (int i = 0; i < na; ++i) {
        int j = anc[i];
        vel = add(vel, scl(crs(ld3(ax[j]), sub(x, ld3(p[j + 1]))), qd[j]));
      }
      T phi_g = rad - x.z;
      V3<T> f = contact_force(phi_g, v3(T(0.), T(0.), T(1.)), vel, mu_g);
      V3<T> fo = v3(T(0.), T(0.), T(0.));
      T phib;
      for (int k = 0; k < K; ++k)
        fo = add(fo, box_force(x, vel, rad, boxes + (size_t)8 * k * E, E, mu_b, &phib));
      for (int k = 0; k < Q; ++k)
        fo = add(fo, sphere_force(x, vel, rad, spheres + (size_t)5 * k * E, E, mu_b, &phib));
      f = add(f, fo);
      V3<T> rf = crs(sub(x, p0), f);
      tc[0] += rf.x; tc[1] += rf.y; tc[2] += rf.z;
      tc[3] += f.x; tc[4] += f.y; tc[5] += f.z;
      for (int i = 0; i < na; ++i) {
        int j = anc[i];
        tc[6 + j] += dot(ld3(ax[j]), crs(sub(x, ld3(p[j + 1])), f));
      }
    }

    // --- generalized forces, armature, Jacobi-PCG solve of M vdot = rhs ---
    T rhs[NV], x_[NV], r_[NV], z_[NV], p_[NV], Mp[NV], dinv[NV];
    for (int i = 0; i < 6; ++i) rhs[i] = tc[i] - h[i];
    for (int j = 0; j < NJ; ++j) {
      T lo = mdl[M_LO + j], hi = mdl[M_HI + j];
      T below = Fmax(lo - q[j], T(0.0)), above = Fmax(q[j] - hi, T(0.0));
      T viol = (below > T(0.0) || above > T(0.0)) ? T(1.0) : T(0.0);
      T tj = tau[j] + (T(300.0) * (below - above) - T(1.0) * qd[j] * viol) -
                 (mdl[M_DAMP + j] + mfric) * qd[j] -
                 (mdl[M_FRIC + j] + jfric) * Tanh(qd[j] / T(0.05));
      rhs[6 + j] = tj + tc[6 + j] - h[6 + j];
      M[6 + j][6 + j] += mdl[M_ARM + j];
    }
    for (int i = 0; i < NV; ++i) dinv[i] = T(1.0) / M[i][i];
    T rz = T(0.0);
    for (int i = 0; i < NV; ++i) x_[i] = rhs[i] * dinv[i];
    for (int i = 0; i < NV; ++i) {
      T acc = T(0.0);
      for (int k = 0; k < NV; ++k) acc += M[i][k] * x_[k];
      r_[i] = rhs[i] - acc;
      z_[i] = dinv[i] * r_[i];
      p_[i] = z_[i];
      rz += r_[i] * z_[i];
    }
#pragma unroll 1
    for (int it = 0; it < 16; ++it) {
      T pMp = T(0.0);
      for (int i = 0; i < NV; ++i) {
        T acc = T(0.0);
        for (int k = 0; k < NV; ++k) acc += M[i][k] * p_[k];
        Mp[i] = acc;
        pMp += p_[i] * acc;
      }
      T alpha = rz / Fmax(pMp, T(1e-12));
      T rz_new = T(0.0);
      for (int i = 0; i < NV; ++i) {
        x_[i] += alpha * p_[i];
        r_[i] -= alpha * Mp[i];
        z_[i] = dinv[i] * r_[i];
        rz_new += r_[i] * z_[i];
      }
      T beta = rz_new / Fmax(rz, T(1e-12));
      for (int i = 0; i < NV; ++i) p_[i] = z_[i] + beta * p_[i];
      rz = rz_new;
    }

    // --- semi-implicit Euler + quaternion exponential map ---
    ang = add(ang, scl(v3(x_[0], x_[1], x_[2]), dt));
    lin = add(lin, scl(v3(x_[3], x_[4], x_[5]), dt));
    for (int j = 0; j < NJ; ++j) {
      qd[j] += dt * x_[6 + j];
      q[j] += dt * qd[j];
    }
    pos = add(pos, scl(lin, dt));
    {
      T angle = Sqrt(dot(ang, ang));
      V3<T> axis = scl(ang, T(1.0) / Fmax(angle, T(1e-9)));
      T half = T(0.5) * angle * dt;
      T cw = Cos(half), sw = Sin(half);
      T bw = cw, bx = sw * axis.x, by = sw * axis.y, bz = sw * axis.z;
      T aw = quat[0], ax_ = quat[1], ay = quat[2], az = quat[3];
      T o0 = bw * aw - bx * ax_ - by * ay - bz * az;
      T o1 = bw * ax_ + bx * aw + by * az - bz * ay;
      T o2 = bw * ay - bx * az + by * aw + bz * ax_;
      T o3 = bw * az + bx * ay - by * ax_ + bz * aw;
      T nrm = Sqrt(o0 * o0 + o1 * o1 + o2 * o2 + o3 * o3);
      quat[0] = o0 / nrm; quat[1] = o1 / nrm; quat[2] = o2 / nrm; quat[3] = o3 / nrm;
    }

    // --- history record: substep s lands at row n_substeps - 1 - s ---
    int row = n_substeps - 1 - s;
    if (row < HLEN) {
      T* H = sout + e + (size_t)(S_HIST + row * HDIM) * E;
      for (int j = 0; j < NJ; ++j) H[(size_t)j * E] = q[j];
      for (int j = 0; j < NJ; ++j) H[(size_t)(12 + j) * E] = qd[j];
      for (int i = 0; i < 4; ++i) H[(size_t)(24 + i) * E] = quat[i];
      H[(size_t)28 * E] = ang.x; H[(size_t)29 * E] = ang.y; H[(size_t)30 * E] = ang.z;
    }
  }

  // older history rows shift down by n_substeps
  for (int row = n_substeps; row < HLEN; ++row)
    for (int k = 0; k < HDIM; ++k)
      sout[e + (size_t)(S_HIST + row * HDIM + k) * E] =
          SIN(S_HIST + (row - n_substeps) * HDIM + k);

  T* O = sout + e;
  O[(size_t)(S_POS) * E] = pos.x; O[(size_t)(S_POS + 1) * E] = pos.y;
  O[(size_t)(S_POS + 2) * E] = pos.z;
  for (int i = 0; i < 4; ++i) O[(size_t)(S_QUAT + i) * E] = quat[i];
  O[(size_t)(S_ANG) * E] = ang.x; O[(size_t)(S_ANG + 1) * E] = ang.y;
  O[(size_t)(S_ANG + 2) * E] = ang.z;
  O[(size_t)(S_LIN) * E] = lin.x; O[(size_t)(S_LIN + 1) * E] = lin.y;
  O[(size_t)(S_LIN + 2) * E] = lin.z;
  for (int j = 0; j < NJ; ++j) {
    O[(size_t)(S_Q + j) * E] = q[j];
    O[(size_t)(S_QD + j) * E] = qd[j];
    O[(size_t)(S_TAU + j) * E] = tau[j];
  }

  // --- post-window contact read: [ground, obstacle] penetration ---
  forward_kinematics(mdl, pos, quat, q, R, p, ax);
#pragma unroll 1
  for (int c = 0; c < NCP; ++c) {
    int b = c_cp_body[c];
    T rad = mdl[M_CPRAD + c];
    V3<T> x = add(ld3(p[b]), mat_v(R[b], ld3(mdl + M_CPOFF + 3 * c)));
    T phib = -T(1.0), ph;
    V3<T> zero = v3(T(0.), T(0.), T(0.));
    for (int k = 0; k < K; ++k) {
      box_force(x, zero, rad, boxes + (size_t)8 * k * E, E, mu_b, &ph);
      phib = k == 0 ? ph : Fmax(phib, ph);
    }
    for (int k = 0; k < Q; ++k) {
      sphere_force(x, zero, rad, spheres + (size_t)5 * k * E, E, mu_b, &ph);
      phib = Fmax(phib, ph);
    }
    pen_out[e + (size_t)(2 * c) * E] = rad - x.z;
    pen_out[e + (size_t)(2 * c + 1) * E] = phib;
  }
#undef SIN
#undef PAR
}

// Launches the window on `stream`.  f64 selects the double instantiation
// (every buffer then holds doubles); hybrid reads the tau_ff and mask
// rows.  Returns cudaGetLastError().
extern "C" int physics_window_launch(const void* state_in, void* state_out,
                                     const void* params, const void* model,
                                     void* pen_out, int E, int K, int Q,
                                     int n_substeps, int interpolate,
                                     int hybrid, double dt, int f64,
                                     void* stream) {
  const int threads = 32;
  const int blocks = (E + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    physics_window_kernel<double><<<blocks, threads, 0, st>>>(
        (const double*)state_in, (double*)state_out, (const double*)params,
        (const double*)model, (double*)pen_out, E, K, Q, n_substeps,
        interpolate, hybrid, dt);
  else
    physics_window_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)state_in, (float*)state_out, (const float*)params,
        (const float*)model, (float*)pen_out, E, K, Q, n_substeps,
        interpolate, hybrid, (float)dt);
  return (int)cudaGetLastError();
}
