// Physics window of the A1 quadruped: n_substeps of PD motors, rigid-body
// dynamics, penalty contacts and semi-implicit Euler for every env, plus
// the post-window contact read.  One warp per env.
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
// the function needs, counted by ops/window_cost.py).  What bounds it is
// the length of each env's dependent chain: 16 substeps, each a tree
// sweep, an 18x18 mass matrix, 20 contact points against the ground and
// every box and sphere, and 16 conjugate-gradient iterations whose sums
// keep their serial order.
//
// Design: one warp per env, PW_WARPS envs per block, so that 1024 envs
// give 1024 warps (about 8 per SM) where one thread per env gave 32.
// pw_window runs an env's window as a sequence of phases (PW_PHASE), each
// followed by __syncwarp(): a phase is a function of (env, lane) whose
// lanes write disjoint outputs in the env's shared-memory slab and read
// only what earlier phases wrote.  Loop scalars (the CG's rz) live in the
// slab too, and there are no shuffles, so the same source runs on the host
// phase by phase, lane after lane (tests/test_torch_kernel_host.py).  Per
// substep:
//   tree     one lane per leg walks its 3 bodies in tree order (forward
//            kinematics and the velocity recursion); lane 0 writes the
//            trunk, which every leg lane also computes for itself;
//   body     one lane per body: world inertia, Newton-Euler force, the
//            body's active Jacobian columns (6 base dofs and at most 3
//            ancestor joints), inertia times its angular columns, and
//            its terms of the bias forces h;
//   mass     one lane per entry of M, summing the bodies that have both
//            columns in the order b = 0..12 (entries of two legs' joints
//            are zero and are written once a window);
//   contact  one lane per contact point: ground, boxes k = 0..K-1, then
//            spheres (an obstacle that does not touch adds a force of
//            +-0 and is skipped); its force and generalized-force terms;
//   rhs      one lane per dof: h and the contact force summed in the order
//            of bodies and points, the PD (or hybrid) torque, limits,
//            friction, armature, the Jacobi preconditioner;
//   cg       Jacobi-PCG, 16 iterations of three phases: M p with one lane
//            per row (k in order), then alpha and the updates, then beta;
//            every lane sums pMp and rz over i in order for itself;
//   step     one lane per joint and one for the base: semi-implicit Euler,
//            the quaternion exponential map, the history record, and the
//            joint angles' cosines and sines for the next tree phase.
// Staged once per window, not per substep: the 384-value model buffer
// (once per block), the env's parameter rows, its boxes with the cosine
// and sine of each yaw, its spheres and, in hybrid mode, tau_ff and the
// mask.  The kernel is a template on its scalar type: the float
// instantiation is the one the env runs, the double one lets the kernel be
// held against the plain version in float64, where rounding cannot hide a
// fault.  At 1024 envs and at 8 the window takes about the same time: it
// runs at the latency of one warp's chain (tools/window_case_report.py
// --phases splits that by phase).
//
// Rounding: every sum keeps the order of the one-thread-per-env kernel
// this design replaced, and the source is built with -fmad=false
// (ops/nvcc.py EXTRA_FLAGS), so each product and each sum is rounded on
// its own, as in the plain version and in the JAX package; the outputs
// are that kernel's bit for bit (tools/window_case_report.py --other).
// With nvcc's default contraction of a * b + c into one FMA, the float32
// kernel departed from the plain version in one env of
// tests/test_torch_kernel_cuda.py's sphere case: at its third substep a
// foot sphere's ground penetration came out -3.7e-9 m where the plain
// version gives +1e-8 m, so the penalty contact, whose damping term is
// already tens of newtons at first touch, stayed off for one substep.
#include <cuda_runtime.h>

#define NB 13          // bodies (0 = trunk; leg l holds bodies 3l+1..3l+3)
#define NJ 12          // revolute joints; body b's joint is b - 1
#define NV 18          // generalized velocity: 6 base dofs + 12 joints
#define NCP 20         // collision spheres
#define HLEN 20        // observation-history depth
#define HDIM 31        // record: q(12) qd(12) quat(4) omega(3)
#define CG_ITERS 16
#define PW_WARPS 4     // envs (warps) per block
#define PW_THREADS (32 * PW_WARPS)

// state rows (each row holds E values)
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

// model buffer offsets
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
#define M_SIZE 384     // values; physics_kernel.MODEL_SIZE

#define STIFFNESS 5000
#define DAMPING 150
#define V_SLIP 0.02

// One env's shared-memory slab (offsets in values of T).  The first 49
// entries hold the carried state in the order of the state rows.
enum : int {
  X_STATE = 0,               // pos quat q ang lin qd tau, as S_POS..S_HIST
  X_PAR = S_HIST,            // parameter rows P_CMD..P_FB
  X_MASS = X_PAR + P_BOX,    // 13: mass x mass scale
  X_CQ = X_MASS + NB,        // 12: cos q
  X_SQ = X_CQ + NJ,          // 12: sin q
  X_R = X_SQ + NJ,           // 13 x 9: body rotations, row-major
  X_P = X_R + 9 * NB,        // 13 x 3: body origins
  X_AX = X_P + 3 * NB,       // 12 x 3: world joint axes
  X_OM = X_AX + 3 * NJ,      // 13 x 3: angular velocity
  X_AL = X_OM + 3 * NB,      // 13 x 3: its velocity-product term
  X_AR = X_AL + 3 * NB,      // 13 x 3: origin acceleration term
  X_JV = X_AR + 3 * NB,      // 13 x 3 x 9: linear Jacobian, active columns
  X_JW = X_JV + 27 * NB,     // 13 x 3 x 9: angular Jacobian
  X_IJ = X_JW + 27 * NB,     // 13 x 3 x 9: world inertia x angular Jacobian
  X_HT = X_IJ + 27 * NB,     // 13 x 9: each body's terms of h, its columns
  X_M = X_HT + 9 * NB,       // 18 x 18: mass matrix
  X_CF = X_M + NV * NV,      // 20 x 9: per point (x - p0) x f, f, joint terms
  X_RHS = X_CF + 9 * NCP,    // 18 each: right-hand side, 1 / diag(M),
  X_DINV = X_RHS + NV,       //   and the CG's x, r, z, p, M p
  X_X = X_DINV + NV,
  X_RR = X_X + NV,
  X_Z = X_RR + NV,
  X_PV = X_Z + NV,
  X_MP = X_PV + NV,
  X_RZ = X_MP + NV,          // 2: rz, double-buffered across iterations
  X_BOX = X_RZ + 2           // K x 9 boxes (centre, half sizes, cos yaw,
                             // sin yaw, valid), Q x 5 spheres, 24 hybrid
};

// kinds of phase (pw_window runs them)
enum : int {
  K_STAGE, K_TREE, K_BODY, K_MASS, K_CONTACT, K_RHS, K_CG_START, K_CG_MP,
  K_CG_ALPHA, K_CG_BETA, K_STEP, K_OUT, K_READ, PW_KINDS
};

// One phase of kind `kind`: on the card the statement for this lane, then
// __syncwarp().  The host build (tests/test_torch_kernel_host.py) defines
// it to run the statement for lanes 0..31 in turn, and
// tools/window_case_report.py --phases to time each kind.
#ifndef PW_PHASE
#define PW_PHASE(kind, ...) do { __VA_ARGS__; __syncwarp(); } while (0)
#endif

__host__ __device__ inline int pw_slab_size(int K, int Q) {
  return X_BOX + 9 * K + 5 * Q + 2 * NJ;
}


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

// Sphere (center x, radius rad) against one yaw-oriented staged box (bx:
// centre, half sizes, cos yaw, sin yaw, valid); returns the penetration
// (-1 for an invalid box) and, where it is positive and n_out is given,
// writes the world normal.
template <typename T>
__device__ __forceinline__ T box_phi(V3<T> x, T rad, const T* bx, V3<T>* n_out) {
  T hx = bx[3], hy = bx[4], hz = bx[5];
  T cy = bx[6], sy = bx[7];
  V3<T> d = v3(x.x - bx[0], x.y - bx[1], x.z - bx[2]);
  V3<T> lp = v3(cy * d.x + sy * d.y, -sy * d.x + cy * d.y, d.z);
  V3<T> cl = v3(Fmax(Fmin(lp.x, hx), -hx), Fmax(Fmin(lp.y, hy), -hy),
             Fmax(Fmin(lp.z, hz), -hz));
  V3<T> delta = sub(lp, cl);
  T dist_out = Sqrt(dot(delta, delta));
  bool inside = dist_out <= T(1e-9);
  T g0 = hx - Fabs(lp.x), g1 = hy - Fabs(lp.y), g2 = hz - Fabs(lp.z);
  T min_gap = Fmin(Fmin(g0, g1), g2);
  T phi = inside ? rad + min_gap : rad - dist_out;
  if (!(bx[8] > T(0.5))) phi = -T(1.0);
  if (n_out == nullptr || !(phi > T(0.0))) return phi;
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
  *n_out = v3(cy * nl.x - sy * nl.y, sy * nl.x + cy * nl.y, nl.z);
  return phi;
}

// The same for one staged sphere (centre, radius, valid).
template <typename T>
__device__ __forceinline__ T sphere_phi(V3<T> x, T rad, const T* sp, V3<T>* n_out) {
  V3<T> d = v3(x.x - sp[0], x.y - sp[1], x.z - sp[2]);
  T dist = Sqrt(dot(d, d));
  T phi = (rad + sp[3]) - dist;
  if (!(sp[4] > T(0.5))) phi = -T(1.0);
  if (n_out != nullptr && phi > T(0.0))
    *n_out = scl(d, T(1.0) / Fmax(dist, T(1e-9)));
  return phi;
}

template <typename T> struct PwArgs {
  const T* sin;    // state rows (NS x E)
  T* sout;         // state rows out
  const T* par;    // parameter rows
  const T* mdl;    // model buffer (M_SIZE)
  T* pen;          // post-window penetration (NCP x 2 x E)
  int E, K, Q, n_substeps, interpolate, hybrid;
  T dt;
};

// The model buffer into the block's shared memory (thread tid of nt).
template <typename T>
__device__ inline void pw_stage_model(const PwArgs<T>& a, T* sm, int tid,
                                      int nt) {
  for (int i = tid; i < M_SIZE; i += nt) sm[i] = a.mdl[i];
}

// Body of contact point c: the feet (3, 6, 9, 12) twice, the thighs (1,
// 4, 7, 10), then eight trunk points (physics_kernel.KERNEL_CP_BODY).
__device__ __forceinline__ int pw_cp_body(int c) {
  return c < 8 ? 3 * (c % 4 + 1) : c < 12 ? 3 * (c - 8) + 1 : 0;
}

// Ancestor joints of a body, own joint first: body b's i-th is b - 1 - i
// for i < pw_depth(b) (legs are chains hanging from the trunk).
__device__ __forceinline__ int pw_depth(int b) { return b == 0 ? 0 : (b - 1) % 3 + 1; }

// Trunk rotation (row-major) from the slab's quaternion.
template <typename T>
__device__ __forceinline__ void pw_trunk_rotation(const T* x, T* R) {
  const T* quat = x + S_QUAT;
  T w = quat[0], qx = quat[1], y = quat[2], z = quat[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (qx * y - w * z); R[2] = 2 * (qx * z + w * y);
  R[3] = 2 * (qx * y + w * z); R[4] = 1 - 2 * (qx * qx + z * z); R[5] = 2 * (y * z - w * qx);
  R[6] = 2 * (qx * z - w * y); R[7] = 2 * (y * z + w * qx); R[8] = 1 - 2 * (qx * qx + y * y);
}

// One leg's forward kinematics (rotations, origins, world joint axes),
// body after body from the trunk; with `vel`, the velocity recursion too.
// Lane 0's leg also writes the trunk.
template <typename T>
__device__ void pw_leg(const T* mdl, T* x, int leg, bool vel) {
  T Rp[9];
  pw_trunk_rotation(x, Rp);
  V3<T> pp = ld3(x + S_POS);
  V3<T> omp = ld3(x + S_ANG), alp = v3(T(0.), T(0.), T(0.)), arp = alp;
  if (leg == 0) {
    for (int k = 0; k < 9; ++k) x[X_R + k] = Rp[k];
    st3(x + X_P, pp);
    if (vel) { st3(x + X_OM, omp); st3(x + X_AL, alp); st3(x + X_AR, arp); }
  }
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    const int b = 3 * leg + 1 + i, j = b - 1;
    V3<T> a = ld3(mdl + M_AXIS + 3 * j);
    V3<T> pb = add(pp, mat_v(Rp, ld3(mdl + M_OFF + 3 * j)));
    V3<T> aw = mat_v(Rp, a);
    T c = x[X_CQ + j], s = x[X_SQ + j], oc = T(1.0) - c;
    T rot[9] = {c + oc * a.x * a.x, -s * a.z + oc * a.x * a.y, s * a.y + oc * a.x * a.z,
                s * a.z + oc * a.y * a.x, c + oc * a.y * a.y, -s * a.x + oc * a.y * a.z,
                -s * a.y + oc * a.z * a.x, s * a.x + oc * a.z * a.y, c + oc * a.z * a.z};
    T Rb[9];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        Rb[3 * r + k] = Rp[3 * r] * rot[k] + Rp[3 * r + 1] * rot[3 + k] +
                        Rp[3 * r + 2] * rot[6 + k];
    for (int k = 0; k < 9; ++k) x[X_R + 9 * b + k] = Rb[k];
    st3(x + X_P + 3 * b, pb);
    st3(x + X_AX + 3 * j, aw);
    if (vel) {
      const T qd = x[S_QD + j];
      V3<T> r = sub(pb, pp);
      V3<T> omb = add(omp, scl(aw, qd));
      V3<T> alb = add(alp, scl(crs(omp, aw), qd));
      V3<T> arb = add(add(arp, crs(alp, r)), crs(omp, crs(omp, r)));
      st3(x + X_OM + 3 * b, omb); st3(x + X_AL + 3 * b, alb); st3(x + X_AR + 3 * b, arb);
      omp = omb; alp = alb; arp = arb;
    }
    for (int k = 0; k < 9; ++k) Rp[k] = Rb[k];
    pp = pb;
  }
}

// Body b's active Jacobian columns (6 base dofs, then its ancestor joints,
// own joint first; blocks 3 x 9 row-major), its world inertia times its
// angular columns, and its terms of the bias forces h: its Newton-Euler
// force and torque through each column.
template <typename T>
__device__ void pw_body(const T* mdl, T* x, int b) {
  V3<T> omb = ld3(x + X_OM + 3 * b), alb = ld3(x + X_AL + 3 * b);
  V3<T> arb = ld3(x + X_AR + 3 * b);
  const T* Rb = x + X_R + 9 * b;
  V3<T> pb3 = ld3(x + X_P + 3 * b);
  V3<T> com_w = add(pb3, mat_v(Rb, ld3(mdl + M_COM + 3 * b)));
  V3<T> rc = sub(com_w, pb3);
  V3<T> a_com = add(add(arb, crs(alb, rc)), crs(omb, crs(omb, rc)));
  // world inertia Iw = R (I * scale) R^T
  const T* I0 = mdl + M_INER + 9 * b;
  const T iscale = x[X_PAR + P_IS + b];
  T RI[9], Iw[9];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      RI[3 * r + k] = (Rb[3 * r] * I0[k] + Rb[3 * r + 1] * I0[3 + k] +
                       Rb[3 * r + 2] * I0[6 + k]) * iscale;
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      Iw[3 * r + k] = RI[3 * r] * Rb[3 * k] + RI[3 * r + 1] * Rb[3 * k + 1] +
                      RI[3 * r + 2] * Rb[3 * k + 2];
  V3<T> F = scl(sub(a_com, ld3(mdl + M_GRAV)), x[X_MASS + b]);
  V3<T> Tb = add(mat_v(Iw, alb), crs(omb, mat_v(Iw, omb)));

  T* Jv = x + X_JV + 27 * b;
  T* Jw = x + X_JW + 27 * b;
  V3<T> r0 = sub(com_w, ld3(x + X_P));
  for (int k = 0; k < 3; ++k) {
    // base angular dof k: Jv column e_k x r0, Jw column e_k
    V3<T> ek = v3<T>(k == 0, k == 1, k == 2);
    V3<T> c = crs(ek, r0);
    Jv[k] = c.x; Jv[9 + k] = c.y; Jv[18 + k] = c.z;
    Jw[k] = ek.x; Jw[9 + k] = ek.y; Jw[18 + k] = ek.z;
    // base linear dof k
    Jv[3 + k] = ek.x; Jv[12 + k] = ek.y; Jv[21 + k] = ek.z;
    Jw[3 + k] = T(0.); Jw[12 + k] = T(0.); Jw[21 + k] = T(0.);
  }
  const int na = pw_depth(b);
  for (int i = 0; i < na; ++i) {
    const int j = b - 1 - i;
    V3<T> a = ld3(x + X_AX + 3 * j);
    V3<T> c = crs(a, sub(com_w, ld3(x + X_P + 3 * (j + 1))));
    Jv[6 + i] = c.x; Jv[15 + i] = c.y; Jv[24 + i] = c.z;
    Jw[6 + i] = a.x; Jw[15 + i] = a.y; Jw[24 + i] = a.z;
  }
  T* IJ = x + X_IJ + 27 * b;
  T* ht = x + X_HT + 9 * b;
  for (int k = 0; k < 6 + na; ++k) {
    for (int r = 0; r < 3; ++r)
      IJ[9 * r + k] = Iw[3 * r] * Jw[k] + Iw[3 * r + 1] * Jw[9 + k] +
                      Iw[3 * r + 2] * Jw[18 + k];
    ht[k] = Jv[k] * F.x + Jv[9 + k] * F.y + Jv[18 + k] * F.z +
            Jw[k] * Tb.x + Jw[9 + k] * Tb.y + Jw[18 + k] * Tb.z;
  }
}

// Entry t < 36 of the mass phase: M_ik, i = t / 6, k = t % 6 (base
// dofs).  Base columns are every body's: the bodies' terms are summed over
// b = 0..12, in order.
template <typename T>
__device__ void pw_mass_base(T* x, int t) {
  const int i = t / 6, k = t % 6;
  T acc = T(0.0);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const T* Jv = x + X_JV + 27 * b;
    const T* Jw = x + X_JW + 27 * b;
    const T* IJ = x + X_IJ + 27 * b;
    acc += x[X_MASS + b] * (Jv[i] * Jv[k] + Jv[9 + i] * Jv[9 + k] +
                            Jv[18 + i] * Jv[18 + k]) +
           Jw[i] * IJ[k] + Jw[9 + i] * IJ[9 + k] + Jw[18 + i] * IJ[18 + k];
  }
  x[X_M + NV * i + k] = acc;
}

// Body b's local column of generalized column c, where b has it: base dofs
// first, then its joints from its own up (joint c - 6 at 5 + b - (c - 6)).
__device__ __forceinline__ int pw_local(int b, int c) {
  return c < 6 ? c : b + 11 - c;
}

// Entry t < 180 of the mass phase with a joint column: M_ik with a base
// row and joint column (t < 72), a joint row and base column (< 144), or
// two joints of one leg.  Joint j's column is its body's and those below
// it in its leg: at most 3 bodies, summed in order.  Entries of joints of
// two legs stay zero (pw_stage).
template <typename T>
__device__ void pw_mass_joint(T* x, int t) {
  int i, k;
  if (t < 72) { i = t / 12; k = 6 + t % 12; }
  else if (t < 144) { i = 6 + (t - 72) / 6; k = (t - 72) % 6; }
  else {
    const int leg = (t - 144) / 9, r = (t - 144) % 9;
    i = 6 + 3 * leg + r / 3; k = 6 + 3 * leg + r % 3;
  }
  const int j = (i > k ? i : k) - 6;   // the later joint of the entry
  const int hi = 3 * (j / 3) + 4;      // one past its leg's last body
  T acc = T(0.0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int b = j + 1 + q;
    if (b < hi) {
      const int li = pw_local(b, i), lk = pw_local(b, k);
      const T* Jv = x + X_JV + 27 * b;
      const T* Jw = x + X_JW + 27 * b;
      const T* IJ = x + X_IJ + 27 * b;
      acc += x[X_MASS + b] * (Jv[li] * Jv[lk] + Jv[9 + li] * Jv[9 + lk] +
                              Jv[18 + li] * Jv[18 + lk]) +
             Jw[li] * IJ[lk] + Jw[9 + li] * IJ[9 + lk] +
             Jw[18 + li] * IJ[18 + lk];
    }
  }
  x[X_M + NV * i + k] = acc;
}

// The mass matrix, one lane per entry, each summing its bodies' terms in
// the order b = 0..12.
template <typename T>
__device__ void pw_mass(T* x, int lane) {
  for (int t = lane; t < 36; t += 32) pw_mass_base(x, t);
  for (int t = lane; t < 180; t += 32) pw_mass_joint(x, t);
}

// World position of contact point c (on body b).
template <typename T>
__device__ __forceinline__ V3<T> pw_point(const T* mdl, const T* x, int c, int b) {
  return add(ld3(x + X_P + 3 * b), mat_v(x + X_R + 9 * b, ld3(mdl + M_CPOFF + 3 * c)));
}

// Contact point c of env e at substep s: its velocity, the ground, box
// and sphere forces, and their terms of the generalized contact force.
template <typename T>
__device__ void pw_contact(const PwArgs<T>& a, const T* mdl, T* x, int e,
                           int s, int c) {
  const int b = pw_cp_body(c), na = pw_depth(b);
  const T rad = mdl[M_CPRAD + c];
  const T mu_g = x[X_PAR + P_FG], mu_b = x[X_PAR + P_FB];
  const T* boxes = x + X_BOX;
  const T* spheres = boxes + 9 * a.K;
  V3<T> p0 = ld3(x + X_P);
  V3<T> xc = pw_point(mdl, x, c, b);
  V3<T> vel = add(crs(ld3(x + S_ANG), sub(xc, p0)), ld3(x + S_LIN));
  for (int i = 0; i < na; ++i) {
    const int j = b - 1 - i;
    vel = add(vel, scl(crs(ld3(x + X_AX + 3 * j), sub(xc, ld3(x + X_P + 3 * (j + 1)))),
                       x[S_QD + j]));
  }
  T phi_g = rad - xc.z;
  V3<T> f = contact_force(phi_g, v3(T(0.), T(0.), T(1.)), vel, mu_g);
  // An obstacle that does not touch (phi <= 0) has a force of +-0, which
  // leaves fo's bits as they are (fo starts at +0), so it is skipped.
  V3<T> fo = v3(T(0.), T(0.), T(0.)), n;
  T phib;
#pragma unroll 1
  for (int k = 0; k < a.K; ++k) {
    phib = box_phi(xc, rad, boxes + 9 * k, &n);
    if (phib > T(0.0)) fo = add(fo, contact_force(phib, n, vel, mu_b));
  }
#pragma unroll 1
  for (int k = 0; k < a.Q; ++k) {
    phib = sphere_phi(xc, rad, spheres + 5 * k, &n);
    if (phib > T(0.0)) fo = add(fo, contact_force(phib, n, vel, mu_b));
  }
  f = add(f, fo);
  T* cf = x + X_CF + 9 * c;
  st3(cf, crs(sub(xc, p0), f));
  st3(cf + 3, f);
  for (int i = 0; i < na; ++i) {
    const int j = b - 1 - i;
    cf[6 + i] = dot(ld3(x + X_AX + 3 * j), crs(sub(xc, ld3(x + X_P + 3 * (j + 1))), f));
  }
}

// Dof i: contact force, torque, the right-hand side, armature, 1 / M_ii
// and the preconditioned start x = rhs / M_ii.
template <typename T>
__device__ void pw_rhs(const PwArgs<T>& a, const T* mdl, T* x, int s, int i) {
  // the bodies [b0, b1) that have column i: all for a base dof, for joint
  // j its body and those below it in its leg.  h_i sums their terms in
  // order b, the contact force the terms of the points on them in order c
  // (a point's terms sit at its body's local columns).
  const int b0 = i < 6 ? 0 : i - 5, b1 = i < 6 ? NB : 3 * ((i - 6) / 3) + 4;
  T h = T(0.0), tc = T(0.0);
  for (int b = b0; b < b1; ++b) h += x[X_HT + 9 * b + pw_local(b, i)];
  for (int c = 0; c < NCP; ++c) {
    const int b = pw_cp_body(c);
    if (b >= b0 && b < b1) tc += x[X_CF + 9 * c + pw_local(b, i)];
  }
  T rhs;
  if (i < 6) {
    rhs = tc - h;
  } else {
    const int j = i - 6;
    const T* P = x + X_PAR;
    const T q = x[S_Q + j], qd = x[S_QD + j];
    // PD motor torque (optionally interpolated command)
    T cmd = P[P_CMD + j];
    if (a.interpolate) {
      T lerp = (T)(s + 1) / (T)a.n_substeps;
      T prev = P[P_PREV + j];
      cmd = prev + lerp * (cmd - prev);
    }
    T tau = P[P_STR + j] * (-P[P_KP + j] * (q - cmd) - P[P_KD + j] * qd);
    if (a.hybrid) {
      const T* hyb = x + X_BOX + 9 * a.K + 5 * a.Q;
      T m = hyb[NJ + j];
      tau = (T(1.0) - m) * tau + m * hyb[j];
    }
    x[S_TAU + j] = tau;
    T lo = mdl[M_LO + j], hi = mdl[M_HI + j];
    T below = Fmax(lo - q, T(0.0)), above = Fmax(q - hi, T(0.0));
    T viol = (below > T(0.0) || above > T(0.0)) ? T(1.0) : T(0.0);
    T tj = tau + (T(300.0) * (below - above) - T(1.0) * qd * viol) -
           (mdl[M_DAMP + j] + P[P_MFRIC]) * qd -
           (mdl[M_FRIC + j] + P[P_JFRIC]) * Tanh(qd / T(0.05));
    rhs = tj + tc - h;
    x[X_M + NV * i + i] += mdl[M_ARM + j];
  }
  const T dinv = T(1.0) / x[X_M + NV * i + i];
  x[X_RHS + i] = rhs;
  x[X_DINV + i] = dinv;
  x[X_X + i] = rhs * dinv;
}

// sum_k u_k v_k in order k
template <typename T>
__device__ __forceinline__ T pw_dot18(const T* u, const T* v) {
  T acc = T(0.0);
#pragma unroll
  for (int k = 0; k < NV; ++k) acc += u[k] * v[k];
  return acc;
}

// Jacobi-PCG on M vdot = rhs, row i of each phase.  Start: r = rhs - M x,
// z = r / M_ii, p = z.
template <typename T>
__device__ void pw_cg_start(T* x, int i) {
  x[X_RR + i] = x[X_RHS + i] - pw_dot18(x + X_M + NV * i, x + X_X);
  x[X_Z + i] = x[X_DINV + i] * x[X_RR + i];
  x[X_PV + i] = x[X_Z + i];
}

// M p; in the first iteration row 0 also sums rz = r . z.
template <typename T>
__device__ void pw_cg_mp(T* x, int it, int i) {
  x[X_MP + i] = pw_dot18(x + X_M + NV * i, x + X_PV);
  if (it == 0 && i == 0) x[X_RZ] = pw_dot18(x + X_RR, x + X_Z);
}

// alpha = rz / p.Mp (every row sums p.Mp for itself); x, r, z.  Iteration
// it reads rz from X_RZ + it % 2.  Env e and substep s name the traces of
// tools/window_case_report.py --locate.
template <typename T>
__device__ void pw_cg_alpha(T* x, int e, int s, int it, int i) {
  const T* rz = x + X_RZ;
  T pMp = pw_dot18(x + X_PV, x + X_MP);
  T alpha = rz[it & 1] / Fmax(pMp, T(1e-12));
  x[X_X + i] += alpha * x[X_PV + i];
  x[X_RR + i] -= alpha * x[X_MP + i];
  x[X_Z + i] = x[X_DINV + i] * x[X_RR + i];
}

// beta = rz_new / rz (every row sums rz_new = r . z for itself); p; row 0
// keeps rz_new for the next iteration in the other slot.
template <typename T>
__device__ void pw_cg_beta(T* x, int it, int i) {
  T* rz = x + X_RZ;
  T rz_new = pw_dot18(x + X_RR, x + X_Z);
  T beta = rz_new / Fmax(rz[it & 1], T(1e-12));
  x[X_PV + i] = x[X_Z + i] + beta * x[X_PV + i];
  if (i == 0) rz[(it + 1) & 1] = rz_new;
}

// Semi-implicit Euler of joint `lane` (< 12) or of the base (lane 12),
// the history record of substep s (lands at row n_substeps - 1 - s), and
// the joint's cosine and sine for the next tree phase.
template <typename T>
__device__ void pw_step(const PwArgs<T>& a, T* x, int e, int s, int lane) {
  const int E = a.E, row = a.n_substeps - 1 - s;
  T* H = a.sout + e + (size_t)(S_HIST + row * HDIM) * E;
  const T dt = a.dt;
  if (lane < NJ) {
    const int j = lane;
    T qd = x[S_QD + j] + dt * x[X_X + 6 + j];
    T q = x[S_Q + j] + dt * qd;
    x[S_QD + j] = qd;
    x[S_Q + j] = q;
    x[X_CQ + j] = Cos(q);
    x[X_SQ + j] = Sin(q);
    if (row < HLEN) {
      H[(size_t)j * E] = q;
      H[(size_t)(12 + j) * E] = qd;
    }
  } else {
    // semi-implicit Euler + quaternion exponential map
    V3<T> ang = add(ld3(x + S_ANG), scl(ld3(x + X_X), dt));
    V3<T> lin = add(ld3(x + S_LIN), scl(ld3(x + X_X + 3), dt));
    st3(x + S_ANG, ang);
    st3(x + S_LIN, lin);
    st3(x + S_POS, add(ld3(x + S_POS), scl(lin, dt)));
    T* quat = x + S_QUAT;
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
    if (row < HLEN) {
      for (int i = 0; i < 4; ++i) H[(size_t)(24 + i) * E] = quat[i];
      H[(size_t)28 * E] = ang.x; H[(size_t)29 * E] = ang.y; H[(size_t)30 * E] = ang.z;
    }
  }
}

// The window's inputs into the slab: state, parameter rows, mass x mass
// scale, cos / sin of the joint angles, boxes with their yaw's cos / sin,
// spheres and the hybrid rows.
template <typename T>
__device__ void pw_stage(const PwArgs<T>& a, const T* mdl, T* x, int e, int lane) {
  const int E = a.E;
  const T* S = a.sin + e;
  const T* PP = a.par + e;
  for (int i = lane; i < S_HIST; i += 32) x[X_STATE + i] = S[(size_t)i * E];
  for (int i = lane; i < P_BOX; i += 32) x[X_PAR + i] = PP[(size_t)i * E];
  if (lane < NB) x[X_MASS + lane] = mdl[M_MASS + lane] * PP[(size_t)(P_MS + lane) * E];
  if (lane < NJ) {
    const T q = S[(size_t)(S_Q + lane) * E];
    x[X_CQ + lane] = Cos(q);
    x[X_SQ + lane] = Sin(q);
  }
  for (int k = lane; k < a.K; k += 32) {
    const T* bx = PP + (size_t)(P_BOX + 8 * k) * E;
    T* o = x + X_BOX + 9 * k;
    for (int i = 0; i < 6; ++i) o[i] = bx[(size_t)i * E];
    const T yaw = bx[(size_t)6 * E];
    o[6] = Cos(yaw);
    o[7] = Sin(yaw);
    o[8] = bx[(size_t)7 * E];
  }
  // entries of M between joints of two legs: zero in every substep
  for (int t = lane; t < NJ * NJ; t += 32)
    if (t / 12 / 3 != t % 12 / 3) x[X_M + NV * (6 + t / 12) + 6 + t % 12] = T(0.0);
  const int rest = 5 * a.Q + (a.hybrid ? 2 * NJ : 0);
  const T* sp = PP + (size_t)(P_BOX + 8 * a.K) * E;
  for (int i = lane; i < rest; i += 32) x[X_BOX + 9 * a.K + i] = sp[(size_t)i * E];
}

// After the last substep: the final state and the older history rows
// (shifted down by n_substeps) out, and the final state's tree.
template <typename T>
__device__ void pw_write_out(const PwArgs<T>& a, const T* mdl, T* x, int e, int lane) {
  const int E = a.E, n = a.n_substeps;
  T* O = a.sout + e;
  const T* S = a.sin + e;
  for (int i = lane; i < S_HIST; i += 32) O[(size_t)i * E] = x[X_STATE + i];
  const int shifted = n < HLEN ? (HLEN - n) * HDIM : 0;
  for (int i = lane; i < shifted; i += 32)
    O[(size_t)(S_HIST + n * HDIM + i) * E] = S[(size_t)(S_HIST + i) * E];
  if (lane < 4) pw_leg(mdl, x, lane, false);
}

// Post-window contact read of point c: [ground, obstacle] penetration.
template <typename T>
__device__ void pw_contact_read(const PwArgs<T>& a, const T* mdl, const T* x, int e, int c) {
  const int b = pw_cp_body(c);
  const T rad = mdl[M_CPRAD + c];
  const T* boxes = x + X_BOX;
  const T* spheres = boxes + 9 * a.K;
  V3<T> xc = pw_point(mdl, x, c, b);
  T phib = -T(1.0), ph;
  for (int k = 0; k < a.K; ++k) {
    ph = box_phi(xc, rad, boxes + 9 * k, (V3<T>*)nullptr);
    phib = k == 0 ? ph : Fmax(phib, ph);
  }
  for (int k = 0; k < a.Q; ++k) {
    ph = sphere_phi(xc, rad, spheres + 5 * k, (V3<T>*)nullptr);
    phib = Fmax(phib, ph);
  }
  a.pen[e + (size_t)(2 * c) * a.E] = rad - xc.z;
  a.pen[e + (size_t)(2 * c + 1) * a.E] = phib;
}

// The window of env e for one lane; mdl is the block's copy of the model
// buffer, x the env's slab.  Envs past the batch (a ragged last block's
// warps) do nothing.
template <typename T>
__device__ void pw_window(const PwArgs<T>& a, const T* mdl, T* x, int e,
                          int lane) {
  if (e >= a.E) return;
  PW_PHASE(K_STAGE, pw_stage(a, mdl, x, e, lane));
#pragma unroll 1
  for (int s = 0; s < a.n_substeps; ++s) {
    PW_PHASE(K_TREE, if (lane < 4) pw_leg(mdl, x, lane, true));
    PW_PHASE(K_BODY, if (lane < NB) pw_body(mdl, x, lane));
    PW_PHASE(K_MASS, pw_mass(x, lane));
    PW_PHASE(K_CONTACT, if (lane < NCP) pw_contact(a, mdl, x, e, s, lane));
    PW_PHASE(K_RHS, if (lane < NV) pw_rhs(a, mdl, x, s, lane));
    PW_PHASE(K_CG_START, if (lane < NV) pw_cg_start(x, lane));
#pragma unroll 1
    for (int it = 0; it < CG_ITERS; ++it) {
      PW_PHASE(K_CG_MP, if (lane < NV) pw_cg_mp(x, it, lane));
      PW_PHASE(K_CG_ALPHA, if (lane < NV) pw_cg_alpha(x, e, s, it, lane));
      if (it < CG_ITERS - 1)   // the last iteration needs no beta
        PW_PHASE(K_CG_BETA, if (lane < NV) pw_cg_beta(x, it, lane));
    }
    PW_PHASE(K_STEP, if (lane <= NJ) pw_step(a, x, e, s, lane));
  }
  PW_PHASE(K_OUT, pw_write_out(a, mdl, x, e, lane));
  PW_PHASE(K_READ, if (lane < NCP) pw_contact_read(a, mdl, x, e, lane));
}

template <typename T>
static PwArgs<T> pw_args(const void* state_in, void* state_out,
                         const void* params, const void* model, void* pen_out,
                         int E, int K, int Q, int n_substeps, int interpolate,
                         int hybrid, double dt) {
  PwArgs<T> a;
  a.sin = (const T*)state_in;
  a.sout = (T*)state_out;
  a.par = (const T*)params;
  a.mdl = (const T*)model;
  a.pen = (T*)pen_out;
  a.E = E;
  a.K = K;
  a.Q = Q;
  a.n_substeps = n_substeps;
  a.interpolate = interpolate;
  a.hybrid = hybrid;
  a.dt = (T)dt;
  return a;
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(PW_THREADS)
physics_window_kernel(PwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char pw_smem[];
  T* sm = reinterpret_cast<T*>(pw_smem);
  pw_stage_model(a, sm, threadIdx.x, blockDim.x);
  __syncthreads();
  const int w = threadIdx.x / 32;
  pw_window(a, sm, sm + M_SIZE + w * pw_slab_size(a.K, a.Q),
            blockIdx.x * PW_WARPS + w, threadIdx.x % 32);
}

template <typename T>
static int pw_launch(const PwArgs<T>& a, cudaStream_t st) {
  const size_t smem =
      (size_t)(M_SIZE + PW_WARPS * pw_slab_size(a.K, a.Q)) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        physics_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.E + PW_WARPS - 1) / PW_WARPS;
  physics_window_kernel<T><<<blocks, PW_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return pw_launch(pw_args<double>(state_in, state_out, params, model,
                                     pen_out, E, K, Q, n_substeps,
                                     interpolate, hybrid, dt), st);
  return pw_launch(pw_args<float>(state_in, state_out, params, model,
                                  pen_out, E, K, Q, n_substeps, interpolate,
                                  hybrid, dt), st);
}
#endif
