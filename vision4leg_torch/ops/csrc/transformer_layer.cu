// Fused LocoTransformer encoder layer, forward: for every sample of a
// (B, T, D) float32 batch, a single-head post-norm layer
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//   a = softmax(q k^T / sqrt(D)) (row maximum subtracted)
//   y = LN1(x + (a v) Wo + bo)
//   out = LN2(y + relu(y W1 + b1) W2 + b2)      (LayerNorm eps 1e-6)
// with the weights in (in, out) layout: Wq..Wo (D, D), W1 (D, F), W2 (F, D).
//
// Replaces the TPU kernel vision4leg_tpu/ops/attention.py:116
// (fused_transformer_layer, pl.pallas_call at :130, math _layer_math :77).
// Its plain PyTorch version is layer_math in vision4leg_torch/ops/attention.py.
//
// What bounds it on an H100: operations.  At the rollout and update shape
// (B = 1024, T = 17, D = 64, F = 256) a launch does 1.787 GFLOP of matrix
// products (26.7 us at the 67 TFLOP/s non-tensor f32 peak) and must move
// 9.1 MB (x, out and the weights once: 2.7 us at 3.35 TB/s).  The TPU
// kernel stacked 64 samples so that its matrix unit saw (64*17, 64)
// products; here the design is the simple one: one block of 256 threads
// per sample (1024 blocks keep all 132 SMs busy), the sample's whole
// working set in shared memory (x, q, k, v, the T x T scores, the
// T x F hidden layer: 36.5 KB at the main shape), weights read from
// device memory through L1/L2 with neighbouring threads on neighbouring
// output columns, and FP32 FMAs throughout (no tensor cores, no TF32).
// Each dense product gives a thread one output column over up to RB rows,
// so one weight load feeds RB FMAs.  Rows of shared buffers are padded
// by one float so that the score and context phases, whose threads walk
// rows at a stride, hit distinct banks.  LayerNorm takes the mean first
// and then the mean of the squared deviations, as the reference does.
//
// The layer runs as TL_NUM_PHASES phases separated by __syncthreads();
// each phase is a function of (sample, thread, thread count) whose
// threads write disjoint outputs and read only what earlier phases
// wrote, so the same phases run on the host one thread after another
// (tests/test_torch_layer_host.py).
//
// Under autograd the forward also writes the layer's residuals (res set;
// with res null it is the inference forward, the same arithmetic), and
// the second kernel of this file, transformer_layer_bwd_kernel, is the
// backward.  It replaces the TPU package's _ad_bwd
// (vision4leg_tpu/ops/attention.py:178, the XLA VJP of a recompute of
// the layer; its plain PyTorch version is layer_backward_rows in
// vision4leg_torch/ops/attention.py).  What bounds it on an H100: bytes
// and operations about equally.  At B = 1024 it reads 46 MB of residuals
// and the output gradient and writes 48 MB of row gradients (28.0 us at
// 3.35 TB/s), and its products are 1.863 GFLOP (27.8 us at 67 TFLOP/s).
// Why residuals: the TPU's retired Pallas backward had 16 MiB of scoped
// VMEM and rematerialized the whole layer for each tile (0.09x XLA's
// speed); the H100 has 80 GB of device memory at 3.35 TB/s, so the
// forward writes 49 KB a sample (50 MB at B = 1024, 15 us of writes)
// and the backward recomputes nothing.  Its design is the forward's: one
// block of 256 threads per sample, 13 barrier-separated phases that also
// run on the host (tests/test_torch_layer_bwd_host.py), the sample's
// working set in shared memory, weights through L1/L2.
#include <cuda_runtime.h>

#define TL_THREADS 256
#define TL_NUM_PHASES 12
#define RB 4              // rows of one dense-product work item
#define LN_EPS 1e-6f

struct LayerArgs {
  const float* x;
  float* out;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
  const float *ln1s, *ln1b, *w1, *b1, *w2, *b2, *ln2s, *ln2b;
  int T, D, F;
  float* res;   // residuals for the backward, or null (inference)
  int B;
};

// Residuals the saving forward writes for the backward, field-major: field
// f of sample b starts at res + B * (sizes of fields < f) + b * size(f),
// so that each field is one (B, ...) tensor to torch.  h is relu(y W1 +
// b1): h > 0 is the FFN's mask, and h is what dW2 needs.
enum { R_Q, R_K, R_V, R_CTX, R_XHAT1, R_Y, R_XHAT2, R_H, R_P, R_RSTD1,
       R_RSTD2, R_NUM };

__host__ __device__ inline int tl_res_size(int f, int T, int D, int F) {
  return f < R_H ? T * D : f == R_H ? T * F : f == R_P ? T * T : T;
}

__host__ __device__ inline float* tl_res(float* res, int f, int b, int B,
                                         int T, int D, int F) {
  size_t off = 0;
  for (int i = 0; i < f; ++i) off += (size_t)tl_res_size(i, T, D, F);
  return res + (size_t)B * off + (size_t)b * tl_res_size(f, T, D, F);
}

// shared-memory layout of one sample (floats); ld* are row strides
struct Smem {
  float *x, *q, *k, *v, *s, *h, *mu, *rstd;
  int ld, lds, ldh;
};

__host__ __device__ inline int tl_smem_floats(int T, int D, int F) {
  return 4 * T * (D + 1) + T * (T + 1) + T * (F + 1) + 2 * T;
}

__device__ inline Smem tl_layout(const LayerArgs& a, float* base) {
  Smem m;
  m.ld = a.D + 1;
  m.lds = a.T + 1;
  m.ldh = a.F + 1;
  const int td = a.T * m.ld;
  m.x = base;
  m.q = m.x + td;
  m.k = m.q + td;
  m.v = m.k + td;
  m.s = m.v + td;
  m.h = m.s + a.T * m.lds;
  m.mu = m.h + a.T * m.ldh;
  m.rstd = m.mu + a.T;
  return m;
}

// out[t][j] = res[t][j] + act(bias[j] + sum_i in[t][i] W[i][j]) for the
// rows t = r0 .. min(r0 + RB, T) - 1 of one column j; W is (K, N) row-major
__device__ inline void dense_item(const float* in, int ldi, int K,
                                  const float* __restrict__ W,
                                  const float* __restrict__ bias, int N,
                                  int j, int r0, int T, float* out, int ldo,
                                  const float* res, int ldr, bool relu) {
  const int rows = (T - r0 < RB) ? T - r0 : RB;
  const float* rp[RB];
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    rp[r] = in + (r0 + (r < rows ? r : rows - 1)) * ldi;
    acc[r] = 0.0f;
  }
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
    const float w = W[i * N + j];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(rp[r][i], w, acc[r]);
  }
  for (int r = 0; r < rows; ++r) {
    float y = acc[r] + bias[j];
    if (relu) y = fmaxf(y, 0.0f);
    if (res != nullptr) y = res[(r0 + r) * ldr + j] + y;
    out[(r0 + r) * ldo + j] = y;
  }
}

// mean and 1/sqrt(var + eps) of each row of z (one thread per row)
__device__ inline void ln_stats(const float* z, int ld, int T, int D,
                                float* mu, float* rstd, int tid, int nt) {
  for (int t = tid; t < T; t += nt) {
    const float* row = z + t * ld;
    float s = 0.0f;
    for (int i = 0; i < D; ++i) s += row[i];
    const float m = s / (float)D;
    float v = 0.0f;
    for (int i = 0; i < D; ++i) {
      const float d = row[i] - m;
      v += d * d;
    }
    mu[t] = m;
    rstd[t] = 1.0f / sqrtf(v / (float)D + LN_EPS);
  }
}

__device__ inline void tl_phase(int ph, const LayerArgs& a, float* base,
                                int b, int tid, int nt) {
  const Smem m = tl_layout(a, base);
  const int T = a.T, D = a.D, F = a.F;
  const int nrb = (T + RB - 1) / RB;
  switch (ph) {
    case 0:  // load the sample
      for (int idx = tid; idx < T * D; idx += nt)
        m.x[(idx / D) * m.ld + idx % D] = a.x[(size_t)b * T * D + idx];
      break;
    case 1:  // q, k, v
      for (int idx = tid; idx < 3 * D * nrb; idx += nt) {
        const int which = idx / (D * nrb), r = idx % (D * nrb);
        const float* W = which == 0 ? a.wq : which == 1 ? a.wk : a.wv;
        const float* bias = which == 0 ? a.bq : which == 1 ? a.bk : a.bv;
        float* o = which == 0 ? m.q : which == 1 ? m.k : m.v;
        dense_item(m.x, m.ld, D, W, bias, D, r % D, (r / D) * RB, T, o, m.ld,
                   nullptr, 0, false);
      }
      break;
    case 2: {  // scores q k^T / sqrt(D)
      if (a.res != nullptr)
        for (int idx = tid; idx < 3 * T * D; idx += nt) {
          const int which = idx / (T * D), r = idx % (T * D);
          const float* src = which == 0 ? m.q : which == 1 ? m.k : m.v;
          tl_res(a.res, R_Q + which, b, a.B, T, D, F)[r] =
              src[(r / D) * m.ld + r % D];
        }
      const float scale = sqrtf((float)D);
      for (int idx = tid; idx < T * T; idx += nt) {
        const int t = idx / T, u = idx % T;
        const float* qr = m.q + t * m.ld;
        const float* kr = m.k + u * m.ld;
        float s = 0.0f;
        for (int i = 0; i < D; ++i) s = fmaf(qr[i], kr[i], s);
        m.s[t * m.lds + u] = s / scale;
      }
      break;
    }
    case 3:  // row softmax, maximum subtracted
      for (int t = tid; t < T; t += nt) {
        float* row = m.s + t * m.lds;
        float mx = row[0];
        for (int u = 1; u < T; ++u) mx = fmaxf(mx, row[u]);
        float sum = 0.0f;
        for (int u = 0; u < T; ++u) {
          row[u] = expf(row[u] - mx);
          sum += row[u];
        }
        for (int u = 0; u < T; ++u) row[u] = row[u] / sum;
      }
      break;
    case 4:  // context a v, into q's rows
      if (a.res != nullptr)
        for (int idx = tid; idx < T * T; idx += nt)
          tl_res(a.res, R_P, b, a.B, T, D, F)[idx] =
              m.s[(idx / T) * m.lds + idx % T];
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, i = idx % D;
        const float* ar = m.s + t * m.lds;
        float c = 0.0f;
        for (int u = 0; u < T; ++u) c = fmaf(ar[u], m.v[u * m.ld + i], c);
        m.q[t * m.ld + i] = c;
      }
      break;
    case 5:  // x + out-projection, into k's rows
      if (a.res != nullptr)
        for (int idx = tid; idx < T * D; idx += nt)
          tl_res(a.res, R_CTX, b, a.B, T, D, F)[idx] =
              m.q[(idx / D) * m.ld + idx % D];
      for (int idx = tid; idx < D * nrb; idx += nt)
        dense_item(m.q, m.ld, D, a.wo, a.bo, D, idx % D, (idx / D) * RB, T,
                   m.k, m.ld, m.x, m.ld, false);
      break;
    case 6:
      ln_stats(m.k, m.ld, T, D, m.mu, m.rstd, tid, nt);
      break;
    case 7:  // y = LN1, into v's rows
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, j = idx % D;
        const float xh = (m.k[t * m.ld + j] - m.mu[t]) * m.rstd[t];
        const float y = xh * a.ln1s[j] + a.ln1b[j];
        m.v[t * m.ld + j] = y;
        if (a.res != nullptr) {
          tl_res(a.res, R_XHAT1, b, a.B, T, D, F)[idx] = xh;
          tl_res(a.res, R_Y, b, a.B, T, D, F)[idx] = y;
          if (j == 0) tl_res(a.res, R_RSTD1, b, a.B, T, D, F)[t] = m.rstd[t];
        }
      }
      break;
    case 8:  // h = relu(y W1 + b1)
      for (int idx = tid; idx < F * nrb; idx += nt)
        dense_item(m.v, m.ld, D, a.w1, a.b1, F, idx % F, (idx / F) * RB, T,
                   m.h, m.ldh, nullptr, 0, true);
      break;
    case 9:  // y + h W2 + b2, into k's rows
      if (a.res != nullptr)
        for (int idx = tid; idx < T * F; idx += nt)
          tl_res(a.res, R_H, b, a.B, T, D, F)[idx] =
              m.h[(idx / F) * m.ldh + idx % F];
      for (int idx = tid; idx < D * nrb; idx += nt)
        dense_item(m.h, m.ldh, F, a.w2, a.b2, D, idx % D, (idx / D) * RB, T,
                   m.k, m.ld, m.v, m.ld, false);
      break;
    case 10:
      ln_stats(m.k, m.ld, T, D, m.mu, m.rstd, tid, nt);
      break;
    case 11:  // out = LN2
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, j = idx % D;
        const float xh = (m.k[t * m.ld + j] - m.mu[t]) * m.rstd[t];
        a.out[(size_t)b * T * D + idx] = xh * a.ln2s[j] + a.ln2b[j];
        if (a.res != nullptr) {
          tl_res(a.res, R_XHAT2, b, a.B, T, D, F)[idx] = xh;
          if (j == 0) tl_res(a.res, R_RSTD2, b, a.B, T, D, F)[t] = m.rstd[t];
        }
      }
      break;
  }
}

// ---------------------------------------------------------------------------
// Backward: from the output gradient g and the saving forward's residuals,
// one block per sample computes the row gradients of the layer,
//   dz2 = LN2'(g)                   dh = (dz2 W2^T) * [h > 0]
//   dy = dz2 + dh W1^T              dr1 = LN1'(dy)
//   dctx = dr1 Wo^T                 dP = dctx v^T,  dv = P^T dctx
//   dS = P * (dP - rowsum(dP * P)) / sqrt(D)
//   dq = dS k,  dk = dS^T q         dx = dr1 + dq Wq^T + dk Wk^T + dv Wv^T
// (LN'(d) = rstd (d s - mean(d s) - xhat mean(d s xhat)) per row), writes
// dx, dq|dk|dv, dr1, dh and dz2 to device memory, and per sample the
// column sums over its T rows that the bias and LayerNorm gradients need
// (part: bq bk bv bo ln1s ln1b b1 b2 ln2s ln2b, 9 D + F floats).  The
// weight gradients are products over all B * T rows (x^T dq, ..., h^T dz2)
// that the wrapper leaves to torch.matmul, and it sums the per-sample
// column sums with one torch reduction: no float atomics anywhere, so two
// calls on the same inputs give the same bits.  The transposed products
// read the transposed weights (Wq^T .. W2^T, (out, in) row-major) so that
// neighbouring threads read neighbouring weights, as in the forward.

struct BwdArgs {
  const float* g;
  float* res;  // the saving forward's residuals (read only here)
  const float *wqt, *wkt, *wvt, *wot, *w1t, *w2t, *ln1s, *ln2s;
  float *dx, *dqkv, *dr1, *dh, *dz2, *part;
  int B, T, D, F;
};

// Shared memory of one sample (floats), rows padded by one float:
//   6 T (D + 1)  g -> dz2 -> dy -> dr1 | xhat2 -> xhat1 -> dv | dctx -> dq |
//                q | k | v -> dk
//   2 T (T + 1)  P | dP -> dS
//   T (F + 1)    dh
//   3 T          rstd and the two row means of a LayerNorm backward
// At B x 17 x 64 with F = 256: 6630 + 612 + 4369 + 51 = 11662 floats,
// 46.6 KB, so four blocks fit in an SM's 227 KB; at the largest shape the
// wrapper takes (T = 32, D = 128, F = 512): 24768 + 2112 + 16416 + 96 =
// 43392 floats, 173.6 KB.
struct BwdSmem {
  float *g, *a, *c, *q, *k, *v, *p, *dp, *h, *rstd, *s1, *s2;
  int ld, lds, ldh;
};

__host__ __device__ inline int tlb_smem_floats(int T, int D, int F) {
  return 6 * T * (D + 1) + 2 * T * (T + 1) + T * (F + 1) + 3 * T;
}

__device__ inline BwdSmem tlb_layout(const BwdArgs& a, float* base) {
  BwdSmem m;
  m.ld = a.D + 1;
  m.lds = a.T + 1;
  m.ldh = a.F + 1;
  const int td = a.T * m.ld, tt = a.T * m.lds;
  m.g = base;
  m.a = m.g + td;
  m.c = m.a + td;
  m.q = m.c + td;
  m.k = m.q + td;
  m.v = m.k + td;
  m.p = m.v + td;
  m.dp = m.p + tt;
  m.h = m.dp + tt;
  m.rstd = m.h + a.T * m.ldh;
  m.s1 = m.rstd + a.T;
  m.s2 = m.s1 + a.T;
  return m;
}

// acc[r] += sum_i in[r0 + r][i] W[i][j] over the rows r0 .. min(r0 + RB,
// T) - 1 (rows past T repeat the last one and are not stored); W is (K, N)
// row-major
__device__ inline void rows_dot(const float* in, int ldi, int K,
                                const float* __restrict__ W, int N, int j,
                                int r0, int T, float* acc) {
  const int rows = (T - r0 < RB) ? T - r0 : RB;
  const float* rp[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) rp[r] = in + (r0 + (r < rows ? r : rows - 1)) * ldi;
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
    const float w = W[i * N + j];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(rp[r][i], w, acc[r]);
  }
}

// means over row t of d * s and of d * s * xhat
__device__ inline void ln_bwd_row(const float* d, const float* xh, int ld,
                                  const float* s, int D, float* s1,
                                  float* s2, int t) {
  float m1 = 0.0f, m2 = 0.0f;
  for (int i = 0; i < D; ++i) {
    const float ds = d[t * ld + i] * s[i];
    m1 += ds;
    m2 = fmaf(ds, xh[t * ld + i], m2);
  }
  s1[t] = m1 / (float)D;
  s2[t] = m2 / (float)D;
}

// column sums over the T rows of one sample: col[j] = sum_t x[t][j] and,
// with xh, colx[j] = sum_t x[t][j] xh[t][j]
__device__ inline void col_sums(const float* x, const float* xh, int ld,
                                int T, float* col, float* colx, int j) {
  float s = 0.0f, sx = 0.0f;
  for (int t = 0; t < T; ++t) {
    s += x[t * ld + j];
    if (xh != nullptr) sx = fmaf(x[t * ld + j], xh[t * ld + j], sx);
  }
  col[j] = s;
  if (xh != nullptr) colx[j] = sx;
}

#define TLB_NUM_PHASES 13

__device__ inline void tlb_phase(int ph, const BwdArgs& a, float* base,
                                 int b, int tid, int nt) {
  const BwdSmem m = tlb_layout(a, base);
  const int B = a.B, T = a.T, D = a.D, F = a.F;
  const int nrb = (T + RB - 1) / RB;
  const size_t row0 = (size_t)b * T;  // first row of the sample
  float* part = a.part + (size_t)b * (9 * D + F);
  float *p_bq = part, *p_bk = part + D, *p_bv = part + 2 * D,
        *p_bo = part + 3 * D, *p_ln1s = part + 4 * D, *p_ln1b = part + 5 * D,
        *p_b1 = part + 6 * D, *p_b2 = part + 6 * D + F,
        *p_ln2s = part + 7 * D + F, *p_ln2b = part + 8 * D + F;
#define RES(f) tl_res(a.res, f, b, B, T, D, F)
  switch (ph) {
    case 0: {  // load g, xhat2, rstd2, q, k, v and P
      const float* xh2 = RES(R_XHAT2);
      const float *rq = RES(R_Q), *rk = RES(R_K), *rv = RES(R_V);
      for (int idx = tid; idx < T * D; idx += nt) {
        const int o = (idx / D) * m.ld + idx % D;
        m.g[o] = a.g[row0 * D + idx];
        m.a[o] = xh2[idx];
        m.q[o] = rq[idx];
        m.k[o] = rk[idx];
        m.v[o] = rv[idx];
      }
      const float* rp = RES(R_P);
      for (int idx = tid; idx < T * T; idx += nt)
        m.p[(idx / T) * m.lds + idx % T] = rp[idx];
      const float* r2 = RES(R_RSTD2);
      for (int t = tid; t < T; t += nt) m.rstd[t] = r2[t];
      break;
    }
    case 1:  // LN2 backward's row means; ln2 scale and bias column sums
      for (int idx = tid; idx < T + D; idx += nt) {
        if (idx < T)
          ln_bwd_row(m.g, m.a, m.ld, a.ln2s, D, m.s1, m.s2, idx);
        else
          col_sums(m.g, m.a, m.ld, T, p_ln2b, p_ln2s, idx - T);
      }
      break;
    case 2:  // dz2, in g's rows
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, j = idx % D, o = t * m.ld + j;
        const float dz = m.rstd[t] * (m.g[o] * a.ln2s[j] - m.s1[t] -
                                      m.a[o] * m.s2[t]);
        m.g[o] = dz;
        a.dz2[row0 * D + idx] = dz;
      }
      break;
    case 3: {  // dh = (dz2 W2^T) * [h > 0]; b2's column sums; load xhat1
      const float* hres = RES(R_H);
      for (int idx = tid; idx < F * nrb + D; idx += nt) {
        if (idx >= F * nrb) {
          col_sums(m.g, nullptr, m.ld, T, p_b2, nullptr, idx - F * nrb);
          continue;
        }
        const int f = idx % F, r0 = (idx / F) * RB;
        float acc[RB] = {};
        rows_dot(m.g, m.ld, D, a.w2t, F, f, r0, T, acc);
        for (int r = 0; r < RB && r0 + r < T; ++r) {
          const int t = r0 + r;
          const float d = hres[t * F + f] > 0.0f ? acc[r] : 0.0f;
          m.h[t * m.ldh + f] = d;
          a.dh[(row0 + t) * F + f] = d;
        }
      }
      const float* xh1 = RES(R_XHAT1);
      for (int idx = tid; idx < T * D; idx += nt)
        m.a[(idx / D) * m.ld + idx % D] = xh1[idx];
      const float* r1 = RES(R_RSTD1);
      for (int t = tid; t < T; t += nt) m.rstd[t] = r1[t];
      break;
    }
    case 4:  // dy = dz2 + dh W1^T, in g's rows; b1's column sums
      for (int idx = tid; idx < D * nrb; idx += nt) {
        const int j = idx % D, r0 = (idx / D) * RB;
        float acc[RB] = {};
        rows_dot(m.h, m.ldh, F, a.w1t, D, j, r0, T, acc);
        for (int r = 0; r < RB && r0 + r < T; ++r)
          m.g[(r0 + r) * m.ld + j] += acc[r];
      }
      for (int f = tid; f < F; f += nt)
        col_sums(m.h, nullptr, m.ldh, T, p_b1, nullptr, f);
      break;
    case 5:  // LN1 backward's row means; ln1 scale and bias column sums
      for (int idx = tid; idx < T + D; idx += nt) {
        if (idx < T)
          ln_bwd_row(m.g, m.a, m.ld, a.ln1s, D, m.s1, m.s2, idx);
        else
          col_sums(m.g, m.a, m.ld, T, p_ln1b, p_ln1s, idx - T);
      }
      break;
    case 6:  // dr1, in g's rows
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, j = idx % D, o = t * m.ld + j;
        const float d = m.rstd[t] * (m.g[o] * a.ln1s[j] - m.s1[t] -
                                     m.a[o] * m.s2[t]);
        m.g[o] = d;
        a.dr1[row0 * D + idx] = d;
      }
      break;
    case 7:  // dctx = dr1 Wo^T; bo's column sums
      for (int idx = tid; idx < D * nrb + D; idx += nt) {
        if (idx >= D * nrb) {
          col_sums(m.g, nullptr, m.ld, T, p_bo, nullptr, idx - D * nrb);
          continue;
        }
        const int i = idx % D, r0 = (idx / D) * RB;
        float acc[RB] = {};
        rows_dot(m.g, m.ld, D, a.wot, D, i, r0, T, acc);
        for (int r = 0; r < RB && r0 + r < T; ++r)
          m.c[(r0 + r) * m.ld + i] = acc[r];
      }
      break;
    case 8:  // dP = dctx v^T; dv = P^T dctx, in xhat1's rows
      for (int idx = tid; idx < T * T + T * D; idx += nt) {
        if (idx < T * T) {
          const int t = idx / T, u = idx % T;
          float s = 0.0f;
          for (int i = 0; i < D; ++i)
            s = fmaf(m.c[t * m.ld + i], m.v[u * m.ld + i], s);
          m.dp[t * m.lds + u] = s;
        } else {
          const int u = (idx - T * T) / D, i = (idx - T * T) % D;
          float s = 0.0f;
          for (int t = 0; t < T; ++t)
            s = fmaf(m.p[t * m.lds + u], m.c[t * m.ld + i], s);
          m.a[u * m.ld + i] = s;
        }
      }
      break;
    case 9:  // rowsum(dP * P)
      for (int t = tid; t < T; t += nt) {
        float s = 0.0f;
        for (int u = 0; u < T; ++u)
          s = fmaf(m.dp[t * m.lds + u], m.p[t * m.lds + u], s);
        m.s1[t] = s;
      }
      break;
    case 10: {  // dS = P * (dP - rowsum) / sqrt(D), in dP
      const float scale = sqrtf((float)D);
      for (int idx = tid; idx < T * T; idx += nt) {
        const int t = idx / T, u = idx % T, o = t * m.lds + u;
        m.dp[o] = m.p[o] * (m.dp[o] - m.s1[t]) / scale;
      }
      break;
    }
    case 11:  // dq = dS k, in dctx's rows; dk = dS^T q, in v's rows
      for (int idx = tid; idx < 2 * T * D; idx += nt) {
        const int which = idx / (T * D), t = (idx % (T * D)) / D,
                  i = idx % D;
        float s = 0.0f;
        if (which == 0) {
          for (int u = 0; u < T; ++u)
            s = fmaf(m.dp[t * m.lds + u], m.k[u * m.ld + i], s);
          m.c[t * m.ld + i] = s;
        } else {
          for (int u = 0; u < T; ++u)
            s = fmaf(m.dp[u * m.lds + t], m.q[u * m.ld + i], s);
          m.v[t * m.ld + i] = s;
        }
        a.dqkv[(row0 + t) * 3 * D + which * D + i] = s;
      }
      for (int idx = tid; idx < T * D; idx += nt)
        a.dqkv[(row0 + idx / D) * 3 * D + 2 * D + idx % D] =
            m.a[(idx / D) * m.ld + idx % D];
      break;
    case 12:  // dx = dr1 + dq Wq^T + dk Wk^T + dv Wv^T; q, k, v bias sums
      for (int idx = tid; idx < D * nrb + 3 * D; idx += nt) {
        if (idx >= D * nrb) {
          const int c = idx - D * nrb, which = c / D;
          col_sums(which == 0 ? m.c : which == 1 ? m.v : m.a, nullptr, m.ld,
                   T, which == 0 ? p_bq : which == 1 ? p_bk : p_bv, nullptr,
                   c % D);
          continue;
        }
        const int i = idx % D, r0 = (idx / D) * RB;
        float acc[RB] = {};
        rows_dot(m.c, m.ld, D, a.wqt, D, i, r0, T, acc);
        rows_dot(m.v, m.ld, D, a.wkt, D, i, r0, T, acc);
        rows_dot(m.a, m.ld, D, a.wvt, D, i, r0, T, acc);
        for (int r = 0; r < RB && r0 + r < T; ++r)
          a.dx[(row0 + r0 + r) * D + i] = m.g[(r0 + r) * m.ld + i] + acc[r];
      }
      break;
  }
#undef RES
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(TL_THREADS)
    transformer_layer_kernel(LayerArgs a) {
  extern __shared__ float smem[];
#pragma unroll
  for (int ph = 0; ph < TL_NUM_PHASES; ++ph) {
    tl_phase(ph, a, smem, blockIdx.x, threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// One block per sample on `stream`; res null for inference, else the
// residual buffer (csrc tl_res); returns cudaGetLastError() (the wrapper
// checks shapes: 1 <= T <= 32, D <= 128, F <= 512).
extern "C" int transformer_layer_launch(
    const void* x, void* out, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, const void* ln1s, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2s,
    const void* ln2b, int B, int T, int D, int F, void* res, void* stream) {
  LayerArgs a;
  a.x = (const float*)x;
  a.out = (float*)out;
  a.wq = (const float*)wq;
  a.bq = (const float*)bq;
  a.wk = (const float*)wk;
  a.bk = (const float*)bk;
  a.wv = (const float*)wv;
  a.bv = (const float*)bv;
  a.wo = (const float*)wo;
  a.bo = (const float*)bo;
  a.ln1s = (const float*)ln1s;
  a.ln1b = (const float*)ln1b;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.b2 = (const float*)b2;
  a.ln2s = (const float*)ln2s;
  a.ln2b = (const float*)ln2b;
  a.T = T;
  a.D = D;
  a.F = F;
  a.res = (float*)res;
  a.B = B;
  const size_t smem = (size_t)tl_smem_floats(T, D, F) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        transformer_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  transformer_layer_kernel<<<B, TL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(TL_THREADS)
    transformer_layer_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
#pragma unroll
  for (int ph = 0; ph < TLB_NUM_PHASES; ++ph) {
    tlb_phase(ph, a, smem, blockIdx.x, threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// The backward, one block per sample on `stream`: weights transposed,
// (out, in) row-major; outputs dx (B, T, D), dqkv (B, T, 3 D), dr1
// (B, T, D), dh (B, T, F), dz2 (B, T, D) and part (B, 9 D + F).  Returns
// cudaGetLastError() (the wrapper checks the shapes and the residuals).
extern "C" int transformer_layer_bwd_launch(
    const void* g, void* res, const void* wqt, const void* wkt,
    const void* wvt, const void* wot, const void* w1t, const void* w2t,
    const void* ln1s, const void* ln2s, void* dx, void* dqkv, void* dr1,
    void* dh, void* dz2, void* part, int B, int T, int D, int F,
    void* stream) {
  BwdArgs a;
  a.g = (const float*)g;
  a.res = (float*)res;
  a.wqt = (const float*)wqt;
  a.wkt = (const float*)wkt;
  a.wvt = (const float*)wvt;
  a.wot = (const float*)wot;
  a.w1t = (const float*)w1t;
  a.w2t = (const float*)w2t;
  a.ln1s = (const float*)ln1s;
  a.ln2s = (const float*)ln2s;
  a.dx = (float*)dx;
  a.dqkv = (float*)dqkv;
  a.dr1 = (float*)dr1;
  a.dh = (float*)dh;
  a.dz2 = (float*)dz2;
  a.part = (float*)part;
  a.B = B;
  a.T = T;
  a.D = D;
  a.F = F;
  const size_t smem = (size_t)tlb_smem_floats(T, D, F) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        transformer_layer_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  transformer_layer_bwd_kernel<<<B, TL_THREADS, smem,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
