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
};

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
      for (int idx = tid; idx < T * D; idx += nt) {
        const int t = idx / D, i = idx % D;
        const float* ar = m.s + t * m.lds;
        float c = 0.0f;
        for (int u = 0; u < T; ++u) c = fmaf(ar[u], m.v[u * m.ld + i], c);
        m.q[t * m.ld + i] = c;
      }
      break;
    case 5:  // x + out-projection, into k's rows
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
        m.v[t * m.ld + j] =
            (m.k[t * m.ld + j] - m.mu[t]) * m.rstd[t] * a.ln1s[j] + a.ln1b[j];
      }
      break;
    case 8:  // h = relu(y W1 + b1)
      for (int idx = tid; idx < F * nrb; idx += nt)
        dense_item(m.v, m.ld, D, a.w1, a.b1, F, idx % F, (idx / F) * RB, T,
                   m.h, m.ldh, nullptr, 0, true);
      break;
    case 9:  // y + h W2 + b2, into k's rows
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
        a.out[(size_t)b * T * D + idx] =
            (m.k[t * m.ld + j] - m.mu[t]) * m.rstd[t] * a.ln2s[j] + a.ln2b[j];
      }
      break;
  }
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

// One block per sample on `stream`; returns cudaGetLastError() (the
// wrapper checks shapes: 1 <= T <= 32, D <= 128, F <= 512).
extern "C" int transformer_layer_launch(
    const void* x, void* out, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, const void* ln1s, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2s,
    const void* ln2b, int B, int T, int D, int F, void* stream) {
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
#endif
