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
// products and must move 9.1 MB (x, out and the weights once: 2.7 us at
// 3.35 TB/s).  Its products (QKV, q k^T, P v, Wo and the FFN) run on the
// tensor cores in 3xTF32, three TF32 products for each float32 one, so the
// least time is 3 x 1.787 GFLOP at 495 TFLOP/s = 10.8 us (the
// same FLOPs at the CUDA cores' 67 TFLOP/s: 26.7 us).  The saving forward
// (below) is bound by bytes: 50.3 MB of residuals more, 17.7 us.
//
// Design.  The TPU kernel stacked 64 samples so that its matrix unit saw
// (64*17, 64) products.  Here a block takes a tile of G whole samples, G T
// rows padded to a multiple of 48 (G = 8 at T = 17: 136 rows in 144), and
// runs the layer on the tile in shared memory with 12 warps:
//  - The dense products run on tensor cores, mma.sync m16n8k8 TF32 in
//    3xTF32: each operand a splits into big = tf32(a) (round to nearest,
//    ties away from zero, at 10 mantissa bits, as cvt.rna.tf32.f32 rounds:
//    tl_tf32) and small = a - big (which the tensor core reads truncated
//    to TF32), and a b accumulates in float32 as a_big b_small + a_small
//    b_big + a_big b_big, each 16-deep step summed apart (tl_unit_mma): as
//    close to a float64 reference as torch's float32, where one TF32
//    product keeps ~3 digits, short of the 2e-5 / 1e-4 tolerance.
//    mma.sync and not wgmma: a warp owns a 48 x 16 unit of a product and
//    splits its operands in registers, where wgmma would read
//    both operands, K-major and split in two, from shared memory that the
//    tile's activations already fill; and the warp-level tile product
//    tl_unit_mma has a host body (the same split, in loops) that the g++
//    build of this file runs (tests/test_torch_layer_host.py).  Each panel
//    of the main shape has 12 units, one for each warp.
//  - Weights are staged once per tile, not once per sample: a product
//    walks its weight matrix in panels of at most 64 output columns, each
//    copied by cp.async into a ring of two slots in shared memory while the
//    previous panel is in use.  The FFN goes in chunks of 64 of F: W1's
//    columns (h, ReLU), then the matching rows of W2 adding into the
//    output, so the T x F hidden layer is never whole in shared memory.  At
//    G = 8 each weight byte crosses L2 once per tile, 25 MB a launch at B =
//    1024, where one block per sample read 201 MB.
//  - Attention runs on the tensor cores too, a warp per sample
//    (tl_attn_sample): q k^T and P v in 3xTF32, the softmax on the score
//    fragments in registers.  The kernel has two instantiations, by the
//    attention's m-tiles and key tiles a sample: <2, 4> for T <= 32 (the
//    17 and 16 tokens of the 4-frame models) and <3, 6> for T <= 48 (the
//    16-channel LocoTransformer's 33 tokens, 1 + 16 rgb + 16 depth), so
//    that the larger fragment arrays cost the T <= 32 launches no
//    registers.  Both LayerNorms run on the CUDA cores,
//    a warp per six rows, 4 columns a lane (16-byte loads and stores),
//    with butterfly shuffles for the sums (every lane gets the same bits);
//    the mean first and then the mean of the squared deviations, as the
//    reference does.
//  - G: at B = 1024, G = 8 makes 128 tiles for the 132 SMs, one wave of one
//    block (208.5 KB of shared memory) per SM.  A smaller batch takes G =
//    ceil(B / SMs) so that it still spreads over the SMs (eval's B = 8: 8
//    blocks of one sample), and the shared memory caps G (G = 1 at T = 32,
//    D = 128); TL_ROWS_MAX caps it too (G = 4 at T = 33: 132 rows in 144,
//    256 tiles at B = 1024).  The last tile may be ragged.  A tile's rows are padded to
//    whole units (48 rows), so that no unit needs a row guard.
//  - Bank conflicts: activation rows have a stride of 16 mod 32 floats, so
//    that an A fragment's 16-byte loads (lane (g, t) takes k = 4t..4t+3 of
//    a 16-deep step: the same permutation of k on both operands) hit
//    distinct banks; a weight panel's 16-byte chunks are XOR-swizzled by
//    their row (tl_swz), so that a B fragment's rows k = 4t + i of one
//    column hit distinct banks too; v's rows have a stride of 4 mod 32, for
//    P v's B fragments (keys 2t and 2t + 1).
//  - No atomics: every output has one owner, so two calls give the same
//    bits, and the saving forward runs the same arithmetic with more
//    stores.
//
// A tile's layer runs as barrier-separated phases (TL_PHASE), each a
// function of (tile, warp, lane) whose warps write disjoint outputs and
// read only what earlier phases wrote.  On the card each phase is followed
// by cp.async.wait_group and __syncthreads(); the host build runs each
// phase for warps 0..11 in turn (or in reverse), a warp as one lane that
// does all 32 lanes' work (TL_LANES = 1).
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
// and the backward recomputes nothing.  Its design: one block of 256
// threads per sample, 13 barrier-separated phases that also run on the
// host thread by thread (tests/test_torch_layer_bwd_host.py), the
// sample's working set in shared memory, weights through L1/L2, FP32 FMAs.
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <cstring>

#define TL_WARPS 12          // warps of a forward block
#define TL_FWD_THREADS (32 * TL_WARPS)
#define TL_MT 3              // m-tiles (16 rows) of a warp's unit
#define TL_NT 2              // n-tiles (8 columns) of a warp's unit
#define TL_PANEL 64          // output columns of a weight panel, FFN chunk
#define TL_GMAX 8            // samples of a tile, at most
#define TL_ROWS_MAX 144      // rows of a tile, at most (3 units of 48)
#define TL_SMEM_MAX 232448   // shared memory a block may use (bytes)
#define TL_MAX_T 48          // tokens of a sample, at most
// the attention's m-tiles (16 rows) and key tiles (8 keys) of a sample:
// the small instantiation for T <= 32, the large one for T <= TL_MAX_T
#define TL_ATTN_SMALL 2, 4
#define TL_ATTN_LARGE 3, 6
#define TLB_THREADS 256      // threads of a backward block
#define RB 4                 // rows of one backward work item
#define LN_EPS 1e-6f

// On the card each of a warp's 32 lanes runs a phase's statements; the
// host build runs a warp as one lane that does the work of all 32.
#ifdef __CUDA_ARCH__
#define TL_LANES 32
#define TL_NOINLINE __noinline__
#else
#define TL_LANES 1
#define TL_NOINLINE
#endif
#define TL_UNIT (TL_MT * TL_NT * 4)           // a lane's accumulators of a unit
#define TL_FRAG (TL_UNIT * (32 / TL_LANES))  // ... of the lanes it stands for
#define TL_HELD (32 / TL_LANES)  // column quads of a row a lane holds

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

// ---------------------------------------------------------------------------
// Forward: shapes and shared-memory layout of a launch, in floats.
//   X   Rp x ldx   x -> x + ctx Wo + bo -> y -> y + h W2 + b2
//   Q   Rp x ldx   q -> ctx             } attention; the FFN's
//   K   Rp x ldx   k                    } H (Rp x ldh, one chunk of h)
//   V   Rp x ldv   v                    } and Z (Rp x ldx, h W2 so far)
//   W   2 slots    the ring of weight panels
//   P   9 Dp + Fp  bq bk bv bo b1 b2 ln1s ln1b ln2s ln2b, zero past D (F)
// Rows past the tile's samples and columns past D (F) are zero or finite,
// and never stored.  At B x 17 x 64, F = 256: 11520 + 32832 + 8192 + 832
// = 53376 floats, 208.5 KB; at T = 32, D = 128 (G = 1): 45120, 176 KB.
struct TlPlan {
  int G, tiles;       // samples of a tile, tiles
  int Rp, Dp, Fp;     // G T padded to a multiple of 48, D and F of 16
  int ldx, ldh, ldv;  // row strides of X, Q, K, Z; of H; of V
  int nd, np;         // panels across D; panels of the whole layer
  int oX, oQ, oV, oK, oH, oZ, oW, slot, oP, floats;
};

__host__ __device__ inline int tl_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// the smallest stride >= n that is r mod 32
__host__ __device__ inline int tl_stride(int n, int r) {
  return n + ((r - n % 32) % 32 + 32) % 32;
}

__host__ __device__ inline TlPlan tl_plan(int G, int B, int T, int D,
                                          int F) {
  TlPlan p;
  p.G = G;
  p.tiles = (B + G - 1) / G;
  p.Rp = tl_up(G * T, 16 * TL_MT);  // whole units: no row guards
  p.Dp = tl_up(D, 16);
  p.Fp = tl_up(F, 16);
  p.ldx = tl_stride(p.Dp, 16);
  p.ldh = tl_stride(p.Fp < TL_PANEL ? p.Fp : TL_PANEL, 16);
  p.ldv = tl_stride(p.Dp, 4);
  p.nd = (p.Dp + TL_PANEL - 1) / TL_PANEL;
  p.np = 4 * p.nd + 2 * ((p.Fp + TL_PANEL - 1) / TL_PANEL);
  const int act = p.Rp * p.ldx;
  const int attn = 2 * act + p.Rp * p.ldv, ffn = p.Rp * p.ldh + act;
  p.oX = 0;
  p.oQ = act;
  p.oK = p.oQ + act;
  p.oV = p.oK + act;
  p.oH = act;
  p.oZ = p.oH + p.Rp * p.ldh;
  p.oW = act + (attn > ffn ? attn : ffn);
  p.slot = TL_PANEL * tl_up(p.Dp, 32);
  p.oP = p.oW + 2 * p.slot;
  p.floats = p.oP + 9 * p.Dp + p.Fp;
  return p;
}

// The plan of a launch on nsm SMs: G as large as TL_GMAX, TL_ROWS_MAX and
// the shared memory allow, but at most ceil(B / nsm) (the design note).
__host__ __device__ inline TlPlan tl_make_plan(int B, int T, int D, int F,
                                               int nsm) {
  int G = TL_ROWS_MAX / T < TL_GMAX ? TL_ROWS_MAX / T : TL_GMAX;
  while (G > 1 && 4 * (size_t)tl_plan(G, B, T, D, F).floats > TL_SMEM_MAX)
    --G;
  const int want = (B + nsm - 1) / nsm;
  if (want < G) G = want > 1 ? want : 1;
  return tl_plan(G, B, T, D, F);
}

// valid rows of a tile (its samples times T)
__host__ __device__ inline int tl_rows(const TlPlan& pl, int B, int T,
                                       int tile) {
  const int s = B - tile * pl.G;
  return (s < pl.G ? s : pl.G) * T;
}

// The layer's weight panels in order: Wq, Wk, Wv and Wo in nd panels of
// 64 output columns each (K = Dp), then per chunk c of 64 of F a panel of
// W1's columns (K = Dp) and one of W2's rows (K = the chunk, N = Dp).
enum { TP_Q, TP_K, TP_V, TP_O, TP_W1, TP_W2 };

// The parameter vectors, in the order of the P region.
enum { PV_BQ, PV_BK, PV_BV, PV_BO, PV_B1, PV_B2, PV_LN1S, PV_LN1B, PV_LN2S,
       PV_LN2B, PV_NUM };

__host__ __device__ inline const float* tl_vec(const LayerArgs& a, int i) {
  switch (i) {
    case PV_BQ: return a.bq;
    case PV_BK: return a.bk;
    case PV_BV: return a.bv;
    case PV_BO: return a.bo;
    case PV_B1: return a.b1;
    case PV_B2: return a.b2;
    case PV_LN1S: return a.ln1s;
    case PV_LN1B: return a.ln1b;
    case PV_LN2S: return a.ln2s;
    default: return a.ln2b;
  }
}

// offset of vector i in the P region (b1 is Fp long, the others Dp)
__host__ __device__ inline int tl_vec_at(const TlPlan& pl, int i) {
  return pl.oP + i * pl.Dp + (i > PV_B1 ? pl.Fp - pl.Dp : 0);
}

struct TlPanel {
  const float* W;
  int bias;        // the bias's offset in shared memory
  int kind, ldg;   // ldg: W's row stride
  int Kv, Nv;      // W's rows and columns
  int k0, n0;      // the panel's first row and column in W
  int Kp, NS;      // the panel's rows and columns (multiples of 16)
  int ldw, last;   // its stride in the ring; the last W2 chunk
};

__host__ __device__ inline TlPanel tl_panel(const LayerArgs& a,
                                            const TlPlan& pl, int p) {
  TlPanel P;
  if (p < 4 * pl.nd) {
    P.kind = p >> (pl.nd - 1);  // nd is 1 or 2
    P.W = P.kind == TP_Q ? a.wq : P.kind == TP_K ? a.wk
        : P.kind == TP_V ? a.wv : a.wo;
    P.bias = tl_vec_at(pl, P.kind);
    P.ldg = P.Kv = P.Nv = a.D;
    P.k0 = 0;
    P.n0 = TL_PANEL * (p & (pl.nd - 1));
    P.Kp = pl.Dp;
    P.NS = pl.Dp - P.n0 < TL_PANEL ? pl.Dp - P.n0 : TL_PANEL;
    P.last = 0;
  } else {
    const int c = (p - 4 * pl.nd) >> 1;
    const int width = pl.Fp - TL_PANEL * c < TL_PANEL
                          ? pl.Fp - TL_PANEL * c : TL_PANEL;
    if (((p - 4 * pl.nd) & 1) == 0) {
      P.kind = TP_W1;
      P.W = a.w1;
      P.bias = tl_vec_at(pl, PV_B1);
      P.ldg = P.Nv = a.F;
      P.Kv = a.D;
      P.k0 = 0;
      P.n0 = TL_PANEL * c;
      P.Kp = pl.Dp;
      P.NS = width;
    } else {
      P.kind = TP_W2;
      P.W = a.w2;
      P.bias = tl_vec_at(pl, PV_B2);
      P.ldg = P.Nv = a.D;
      P.Kv = a.F;
      P.k0 = TL_PANEL * c;
      P.n0 = 0;
      P.Kp = width;
      P.NS = pl.Dp;
    }
    P.last = p == pl.np - 1;
  }
  P.bias += P.n0;
  P.ldw = tl_up(P.NS, 32);
  return P;
}

// Word of element (k, n) of a staged panel: 16-byte chunks of a row are
// XOR-swizzled by bits 2-3 of k, so that the rows k0 + 4t + i (t = 0..3)
// of the 8 columns of a B fragment fall in 32 distinct banks.
__host__ __device__ inline int tl_swz(int k, int n, int ldw) {
  return k * ldw + (((n >> 2) ^ ((k >> 1) & 6)) << 2) + (n & 3);
}

// a rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, with the low 13 bits zero
__host__ __device__ inline float tl_tf32(float a) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(a);
#else
  memcpy(&u, &a, 4);
#endif
  u = (u + 0x1000u) & 0xffffe000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float r;
  memcpy(&r, &u, 4);
  return r;
#endif
}

// a truncated to TF32: what the tensor core reads of a float32 operand
__host__ __device__ inline float tl_trunc(float a) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(a) & 0xffffe000u;
  return __uint_as_float(u);
#else
  memcpy(&u, &a, 4);
  u &= 0xffffe000u;
  float r;
  memcpy(&r, &u, 4);
  return r;
#endif
}

// the three TF32 products of a b that the tensor cores add: a_big
// b_small, a_small b_big, a_big b_big (small parts truncated to TF32);
// exact in float32
__host__ __device__ inline void tl_3xtf32(float a, float b, float* p) {
  const float ab = tl_tf32(a), as = tl_trunc(a - ab);
  const float bb = tl_tf32(b), bs = tl_trunc(b - bb);
  p[0] = ab * bs;
  p[1] = as * bb;
  p[2] = ab * bb;
}

// a b in 3xTF32
__host__ __device__ inline float tl_tf32x3(float a, float b) {
  float p[3];
  tl_3xtf32(a, b, p);
  return (p[0] + p[1]) + p[2];
}

// Row and column within its unit of accumulator e of a lane: on the card
// the m16n8k8 C fragment of m-tile mi, n-tile ni (lane (g, t) holds rows g
// and g + 8, columns 2t and 2t + 1); on the host, e / TL_UNIT is the lane.
__host__ __device__ __forceinline__ void tl_frag_rc(int e, int lane, int& r,
                                                   int& c) {
  const int l = lane + e / TL_UNIT, q = e % TL_UNIT;
  const int mi = q / (TL_NT * 4), ni = (q / 4) % TL_NT, h = q & 3;
  r = mi * 16 + (l >> 2) + 8 * (h >> 1);
  c = ni * 8 + 2 * (l & 3) + (h & 1);
}

__host__ __device__ __forceinline__ void tl_ld4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

__host__ __device__ __forceinline__ void tl_st4(float* p, const float* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// dst[0..n) = v[0..n), n <= 4, one 16-byte store where it can be
__device__ inline void tl_put4(float* dst, const float* v, int n) {
#ifdef __CUDA_ARCH__
  if (n == 4 && ((size_t)dst & 15) == 0) {
    tl_st4(dst, v);
    return;
  }
#endif
  for (int i = 0; i < n; ++i) dst[i] = v[i];
}

// dst[0..n) = (v0, v1)[0..n), n <= 2, one 8-byte store where it can be
// (the four lanes of a fragment row write 32 contiguous bytes)
__device__ inline void tl_put2(float* dst, float v0, float v1, int n) {
#ifdef __CUDA_ARCH__
  if (n == 2 && ((size_t)dst & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    return;
  }
#endif
  dst[0] = v0;
  if (n == 2) dst[1] = v1;
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ void tl_split(float a, uint32_t& big,
                                         uint32_t& small) {
  const float b = tl_tf32(a);
  big = __float_as_uint(b);
  small = __float_as_uint(a - b);  // the tensor core truncates it to TF32
}

// c += a b on the tensor cores, one m16n8k8 TF32 product (not volatile:
// ptxas may interleave independent products)
__device__ __forceinline__ void tl_mma(float* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// The warp's tile product: acc[e] += sum over k < Kp of A[row0 + r][k]
// W[k][col0 + c] for the lane's accumulators e of the unit at (row0, col0)
// ((r, c) from tl_frag_rc), in 3xTF32.  A is row-major with 16-byte
// aligned rows (stride lda); W is a staged panel (tl_swz, stride ldw); Kp
// is a multiple of 16.  The tensor cores sum each 16-deep step (6
// products: 2 m16n8k8 steps x 3 terms) from zero, and a float32 add puts
// it into acc: the tensor core's own float32 accumulation drops low bits.
// Summed over all of K it left the layer's output up to 5.6e-6 from its
// plain float32 version on the main path's inputs, and one LN2-scale
// gradient outside the gradient check's bound (chip_smoke.py on an H100);
// summed per step, 2.4e-6 and none.  On the card a 16-deep step gives
// lane (g, t) the k = 4t..4t+3: A's as two 16-byte loads per m-tile, W's
// from four rows; each m16n8k8 product takes half of them, k = 4t + 2j
// (its k index t) and 4t + 2j + 1 (its index t + 4) in step j.
__host__ __device__ __forceinline__ void tl_unit_mma(float* acc,
                                                    const float* A, int lda,
                                                    int row0, const float* W,
                                                    int ldw, int col0, int Kp,
                                                    int lane) {
#ifdef __CUDA_ARCH__
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    float lo[TL_MT][4], hi[TL_MT][4], bw[TL_NT][4];
    float blk[TL_UNIT] = {};  // this step's sums
#pragma unroll
    for (int mi = 0; mi < TL_MT; ++mi) {
      const float* p = A + (row0 + mi * 16 + g) * lda + k0 + 4 * t;
      tl_ld4(p, lo[mi]);
      tl_ld4(p + 8 * lda, hi[mi]);
    }
#pragma unroll
    for (int ni = 0; ni < TL_NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bw[ni][i] = W[tl_swz(k0 + 4 * t + i, col0 + ni * 8 + g, ldw)];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ab[TL_MT][4], as[TL_MT][4], bb[TL_NT][2], bs[TL_NT][2];
#pragma unroll
      for (int mi = 0; mi < TL_MT; ++mi) {
        tl_split(lo[mi][2 * j], ab[mi][0], as[mi][0]);
        tl_split(hi[mi][2 * j], ab[mi][1], as[mi][1]);
        tl_split(lo[mi][2 * j + 1], ab[mi][2], as[mi][2]);
        tl_split(hi[mi][2 * j + 1], ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < TL_NT; ++ni) {
        tl_split(bw[ni][2 * j], bb[ni][0], bs[ni][0]);
        tl_split(bw[ni][2 * j + 1], bb[ni][1], bs[ni][1]);
      }
      // each accumulator takes a_big b_small, a_small b_big, a_big b_big
      // in that order; the products of one kind go together, so that
      // consecutive products are independent
#pragma unroll
      for (int kind = 0; kind < 3; ++kind)
#pragma unroll
        for (int mi = 0; mi < TL_MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < TL_NT; ++ni)
            tl_mma(blk + (mi * TL_NT + ni) * 4, kind == 1 ? as[mi] : ab[mi],
                   kind == 0 ? bs[ni] : bb[ni]);
    }
#pragma unroll
    for (int i = 0; i < TL_UNIT; ++i) acc[i] += blk[i];
  }
#else
  for (int e = 0; e < TL_FRAG; ++e) {
    int r, c;
    tl_frag_rc(e, lane, r, c);
    const float* ar = A + (row0 + r) * lda;
    float s = acc[e];
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      float blk = 0.0f;
      for (int j = 0; j < 2; ++j) {
        // the three products of one m16n8k8 step, in the card's order
        float p[3] = {0.0f, 0.0f, 0.0f};
        for (int t = 0; t < 4; ++t)
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + 4 * t + 2 * j + h;
            float q[3];
            tl_3xtf32(ar[k], W[tl_swz(k, col0 + c, ldw)], q);
            p[0] += q[0];
            p[1] += q[1];
            p[2] += q[2];
          }
        blk += p[0];
        blk += p[1];
        blk += p[2];
      }
      s += blk;
    }
    acc[e] = s;
  }
#endif
}

// butterfly sums of n values at once: every lane gets the same bits
__device__ inline void tl_warp_sum(float* v, int n) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
#endif
}

// a / b and 1 / sqrt(a) without the IEEE slow path, whose branch keeps
// the rows a warp runs at once from overlapping (within 2 ulp); plain
// operations on the host
__device__ inline float tl_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdividef(a, b);
#else
  return a / b;
#endif
}

__device__ inline float tl_rsqrt(float a) {
#ifdef __CUDA_ARCH__
  return rsqrtf(a);
#else
  return 1.0f / sqrtf(a);
#endif
}

// cp.async of 16 (4) bytes to shared memory, zeros where !ok (src is then
// any valid address); on the host a plain copy
__device__ inline void tl_cp16(float* dst, const float* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = ok ? src[i] : 0.0f;
#endif
}

__device__ inline void tl_cp4(float* dst, const float* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
#else
  *dst = ok ? *src : 0.0f;
#endif
}

__device__ inline void tl_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// After a phase: wait < 0 only syncs the block; wait 0 first waits for
// all of this thread's copies.
__device__ inline void tl_barrier(int wait) {
#ifdef __CUDA_ARCH__
  if (wait == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
#endif
}

// Copy rows r < rows, columns c < cols (multiples of 4) of src (stride
// lds) into dst (stride ldd, swizzled by tl_swz if swz), zeros where r >=
// rows_ok or c >= cols_ok; in 16-byte chunks where src allows (cols_ok is
// then a multiple of 4 too), else float by float.  Thread idx of n.  Not
// inlined: it runs for x and once per panel, and each inlined copy would
// be code that one block fetches once.
__device__ TL_NOINLINE void tl_copy(float* dst, int ldd, bool swz,
                               const float* src, int lds, int rows_ok,
                               int cols_ok, int rows, int cols, int idx,
                               int n) {
  const bool vec = lds % 4 == 0 && ((size_t)src & 15) == 0;
  const int w = vec ? 4 : 1, q = cols / w;  // pieces of a row
  // piece i is (r, c); stepping i by n steps (r, c) by (dr, dc); shifts
  // where q is a power of two (every panel of the main shape)
  int r, c, dr, dc;
  if ((q & (q - 1)) == 0) {
    int sh = 0;
    while ((1 << sh) < q) ++sh;
    r = idx >> sh;
    c = idx & (q - 1);
    dr = n >> sh;
    dc = n & (q - 1);
  } else {
    r = idx / q;
    c = idx % q;
    dr = n / q;
    dc = n % q;
  }
  for (; r < rows; r += dr, c += dc) {
    if (c >= q) {
      c -= q;
      ++r;
      if (r >= rows) break;
    }
    const bool ok = r < rows_ok && w * c < cols_ok;
    float* d = dst + (swz ? tl_swz(r, w * c, ldd) : r * ldd + w * c);
    const float* s = ok ? src + (size_t)r * lds + w * c : src;
    if (vec)
      tl_cp16(d, s, ok);
    else
      tl_cp4(d, s, ok);
  }
}

// issue the copy of panel p into ring slot p % 2 (one cp.async group)
__device__ inline void tl_stage(const LayerArgs& a, const TlPlan& pl,
                                float* smem, int p, int warp, int lane) {
  const TlPanel P = tl_panel(a, pl, p);
  tl_copy(smem + pl.oW + (p & 1) * pl.slot, P.ldw, true,
          P.W + (size_t)P.k0 * P.ldg + P.n0, P.ldg, P.Kv - P.k0,
          P.Nv - P.n0, P.Kp, P.NS, warp * TL_LANES + lane,
          TL_WARPS * TL_LANES);
  tl_commit();
}

// A residual field: every field is T rows of `width` a sample, so row t
// of sample b, tile row r = (b - tile G) T + t, starts at base + (tile G T
// + r) width.
struct TlRes {
  float* base;
  int width;
};

__device__ inline TlRes tl_res_field(const LayerArgs& a, int f) {
  TlRes r;
  r.base = tl_res(a.res, f, 0, a.B, a.T, a.D, a.F);
  r.width = f == R_H ? a.F : f == R_P ? a.T : f >= R_RSTD1 ? 1 : a.D;
  return r;
}

// the residual row of tile row r
__device__ inline float* tl_res_row(const TlRes& f, const TlPlan& pl, int T,
                                    int tile, int r) {
  return f.base + ((size_t)tile * pl.G * T + r) * f.width;
}

// phase: the warp's units of panel p (slot p % 2); the warp also issues
// its part of the copy of panel p + 1 into the other slot.  The
// accumulators start at what the
// product adds to: the bias (Q, K, V, W1), x + bo (Wo), y + b2 (W2's
// first chunk), h W2 so far (Z, its later chunks).  They go into Q, KT or
// V (and the residuals q, k, v), into X, relu'd into H (and the residual
// h), or, for W2, into Z until the last chunk puts them into X.  Columns
// past D (F) hold zero (so do their weights and biases).
__device__ __forceinline__ void tl_compute(const LayerArgs& a,
                                           const TlPlan& pl, float* smem,
                                           int tile, int p, int warp,
                                           int lane) {
  const TlPanel P = tl_panel(a, pl, p);
  const float* W = smem + pl.oW + (p & 1) * pl.slot;
  const float* A = smem + (P.kind == TP_O ? pl.oQ
                           : P.kind == TP_W2 ? pl.oH : pl.oX);
  const int lda = P.kind == TP_W2 ? pl.ldh : pl.ldx;
  const bool more = P.kind == TP_W2 && P.k0 > 0;
  const bool to_add = more || P.kind == TP_O || P.kind == TP_W2;
  const float* add = smem + (more ? pl.oZ : pl.oX) + P.n0;
  const float* bias = smem + P.bias;
  // destination of output (r, panel column c): out[r * rs + c]
  float* out;
  int rs = pl.ldx;
  switch (P.kind) {
    case TP_Q: out = smem + pl.oQ + P.n0; break;
    case TP_K: out = smem + pl.oK + P.n0; break;
    case TP_V: out = smem + pl.oV + P.n0; rs = pl.ldv; break;
    case TP_W1: out = smem + pl.oH; rs = pl.ldh; break;
    case TP_O: out = smem + pl.oX + P.n0; break;
    default: out = smem + (P.last ? pl.oX : pl.oZ);
  }
  const bool relu = P.kind == TP_W1;
  const bool save = a.res != nullptr && (P.kind <= TP_V || relu);
  TlRes field = {nullptr, 0};
  if (save) field = tl_res_field(a, relu ? R_H : R_Q + P.kind);
  const int nrows = tl_rows(pl, a.B, a.T, tile);
  const int mg = pl.Rp / (16 * TL_MT), ng = P.NS / (8 * TL_NT);
  bool staged = p + 1 >= pl.np;
  for (int u = warp; u < mg * ng; u += TL_WARPS) {
    const int row0 = (u / ng) * 16 * TL_MT, col0 = (u % ng) * 8 * TL_NT;
    float acc[TL_FRAG];
#pragma unroll
    for (int e = 0; e < TL_FRAG; ++e) {
      int r, c;
      tl_frag_rc(e, lane, r, c);
      r += row0;
      c += col0;
      float v = more ? 0.0f : bias[c];
      if (to_add) v = add[r * pl.ldx + c] + v;
      acc[e] = v;
    }
    if (!staged) {  // while the reads above are in flight
      tl_stage(a, pl, smem, p + 1, warp, lane);
      staged = true;
    }
    tl_unit_mma(acc, A, lda, row0, W, P.ldw, col0, P.Kp, lane);
#pragma unroll
    for (int e = 0; e < TL_FRAG; e += 2) {
      int r, c;
      tl_frag_rc(e, lane, r, c);
      r += row0;
      c += col0;
      float v0 = acc[e], v1 = acc[e + 1];
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      out[r * rs + c] = v0;
      out[r * rs + c + 1] = v1;
      const int n = P.Nv - P.n0 - c;  // columns of the pair inside D (F)
      if (save && r < nrows && n > 0)
        tl_put2(tl_res_row(field, pl, a.T, tile, r) + P.n0 + c, v0, v1,
                n < 2 ? n : 2);
    }
  }
  if (!staged) tl_stage(a, pl, smem, p + 1, warp, lane);
}

// The attention of the sample whose rows start at tile row base, for one
// warp: S = q k^T / sqrt(D) against the T keys, softmax with the row
// maximum subtracted, ctx = P v into the rows of q (and the residuals P
// and ctx; rp, rc are unused without them).  On the card S and P v run on
// the tensor cores in 3xTF32, as the dense products, for the sample's MT
// m-tiles of rows at once (T <= 16 MT): S's m16n8k8 tiles (rows g, g + 8;
// keys 2t, 2t + 1 of each of up to NK key tiles, T <= 8 NK) stay in
// registers for the softmax (row maxima and sums over the 4 lanes of a
// row: 2 shuffles), and are P v's A fragments as they are, with P v's k
// index t standing for key 2t and t + 4 for key 2t + 1 of each key tile.
// Rows and keys past T read row T - 1 and are dropped (keys as -inf
// before the softmax).  The host body computes the same products row by
// row, whatever MT and NK.
template <int MT, int NK>
__device__ __forceinline__ void tl_attn_sample(const LayerArgs& a,
                                               const TlPlan& pl, float* smem,
                                               int tile, int base,
                                               float inv_scale,
                                               const TlRes& rp,
                                               const TlRes& rc, int lane) {
  const int T = a.T;
  float* Q = smem + pl.oQ;
  const float* K = smem + pl.oK;
  const float* V = smem + pl.oV;
#ifdef __CUDA_ARCH__
  const int g = lane >> 2, t = lane & 3, nk = (T + 7) / 8, mt = (T + 15) / 16;
  int ra[MT], rb[MT];  // the lane's rows g and g + 8 of each m-tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    ra[m] = base + (16 * m + g < T ? 16 * m + g : T - 1);
    rb[m] = base + (16 * m + g + 8 < T ? 16 * m + g + 8 : T - 1);
  }
  float S[MT][NK][4] = {};  // m-tile m, key tile ni: rows g, g + 8 x
                            // keys 8 ni + 2t, +1
  for (int k0 = 0; k0 < pl.Dp; k0 += 16) {
    float lo[MT][4], hi[MT][4], kb[NK][4], blk[MT][NK][4] = {};
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      tl_ld4(Q + ra[m] * pl.ldx + k0 + 4 * t, lo[m]);
      tl_ld4(Q + rb[m] * pl.ldx + k0 + 4 * t, hi[m]);
    }
#pragma unroll
    for (int ni = 0; ni < NK; ++ni) {
      const int key = 8 * ni + g < T ? 8 * ni + g : T - 1;
      tl_ld4(K + (base + key) * pl.ldx + k0 + 4 * t, kb[ni]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ab[MT][4], as[MT][4], bb[NK][2], bs[NK][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        tl_split(lo[m][2 * j], ab[m][0], as[m][0]);
        tl_split(hi[m][2 * j], ab[m][1], as[m][1]);
        tl_split(lo[m][2 * j + 1], ab[m][2], as[m][2]);
        tl_split(hi[m][2 * j + 1], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NK; ++ni) {
        tl_split(kb[ni][2 * j], bb[ni][0], bs[ni][0]);
        tl_split(kb[ni][2 * j + 1], bb[ni][1], bs[ni][1]);
      }
#pragma unroll
      for (int kind = 0; kind < 3; ++kind)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int ni = 0; ni < NK; ++ni)
            if (m < mt && ni < nk)
              tl_mma(blk[m][ni], kind == 1 ? as[m] : ab[m],
                     kind == 0 ? bs[ni] : bb[ni]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ni = 0; ni < NK; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) S[m][ni][i] += blk[m][ni][i];
  }
  // softmax of rows g (i = 0, 1) and g + 8 (i = 2, 3) of each m-tile
  float mx[MT][2], sum[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    mx[m][0] = mx[m][1] = -INFINITY;
    sum[m][0] = sum[m][1] = 0.0f;
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool key = ni < nk && 8 * ni + 2 * t + (i & 1) < T;
        S[m][ni][i] = key ? S[m][ni][i] * inv_scale : -INFINITY;
        mx[m][i >> 1] = fmaxf(mx[m][i >> 1], S[m][ni][i]);
      }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(0xffffffffu, mx[m][h], o));
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool key = ni < nk && 8 * ni + 2 * t + (i & 1) < T;
        S[m][ni][i] = key ? expf(S[m][ni][i] - mx[m][i >> 1]) : 0.0f;
        sum[m][i >> 1] += S[m][ni][i];
      }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sum[m][h] += __shfl_xor_sync(0xffffffffu, sum[m][h], o);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        S[m][ni][i] = tl_div(S[m][ni][i], sum[m][i >> 1]);
  if (a.res != nullptr)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ni = 0; ni < NK; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * m + g + 8 * (i >> 1);
          const int key = 8 * ni + 2 * t + (i & 1);
          if (row < T && key < T && ni < nk)
            tl_res_row(rp, pl, T, tile, base + row)[key] = S[m][ni][i];
        }
  __syncwarp();  // every lane has read the rows' q
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mt) break;
    // P's A fragments of m-tile m, split
    uint32_t pb[NK][4], ps[NK][4];
#pragma unroll
    for (int ni = 0; ni < NK; ++ni) {
      tl_split(S[m][ni][0], pb[ni][0], ps[ni][0]);
      tl_split(S[m][ni][2], pb[ni][1], ps[ni][1]);
      tl_split(S[m][ni][1], pb[ni][2], ps[ni][2]);
      tl_split(S[m][ni][3], pb[ni][3], ps[ni][3]);
    }
    for (int n0 = 0; n0 < pl.Dp; n0 += 32) {
      float o[4][4] = {};  // column tile nj: rows g, g + 8 x columns 2t, +1
#pragma unroll
      for (int ni = 0; ni < NK; ++ni) {
        if (ni >= nk) continue;
        const int k0 = 8 * ni + 2 * t, k1 = k0 + 1;
        const float* v0 = V + (base + (k0 < T ? k0 : T - 1)) * pl.ldv + n0 + g;
        const float* v1 = V + (base + (k1 < T ? k1 : T - 1)) * pl.ldv + n0 + g;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int c = n0 + 8 * nj < pl.Dp ? 8 * nj : 0;
          tl_split(v0[c], bb[nj][0], bs[nj][0]);
          tl_split(v1[c], bb[nj][1], bs[nj][1]);
        }
        // the large instantiation sums each key tile's three products
        // from zero and adds them in float32, as the dense products sum
        // each 16-deep step (tl_unit_mma), rather than leave its 15-18
        // products to the tensor core's own accumulation (which drops
        // low bits); the small one keeps its 9-12 there, as measured
        // since the tiles were written.  On an H100 the layer's gradient
        // check at (1024, 33) passed 7 of 8 seeds so, 6 of 8 without
        if constexpr (NK > 4) {
          float blk[4][4] = {};
#pragma unroll
          for (int kind = 0; kind < 3; ++kind)
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
              tl_mma(blk[nj], kind == 1 ? ps[ni] : pb[ni],
                     kind == 0 ? bs[nj] : bb[nj]);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[nj][i] += blk[nj][i];
        } else {
#pragma unroll
          for (int kind = 0; kind < 3; ++kind)
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
              tl_mma(o[nj], kind == 1 ? ps[ni] : pb[ni],
                     kind == 0 ? bs[nj] : bb[nj]);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int c = n0 + 8 * nj + 2 * t;
        if (c >= pl.Dp) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * m + g + 8 * h;
          if (row >= T) continue;
          Q[(base + row) * pl.ldx + c] = o[nj][2 * h];
          Q[(base + row) * pl.ldx + c + 1] = o[nj][2 * h + 1];
          const int n = a.D - c;
          if (a.res != nullptr && n > 0)
            tl_put2(tl_res_row(rc, pl, T, tile, base + row) + c, o[nj][2 * h],
                    o[nj][2 * h + 1], n < 2 ? n : 2);
        }
      }
    }
  }
#else
  for (int row = 0; row < T; ++row) {
    float* qr = Q + (base + row) * pl.ldx;
    float p[TL_MAX_T], mx = -INFINITY, sum = 0.0f;
    for (int u = 0; u < T; ++u) {
      const float* kr = K + (base + u) * pl.ldx;
      float s = 0.0f;
      for (int k0 = 0; k0 < pl.Dp; k0 += 16) {
        float blk = 0.0f;
        for (int k = k0; k < k0 + 16; ++k) blk += tl_tf32x3(qr[k], kr[k]);
        s += blk;
      }
      p[u] = s * inv_scale;
      mx = fmaxf(mx, p[u]);
    }
    for (int u = 0; u < T; ++u) {
      p[u] = expf(p[u] - mx);
      sum += p[u];
    }
    for (int u = 0; u < T; ++u) {
      p[u] = tl_div(p[u], sum);
      if (a.res != nullptr) tl_res_row(rp, pl, T, tile, base + row)[u] = p[u];
    }
    float ctx[128];
    for (int c = 0; c < pl.Dp; ++c) {
      ctx[c] = 0.0f;
      for (int u = 0; u < T; ++u)
        ctx[c] += tl_tf32x3(p[u], V[(base + u) * pl.ldv + c]);
    }
    for (int c = 0; c < pl.Dp; ++c) {
      qr[c] = ctx[c];
      if (a.res != nullptr && c < a.D)
        tl_res_row(rc, pl, T, tile, base + row)[c] = ctx[c];
    }
  }
#endif
}

// phase: attention, a warp per sample (tl_attn_sample)
template <int MT, int NK>
__device__ __forceinline__ void tl_attention(const LayerArgs& a,
                                             const TlPlan& pl, float* smem,
                                             int tile, int warp, int lane) {
  const int T = a.T, samples = tl_rows(pl, a.B, T, tile) / T;
  const float inv_scale = 1.0f / sqrtf((float)a.D);
  TlRes rp = {nullptr, 0}, rc = {nullptr, 0};
  if (a.res != nullptr) {
    rp = tl_res_field(a, R_P);
    rc = tl_res_field(a, R_CTX);
  }
  for (int s = warp; s < samples; s += TL_WARPS)
    tl_attn_sample<MT, NK>(a, pl, smem, tile, s * T, inv_scale, rp, rc,
                           lane);
}

// LayerNorm runs TL_RA rows at once in a warp, so that their latency
// chains overlap.
#define TL_RA 6

// phase: LayerNorm of the tile's rows of X, a warp per TL_RA rows, 4
// columns a lane: LN1 writes y into X (and the residuals xhat1, y,
// rstd1), LN2 the output (and xhat2, rstd2).  All rows are computed before
// any is stored, so that no branch separates their chains.
__device__ __forceinline__ void tl_layernorm(const LayerArgs& a,
                                             const TlPlan& pl, float* smem,
                                             int tile, int warp, int lane,
                                             bool second) {
  const int T = a.T, D = a.D;
  const int nrows = tl_rows(pl, a.B, T, tile);
  const float inv_d = 1.0f / (float)D;
  TlRes rx = {nullptr, 0}, ry = {nullptr, 0}, rs = {nullptr, 0};
  if (a.res != nullptr) {
    rx = tl_res_field(a, second ? R_XHAT2 : R_XHAT1);
    ry = tl_res_field(a, R_Y);
    rs = tl_res_field(a, second ? R_RSTD2 : R_RSTD1);
  }
  // the lane's columns c0..c0+3 (lanes past D: columns 0..3, dropped) and
  // their scales and biases (zero past D)
  int c0[TL_HELD];
  float sc[TL_HELD][4], bi[TL_HELD][4];
  for (int j = 0; j < TL_HELD; ++j) {
    c0[j] = 4 * (lane + j * TL_LANES);
    const int c = c0[j] < D ? c0[j] : 0;
    tl_ld4(smem + tl_vec_at(pl, second ? PV_LN2S : PV_LN1S) + c, sc[j]);
    tl_ld4(smem + tl_vec_at(pl, second ? PV_LN2B : PV_LN1B) + c, bi[j]);
  }
  for (int r0 = warp * TL_RA; r0 < nrows; r0 += TL_WARPS * TL_RA) {
    int rr[TL_RA];
    float v[TL_RA][TL_HELD][4], mu[TL_RA], var[TL_RA];
#pragma unroll
    for (int i = 0; i < TL_RA; ++i) {
      rr[i] = r0 + i < nrows ? r0 + i : r0;
      mu[i] = 0.0f;
      for (int j = 0; j < TL_HELD; ++j) {
        tl_ld4(smem + pl.oX + rr[i] * pl.ldx + (c0[j] < D ? c0[j] : 0),
               v[i][j]);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (c0[j] + h >= D) v[i][j][h] = 0.0f;
          mu[i] += v[i][j][h];
        }
      }
    }
    tl_warp_sum(mu, TL_RA);
#pragma unroll
    for (int i = 0; i < TL_RA; ++i) {
      mu[i] = mu[i] * inv_d;
      var[i] = 0.0f;
      for (int j = 0; j < TL_HELD; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float d = c0[j] + h < D ? v[i][j][h] - mu[i] : 0.0f;
          var[i] += d * d;
        }
    }
    tl_warp_sum(var, TL_RA);
    // v becomes xhat; y is xhat * scale + bias (zero past D)
#pragma unroll
    for (int i = 0; i < TL_RA; ++i) {
      var[i] = tl_rsqrt(var[i] * inv_d + LN_EPS);  // rstd
      for (int j = 0; j < TL_HELD; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          v[i][j][h] = c0[j] + h < D ? (v[i][j][h] - mu[i]) * var[i] : 0.0f;
    }
    for (int j = 0; j < TL_HELD; ++j) {
      if (c0[j] >= D) continue;
      const int n = D - c0[j] < 4 ? D - c0[j] : 4;
#pragma unroll
      for (int i = 0; i < TL_RA; ++i) {
        if (r0 + i >= nrows) continue;
        float y[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) y[h] = v[i][j][h] * sc[j][h] + bi[j][h];
        if (second)
          tl_put4(a.out + ((size_t)tile * pl.G * T + rr[i]) * D + c0[j], y,
                  n);
        else
          tl_st4(smem + pl.oX + rr[i] * pl.ldx + c0[j], y);
        if (a.res != nullptr) {
          tl_put4(tl_res_row(rx, pl, T, tile, rr[i]) + c0[j], v[i][j], n);
          if (!second)
            tl_put4(tl_res_row(ry, pl, T, tile, rr[i]) + c0[j], y, n);
          if (lane == 0 && j == 0)
            *tl_res_row(rs, pl, T, tile, rr[i]) = var[i];
        }
      }
    }
  }
}

// phase: the tile's x into X, the parameter vectors into P (zero padded)
// and panel 0 into the ring
__device__ __forceinline__ void tl_load(const LayerArgs& a, const TlPlan& pl,
                                        float* smem, int tile, int warp,
                                        int lane) {
  const int idx = warp * TL_LANES + lane, n = TL_WARPS * TL_LANES;
  tl_copy(smem + pl.oX, pl.ldx, false,
          a.x + (size_t)tile * pl.G * a.T * a.D, a.D,
          tl_rows(pl, a.B, a.T, tile), a.D, pl.Rp, pl.Dp, idx, n);
  // parameter vector v by warp v (TL_WARPS >= PV_NUM)
  if (warp < PV_NUM) {
    const int len = warp == PV_B1 ? a.F : a.D;
    const float* src = tl_vec(a, warp);
    float* dst = smem + tl_vec_at(pl, warp);
    for (int e = lane; e < (warp == PV_B1 ? pl.Fp : pl.Dp); e += TL_LANES)
      tl_cp4(dst + e, e < len ? src + e : src, e < len);
  }
  tl_stage(a, pl, smem, 0, warp, lane);
}

// One phase of a tile: on the card the phase for this thread, then
// tl_barrier(wait).  The host build (tests/test_torch_layer_host.py)
// defines it to run the phase for warps 0..TL_WARPS-1 in turn.
#ifndef TL_PHASE
#define TL_PHASE(wait, call) \
  do {                       \
    call;                    \
    tl_barrier(wait);        \
  } while (0)
#endif

// The layer on tile `tile`: x, the parameter vectors and panel 0 in; per
// panel its product (which also issues the copy of the next panel), with
// attention before Wo, LN1 before the FFN and LN2 after it.  Each phase
// is written once, so that its code is inlined once.  MT, NK: the
// attention's m-tiles and key tiles (TL_ATTN_SMALL or TL_ATTN_LARGE).
template <int MT, int NK>
__device__ inline void tl_tile(const LayerArgs& a, const TlPlan& pl,
                               float* smem, int tile, int warp, int lane) {
  TL_PHASE(0, tl_load(a, pl, smem, tile, warp, lane));
  for (int p = 0;; ++p) {
    if (p == 3 * pl.nd)
      TL_PHASE(-1, (tl_attention<MT, NK>(a, pl, smem, tile, warp, lane)));
    if (p == 4 * pl.nd || p == pl.np)
      TL_PHASE(-1, tl_layernorm(a, pl, smem, tile, warp, lane, p == pl.np));
    if (p == pl.np) break;
    TL_PHASE(0, tl_compute(a, pl, smem, tile, p, warp, lane));
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
// 46.6 KB, so four blocks fit in an SM's 227 KB; at T = 33: 12870 + 2244
// + 8481 + 99 = 23694 floats, 94.8 KB; at T = 32, D = 128, F = 512: 24768
// + 2112 + 16416 + 96 = 43392 floats, 173.6 KB.  Nothing in it is sized
// by T at compile time; the wrapper refuses a shape past 227 KB (at
// T = 48, D = 128, F = 512 it would take 266.5 KB).
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
          if (which == 1) {
            // bk's sum: dk = dS^T q sums over its rows to sum_u q[u]
            // rowsum(dS)[u], and dS's row u to c[u] (1 - sum_t P[u][t]) /
            // sqrt(D) with c = rowsum(dP * P) (s1): the softmax is
            // unchanged by a shift along the keys.  1 - sum P is of the
            // order of P's rounding, so the sum runs in double, far
            // below it; a sum of dk's (or dS's) rounded elements would
            // leave rounding noise of their size instead.
            const int j = c % D;
            float s = 0.0f;
            for (int u = 0; u < T; ++u) {
              double r = 1.0;
              for (int t = 0; t < T; ++t) r -= (double)m.p[u * m.lds + t];
              s = fmaf(m.q[u * m.ld + j], m.s1[u] * (float)r, s);
            }
            p_bk[j] = s / sqrtf((float)D);
            continue;
          }
          col_sums(which == 0 ? m.c : m.a, nullptr, m.ld, T,
                   which == 0 ? p_bq : p_bv, nullptr, c % D);
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
template <int MT, int NK>
__global__ void __launch_bounds__(TL_FWD_THREADS, 1)
    transformer_layer_kernel(LayerArgs a, TlPlan pl) {
  extern __shared__ float4 tl_smem[];
  tl_tile<MT, NK>(a, pl, reinterpret_cast<float*>(tl_smem), blockIdx.x,
                  threadIdx.x >> 5, threadIdx.x & 31);
}

// SMs of the current card (first call: also raises both forward
// instantiations' shared memory limit); 0 on error, in *err
static int tl_num_sms(cudaError_t* err) {
  static int nsm = 0;
  *err = cudaSuccess;
  if (nsm == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(transformer_layer_kernel<TL_ATTN_SMALL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TL_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(transformer_layer_kernel<TL_ATTN_LARGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TL_SMEM_MAX);
    if (e != cudaSuccess) {
      *err = e;
      return 0;
    }
    nsm = n;
  }
  return nsm;
}

// Samples of a tile (G) for a launch at this shape on the current card, or
// minus a cudaError.
extern "C" int transformer_layer_tile_samples(int B, int T, int D, int F) {
  cudaError_t e;
  const int nsm = tl_num_sms(&e);
  return nsm > 0 ? tl_make_plan(B, T, D, F, nsm).G : -(int)e;
}

// One block per tile of G samples on `stream`, the attention's small
// instantiation for T <= 32 and the large one above; res null for
// inference, else the residual buffer (tl_res); returns
// cudaGetLastError() (the wrapper checks shapes: 1 <= T <= TL_MAX_T = 48,
// D <= 128, F <= 512).
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
  cudaError_t e;
  const int nsm = tl_num_sms(&e);
  if (nsm == 0) return (int)e;
  const TlPlan pl = tl_make_plan(B, T, D, F, nsm);
  const size_t smem = (size_t)pl.floats * sizeof(float);
  if (T <= 32)
    transformer_layer_kernel<TL_ATTN_SMALL>
        <<<pl.tiles, TL_FWD_THREADS, smem, (cudaStream_t)stream>>>(a, pl);
  else
    transformer_layer_kernel<TL_ATTN_LARGE>
        <<<pl.tiles, TL_FWD_THREADS, smem, (cudaStream_t)stream>>>(a, pl);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(TLB_THREADS)
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
  transformer_layer_bwd_kernel<<<B, TLB_THREADS, smem,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
