// Backward of blocked causal GQA attention for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its attention with
// XLA (einsums), and the port's backward before this ran the plain version
// recomputed under autograd, with its fp32 B x H x S x S scores.  This is
// the gradient of flash_attention.cu's function, from the forward's output
// O and its fp32 row log-sum-exp (LSE), in the formulas of
// kernels/flash_attention/ref.py::flash_bwd_ref:
//   D  = rowsum(dO o O)                 P  = exp(S scale - LSE)
//   dV = sum over the group of P^T dO   dP = dO V^T      dS = P o (dP - D)
//   dQ = scale dS K                     dK = scale sum over the group of dS^T Q
// Three launches: (1) D, one warp a row; (2) dK and dV, one CTA per (b, KV
// head, 64-key block), which loops over the group's H / KV query heads and
// over the query blocks from the diagonal on, so the GQA sum happens inside
// the CTA; (3) dQ, one CTA per (b, head, 64-query block), which loops over
// the key blocks up to the diagonal.  S and dP are computed in both (2) and
// (3).  No float atomics: every sum runs in a fixed order, so two runs give
// the same bits.  Rows past S are read as zeros and masked out of P, so S
// need not be a multiple of a block.
//
// What bounds it on an H100: five products of 2 d flops over the causal
// (query, key) pairs (S, dP, dV, dQ, dK) against one pass over q, k, v, O,
// dO and the gradients: at the tinyllama-1.1b train shape (B=8, H 32, KV 4,
// S=1024, d=64) ~0.086 ms of bf16 tensor-core operations, so operations.
// This first version is simple rather than fast: plain loads into padded
// shared memory, one tile at a time, and 4 warps a CTA.  Measured
// (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.97 ms a call at that shape,
// 11x its bound, against scaled_dot_product_attention's 0.63 ms for the
// forward and backward together; the plain recompute it replaces took 26.8.
//
// bf16: the products on the tensor cores (mma.sync m16n8k16, fp32
// accumulators); each warp owns 16 rows (keys in (2), queries in (3)), so S
// (or S^T) and dP come back in accumulator layout, are turned into P and dS
// in registers and rounded once to bf16, and feed the next product as its A
// fragments.  The B operands read K-contiguous rows from shared memory, or
// with ldmatrix.trans where the product's K runs down the rows (dO and Q in
// (2), K in (3)).  At d = 128 the inner tiles are 32 rows, to keep the
// accumulators in registers.
//
// fp32: CUDA-core FFMA only (never TF32), the forward fp32 kernel's layout:
// 128 threads, each owning 4 rows of a 64-row block, P and dS through
// shared memory.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int BR = 64;                // rows of the CTA's own block
constexpr float kLog2e = 1.4426950408889634f;

// --------------------------------------------------------------- D = rowsum(dO o O)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f(o[(size_t)row * D + c]), to_f(dout[(size_t)row * D + c]), s);
#pragma unroll
  for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------------------------ bf16 route

// rows r0 .. r0+n-1 of a (S, D) bf16 matrix into shared memory with row
// pitch LD, zeros past S
template <int D, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int n, int S) {
  constexpr int V = D / 8;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < n * V; e += kThreads) {
    const int r = e / V, c = (e % V) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the m16n8k16 A fragment of rows r0.., columns k0.. of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int r0, int k0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

// the B fragment (k0.., n0..) of a tile stored n-major: row n holds B(., n)
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const bf16* s, int ld, int n0,
                                       int k0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  b0 = ld32(s + (n0 + g) * ld + k0 + 2 * t);
  b1 = ld32(s + (n0 + g) * ld + k0 + 8 + 2 * t);
}

// the B fragment (k0.., n0..) of a tile stored k-major: row k holds B(k, .)
__device__ __forceinline__ void frag_b_trans(uint32_t& b0, uint32_t& b1, const bf16* s, int ld,
                                             int k0, int n0) {
  const uint32_t addr = smem_u32(s + (k0 + threadIdx.x % 16) * ld + n0);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 rows x 8 NT columns) = A (rows r0.. of a, D wide) B^T (rows of b, D wide)
template <int D, int NT, int LD>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4], const bf16* a, int r0,
                                            const bf16* b) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    frag_a(af, a, LD, r0, kk * 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b0, b1;
      frag_b(b0, b1, b, LD, n * 8, kk * 16);
      mma(acc[n], af, b0, b1);
    }
  }
}

// out (16 rows x D) += X (16 x 8 NT, accumulator layout, rounded to bf16) Y
// (8 NT rows of y, D wide, stored k-major)
template <int D, int NT, int LD>
__device__ __forceinline__ void product_xy(float (&out)[D / 8][4], const float (&x)[NT][4],
                                           const bf16* y) {
#pragma unroll
  for (int kq = 0; kq < NT / 2; ++kq) {
    const uint32_t af[4] = {pack_bf16(x[2 * kq][0], x[2 * kq][1]),
                            pack_bf16(x[2 * kq][2], x[2 * kq][3]),
                            pack_bf16(x[2 * kq + 1][0], x[2 * kq + 1][1]),
                            pack_bf16(x[2 * kq + 1][2], x[2 * kq + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t b0, b1;
      frag_b_trans(b0, b1, y, LD, kq * 16, nd * 8);
      mma(out[nd], af, b0, b1);
    }
  }
}

// this thread's accumulator rows (of 16: g and g + 8) and columns of 8 NT
__device__ __forceinline__ int acc_row(int e) { return threadIdx.x % 32 / 4 + 8 * (e / 2); }
__device__ __forceinline__ int acc_col(int n, int e) { return 8 * n + 2 * (threadIdx.x % 4) + e % 2; }

// write a 16 x D accumulator (times `mul`) as bf16 rows r0.. of (S, D)
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int r0, int S,
                                           float mul) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + acc_row(2 * h);
      if (r < S)
        *reinterpret_cast<uint32_t*>(dst + (size_t)r * D + acc_col(nd, 0)) =
            pack_bf16(acc[nd][2 * h] * mul, acc[nd][2 * h + 1] * mul);
    }
}

// (2) dK, dV: CTA (key block, b * KV + kv head); warp w owns keys 16 w ..
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int group, int causal,
                   float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BR * LD;
  bf16* qs = vs + BR * LD;
  bf16* dos = qs + BQ * LD;
  float* ls = reinterpret_cast<float*>(dos + BQ * LD);  // LSE in log2 units
  float* dl = ls + BQ;

  const int k0 = blockIdx.x * BR, kvh = blockIdx.y, kr = threadIdx.x / 32 * 16;
  const float scale_log2 = scale * kLog2e;
  load_rows<D, LD>(ks, k + (size_t)kvh * S * D, k0, BR, S);
  load_rows<D, LD>(vs, v + (size_t)kvh * S * D, k0, BR, S);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int q_first = causal ? k0 / BQ * BQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)kvh * group + hh;
    for (int q0 = q_first; q0 < S; q0 += BQ) {
      __syncthreads();  // the last tile's reads are done
      load_rows<D, LD>(qs, q + bh * S * D, q0, BQ, S);
      load_rows<D, LD>(dos, dout + bh * S * D, q0, BQ, S);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool ok = q0 + i < S;
        ls[i] = ok ? lse[bh * S + q0 + i] * kLog2e : 0.f;
        dl[i] = ok ? delta[bh * S + q0 + i] : 0.f;
      }
      __syncthreads();
      float st[NT][4], dpt[NT][4];  // S^T and dP^T: this warp's 16 keys x BQ queries
      product_abt<D, NT, LD>(st, ks, kr, qs);
      product_abt<D, NT, LD>(dpt, vs, kr, dos);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + acc_row(e), qi = acc_col(n, e), qry = q0 + qi;
          float p = exp2f(fmaf(st[n][e], scale_log2, -ls[qi]));
          if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl[qi]);
        }
      product_xy<D, NT, LD>(dv_acc, st, dos);   // dV += P^T dO
      product_xy<D, NT, LD>(dk_acc, dpt, qs);   // dK += dS^T Q
    }
  }
  store_rows<D>(dk + (size_t)kvh * S * D, dk_acc, k0 + kr, S, scale);
  store_rows<D>(dv + (size_t)kvh * S * D, dv_acc, k0 + kr, S, 1.f);
}

// (3) dQ: CTA (query block, b * H + head); warp w owns queries 16 w ..
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int group, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BR * LD;
  bf16* ks = dos + BR * LD;
  bf16* vs = ks + BK * LD;

  const int q0 = blockIdx.x * BR, qr = threadIdx.x / 32 * 16;
  const size_t bh = blockIdx.y, kvh = bh / group;
  const float scale_log2 = scale * kLog2e;
  load_rows<D, LD>(qs, q + bh * S * D, q0, BR, S);
  load_rows<D, LD>(dos, dout + bh * S * D, q0, BR, S);
  float lrow[2], drow[2];  // LSE (log2 units) and D of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + qr + acc_row(2 * h);
    lrow[h] = r < S ? lse[bh * S + r] * kLog2e : 0.f;
    drow[h] = r < S ? delta[bh * S + r] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;

  const int k_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<D, LD>(ks, k + kvh * S * D, k0, BK, S);
    load_rows<D, LD>(vs, v + kvh * S * D, k0, BK, S);
    __syncthreads();
    float s[NT][4], dp[NT][4];  // this warp's 16 queries x BK keys
    product_abt<D, NT, LD>(s, qs, qr, ks);
    product_abt<D, NT, LD>(dp, dos, qr, vs);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qry = q0 + qr + acc_row(e), key = k0 + acc_col(n, e);
        float p = exp2f(fmaf(s[n][e], scale_log2, -lrow[e / 2]));
        if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
        dp[n][e] = p * (dp[n][e] - drow[e / 2]);
      }
    product_xy<D, NT, LD>(dq_acc, dp, ks);   // dQ += dS K
  }
  store_rows<D>(dq + bh * S * D, dq_acc, q0 + qr, S, scale);
}

// ------------------------------------------------------------------ fp32 route

// thread (ty, tx) = (tid / 8, tid % 8) owns rows 4 ty .. 4 ty + 3 of the
// CTA's block; columns tx + 8 j of a tile
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int r0, int n, int S) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// acc[i][j] = sum_d a[4 ty + i][d] b[tx + 8 j][d]   (rows of pitch D + 1)
template <int D, int NJ>
__device__ __forceinline__ void rows_dot(float (&acc)[4][NJ], const float* a, const float* b) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_m x[4 ty + i][m] y[m][tx + 8 c]   (x pitch M + 1, y pitch D + 1)
template <int D, int M>
__device__ __forceinline__ void rows_times(float (&out)[4][D / 8], const float* x, const float* y) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    float xv[4], yv[D / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = x[(4 * ty + i) * (M + 1) + m];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) yv[c] = y[m * (D + 1) + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) out[i][c] = fmaf(xv[i], yv[c], out[i][c]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, const float (&acc)[4][D / 8], int r0,
                                               int S, float mul) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dst[(size_t)r * D + tx + 8 * c] = acc[i][c] * mul;
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_fp32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int S, int group, int causal,
                    float scale) {
  constexpr int NJ = BQ / 8;
  extern __shared__ float sm[];
  float* ks = sm;                   // BR x (D + 1)
  float* vs = ks + BR * (D + 1);    // BR x (D + 1)
  float* qs = vs + BR * (D + 1);    // BQ x (D + 1)
  float* dos = qs + BQ * (D + 1);   // BQ x (D + 1)
  float* pt = dos + BQ * (D + 1);   // P^T: BR x (BQ + 1)
  float* dst = pt + BR * (BQ + 1);  // dS^T: BR x (BQ + 1)
  float* ls = dst + BR * (BQ + 1);  // BQ
  float* dl = ls + BQ;              // BQ

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int k0 = blockIdx.x * BR, kvh = blockIdx.y;
  load_rows_f32<D>(ks, k + (size_t)kvh * S * D, k0, BR, S);
  load_rows_f32<D>(vs, v + (size_t)kvh * S * D, k0, BR, S);
  float dk_acc[4][D / 8], dv_acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int q_first = causal ? k0 / BQ * BQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)kvh * group + hh;
    for (int q0 = q_first; q0 < S; q0 += BQ) {
      __syncthreads();
      load_rows_f32<D>(qs, q + bh * S * D, q0, BQ, S);
      load_rows_f32<D>(dos, dout + bh * S * D, q0, BQ, S);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool ok = q0 + i < S;
        ls[i] = ok ? lse[bh * S + q0 + i] : 0.f;
        dl[i] = ok ? delta[bh * S + q0 + i] : 0.f;
      }
      __syncthreads();
      float st[4][NJ], dpt[4][NJ];
      rows_dot<D, NJ>(st, ks, qs);
      rows_dot<D, NJ>(dpt, vs, dos);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int key = k0 + 4 * ty + i, qi = tx + 8 * j, qry = q0 + qi;
          float p = expf(st[i][j] * scale - ls[qi]);
          if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
          pt[(4 * ty + i) * (BQ + 1) + qi] = p;
          dst[(4 * ty + i) * (BQ + 1) + qi] = p * (dpt[i][j] - dl[qi]);
        }
      __syncthreads();
      rows_times<D, BQ>(dv_acc, pt, dos);
      rows_times<D, BQ>(dk_acc, dst, qs);
    }
  }
  store_rows_f32<D>(dk + (size_t)kvh * S * D, dk_acc, k0, S, scale);
  store_rows_f32<D>(dv + (size_t)kvh * S * D, dv_acc, k0, S, 1.f);
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int S, int group, int causal, float scale) {
  constexpr int NJ = BK / 8;
  extern __shared__ float sm[];
  float* qs = sm;                   // BR x (D + 1)
  float* dos = qs + BR * (D + 1);   // BR x (D + 1)
  float* ks = dos + BR * (D + 1);   // BK x (D + 1)
  float* vs = ks + BK * (D + 1);    // BK x (D + 1)
  float* dss = vs + BK * (D + 1);   // dS: BR x (BK + 1)

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int q0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y, kvh = bh / group;
  load_rows_f32<D>(qs, q + bh * S * D, q0, BR, S);
  load_rows_f32<D>(dos, dout + bh * S * D, q0, BR, S);
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lrow[i] = r < S ? lse[bh * S + r] : 0.f;
    drow[i] = r < S ? delta[bh * S + r] : 0.f;
  }
  float dq_acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq_acc[i][c] = 0.f;

  const int k_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows_f32<D>(ks, k + kvh * S * D, k0, BK, S);
    load_rows_f32<D>(vs, v + kvh * S * D, k0, BK, S);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    rows_dot<D, NJ>(s, qs, ks);
    rows_dot<D, NJ>(dp, dos, vs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qry = q0 + 4 * ty + i, kj = tx + 8 * j, key = k0 + kj;
        float p = expf(s[i][j] * scale - lrow[i]);
        if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
        dss[(4 * ty + i) * (BK + 1) + kj] = p * (dp[i][j] - drow[i]);
      }
    __syncthreads();
    rows_times<D, BK>(dq_acc, dss, ks);
  }
  store_rows_f32<D>(dq + bh * S * D, dq_acc, q0, S, scale);
}

// ------------------------------------------------------------------ launches

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv;
  float* delta;
  int BH, S, group, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D) {
  const int rows = a.BH * a.S, per_block = 256 / 32;
  flash_bwd_delta<T><<<(rows + per_block - 1) / per_block, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows, D);
  return cudaGetLastError();
}

// the three launches: D, then dK and dV (one CTA per key block and KV row),
// then dQ (one CTA per query block and query row)
template <typename T, int D, auto DKDV, auto DQ>
cudaError_t launch(const Args& a, size_t smem_kv, size_t smem_q) {
  cudaError_t err = launch_delta<T>(a, D);
  if (err == cudaSuccess) err = allow_smem<DKDV>();
  if (err == cudaSuccess) err = allow_smem<DQ>();
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const int blocks = (a.S + BR - 1) / BR;
  DKDV<<<dim3(blocks, a.BH / a.group), kThreads, smem_kv, a.stream>>>(
      q, k, v, dout, lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.group,
      a.causal, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  DQ<<<dim3(blocks, a.BH), kThreads, smem_q, a.stream>>>(
      q, k, v, dout, lse, a.delta, static_cast<T*>(a.dq), a.S, a.group, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  constexpr int BI = D == 128 ? 32 : 64;  // rows of the inner tiles
  constexpr size_t tiles = (size_t)(2 * BR + 2 * BI) * (D + 8) * sizeof(bf16);
  return launch<bf16, D, flash_bwd_dkdv_mma<D, BI>, flash_bwd_dq_mma<D, BI>>(
      a, tiles + 2 * BI * sizeof(float), tiles);
}

template <int D>
cudaError_t launch_fp32(const Args& a) {
  constexpr int BI = D == 128 ? 32 : 64;
  constexpr size_t tiles = (size_t)(2 * BR + 2 * BI) * (D + 1);
  return launch<float, D, flash_bwd_dkdv_fp32<D, BI>, flash_bwd_dq_fp32<D, BI>>(
      a, (tiles + 2 * BR * (BI + 1) + 2 * BI) * sizeof(float),
      (tiles + BR * (BI + 1)) * sizeof(float));
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (mma.sync).  q, o, dout, dq:
// (BH, S, D); k, v, dk, dv: (BH / group, S, D); lse, delta (scratch): fp32
// (BH, S).  Returns the first failing launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, void* delta, int BH,
                                          int S, int D, int group, int causal, int dtype,
                                          float scale, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, static_cast<float*>(delta), BH, S, group,
               causal, scale, static_cast<cudaStream_t>(stream)};
#define FLASH_BWD_CASE(d) \
  case d:                 \
    return dtype == 1 ? launch_mma<d>(a) : launch_fp32<d>(a);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
