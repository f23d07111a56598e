// Mamba2 SSD intra-chunk dual form for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_chunk_kernel (the
// Pallas TPU kernel, body _ssd_chunk_kernel).  Same function, per (batch b,
// chunk c, head h) over the chunk's Q rows:
//   cum         = cumsum(dt * A[h])
//   L[i, j]     = exp(clip(cum_i - cum_j, -60, 0)) for i >= j, 0 above
//   y_intra     = ((C B^T) o L) (x * dt)                      (Q x P)
//   state       = (x * dt * exp(clip(cum_end - cum, -60, 0)))^T B  (P x N)
//   in_decay    = exp(clip(cum, -60, 0)),  chunk_decay = exp(clip(cum_end, -60, 0))
// all in fp32, written in the TPU kernel's layouts: y (B,nc,H,Q,P), states
// (B,nc,H,P,N), in_decay (B,nc,H,Q), chunk_decay (B,nc,H,1).  The mask is
// applied after the exp, as the reference's where() does: above the diagonal
// cum_i - cum_j > 0 and the clip alone would give exp(0) = 1.
//
// Inputs are read in place: x (B,S,H,P) and dt (B,S,H) with their strides
// (the TPU wrapper's transposes to (B,nc,H,Q,P) are a BlockSpec artefact), B
// and C (B,S,N).  S need not be a multiple of Q: rows past S read as the
// TPU wrapper's zero padding (dt = x = B = C = 0, so cum stays flat there).
//
// What bounds it on an H100: at the mamba2-1.3b prefill shape (B=2, S=1024,
// H=64, P=64, N=128, Q=256) the necessary work is ~4.4 GFLOP (the lower
// triangle of both Q x Q products, and C B^T once per (b, chunk)) against
// ~87 MB moved, so it is bound by operations: ~0.066 ms at the 67 TFLOP/s
// fp32 rate.  It computes in fp32 on the CUDA cores (FFMA; TF32 would miss
// the fp32 tolerance), built without fast math so that expf is the accurate
// one.
//
// What the design does about it: one CTA (256 threads) per (b, chunk, head)
// keeps the chunk's working set out of HBM.  The whole (Q x Q) C B^T tile
// (256 KB at Q = 256) does not fit the 227 KB of shared memory, so the CTA
// walks 64-row i-blocks and, for each, the j-blocks j <= i: it stages C_i,
// B_j and (x dt)_j (zero-padded to the template widths NP, NN), forms
// (C_i B_j^T) o L in a 64 x 64 shared tile and accumulates y_i in registers
// (4 rows x NP/16 columns a thread).  Blocks above the diagonal are skipped
// (they are exactly 0).  A second walk over the j-blocks accumulates the
// P x N state in registers.  cum is a block-wide scan (warp shuffles), one
// row a thread.  C B^T does not depend on the head and is recomputed by each
// of the H CTAs of a (b, chunk); one CTA per (b, chunk) over all heads, with
// mma for the products, is the later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;          // 16 x 16; one thread per chunk row for the scan
constexpr int kMaxQ = kThreads;
constexpr int BR = 64;                 // rows of an i- or j-block
constexpr int LDS = BR + 4;            // row stride of the (G o L) tile

__device__ __forceinline__ float decay(float v) { return expf(fminf(fmaxf(v, -60.f), 0.f)); }

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// out[0 .. W-1] = p[0 .. W-1]; p is aligned to W floats (W <= 4) or to 4.
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&out)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      out[k] = t.x; out[k + 1] = t.y; out[k + 2] = t.z; out[k + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <int NP, int NN>
constexpr size_t smem_floats() {
  return 2 * kMaxQ + 16 + 2 * (size_t)BR * (NN + 4) + (size_t)BR * (NP + 4) + (size_t)BR * LDS;
}

// Chunk rows r0 .. r0+63 of a (B, S, N) operand (src = its batch row 0 of
// the chunk) into dst (BR x (NN+4)); zero past the valid rows and past N.
template <int NN>
__device__ void stage_bc(float* dst, const float* src, int r0, int rows, int N) {
  constexpr int LDN = NN + 4;
  constexpr int V = NN / 4;
  for (int e = threadIdx.x; e < BR * V; e += kThreads) {
    const int r = e / V, n = (e % V) * 4;
    const int q = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < rows && n < N) val = *reinterpret_cast<const float4*>(src + (size_t)q * N + n);
    *reinterpret_cast<float4*>(dst + r * LDN + n) = val;
  }
}

// (x * dt) of chunk rows r0 .. r0+63 into dst (BR x (NP+4)), times
// exp(clip(cum_end - cum)) when to_end; zero past the valid rows and past P.
// src is x at (b, first row of the chunk, h); rows are row_stride apart.
template <int NP>
__device__ void stage_x(float* dst, const float* src, size_t row_stride, int r0, int rows,
                        int P, const float* dts, const float* cum, float cum_end, bool to_end) {
  constexpr int LDP = NP + 4;
  constexpr int V = NP / 4;
  for (int e = threadIdx.x; e < BR * V; e += kThreads) {
    const int r = e / V, p = (e % V) * 4;
    const int q = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < rows && p < P) {
      val = *reinterpret_cast<const float4*>(src + (size_t)q * row_stride + p);
      const float d = dts[q];
      val.x *= d; val.y *= d; val.z *= d; val.w *= d;
      if (to_end) {
        const float w = decay(cum_end - cum[q]);
        val.x *= w; val.y *= w; val.z *= w; val.w *= w;
      }
    }
    *reinterpret_cast<float4*>(dst + r * LDP + p) = val;
  }
}

// Grid (H, nc, B).  Thread (ty, tx) = (tid / 16, tid % 16).  In the C B^T
// tile it owns rows ty + 16a and columns tx + 16b (a, b < 4); in y_i rows
// ty + 16a and columns tx*CP .. tx*CP+CP-1; in the state rows ty + 16a
// (a < NP/16) and columns tx*CN .. tx*CN+CN-1.
template <int NP, int NN>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ in_decay,
                 float* __restrict__ chunk_decay, int S, int H, int P, int N, int Q) {
  constexpr int LDN = NN + 4;
  constexpr int LDP = NP + 4;
  constexpr int CP = NP / 16;
  constexpr int CN = NN / 16;
  constexpr int RP = NP / 16;
  extern __shared__ float4 sm4[];
  float* cum = reinterpret_cast<float*>(sm4);  // kMaxQ
  float* dts = cum + kMaxQ;                    // kMaxQ
  float* wtot = dts + kMaxQ;                   // 16 (8 used)
  float* Cs = wtot + 16;                       // BR x LDN
  float* Bs = Cs + BR * LDN;                   // BR x LDN
  float* Xs = Bs + BR * LDN;                   // BR x LDP
  float* Ss = Xs + BR * LDP;                   // BR x LDS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int s0 = c * Q;                        // the chunk's first sequence row
  const int rows = min(Q, S - s0);             // its rows inside S
  const size_t bch = ((size_t)b * gridDim.y + c) * H + h;

  // cum = cumsum(dt * A[h]) over the chunk: one row a thread, zero past S
  float v = 0.f;
  dts[tid] = 0.f;
  if (tid < rows) {
    const float d = dt[((size_t)b * S + s0 + tid) * H + h];
    dts[tid] = d;
    v = d * A[h];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wtot[w];
  cum[tid] = v;  // rows past the chunk hold cum[rows - 1]: finite, and met only by zeros
  __syncthreads();
  const float cum_end = cum[Q - 1];
  if (tid < Q) in_decay[bch * Q + tid] = decay(v);
  if (tid == 0) chunk_decay[bch] = decay(cum_end);

  const float* Cc = Cm + ((size_t)b * S + s0) * N;
  const float* Bc = Bm + ((size_t)b * S + s0) * N;
  const size_t xrow = (size_t)H * P;
  const float* xc = x + ((size_t)b * S + s0) * xrow + (size_t)h * P;
  const int nblk = (Q + BR - 1) / BR;

  // y_intra, one 64-row i-block at a time
  float* yo = y + bch * Q * P;
  for (int ib = 0; ib < nblk; ++ib) {
    float acc[4][CP];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < CP; ++k) acc[a][k] = 0.f;
    stage_bc<NN>(Cs, Cc, ib * BR, rows, N);
    for (int jb = 0; jb <= ib; ++jb) {
      stage_bc<NN>(Bs, Bc, jb * BR, rows, N);
      stage_x<NP>(Xs, xc, xrow, jb * BR, rows, P, dts, cum, cum_end, false);
      __syncthreads();

      float g[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[a][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < NN; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * a) * LDN + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * k) * LDN + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            g[a][k] = fmaf(cv[a].x, bv[k].x, g[a][k]);
            g[a][k] = fmaf(cv[a].y, bv[k].y, g[a][k]);
            g[a][k] = fmaf(cv[a].z, bv[k].z, g[a][k]);
            g[a][k] = fmaf(cv[a].w, bv[k].w, g[a][k]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = ib * BR + ty + 16 * a, j = jb * BR + tx + 16 * k;
          Ss[(ty + 16 * a) * LDS + tx + 16 * k] = (j <= i) ? g[a][k] * decay(cum[i] - cum[j]) : 0.f;
        }
      __syncthreads();

#pragma unroll 2
      for (int jj = 0; jj < BR; jj += 4) {
        float4 sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * a) * LDS + jj);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float xv[CP];
          load_row<CP>(Xs + (jj + k) * LDP + tx * CP, xv);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float s = comp(sv[a], k);
#pragma unroll
            for (int e = 0; e < CP; ++e) acc[a][e] = fmaf(s, xv[e], acc[a][e]);
          }
        }
      }
      __syncthreads();  // Bs, Xs, Ss (and Cs after the last j-block) are free again
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ib * BR + ty + 16 * a;
      if (i >= Q) continue;
#pragma unroll
      for (int e = 0; e < CP; ++e) {
        const int p = tx * CP + e;
        if (p < P) yo[(size_t)i * P + p] = acc[a][e];
      }
    }
  }

  // the chunk's outgoing state, sum_j (x dt exp(clip(cum_end - cum)))_j^T B_j
  float st[RP][CN];
#pragma unroll
  for (int a = 0; a < RP; ++a)
#pragma unroll
    for (int e = 0; e < CN; ++e) st[a][e] = 0.f;
  for (int jb = 0; jb < nblk; ++jb) {
    stage_bc<NN>(Bs, Bc, jb * BR, rows, N);
    stage_x<NP>(Xs, xc, xrow, jb * BR, rows, P, dts, cum, cum_end, true);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      float bv[CN];
      load_row<CN>(Bs + r * LDN + tx * CN, bv);
#pragma unroll
      for (int a = 0; a < RP; ++a) {
        const float xv = Xs[r * LDP + ty + 16 * a];
#pragma unroll
        for (int e = 0; e < CN; ++e) st[a][e] = fmaf(xv, bv[e], st[a][e]);
      }
    }
    __syncthreads();
  }
  float* so = states + bch * P * N;
#pragma unroll
  for (int a = 0; a < RP; ++a) {
    const int p = ty + 16 * a;
    if (p >= P) continue;
#pragma unroll
    for (int e = 0; e < CN; ++e) {
      const int n = tx * CN + e;
      if (n < N) so[(size_t)p * N + n] = st[a][e];
    }
  }
}

// Opt the kernel in to the largest dynamic shared memory a block may use, once
// per device; launches then ask for what they need.
template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};  // one flag set per kernel instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  float *y, *states, *in_decay, *chunk_decay;
  int B, S, H, P, N, Q;
  cudaStream_t stream;
};

template <int NP, int NN>
cudaError_t launch(const Args& a) {
  cudaError_t err = allow_smem<ssd_chunk_kernel<NP, NN>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.S + a.Q - 1) / a.Q, a.B);
  ssd_chunk_kernel<NP, NN><<<grid, kThreads, smem_floats<NP, NN>() * sizeof(float), a.stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.y, a.states, a.in_decay, a.chunk_decay, a.S, a.H, a.P, a.N,
      a.Q);
  return cudaGetLastError();
}

// The template widths: P and N rounded up to 16, 32, 64 or 128.
constexpr int width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int NP>
cudaError_t launch_n(const Args& a) {
  switch (width(a.N)) {
    case 16: return launch<NP, 16>(a);
    case 32: return launch<NP, 32>(a);
    case 64: return launch<NP, 64>(a);
    default: return launch<NP, 128>(a);
  }
}

}  // namespace

// All pointers fp32 and contiguous; x, Bm, Cm 16-byte aligned.  0 < Q <= 256;
// P and N multiples of 4 in (0, 128].  Returns the launch's cudaError_t.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, void* y, void* states, void* in_decay,
                                void* chunk_decay, int B, int S, int H, int P, int N, int Q,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > 128 || P % 4 ||
      N <= 0 || N > 128 || N % 4)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<float*>(y),
               static_cast<float*>(states), static_cast<float*>(in_decay),
               static_cast<float*>(chunk_decay), B, S, H, P, N, Q,
               static_cast<cudaStream_t>(stream)};
  switch (width(P)) {
    case 16: return launch_n<16>(a);
    case 32: return launch_n<32>(a);
    case 64: return launch_n<64>(a);
    default: return launch_n<128>(a);
  }
}
