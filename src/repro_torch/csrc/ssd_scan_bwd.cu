// Backward of the Mamba2 SSD intra-chunk dual form for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its scan with XLA,
// and the port's backward before this ran ssd_chunk_ref recomputed under
// autograd.  This is the gradient of ssd_scan.cu's four outputs, in the
// formulas of kernels/ssd_scan/ref.py::ssd_chunk_bwd_ref.  Per (batch b,
// chunk c, head h), with cum = cumsum(dt A[h]), L = exp(clip(cum_i - cum_j,
// -60, 0)) below the diagonal, G = C B^T, M = G o L, xdt = x dt,
// de = exp(clip(cum_end - cum, -60, 0)) and the outputs' gradients dy, dS,
// din, dcd:
//   dM = dy xdt^T                 dxdt = M^T dy + de o (B dS^T)
//   dG = dM o L (summed over heads)   dC = dG B      dB = dG^T C + (de o xdt) dS
//   dseg = dM o G o L inside the clip: added to dcum_i, taken from dcum_j
//   d de = rowsum(xdt o (B dS^T)); din and dcd through exp(clip(cum))
//   dx = dxdt dt;  ddt = rowsum(dxdt o x) + A[h] revcumsum(dcum);
//   dA[h] = sum of revcumsum(dcum) dt
// with torch's clamp gradient at the bounds (both included).  Rows past S
// are the forward's zero padding: read as zeros, their gradients not stored.
//
// One CTA per (b, chunk, group of HG heads), 256 threads, fp32 FFMA only.
// The chunk's rows are cut into 64-row blocks; for each j-block J the CTA
// forms G's blocks (i-blocks I >= J) once for its heads, then per head runs
// over the i-blocks with dxdt of J in registers, then adds the states' terms;
// dG summed over the heads of the CTA then gives dB of J (in registers) and
// dC of every I (added in place to this CTA's partial in device memory, by
// the thread that owns each element, in a fixed order).  The CTA's dB and
// dC partials (one per head group) and dA per (b, chunk, head) are summed by
// the wrapper (torch.sum: a fixed order), so no float atomics are used and
// two runs give the same bits.  G's blocks and the head-summed dG live in a
// per-CTA scratch in device memory (L2), each element read back only by the
// thread that wrote it.  dcum is gathered per head in shared memory (row sums
// by warp shuffles, column sums through shared memory, one owner per entry)
// and its reverse cumsum run by one thread a head at the end, in float64
// (decay_end's part of it as the prefix sum it equals, free of the
// cancellation); cum itself is summed and kept in float64.
//
// What bounds it on an H100: at the mamba2-1.3b train shape (B=2, S=1024,
// H=64, P=64, N=128, Q=256) the backward's products, counted from the shapes
// (three over C B^T's lower triangle per (b, chunk), four per head), are
// 8.8e9 FLOPs, 2.02 times the forward's: 0.131 ms at the fp32 CUDA-core rate
// (67 TFLOP/s), operations.  This first version is simple rather than fast
// (one tile at a time through shared memory, no tensor cores): 1.35 ms a
// launch at that shape (chip_smoke.py, H100 80GB HBM3 at 700 W), 10x its
// bound; the plain recompute it replaces took 4.1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;          // 16 x 16: (ty, tx)
constexpr int BR = 64;                 // rows of an i- or j-block
constexpr int kMaxQ = 256;
constexpr int kMaxHeads = 4;           // heads of a CTA
constexpr int LT = BR + 1;             // pitch of a 64 x 64 tile in shared memory

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  const float *gy, *gs, *gin, *gcd;  // the outputs' gradients; null: none
  float *gx, *gdt, *gA, *gB, *gC, *scratch;
  int B, S, H, P, N, Q, HG;
};

__device__ __forceinline__ float decay(float v) { return expf(fminf(fmaxf(v, -60.f), 0.f)); }
__device__ __forceinline__ float in_clip(float v) { return v >= -60.f && v <= 0.f ? 1.f : 0.f; }

// acc[r][c] += sum_{k < K} a(4 ty + r, k) b(k, tx + 16 c)
template <int NC, typename FA, typename FB>
__device__ __forceinline__ void tile_mm(float (&acc)[4][NC], int K, FA a, FB b) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a(4 * ty + r, k);
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = b(k, tx + 16 * c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
}

// sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 8; m > 0; m /= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// rows r0 .. r0+63 of a row-major matrix (`rows` valid rows `stride` floats
// apart, `width` valid columns) into shared memory with pitch ld, `pad`
// columns in all, zeros past both
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t stride,
                                      int r0, int rows, int width, int pad) {
  for (int e = threadIdx.x; e < BR * pad; e += kThreads) {
    const int r = e / pad, col = e % pad;
    dst[r * ld + col] = (r0 + r < rows && col < width) ? src[(size_t)(r0 + r) * stride + col] : 0.f;
  }
}

// NP, NN: columns of P and N a thread covers (16 NP >= P, 16 NN >= N)
template <int NP, int NN>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_bwd(const Args a) {
  constexpr int WP = 16 * NP, WN = 16 * NN;
  constexpr int LP = WP + 1, LN = WN + 1;
  extern __shared__ double sm[];
  double* cum = sm;                  // per head: cumsum(dt A), kept in float64
  float* xs = reinterpret_cast<float*>(cum + kMaxHeads * kMaxQ);  // xdt of the j-block: 64 x LP
  float* bs = xs + BR * LP;          // B of the j-block: 64 x LN
  float* u = bs + BR * LN;           // dy of an i-block (64 x LP), C of an i-block
                                     // (64 x LN) or dS of a head (WP x LN)
  constexpr int kU = (WP * LN > BR * LN ? WP * LN : BR * LN) > BR * LP
                         ? (WP * LN > BR * LN ? WP * LN : BR * LN) : BR * LP;
  float* ms = u + kU;                // M, or the head-summed dG: 64 x LT
  float* colpart = ms + BR * LT;     // 16 x 64
  float* vec = colpart + 16 * BR;    // per head: 5 vectors of kMaxQ
  float* dtv = vec;
  float* grow = dtv + kMaxHeads * kMaxQ;   // row sums of dseg
  float* gcol = grow + kMaxHeads * kMaxQ;  // column sums of dseg
  float* gdet = gcol + kMaxHeads * kMaxQ;  // d de o de inside the clip
  float* gdtp = gdet + kMaxHeads * kMaxQ;  // rowsum(dxdt o x)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.Q;
  const int nc = (S + Q - 1) / Q, groups = (H + a.HG - 1) / a.HG, nJ = (Q + BR - 1) / BR;
  const int g = blockIdx.x % groups, c = blockIdx.x / groups % nc, b = blockIdx.x / groups / nc;
  const int h0 = g * a.HG, nh = min(a.HG, H - h0);
  const int s0 = c * Q;                                     // the chunk's first row
  const int rows = min(Q, S - s0);                          // its rows inside S
  float* G = a.scratch + (size_t)blockIdx.x * 2 * nJ * BR * BR;   // [I][64][64]
  float* dG = G + (size_t)nJ * BR * BR;                            // [I][64][64]
  const float* Bb = a.Bm + ((size_t)b * S + s0) * N;
  const float* Cb = a.Cm + ((size_t)b * S + s0) * N;
  float* gBp = a.gB + (((size_t)g * a.B + b) * S + s0) * N;
  float* gCp = a.gC + (((size_t)g * a.B + b) * S + s0) * N;

  for (int i = threadIdx.x; i < 5 * kMaxHeads * kMaxQ; i += kThreads) vec[i] = 0.f;
  __syncthreads();
  // dt and cum of each head (one thread a head).  cum is summed and kept in
  // float64: its differences set every decay, and in fp32 they carry the
  // rounding of |cum| (up to ~1e3-1e4 at Q = 256), which sums that cancel
  // (dA) magnify
  if (threadIdx.x < nh) {
    const int h = h0 + threadIdx.x;
    const double A = a.A[h];
    double run = 0.0;
    for (int i = 0; i < kMaxQ; ++i) {
      const float d = i < rows ? a.dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
      dtv[threadIdx.x * kMaxQ + i] = d;
      run += d * A;
      cum[threadIdx.x * kMaxQ + i] = run;
    }
  }
  __syncthreads();

  for (int J = 0; J < nJ; ++J) {
    const int j0 = J * BR;
    __syncthreads();                 // the last j-block's reads of bs are done
    stage(bs, LN, Bb, N, j0, rows, N, WN);
    float gb[4][NN];                 // dB of the j-block, summed over the heads
    zero(gb);
    if (a.gy) {                      // G's blocks I >= J
      for (int I = J; I < nJ; ++I) {
        __syncthreads();
        stage(u, LN, Cb, N, I * BR, rows, N, WN);
        __syncthreads();
        float t[4][4];
        zero(t);
        tile_mm(t, WN, [&](int i, int k) { return u[i * LN + k]; },
                [&](int k, int j) { return bs[j * LN + k]; });
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) G[(size_t)I * BR * BR + (4 * ty + r) * BR + tx + 16 * cc] = t[r][cc];
      }
    }
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh;
      const double* cumh = cum + hh * kMaxQ;
      const float* dth = dtv + hh * kMaxQ;
      __syncthreads();               // xs and u are free
      for (int e = threadIdx.x; e < BR * WP; e += kThreads) {
        const int r = e / WP, p = e % WP, j = j0 + r;
        xs[r * LP + p] = (j < rows && p < P)
                             ? a.x[(((size_t)b * S + s0 + j) * H + h) * P + p] * dth[j] : 0.f;
      }
      float gx[4][NP];               // dxdt of the j-block
      zero(gx);
      if (a.gy) {
        const float* gyh = a.gy + (((size_t)b * nc + c) * H + h) * Q * P;
        for (int I = J; I < nJ; ++I) {
          __syncthreads();
          stage(u, LP, gyh, P, I * BR, Q, P, WP);
          __syncthreads();
          float gm[4][4];            // dM of (I, J)
          zero(gm);
          tile_mm(gm, WP, [&](int i, int k) { return u[i * LP + k]; },
                  [&](int k, int j) { return xs[j * LP + k]; });
          float rs[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
          float* gt = G + (size_t)I * BR * BR;
          float* dgt = dG + (size_t)I * BR * BR;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int il = 4 * ty + r, jl = tx + 16 * cc, i = I * BR + il, j = j0 + jl;
              const float seg = (float)(cumh[min(i, kMaxQ - 1)] - cumh[j]);
              const float L = (i < Q && j < Q && i >= j) ? decay(seg) : 0.f;
              const float gv = gt[il * BR + jl];
              ms[il * LT + jl] = gv * L;
              const float dg = gm[r][cc] * L;
              dgt[il * BR + jl] = hh == 0 ? dg : dgt[il * BR + jl] + dg;
              const float dseg = dg * gv * in_clip(seg);
              rs[r] += dseg;
              cs[cc] += dseg;
            }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = row_sum(rs[r]);
            const int i = I * BR + 4 * ty + r;
            if (tx == 0 && i < Q) grow[hh * kMaxQ + i] += v;
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) colpart[ty * BR + tx + 16 * cc] = cs[cc];
          __syncthreads();           // ms and colpart are written
          if (threadIdx.x < BR && j0 + threadIdx.x < Q) {
            float v = 0.f;
            for (int k = 0; k < 16; ++k) v += colpart[k * BR + threadIdx.x];
            gcol[hh * kMaxQ + j0 + threadIdx.x] += v;
          }
          // dxdt += M^T dy
          tile_mm(gx, BR, [&](int j, int i) { return ms[i * LT + j]; },
                  [&](int i, int p) { return u[i * LP + p]; });
        }
      }
      float de[4], dem[4];           // decay_end of this thread's rows, and its clip
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = min(j0 + 4 * ty + r, kMaxQ - 1);
        const float v = (float)(cumh[Q - 1] - cumh[j]);
        de[r] = decay(v);
        dem[r] = in_clip(v);
      }
      if (a.gs) {                    // the states' terms
        __syncthreads();
        const float* gsh = a.gs + (((size_t)b * nc + c) * H + h) * P * N;
        for (int e = threadIdx.x; e < WP * WN; e += kThreads) {
          const int p = e / WN, n = e % WN;
          u[p * LN + n] = (p < P && n < N) ? gsh[(size_t)p * N + n] : 0.f;
        }
        __syncthreads();
        float st[4][NP];             // B dS^T of the j-block
        zero(st);
        tile_mm(st, WN, [&](int j, int n) { return bs[j * LN + n]; },
                [&](int n, int p) { return u[p * LN + n]; });
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = 0.f;
#pragma unroll
          for (int cc = 0; cc < NP; ++cc) {
            v = fmaf(xs[(4 * ty + r) * LP + tx + 16 * cc], st[r][cc], v);
            gx[r][cc] = fmaf(de[r], st[r][cc], gx[r][cc]);
          }
          v = row_sum(v);
          const int j = j0 + 4 * ty + r;
          if (tx == 0 && j < Q) gdet[hh * kMaxQ + j] = v * de[r] * dem[r];
        }
        float t[4][NN];              // xdt dS, then times decay_end by rows
        zero(t);
        tile_mm(t, WP, [&](int j, int p) { return xs[j * LP + p]; },
                [&](int p, int n) { return u[p * LN + n]; });
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < NN; ++cc) gb[r][cc] = fmaf(de[r], t[r][cc], gb[r][cc]);
      }
      // dx = dxdt dt; rowsum(dxdt o x) for ddt
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + 4 * ty + r;
        const bool ok = j < rows;
        const size_t row = ((size_t)b * S + s0 + j) * H + h;
        float v = 0.f;
#pragma unroll
        for (int cc = 0; cc < NP; ++cc) {
          const int p = tx + 16 * cc;
          if (ok && p < P) {
            a.gx[row * P + p] = gx[r][cc] * dth[j];
            v = fmaf(gx[r][cc], a.x[row * P + p], v);
          }
        }
        v = row_sum(v);
        if (tx == 0 && ok) gdtp[hh * kMaxQ + j] = v;
      }
    }
    // dB of J and dC of every I >= J from the head-summed dG
    for (int I = J; I < nJ; ++I) {
      __syncthreads();
      float t[4][NN];
      zero(t);
      if (a.gy) {
        const float* dgt = dG + (size_t)I * BR * BR;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            ms[(4 * ty + r) * LT + tx + 16 * cc] = dgt[(4 * ty + r) * BR + tx + 16 * cc];
        stage(u, LN, Cb, N, I * BR, rows, N, WN);
        __syncthreads();
        tile_mm(gb, BR, [&](int j, int i) { return ms[i * LT + j]; },
                [&](int i, int n) { return u[i * LN + n]; });
        tile_mm(t, BR, [&](int i, int j) { return ms[i * LT + j]; },
                [&](int j, int n) { return bs[j * LN + n]; });
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = I * BR + 4 * ty + r;
        if (i >= rows) continue;
#pragma unroll
        for (int cc = 0; cc < NN; ++cc) {
          const int n = tx + 16 * cc;
          if (n < N) {
            float* dst = gCp + (size_t)i * N + n;
            *dst = J == 0 ? t[r][cc] : *dst + t[r][cc];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * ty + r;
      if (j >= rows) continue;
#pragma unroll
      for (int cc = 0; cc < NN; ++cc) {
        const int n = tx + 16 * cc;
        if (n < N) gBp[(size_t)j * N + n] = gb[r][cc];
      }
    }
  }
  __syncthreads();
  // dcum, its reverse cumsum, ddt and dA: one thread a head
  if (threadIdx.x < nh) {
    const int hh = threadIdx.x, h = h0 + hh;
    const double* cumh = cum + hh * kMaxQ;
    const size_t o = ((size_t)b * nc + c) * H + h;
    // decay_end's terms, -t_j at each j and their sum at Q - 1, reach the
    // reverse cumsum at i as the sum of t_j over j < i: summed forward, so
    // that the whole sum and the terms past i do not cancel.  These sums
    // run in float64 (one thread a head, Q terms).
    float* pre = gdet + hh * kMaxQ;    // becomes the sum over j < i, in place
    double acc = 0.0;
    for (int j = 0; j < Q; ++j) {
      const float tj = pre[j];
      pre[j] = (float)acc;
      acc += tj;
    }
    const double A = a.A[h];
    const float cq = (float)cumh[Q - 1];
    double run = 0.0, dA = 0.0;
    for (int i = Q - 1; i >= 0; --i) {
      double v = (double)grow[hh * kMaxQ + i] - gcol[hh * kMaxQ + i];
      const float ci = (float)cumh[i];
      if (a.gin) v += a.gin[o * Q + i] * decay(ci) * in_clip(ci);
      if (i == Q - 1 && a.gcd) v += a.gcd[o] * decay(cq) * in_clip(cq);
      run += v;
      const double g = run + pre[i];   // d(dt A) at i: the reverse cumsum of dcum
      if (i < rows) a.gdt[((size_t)b * S + s0 + i) * H + h] = (float)(gdtp[hh * kMaxQ + i] + A * g);
      dA += g * dtv[hh * kMaxQ + i];
    }
    a.gA[o] = (float)dA;
  }
}

template <int NP, int NN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int WP = 16 * NP, WN = 16 * NN, LP = WP + 1, LN = WN + 1;
  constexpr int kU0 = WP * LN > BR * LN ? WP * LN : BR * LN;
  constexpr int kU = kU0 > BR * LP ? kU0 : BR * LP;
  constexpr size_t smem =
      sizeof(double) * kMaxHeads * kMaxQ +
      sizeof(float) * ((size_t)BR * LP + BR * LN + kU + BR * LT + 16 * BR + 5 * kMaxHeads * kMaxQ);
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_bwd<NP, NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerBlock);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const int nc = (a.S + a.Q - 1) / a.Q, groups = (a.H + a.HG - 1) / a.HG;
  ssd_chunk_bwd<NP, NN><<<a.B * nc * groups, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N); the outputs' gradients gy
// (B,nc,H,Q,P), gs (B,nc,H,P,N), gin (B,nc,H,Q), gcd (B,nc,H,1), each null
// for none; out: gx, gdt in x's and dt's layouts, gA (B,nc,H), gB and gC
// (groups,B,S,N) per group of HG heads; scratch: fp32, B nc groups x 2 x
// ceil(Q/64) x 64 x 64.  All fp32 and contiguous.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* gy, const void* gs,
                                    const void* gin, const void* gcd, void* gx, void* gdt,
                                    void* gA, void* gB, void* gC, void* scratch, int B, int S,
                                    int H, int P, int N, int Q, int HG, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > 128 || P % 4 ||
      N <= 0 || N > 128 || N % 4 || HG <= 0 || HG > kMaxHeads)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x),   static_cast<const float*>(dt),
               static_cast<const float*>(A),   static_cast<const float*>(Bm),
               static_cast<const float*>(Cm),  static_cast<const float*>(gy),
               static_cast<const float*>(gs),  static_cast<const float*>(gin),
               static_cast<const float*>(gcd), static_cast<float*>(gx),
               static_cast<float*>(gdt),       static_cast<float*>(gA),
               static_cast<float*>(gB),        static_cast<float*>(gC),
               static_cast<float*>(scratch),   B, S, H, P, N, Q, HG};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 64) return N <= 64 ? launch<4, 4>(a, st) : launch<4, 8>(a, st);
  return N <= 64 ? launch<8, 4>(a, st) : launch<8, 8>(a, st);
}
