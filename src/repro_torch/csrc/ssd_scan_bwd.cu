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
// What bounds it on an H100: at the mamba2-1.3b train shape (B=2, S=1024,
// H=64, P=64, N=128, Q=256) the backward's products, counted from the shapes
// (three over C B^T's lower triangle per (b, chunk), four per head), are
// 8.8e9 FLOPs: 0.131 ms at the fp32 CUDA-core rate (67 TFLOP/s), operations.
// This kernel runs every product on the tensor cores in bf16x3, three bf16
// products each (0.027 ms at 989 TFLOP/s), which puts the bound on its bytes
// (inputs, the outputs' gradients and the gradients once each: 0.037 ms).
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.477 ms a call at that
// shape (the fp32 FFMA design before it: 1.342), 0.404 at zamba2-1.2b's
// (N=64).  Its products split their operands as they read them from shared
// memory, and that traffic holds them: a 16-warp variant was no faster.
//
// Two launches.  (1) One CTA per (b, chunk, group of HG heads, 64-row
// j-block J), 256 threads, the j-blocks with the most i-blocks (J = 0) first:
// 512 CTAs at the mamba2 shape, for 132 SMs.  A CTA walks the i-blocks I >= J
// from the last one up: G(I, J) = C_I B_J^T once for its heads, then per head
// dM(I, J) = dy_I xdt_J^T, M = G o L into shared memory, dxdt_J += M^T dy_I,
// and dG summed over the heads in registers; then dC_I's partial = dG B_J
// (into this CTA's slot) and dB_J += dG^T C_I.  Each (I, head) step's x_J
// and dy_I come by cp.async into the second of two buffers while the step
// before computes.  The states' terms follow per head (B_J dS^T and (de o
// xdt_J) dS), then dx and rowsum(dxdt o x).  Every product runs mma.sync
// m16n8k16 in bf16x3 (each fp32 operand split into bf16 high and low parts
// as it is read from shared memory; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
// fp32 sums), ~16 bits, as ssd_scan.cu's forward does.  No product stays on
// FFMA: G and dM, which set dseg and so dA, take the same route, since with
// the crossing form below, CPU
// emulation at mamba2's and zamba2's shapes (five inputs each,
// experiments/numerics/ssd_bwd_emulation.py) reads dA at most 8.4e-6 of
// float64 this way, against its 3e-4 limit.  (2) A small launch sums the
// partials in a fixed order and finishes each (b, chunk, head) in one warp,
// in float64: dB, dC, the reverse cumsum of dcum, ddt and dA.  No float
// atomics: two runs give the same bits.
//
// revcumsum(dcum)_i is formed as the sum of dseg over the pairs that cross
// row i (a >= i > b), which the difference of its row and column sums
// telescopes to, free of their cancellation: a CTA writes, per head, the row
// sums of dseg over its j-block for the rows of the blocks below it (each
// such row i gets the suffix sums over a >= i of every j-block above i's),
// and for its own block's rows the crossing pairs inside the diagonal block
// plus the prefix sums of the column sums of the blocks below.
// decay_end's part, the sum of its terms over j < i, is a prefix sum, and
// cum itself is kept in float64.  (The difference form read dA 4e-5-1e-4 of
// float64 even with every product in fp32.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;          // 8 warps: 4 row groups x 2 column halves of a product
constexpr int BR = 64;                 // rows of an i- or j-block
constexpr int kMaxQ = 256;
constexpr int LT = BR + 4;             // pitch of a 64 x 64 tile (4 mod 32: conflict-free k-row reads)
constexpr int LD = BR + 1;             // pitch of the diagonal block's dseg
constexpr int kFinishThreads = 128;    // the second launch: a warp per (b, chunk, head)

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  const float *gy, *gs, *gin, *gcd;    // the outputs' gradients; null: none
  float *gx, *gdt, *gA, *gB, *gC;
  float *part_b, *part_c, *rowp, *diag, *tdet;   // partials (scratch)
  int B, S, H, P, N, Q, HG;
};

__device__ __forceinline__ float decay(float v) { return expf(fminf(fmaxf(v, -60.f), 0.f)); }
__device__ __forceinline__ float in_clip(float v) { return v >= -60.f && v <= 0.f ? 1.f : 0.f; }

// ------------------------------------------------------------- products

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a pair of bf16 packed with x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (this warp's 16 rows m0.. x NT tiles of 8 columns from n0) += A B over
// k < K (a multiple of 16) on the tensor cores in bf16x3, the small products
// first; a(m, k) and b(k, n) read fp32 from shared memory.  Fragments (g =
// lane / 4, t = lane % 4): A(g, 2t..2t+1), A(g+8, ..), A(g, 2t+8..), A(g+8,
// 2t+8..); B(2t..2t+1, g), B(2t+8..2t+9, g); acc[n] = C(g, 2t), C(g, 2t+1),
// C(g+8, 2t), C(g+8, 2t+1) of tile n.
template <int NT, int K, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], int m0, int n0, FA a, FB b) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 2   // (fully unrolled, the products spill at 255 registers)
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int k = k0 + 2 * t;
    uint32_t ah[4], al[4];
    split2(a(m0 + g, k), a(m0 + g, k + 1), ah[0], al[0]);
    split2(a(m0 + g + 8, k), a(m0 + g + 8, k + 1), ah[1], al[1]);
    split2(a(m0 + g, k + 8), a(m0 + g, k + 9), ah[2], al[2]);
    split2(a(m0 + g + 8, k + 8), a(m0 + g + 8, k + 9), ah[3], al[3]);
    // four tiles at a time, each pass over the four before the next, so that
    // no product waits on the one before it for its accumulator
#pragma unroll
    for (int q = 0; q < NT; q += 4) {
      constexpr int G4 = NT < 4 ? NT : 4;
      uint32_t bh[G4][2], bl[G4][2];
#pragma unroll
      for (int n = 0; n < G4; ++n) {
        const int col = n0 + 8 * (q + n) + g;
        split2(b(k, col), b(k + 1, col), bh[n][0], bl[n][0]);
        split2(b(k + 8, col), b(k + 9, col), bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < G4; ++n) mma_bf16(acc[q + n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < G4; ++n) mma_bf16(acc[q + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < G4; ++n) mma_bf16(acc[q + n], ah, bh[n][0], bh[n][1]);
    }
  }
}

// rows r0 .. r0 + nr - 1 of a row-major fp32 matrix (`rows` valid rows
// `stride` floats apart, `width` valid columns, both 16-byte aligned) into
// shared memory with pitch ld, W columns, zeros past both
template <int W>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t stride, int r0,
                                      int nr, int rows, int width) {
  constexpr int V = W / 4;
  for (int e = threadIdx.x; e < nr * V; e += kThreads) {
    const int r = e / V, c = (e % V) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && c < width)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * stride + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// 16 bytes from global to shared memory, asynchronously (zeros where !ok;
// src must still be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {   // at most N groups still in flight
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// stage() by cp.async (not waited for)
template <int W>
__device__ __forceinline__ void stage_async(float* dst, int ld, const float* src, size_t stride,
                                            int r0, int nr, int rows, int width) {
  constexpr int V = W / 4;
  for (int e = threadIdx.x; e < nr * V; e += kThreads) {
    const int r = e / V, c = (e % V) * 4;
    const bool ok = r0 + r < rows && c < width;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}

// ---------------------------------------------------------- scratch layout

struct Dims {
  int nc, nJ, pairs, groups;
  __host__ __device__ Dims(const Args& a)
      : nc((a.S + a.Q - 1) / a.Q), nJ((a.Q + BR - 1) / BR), pairs(nJ * (nJ + 1) / 2),
        groups((a.H + a.HG - 1) / a.HG) {}
};

// part_b (groups, B, S, N): dB per head group; part_c (groups, B, nc, pairs,
// 64, N): dC of i-block I from j-block J at pair I (I + 1) / 2 + J; rowp (B,
// nc, H, nJ, Q): per j-block, the row sums of dseg below it; diag (B, nc, H,
// Q): the crossing pairs of each row's own j-block; tdet (B, nc, H, Q):
// decay_end's terms.
__host__ __device__ inline size_t scratch_floats(const Args& a) {
  const Dims d(a);
  const size_t heads = (size_t)a.B * d.nc * a.H;
  return (size_t)d.groups * a.B * a.S * a.N + (size_t)d.groups * a.B * d.nc * d.pairs * BR * a.N +
         heads * (d.nJ + 2) * a.Q;
}

__host__ __device__ inline void carve(Args& a, float* scratch) {
  const Dims d(a);
  const size_t heads = (size_t)a.B * d.nc * a.H;
  a.part_b = scratch;
  a.part_c = a.part_b + (size_t)d.groups * a.B * a.S * a.N;
  a.rowp = a.part_c + (size_t)d.groups * a.B * d.nc * d.pairs * BR * a.N;
  a.diag = a.rowp + heads * d.nJ * a.Q;
  a.tdet = a.diag + heads * a.Q;
}

// ------------------------------------------------------------- (1) blocks

// WP, WN: P and N rounded up to 64 or 128; HG heads a CTA (4, or 1 at WP = 128)
template <int WP, int WN, int HG>
struct Smem {
  static constexpr int LP = WP + 4, LN = WN + 4;
  static constexpr int NTP = WP / 16;             // 8-column tiles a warp holds of 64 x WP
  static constexpr int NTN = WN / 16;             // ... of 64 x WN
  static constexpr int kU = (WP > BR ? WP : BR) * LN;
  static constexpr int kBufs = WP <= 64 ? 2 : 1;  // x and dy buffers (one ahead), as room allows
  static constexpr size_t kBytes =
      sizeof(double) * HG * kMaxQ +
      sizeof(float) * ((size_t)HG * kMaxQ + BR * LN + kU + 2 * kBufs * BR * LP +
                       HG * kThreads * 4 * NTP + 4 * BR + HG * BR + 4 * BR);
};

template <int WP, int WN, int HG>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_bwd(const Args a) {
  using L = Smem<WP, WN, HG>;
  constexpr int LP = L::LP, LN = L::LN, NTP = L::NTP, NTN = L::NTN;
  extern __shared__ double sm[];
  double* cum = sm;                                          // per head: cumsum(dt A), float64
  float* dtv = reinterpret_cast<float*>(cum + HG * kMaxQ);   // per head: dt
  float* bs = dtv + HG * kMaxQ;                              // B_J: 64 x LN
  float* us = bs + BR * LN;                                  // C_I (64 x LN), or dS (WP x LN)
  // per buffer: x_J of a head (64 x LP), then M (64 x LT), the diagonal
  // block's dseg (64 x LD) or dG (64 x LT); and dy_I of a head (64 x LP)
  float* xbuf = us + L::kU;
  float* ybuf = xbuf + L::kBufs * BR * LP;
  float* dx = ybuf + L::kBufs * BR * LP;   // dxdt_J per head, in the mma layout: [head][value][thread]
  float* colpart = dx + HG * kThreads * 4 * NTP;             // 4 x 64: the row groups' column sums
  float* colacc = colpart + 4 * BR;    // per head: column sums of dseg over the blocks below J
  float* red = colacc + HG * BR;       // 2 x 64: the column halves' row sums
  float* des = red + 2 * BR;           // 64: decay_end of the j-block's rows
  float* dem = des + BR;               // 64: its clip

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g8 = lane / 4, t4 = lane % 4;
  const int m0 = 16 * (warp % 4), half = warp / 4;         // a warp's rows and column half
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.Q;
  const Dims d(a);
  const int per_J = a.B * d.nc * d.groups;
  const int J = blockIdx.x / per_J, item = blockIdx.x % per_J;
  const int gi = item % d.groups, c = item / d.groups % d.nc, b = item / d.groups / d.nc;
  const int h0 = gi * HG, nh = min(HG, H - h0);
  const int s0 = c * Q, rows = min(Q, S - s0), j0 = J * BR;
  if (j0 >= rows) return;                    // padding only: no partial of it is read
  const size_t bc = (size_t)b * d.nc + c;
  const float* Bb = a.Bm + ((size_t)b * S + s0) * N;
  const float* Cb = a.Cm + ((size_t)b * S + s0) * N;
  const size_t xrow = (size_t)H * P;
  const float* xb = a.x + ((size_t)b * S + s0) * xrow;

  // cum (summed and kept in float64: its differences set every decay, and
  // sums that cancel magnify their rounding) and dt of each head: warp w
  // scans head w, lane l rows 8 l .. 8 l + 7
  if (warp < nh) {
    const int h = h0 + warp;
    const double A = a.A[h];
    double v[8], run = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = 8 * lane + k;
      const float dq = q < rows ? a.dt[((size_t)b * S + s0 + q) * H + h] : 0.f;
      dtv[warp * kMaxQ + q] = dq;
      run += (double)dq * A;
      v[k] = run;
    }
    double tot = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double u = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += u;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) cum[warp * kMaxQ + 8 * lane + k] = tot - run + v[k];
  }
  stage<WN>(bs, LN, Bb, N, j0, BR, rows, N);
  for (int e = threadIdx.x; e < HG * BR; e += kThreads) colacc[e] = 0.f;
  for (int e = threadIdx.x; e < HG * kThreads * 4 * NTP; e += kThreads) dx[e] = 0.f;
  __syncthreads();

  float gb[NTN][4];                          // dB_J, summed over the heads
  zero(gb);
  auto dx_of = [&](int hh, int n, int e) -> float& {
    return dx[((hh * NTP + n) * 4 + e) * kThreads + threadIdx.x];
  };

  if (a.gy) {
    // the steps (I, head), I from the last block inside S up to J: each
    // step's x_J and dy_I by cp.async into buffer step % kBufs, one step
    // ahead where there are two buffers
    const int I_top = min(d.nJ - 1, (rows - 1) / BR), n_steps = (I_top - J + 1) * nh;
    auto issue = [&](int st) {
      const int h = h0 + st % nh, buf = st % L::kBufs;
      stage_async<WP>(xbuf + buf * BR * LP, LP, xb + (size_t)h * P, xrow, j0, BR, rows, P);
      stage_async<WP>(ybuf + buf * BR * LP, LP, a.gy + ((bc * H + h) * Q) * P, P,
                      (I_top - st / nh) * BR, BR, Q, P);
      cp_async_commit();
    };
    if (L::kBufs == 2) issue(0);
    int step = 0;
    for (int I = I_top; I >= J; --I) {
      const int i0 = I * BR;
      __syncthreads();                       // us is free
      stage<WN>(us, LN, Cb, N, i0, BR, rows, N);
      __syncthreads();
      // G(I, J) = C_I B_J^T, dM, M, dG, dseg: 64 x 64 in the mma layout, this
      // warp's 16 rows m0.. and 32 columns from 32 half; value (n, e) of a
      // thread at row m0 + g8 + 8 (e / 2), column 32 half + 8 n + 2 t4 + e % 2
      float gv[4][4];
      zero(gv);
      mma_tile<4, WN>(gv, m0, 32 * half, [&](int m, int k) { return us[m * LN + k]; },
                  [&](int k, int n) { return bs[n * LN + k]; });
      float dgs[4][4];                       // dG(I, J), summed over the heads
      zero(dgs);
      for (int hh = 0; hh < nh; ++hh, ++step) {
        const int h = h0 + hh;
        const double* cumh = cum + hh * kMaxQ;
        const float* dth = dtv + hh * kMaxQ;
        float* xs = xbuf + step % L::kBufs * BR * LP;
        const float* ys = ybuf + step % L::kBufs * BR * LP;
        if (L::kBufs == 1) {
          __syncthreads();                   // the last step is done with the buffer
          issue(step);
        }
        cp_async_wait<0>();
        __syncthreads();                     // this step's data has landed; the last step is done
        if (L::kBufs == 2 && step + 1 < n_steps) issue(step + 1);
        float gm[4][4];                      // dM(I, J) = dy_I xdt_J^T
        zero(gm);
        mma_tile<4, WP>(gm, m0, 32 * half, [&](int m, int k) { return ys[m * LP + k]; },
                    [&](int k, int n) { return xs[n * LP + k] * dth[j0 + n]; });
        __syncthreads();                     // xs is read: it takes M
        float rs[2] = {0.f, 0.f}, cs[4][2] = {}, dseg[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = m0 + g8 + 8 * (e / 2), jl = 32 * half + 8 * n + 2 * t4 + e % 2;
            const int i = i0 + il, j = j0 + jl;
            const float seg = (float)(cumh[min(i, kMaxQ - 1)] - cumh[j]);
            const float Lv = (i < Q && j < Q && i >= j) ? decay(seg) : 0.f;
            xs[il * LT + jl] = gv[n][e] * Lv;
            const float dg = gm[n][e] * Lv;
            dgs[n][e] += dg;
            dseg[n][e] = dg * gv[n][e] * in_clip(seg);
            rs[e / 2] += dseg[n][e];
            cs[n][e % 2] += dseg[n][e];
          }
        if (I > J) {                         // row sums for the rows below, column sums kept
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {   // a row: the 4 lanes t4, then the column halves
            float v = rs[h2];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t4 == 0) red[half * BR + m0 + g8 + 8 * h2] = v;
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)        // a column: the 8 lanes g8, then the row groups
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float v = cs[n][q];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (g8 == 0) colpart[(warp % 4) * BR + 32 * half + 8 * n + 2 * t4 + q] = v;
            }
        }
        __syncthreads();                     // M and the sums' parts are written
        if (I > J && threadIdx.x < BR) {
          const int i = i0 + threadIdx.x;
          if (i < Q) a.rowp[((bc * H + h) * d.nJ + J) * Q + i] = red[threadIdx.x] + red[BR + threadIdx.x];
          colacc[hh * BR + threadIdx.x] += (colpart[threadIdx.x] + colpart[BR + threadIdx.x]) +
                                           (colpart[2 * BR + threadIdx.x] + colpart[3 * BR + threadIdx.x]);
        }
        {                                    // dxdt_J += M^T dy_I
          float acc[NTP][4];
#pragma unroll
          for (int n = 0; n < NTP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = dx_of(hh, n, e);
          mma_tile<NTP, BR>(acc, m0, half * WP / 2, [&](int m, int k) { return xs[k * LT + m]; },
                        [&](int k, int n) { return ys[k * LP + n]; });
#pragma unroll
          for (int n = 0; n < NTP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dx_of(hh, n, e) = acc[n][e];
        }
        if (I == J) {
          // revcumsum(dcum) at the block's rows i: the dseg of the pairs
          // (a, b) with a >= i > b, a in this block (the crossing pairs of
          // the diagonal block) or below it (the column sums' prefix)
          __syncthreads();                   // M is read: xs takes dseg
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              xs[(m0 + g8 + 8 * (e / 2)) * LD + 32 * half + 8 * n + 2 * t4 + e % 2] = dseg[n][e];
          __syncthreads();
          const int row = threadIdx.x / 4, part = threadIdx.x % 4;
          {                                  // each row's exclusive prefix sums over b
            float vals[16], tot = 0.f;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              vals[k] = xs[row * LD + 16 * part + k];
              tot += vals[k];
            }
            float incl = tot;
#pragma unroll
            for (int off = 1; off < 4; off *= 2) {
              const float u = __shfl_up_sync(0xffffffffu, incl, off, 4);
              if (part >= off) incl += u;
            }
            float run = incl - tot;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              xs[row * LD + 16 * part + k] = run;
              run += vals[k];
            }
          }
          __syncthreads();
          const int ic = row;                // column i: the rows a >= i of its prefix sums
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int ar = 16 * part + k;
            if (ar >= ic) v += xs[ar * LD + ic];
            if (ar < ic) v += colacc[hh * BR + ar];
          }
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (part == 0 && j0 + ic < Q) a.diag[(bc * H + h) * Q + j0 + ic] = v;
        }
      }
      float* gs_ = xbuf + (step - 1) % L::kBufs * BR * LP;   // the last step's buffer takes dG
      __syncthreads();
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gs_[(m0 + g8 + 8 * (e / 2)) * LT + 32 * half + 8 * n + 2 * t4 + e % 2] = dgs[n][e];
      __syncthreads();
      {                                      // dC_I's partial = dG B_J, this CTA's slot
        float acc[NTN][4];
        zero(acc);
        mma_tile<NTN, BR>(acc, m0, half * WN / 2, [&](int m, int k) { return gs_[m * LT + k]; },
                      [&](int k, int n) { return bs[k * LN + n]; });
        float* pc = a.part_c +
                    (((size_t)gi * a.B + b) * d.nc + c) * d.pairs * BR * N +
                    (size_t)(I * (I + 1) / 2 + J) * BR * N;
#pragma unroll
        for (int n = 0; n < NTN; ++n) {
          const int col = half * WN / 2 + 8 * n + 2 * t4;   // N is a multiple of 4
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = m0 + g8 + 8 * h2;
            if (i0 + r < rows && col < N)
              *reinterpret_cast<float2*>(pc + (size_t)r * N + col) =
                  make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
          }
        }
      }
      // dB_J += dG^T C_I
      mma_tile<NTN, BR>(gb, m0, half * WN / 2, [&](int m, int k) { return gs_[k * LT + m]; },
                    [&](int k, int n) { return us[k * LN + n]; });
    }
  }

  // the states' terms, per head: st = B_J dS^T; dxdt += de o st; decay_end's
  // term rowsum(xdt o st) de; dB_J += (de o xdt_J) dS.  Each head's dS and
  // x_J come by cp.async into buffer hh % kBufs (dS into us, or into the dy
  // buffers, free now), one head ahead where there are two.
  if (a.gs) {
    auto ds_buf = [&](int buf) { return buf ? ybuf : us; };
    auto issue = [&](int hh) {
      const int h = h0 + hh, buf = hh % L::kBufs;
      stage_async<WN>(ds_buf(buf), LN, a.gs + (bc * H + h) * (size_t)P * N, N, 0, WP, P, N);
      stage_async<WP>(xbuf + buf * BR * LP, LP, xb + (size_t)h * P, xrow, j0, BR, rows, P);
      cp_async_commit();
    };
    __syncthreads();                         // us and the buffers are free
    if (L::kBufs == 2) issue(0);
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh, buf = hh % L::kBufs;
      const double* cumh = cum + hh * kMaxQ;
      const float* dth = dtv + hh * kMaxQ;
      const float* dss = ds_buf(buf);
      const float* xss = xbuf + buf * BR * LP;
      __syncthreads();                       // the last head is done with its buffer, red, des
      if (L::kBufs == 1) issue(hh);
      if (threadIdx.x < BR) {
        const float v = (float)(cumh[Q - 1] - cumh[j0 + threadIdx.x]);
        des[threadIdx.x] = decay(v);
        dem[threadIdx.x] = in_clip(v);
      }
      cp_async_wait<0>();
      __syncthreads();
      if (L::kBufs == 2 && hh + 1 < nh) issue(hh + 1);
      float st[NTP][4];
      zero(st);
      mma_tile<NTP, WN>(st, m0, half * WP / 2, [&](int m, int k) { return bs[m * LN + k]; },
                    [&](int k, int n) { return dss[n * LN + k]; });
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NTP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + g8 + 8 * (e / 2), col = half * WP / 2 + 8 * n + 2 * t4 + e % 2;
          dx_of(hh, n, e) += des[r] * st[n][e];
          rsum[e / 2] += xss[r * LP + col] * dth[j0 + r] * st[n][e];
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float v = rsum[h2];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) red[half * BR + m0 + g8 + 8 * h2] = v;
      }
      mma_tile<NTN, WP>(gb, m0, half * WN / 2,
                    [&](int m, int k) { return xss[m * LP + k] * dth[j0 + m] * des[m]; },
                    [&](int k, int n) { return dss[k * LN + n]; });
      __syncthreads();                       // red is written
      if (threadIdx.x < BR && j0 + threadIdx.x < Q)
        a.tdet[(bc * H + h) * Q + j0 + threadIdx.x] =
            (red[threadIdx.x] + red[BR + threadIdx.x]) * des[threadIdx.x] * dem[threadIdx.x];
    }
  }

  // dx = dxdt dt, and rowsum(dxdt o x) (ddt's first term; the second launch
  // adds A revcumsum(dcum))
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NTP; ++n)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = m0 + g8 + 8 * h2, j = j0 + r, col = half * WP / 2 + 8 * n + 2 * t4;
        if (j < rows && col < P) {
          const size_t o = ((size_t)b * S + s0 + j) * xrow + (size_t)h * P + col;
          const float dtj = dtv[hh * kMaxQ + j];
          const float g0 = dx_of(hh, n, 2 * h2), g1 = dx_of(hh, n, 2 * h2 + 1);
          *reinterpret_cast<float2*>(a.gx + o) = make_float2(g0 * dtj, g1 * dtj);
          const float2 xv = *reinterpret_cast<const float2*>(a.x + o);
          rsum[h2] = fmaf(g0, xv.x, fmaf(g1, xv.y, rsum[h2]));
        }
      }
    __syncthreads();                         // red is free
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float v = rsum[h2];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t4 == 0) red[half * BR + m0 + g8 + 8 * h2] = v;
    }
    __syncthreads();
    if (threadIdx.x < BR && j0 + threadIdx.x < rows)
      a.gdt[((size_t)b * S + s0 + j0 + threadIdx.x) * H + h] = red[threadIdx.x] + red[BR + threadIdx.x];
  }

  // dB_J's partial for this head group
  float* pb = a.part_b + (((size_t)gi * a.B + b) * S + s0 + j0) * N;
#pragma unroll
  for (int n = 0; n < NTN; ++n) {
    const int col = half * WN / 2 + 8 * n + 2 * t4;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = m0 + g8 + 8 * h2;
      if (j0 + r < rows && col < N)
        *reinterpret_cast<float2*>(pb + (size_t)r * N + col) =
            make_float2(gb[n][2 * h2], gb[n][2 * h2 + 1]);
    }
  }
}

// ------------------------------------------------------------- (2) finish

__device__ __forceinline__ double warp_prefix(double v) {   // inclusive, over lanes <= this
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__device__ __forceinline__ double warp_suffix(double v) {   // inclusive, over lanes >= this
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double u = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

// The first blocks: a warp per (b, chunk, head), lane l owning rows 8 l ..
// 8 l + 7, all in float64: revcumsum(dcum) = the crossing pairs' dseg +
// decay_end's terms before i + in_decay's terms from i on + chunk_decay's;
// ddt = rowsum(dxdt o x) + A revcumsum; dA.  The rest: dB and dC, a thread
// 4 elements, their partials summed in a fixed order.
__global__ void __launch_bounds__(kFinishThreads) ssd_chunk_bwd_finish(const Args a) {
  const int S = a.S, H = a.H, N = a.N, Q = a.Q;
  const Dims d(a);
  const int n_heads = a.B * d.nc * H;
  const int head_blocks = (n_heads * 32 + kFinishThreads - 1) / kFinishThreads;
  if ((int)blockIdx.x >= head_blocks) {     // 4 consecutive n a thread (N is a multiple of 4)
    const size_t e = ((size_t)(blockIdx.x - head_blocks) * kFinishThreads + threadIdx.x) * 4;
    if (e >= (size_t)a.B * S * N) return;
    const int n = e % N, s = (e / N) % S, b = e / N / S;
    auto add = [](float4& acc, const float* src) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    };
    float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int g = 0; g < d.groups; ++g) add(vb, a.part_b + (((size_t)g * a.B + b) * S + s) * N + n);
    *reinterpret_cast<float4*>(a.gB + e) = vb;
    float4 vc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.gy) {
      const int c = s / Q, i = s % Q, I = i / BR;
      const float* pc = a.part_c + (((size_t)b * d.nc + c) * d.pairs + I * (I + 1) / 2) * BR * N +
                        (size_t)(i % BR) * N + n;
      const size_t group = (size_t)a.B * d.nc * d.pairs * BR * N;
#pragma unroll 4
      for (int g = 0; g < d.groups; ++g)
        for (int J = 0; J <= I; ++J) add(vc, pc + g * group + (size_t)J * BR * N);
    }
    *reinterpret_cast<float4*>(a.gC + e) = vc;
    return;
  }
  const int item = blockIdx.x * (kFinishThreads / 32) + threadIdx.x / 32;
  if (item >= n_heads) return;
  const int lane = threadIdx.x % 32;
  const int h = item % H, c = item / H % d.nc, b = item / H / d.nc;
  const size_t o = ((size_t)b * d.nc + c) * H + h;
  const int s0 = c * Q, rows = min(Q, S - s0);
  const double A = a.A[h];
  float dtk[8];
  double cumk[8], run = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = 8 * lane + k;
    dtk[k] = i < rows ? a.dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
    run += (double)dtk[k] * A;
    cumk[k] = run;
  }
  const double cum_incl = warp_prefix(run);
#pragma unroll
  for (int k = 0; k < 8; ++k) cumk[k] += cum_incl - run;
  const float cum_end = (float)__shfl_sync(0xffffffffu, cum_incl, 31);

  double g[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  double v[8];
  // suffix (from_right) or exclusive prefix sums of v over the rows
  auto scan = [&](bool from_right) {
    double tot = 0.0;
    if (from_right) {
#pragma unroll
      for (int k = 7; k >= 0; --k) v[k] = (tot += v[k]);
      const double after = warp_suffix(tot) - tot;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += after;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const double x = v[k];
        v[k] = tot;
        tot += x;
      }
      const double before = warp_prefix(tot) - tot;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += before;
    }
  };
  if (a.gy) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 8 * lane + k;
      if (i < rows) g[k] = a.diag[o * Q + i];
    }
    for (int J = 0; J + 1 < d.nJ; ++J) {     // the j-blocks above row i: suffix sums of their row sums
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = 8 * lane + k;
        v[k] = (i < rows && i / BR > J) ? a.rowp[(o * d.nJ + J) * Q + i] : 0.0;
      }
      scan(true);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if ((8 * lane + k) / BR > J) g[k] += v[k];
    }
  }
  if (a.gs) {                                // decay_end's terms, summed over j < i
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 8 * lane + k;
      v[k] = i < rows ? a.tdet[o * Q + i] : 0.0;
    }
    scan(false);
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] += v[k];
  }
  if (a.gin) {                               // in_decay's terms, summed over r >= i
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 8 * lane + k;
      const float ci = (float)cumk[k];
      v[k] = i < Q ? (double)(a.gin[o * Q + i] * decay(ci) * in_clip(ci)) : 0.0;
    }
    scan(true);
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] += v[k];
  }
  if (a.gcd) {
    const double t = a.gcd[o] * decay(cum_end) * in_clip(cum_end);
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] += t;
  }
  double dA = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = 8 * lane + k;
    if (i < rows) {
      float* gdt = a.gdt + ((size_t)b * S + s0 + i) * H + h;
      *gdt = (float)(*gdt + A * g[k]);
      dA += g[k] * dtk[k];
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) dA += __shfl_xor_sync(0xffffffffu, dA, m);
  if (lane == 0) a.gA[o] = (float)dA;
}

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

// heads a CTA: 4, or 1 where P > 64 (the dxdt accumulators' shared memory)
constexpr int heads_per_cta(int P) { return P <= 64 ? 4 : 1; }

template <int WP, int WN>
cudaError_t launch(Args a, float* scratch, cudaStream_t stream) {
  constexpr int HG = heads_per_cta(WP);
  using L = Smem<WP, WN, HG>;
  static_assert(L::kBytes <= (size_t)kSmemPerBlock, "ssd_chunk_bwd: shared memory");
  a.HG = HG;
  carve(a, scratch);
  cudaError_t err = allow_smem<ssd_chunk_bwd<WP, WN, HG>>();
  if (err != cudaSuccess) return err;
  const Dims d(a);
  ssd_chunk_bwd<WP, WN, HG><<<d.nJ * a.B * d.nc * d.groups, kThreads, L::kBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int head_blocks = (a.B * d.nc * a.H * 32 + kFinishThreads - 1) / kFinishThreads;
  const size_t quads = (size_t)a.B * a.S * a.N / 4;
  ssd_chunk_bwd_finish<<<head_blocks + (int)((quads + kFinishThreads - 1) / kFinishThreads),
                         kFinishThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int P, int N, int Q) {
  return B > 0 && S > 0 && H > 0 && Q > 0 && Q <= kMaxQ && P > 0 && P <= 128 && P % 4 == 0 &&
         N > 0 && N <= 128 && N % 4 == 0;
}

}  // namespace

// fp32 floats of scratch the launch needs at these shapes (0 if it takes none of them).
extern "C" long long ssd_chunk_bwd_scratch(int B, int S, int H, int P, int N, int Q) {
  if (!valid(B, S, H, P, N, Q)) return 0;
  Args a{};
  a.B = B; a.S = S; a.H = H; a.P = P; a.N = N; a.Q = Q; a.HG = heads_per_cta(P);
  return (long long)scratch_floats(a);
}

// x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N); the outputs' gradients gy
// (B,nc,H,Q,P), gs (B,nc,H,P,N), gin (B,nc,H,Q), gcd (B,nc,H,1), each null
// for none (gy, gs 16-byte aligned); out: gx, gdt in x's and dt's layouts,
// gA (B,nc,H), gB and gC (B,S,N); scratch: ssd_chunk_bwd_scratch() floats.
// All fp32 and contiguous.  Returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* gy, const void* gs,
                                    const void* gin, const void* gcd, void* gx, void* gdt,
                                    void* gA, void* gB, void* gC, void* scratch, int B, int S,
                                    int H, int P, int N, int Q, void* stream) {
  if (!valid(B, S, H, P, N, Q)) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x),   static_cast<const float*>(dt),
         static_cast<const float*>(A),   static_cast<const float*>(Bm),
         static_cast<const float*>(Cm),  static_cast<const float*>(gy),
         static_cast<const float*>(gs),  static_cast<const float*>(gin),
         static_cast<const float*>(gcd), static_cast<float*>(gx),
         static_cast<float*>(gdt),       static_cast<float*>(gA),
         static_cast<float*>(gB),        static_cast<float*>(gC),
         nullptr, nullptr, nullptr, nullptr, nullptr, B, S, H, P, N, Q, 0};
  float* s = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 64) return N <= 64 ? launch<64, 64>(a, s, st) : launch<64, 128>(a, s, st);
  return N <= 64 ? launch<128, 64>(a, s, st) : launch<128, 128>(a, s, st);
}
