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
// ~87 MB moved, so it is bound by operations.  The products run on the tensor
// cores (mma.sync m16n8k16 bf16) in bf16x3 form: each fp32 operand is split
// into a bf16 high part and a bf16 low part (the remainder, rounded), and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi keeps ~16 mantissa bits, which
// holds the fp32 limits with a margin of ~20 (one bf16 or TF32 product keeps
// 8 or 11 bits and misses them).  Sums are fp32.  No fast math: expf is the
// accurate one.
//
// What the design does about it.  C B^T does not depend on the head, so a
// "y CTA" works on one (b, chunk, 64-row i-block) and a group of HG heads:
// it forms G = C_i B_{<=i}^T once (the blocks at or below the diagonal only)
// into shared memory, then runs its heads two at a time, one per warp quad:
// (G o L_h) is built in registers as the A fragment (G from shared memory
// times the decay, masked inside the diagonal block only) and multiplied by
// the head's (x dt) block, split into high and low parts as it is staged.
// The chunk states go to "state CTAs", one per (b, chunk) and group of HS
// heads: B of the whole chunk is staged (split) once and each head's
// (x dt decay_end) blocks stream past it.  Every x and B block is loaded
// into registers one block ahead of its use, so its latency hides under the
// products of the block before.  These CTAs also write in_decay and
// chunk_decay.  Each CTA scans cum for its heads (one warp a head).  The
// grid starts with the heaviest CTAs (the last i-block's y CTAs, then the
// state CTAs, then the other i-blocks' from the bottom up) so that the light
// ones fill the tail.  Measured (chip_smoke.py, H100 80GB HBM3 at 700 W):
// 0.125 ms at the mamba2-1.3b shape, 1.9x its bound at the fp32 FFMA rate
// and 4.8x its bytes bound; PERF.md has the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;          // 8 warps
constexpr int kMaxQ = 256;
constexpr int BR = 64;                 // rows of an i- or j-block
constexpr int HG = 8;                  // heads of a y CTA (two at a time)
constexpr int HS = 4;                  // heads of a state CTA

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  float *y, *states, *in_decay, *chunk_decay;
  int B, S, H, P, N, Q;
};

__device__ __forceinline__ float decay(float v) { return expf(fminf(fmaxf(v, -60.f), 0.f)); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a pair of bf16 packed with x0 in the low half: hi
// rounds (x0, x1), lo rounds what hi leaves (exact in fp32)
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

// d += a b at ~16-bit accuracy (bf16x3), the small products first.
// Fragments (g = lane / 4, t = lane % 4; pairs along k, the lower k in the
// low half): a[0..3] = A(g, 2t..2t+1), A(g+8, 2t..2t+1), A(g, 2t+8..2t+9),
// A(g+8, 2t+8..2t+9); b0 = B(2t..2t+1, g), b1 = B(2t+8..2t+9, g);
// d = D(g, 2t), D(g, 2t+1), D(g+8, 2t), D(g+8, 2t+1).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_bf16(d, al, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, ah, bh0, bh1);
}

// Blocks of 64 rows of a row-major operand, NW (16 .. 128) columns wide, move
// through registers: every load is issued before any is used (so their
// latencies overlap, and the next block's loads are in flight while this
// block is computed), then the values go to shared memory.
//
// Row pairs, for the operands that are stored split and packed along the
// rows (the k of their products): element e < 32 V (V = NW / 4) of thread
// tid + 256 i is row pair e / V, columns 4 (e % V) ..; v[2i], v[2i+1] hold
// its two rows.
template <int NW>
struct Pairs {
  static constexpr int V = NW / 4;
  static constexpr int PER = (32 * V + kThreads - 1) / kThreads;
};

// Rows r0 .. r0+63 (`rows` valid rows `stride` floats apart, W valid
// columns), zero past both.
template <int NW>
__device__ __forceinline__ void load_pairs(float4 (&v)[2 * Pairs<NW>::PER], const float* src,
                                           size_t stride, int r0, int rows, int W) {
  constexpr int V = Pairs<NW>::V;
#pragma unroll
  for (int i = 0; i < Pairs<NW>::PER; ++i) {
    const int e = threadIdx.x + i * kThreads, col = (e % V) * 4, q = r0 + 2 * (e / V);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[2 * i + k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < 32 * V && q + k < rows && col < W)
        v[2 * i + k] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(q + k) * stride + col));
    }
  }
}

// The loaded rows, each row q times dts[q] (when dts) and times
// exp(clip(cum_end - cum[q])) (when cum), split into bf16 high and low parts
// packed by row pairs: hi and lo are 32 pair rows x ld words.
template <int NW>
__device__ __forceinline__ void store_pairs(uint32_t* hi, uint32_t* lo, int ld,
                                            const float4 (&v)[2 * Pairs<NW>::PER], int r0,
                                            int rows, const float* dts, const float* cum,
                                            float cum_end) {
  constexpr int V = Pairs<NW>::V;
#pragma unroll
  for (int i = 0; i < Pairs<NW>::PER; ++i) {
    const int e = threadIdx.x + i * kThreads, m = e / V, col = (e % V) * 4, q = r0 + 2 * m;
    if (e >= 32 * V) continue;
    float4 x[2] = {v[2 * i], v[2 * i + 1]};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!dts || q + k >= rows) continue;
      float s = dts[q + k];
      if (cum) s *= decay(cum_end - cum[q + k]);
      x[k].x *= s; x[k].y *= s; x[k].z *= s; x[k].w *= s;
    }
    uint4 h, l;
    split2(x[0].x, x[1].x, h.x, l.x);
    split2(x[0].y, x[1].y, h.y, l.y);
    split2(x[0].z, x[1].z, h.z, l.z);
    split2(x[0].w, x[1].w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + m * ld + col) = h;
    *reinterpret_cast<uint4*>(lo + m * ld + col) = l;
  }
}

// A plain fp32 block (rows r0 .. r0+63) for the G product, whose operands
// are split as they are read: element e = tid + 256 i is row e / V.
template <int NW>
struct Block {
  static constexpr int V = NW / 4;
  static constexpr int PER = BR * V / kThreads;
};

template <int NW>
__device__ __forceinline__ void load_block(float4 (&v)[Block<NW>::PER], const float* src,
                                           size_t stride, int r0, int rows, int W) {
  constexpr int V = Block<NW>::V;
#pragma unroll
  for (int i = 0; i < Block<NW>::PER; ++i) {
    const int e = threadIdx.x + i * kThreads, col = (e % V) * 4, q = r0 + e / V;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < rows && col < W) v[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)q * stride + col));
  }
}

template <int NW>
__device__ __forceinline__ void store_block(float* dst, int ld, const float4 (&v)[Block<NW>::PER]) {
  constexpr int V = Block<NW>::V;
#pragma unroll
  for (int i = 0; i < Block<NW>::PER; ++i) {
    const int e = threadIdx.x + i * kThreads;
    *reinterpret_cast<float4*>(dst + (e / V) * ld + (e % V) * 4) = v[i];
  }
}

// One warp: cum[q] = sum_{r <= q} dt_r A_h and dts[q] = dt_q for the chunk's
// rows q < kMaxQ (dt = 0 past `rows`).  Lane l sums rows 8l .. 8l+7 in
// order, then the lanes' totals are scanned.  dtc is dt at (b, s0, h).
__device__ void scan_head(float* cum, float* dts, const float* dtc, int H, int rows, float a) {
  const int lane = threadIdx.x & 31;
  float v[8], run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = lane * 8 + k;
    const float d = q < rows ? dtc[(size_t)q * H] : 0.f;
    dts[q] = d;
    run += d * a;
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) cum[lane * 8 + k] = excl + v[k];
}

template <int NP, int NN>
constexpr int y_smem_floats(int nblk) {
  return BR * (nblk * BR + 8) + 2 * HG * kMaxQ +
         (2 * BR * (NN + 8) > 4 * 32 * (NP + 8) ? 2 * BR * (NN + 8) : 4 * 32 * (NP + 8));
}

template <int NP, int NN>
constexpr int state_smem_floats(int nblk) {
  return 2 * nblk * 32 * (NN + 8) + 2 * HS * kMaxQ + 2 * 32 * (NP + 8);
}

// y_intra of i-block ib for heads h0 .. h0 + HG - 1 (those < H).
template <int NP, int NN>
__device__ void y_block(const Args& a, int b, int c, int ib, int h0, float* sm) {
  constexpr int LDC = NN + 8, LDX = NP + 8, NT = NP / 8;
  const int nc = (a.S + a.Q - 1) / a.Q;
  const int hg = min(HG, a.H - h0);
  const int s0 = c * a.Q, rows = min(a.Q, a.S - s0);
  const int ldg = (ib + 1) * BR + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* Gs = sm;                           // 64 x ldg: G of this i-block
  float* cums = Gs + BR * ldg;              // HG x kMaxQ
  float* dts = cums + HG * kMaxQ;           // HG x kMaxQ
  float* R = dts + HG * kMaxQ;              // staging

  // the x blocks of the head pairs, each loaded one block ahead of its use:
  // the first pair's first block now, under the scan and G
  const size_t xrow = (size_t)a.H * a.P;
  const float* xc = a.x + ((size_t)b * a.S + s0) * xrow + (size_t)h0 * a.P;
  float4 xv[2][2 * Pairs<NP>::PER];
  auto load_x = [&](int hp, int jb) {
    load_pairs<NP>(xv[0], xc + (size_t)hp * a.P, xrow, jb * BR, rows, a.P);
    if (hp + 1 < hg) load_pairs<NP>(xv[1], xc + (size_t)(hp + 1) * a.P, xrow, jb * BR, rows, a.P);
  };
  load_x(0, 0);

  if (warp < hg)
    scan_head(cums + warp * kMaxQ, dts + warp * kMaxQ,
              a.dt + ((size_t)b * a.S + s0) * a.H + h0 + warp, a.H, rows, a.A[h0 + warp]);

  // G = C_i B_j^T for the j-blocks jb <= ib; warp w owns rows 16 (w % 4) ..
  // and columns 32 (w / 4) .. of each 64 x 64 block
  float* Cs = R;
  float* Bs = R + BR * LDC;
  const float* Cc = a.Cm + ((size_t)b * a.S + s0) * a.N;
  const float* Bc = a.Bm + ((size_t)b * a.S + s0) * a.N;
  {
    float4 cv[Block<NN>::PER];
    load_block<NN>(cv, Cc, a.N, ib * BR, rows, a.N);
    store_block<NN>(Cs, LDC, cv);
  }
  float4 bv[Block<NN>::PER];
  load_block<NN>(bv, Bc, a.N, 0, rows, a.N);
  const int gr = 16 * (warp & 3), gc = 32 * (warp >> 2);
  for (int jb = 0; jb <= ib; ++jb) {
    store_block<NN>(Bs, LDC, bv);
    __syncthreads();
    if (jb < ib) load_block<NN>(bv, Bc, a.N, (jb + 1) * BR, rows, a.N);
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < NN; k0 += 16) {
      uint32_t ah[4], al[4];
      const float* cp = Cs + (gr + g) * LDC + k0 + 2 * t;
      const float2 c0 = *reinterpret_cast<const float2*>(cp);
      const float2 c1 = *reinterpret_cast<const float2*>(cp + 8 * LDC);
      const float2 c2 = *reinterpret_cast<const float2*>(cp + 8);
      const float2 c3 = *reinterpret_cast<const float2*>(cp + 8 * LDC + 8);
      split2(c0.x, c0.y, ah[0], al[0]);
      split2(c1.x, c1.y, ah[1], al[1]);
      split2(c2.x, c2.y, ah[2], al[2]);
      split2(c3.x, c3.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* bp = Bs + (gc + 8 * n + g) * LDC + k0 + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(bp);
        const float2 b1 = *reinterpret_cast<const float2*>(bp + 8);
        uint32_t bh0, bl0, bh1, bl1;
        split2(b0.x, b0.y, bh0, bl0);
        split2(b1.x, b1.y, bh1, bl1);
        mma3(acc[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float* gp = Gs + (gr + g) * ldg + jb * BR + gc + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(gp) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(gp + 8 * ldg) = make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();  // Bs free; after the last block G is whole
  }

  // the heads, two at a time: warp quad `quad` takes head hp + quad, its
  // warp w % 4 the 16 rows 16 (w % 4) .. of the i-block and all P columns
  const int quad = warp >> 2;
  const int il = 16 * (warp & 3) + g;       // local rows il and il + 8
  const int i0 = ib * BR + il, i1 = i0 + 8;
  uint32_t* X = reinterpret_cast<uint32_t*>(R);   // [quad][hi, lo][32 row pairs][LDX]
  const uint32_t* Xh = X + quad * 2 * 32 * LDX;
  const uint32_t* Xl = Xh + 32 * LDX;
  for (int hp = 0; hp < hg; hp += 2) {
    const int hl = hp + quad;
    const bool active = hl < hg;
    const float* cum = cums + (active ? hl : hp) * kMaxQ;
    const float ci0 = cum[i0], ci1 = cum[i1];
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int jb = 0; jb <= ib; ++jb) {
      store_pairs<NP>(X, X + 32 * LDX, LDX, xv[0], jb * BR, rows, dts + hp * kMaxQ, nullptr, 0.f);
      if (hp + 1 < hg)
        store_pairs<NP>(X + 64 * LDX, X + 96 * LDX, LDX, xv[1], jb * BR, rows,
                        dts + (hp + 1) * kMaxQ, nullptr, 0.f);
      __syncthreads();
      if (jb < ib) load_x(hp, jb + 1);
      else if (hp + 2 < hg) load_x(hp + 2, 0);
      if (active) {
        const bool diag = jb == ib;
#pragma unroll 2
        for (int kk = 0; kk < BR; kk += 16) {
          // A = (G o L) at rows i0, i1 and columns j, j+1, j+8, j+9
          const int j = jb * BR + kk + 2 * t;
          const float2 cj0 = *reinterpret_cast<const float2*>(cum + j);
          const float2 cj8 = *reinterpret_cast<const float2*>(cum + j + 8);
          const float* gp = Gs + il * ldg + j;
          float2 r0 = *reinterpret_cast<const float2*>(gp);
          float2 r1 = *reinterpret_cast<const float2*>(gp + 8 * ldg);
          float2 r2 = *reinterpret_cast<const float2*>(gp + 8);
          float2 r3 = *reinterpret_cast<const float2*>(gp + 8 * ldg + 8);
          r0.x *= decay(ci0 - cj0.x); r0.y *= decay(ci0 - cj0.y);
          r1.x *= decay(ci1 - cj0.x); r1.y *= decay(ci1 - cj0.y);
          r2.x *= decay(ci0 - cj8.x); r2.y *= decay(ci0 - cj8.y);
          r3.x *= decay(ci1 - cj8.x); r3.y *= decay(ci1 - cj8.y);
          if (diag) {                      // the mask, after the exp
            if (j > i0) r0.x = 0.f;
            if (j + 1 > i0) r0.y = 0.f;
            if (j > i1) r1.x = 0.f;
            if (j + 1 > i1) r1.y = 0.f;
            if (j + 8 > i0) r2.x = 0.f;
            if (j + 9 > i0) r2.y = 0.f;
            if (j + 8 > i1) r3.x = 0.f;
            if (j + 9 > i1) r3.y = 0.f;
          }
          uint32_t ah[4], al[4];
          split2(r0.x, r0.y, ah[0], al[0]);
          split2(r1.x, r1.y, ah[1], al[1]);
          split2(r2.x, r2.y, ah[2], al[2]);
          split2(r3.x, r3.y, ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int o = (kk / 2 + t) * LDX + 8 * n + g;
            mma3(acc[n], ah, al, Xh[o], Xh[o + 4 * LDX], Xl[o], Xl[o + 4 * LDX]);
          }
        }
      }
      __syncthreads();  // the staged blocks are free again
    }
    if (active) {
      float* yo = a.y + (((size_t)b * nc + c) * a.H + h0 + hl) * a.Q * a.P;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = 8 * n + 2 * t;      // P is a multiple of 4: p < P means p + 1 < P
        if (p >= a.P) continue;
        if (i0 < a.Q)
          *reinterpret_cast<float2*>(yo + (size_t)i0 * a.P + p) = make_float2(acc[n][0], acc[n][1]);
        if (i1 < a.Q)
          *reinterpret_cast<float2*>(yo + (size_t)i1 * a.P + p) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// The chunk states of heads h0 .. h0 + HS - 1 (those < H), and their
// in_decay and chunk_decay.  Warp w owns rows 16 (w % RS) .. of P and CT
// column tiles of 8 from (w / RS) CT.
template <int NP, int NN>
__device__ void state_block(const Args& a, int b, int c, int h0, float* sm) {
  constexpr int LDB = NN + 8, LDX = NP + 8;
  constexpr int RS = NP / 16, CS = 8 / RS, NTT = NN / 8;
  constexpr int CT = NTT / CS > 0 ? NTT / CS : 1;
  const int nc = (a.S + a.Q - 1) / a.Q, nblk = (a.Q + BR - 1) / BR;
  const int hs = min(HS, a.H - h0);
  const int s0 = c * a.Q, rows = min(a.Q, a.S - s0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  uint32_t* Bh = reinterpret_cast<uint32_t*>(sm);   // nblk * 32 row pairs x LDB: B, split
  uint32_t* Bl = Bh + nblk * 32 * LDB;
  float* cums = reinterpret_cast<float*>(Bl + nblk * 32 * LDB);   // HS x kMaxQ
  float* dts = cums + HS * kMaxQ;                                 // HS x kMaxQ
  uint32_t* Xh = reinterpret_cast<uint32_t*>(dts + HS * kMaxQ);   // 32 x LDX
  uint32_t* Xl = Xh + 32 * LDX;

  // x blocks, each loaded one block ahead of its use: the first one now
  const size_t xrow = (size_t)a.H * a.P;
  const float* xc = a.x + ((size_t)b * a.S + s0) * xrow + (size_t)h0 * a.P;
  float4 xv[2 * Pairs<NP>::PER];
  load_pairs<NP>(xv, xc, xrow, 0, rows, a.P);

  if (warp < hs)
    scan_head(cums + warp * kMaxQ, dts + warp * kMaxQ,
              a.dt + ((size_t)b * a.S + s0) * a.H + h0 + warp, a.H, rows, a.A[h0 + warp]);
  const float* Bc = a.Bm + ((size_t)b * a.S + s0) * a.N;
  for (int jb = 0; jb < nblk; ++jb) {
    float4 bv[2 * Pairs<NN>::PER];
    load_pairs<NN>(bv, Bc, a.N, jb * BR, rows, a.N);
    store_pairs<NN>(Bh + jb * 32 * LDB, Bl + jb * 32 * LDB, LDB, bv, jb * BR, rows, nullptr,
                    nullptr, 0.f);
  }
  __syncthreads();
  const size_t bch0 = ((size_t)b * nc + c) * a.H + h0;
  for (int e = threadIdx.x; e < hs * a.Q; e += kThreads) {
    const int hl = e / a.Q, q = e % a.Q;
    a.in_decay[(bch0 + hl) * a.Q + q] = decay(cums[hl * kMaxQ + q]);
    if (q == 0) a.chunk_decay[bch0 + hl] = decay(cums[hl * kMaxQ + a.Q - 1]);
  }

  const int rs = warp % RS, cg = warp / RS;
  const bool active = cg * CT < NTT;
  for (int hl = 0; hl < hs; ++hl) {
    const float* cum = cums + hl * kMaxQ;
    const float cum_end = cum[a.Q - 1];
    float acc[CT][4];
#pragma unroll
    for (int n = 0; n < CT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int jb = 0; jb < nblk; ++jb) {
      store_pairs<NP>(Xh, Xl, LDX, xv, jb * BR, rows, dts + hl * kMaxQ, cum, cum_end);
      __syncthreads();
      if (jb + 1 < nblk) load_pairs<NP>(xv, xc + (size_t)hl * a.P, xrow, (jb + 1) * BR, rows, a.P);
      else if (hl + 1 < hs) load_pairs<NP>(xv, xc + (size_t)(hl + 1) * a.P, xrow, 0, rows, a.P);
      if (active) {
#pragma unroll 2
        for (int kk = 0; kk < BR; kk += 16) {
          // A = (x dt decay_end)^T: element (p, j) lies at row pair j / 2, column p
          const int o = (kk / 2 + t) * LDX + 16 * rs + g;
          const uint32_t ah[4] = {Xh[o], Xh[o + 8], Xh[o + 4 * LDX], Xh[o + 4 * LDX + 8]};
          const uint32_t al[4] = {Xl[o], Xl[o + 8], Xl[o + 4 * LDX], Xl[o + 4 * LDX + 8]};
#pragma unroll
          for (int n = 0; n < CT; ++n) {
            const int ob = (jb * 32 + kk / 2 + t) * LDB + (cg * CT + n) * 8 + g;
            mma3(acc[n], ah, al, Bh[ob], Bh[ob + 4 * LDB], Bl[ob], Bl[ob + 4 * LDB]);
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      float* so = a.states + (bch0 + hl) * a.P * a.N;
      const int p0 = 16 * rs + g, p1 = p0 + 8;
#pragma unroll
      for (int n = 0; n < CT; ++n) {
        const int col = (cg * CT + n) * 8 + 2 * t;   // N is a multiple of 4
        if (col >= a.N) continue;
        if (p0 < a.P)
          *reinterpret_cast<float2*>(so + (size_t)p0 * a.N + col) = make_float2(acc[n][0], acc[n][1]);
        if (p1 < a.P)
          *reinterpret_cast<float2*>(so + (size_t)p1 * a.N + col) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// Grid: every y CTA (nblk i-blocks x B x nc x ceil(H / HG)) and every state
// CTA (B x nc x ceil(H / HS)), heaviest first (see the header).
template <int NP, int NN>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Args a) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nc = (a.S + a.Q - 1) / a.Q, nblk = (a.Q + BR - 1) / BR;
  const int gy = (a.H + HG - 1) / HG, gs = (a.H + HS - 1) / HS;
  const int per_ib = a.B * nc * gy, n_state = a.B * nc * gs;
  int item = blockIdx.x, ib = nblk - 1;
  if (item >= per_ib) {
    item -= per_ib;
    if (item < n_state) {
      state_block<NP, NN>(a, item / (nc * gs), (item / gs) % nc, (item % gs) * HS, sm);
      return;
    }
    item -= n_state;
    ib = nblk - 2 - item / per_ib;
    item %= per_ib;
  }
  y_block<NP, NN>(a, item / (nc * gy), (item / gy) % nc, ib, (item % gy) * HG, sm);
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

template <int NP, int NN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nc = (a.S + a.Q - 1) / a.Q, nblk = (a.Q + BR - 1) / BR;
  const int ys = y_smem_floats<NP, NN>(nblk), ss = state_smem_floats<NP, NN>(nblk);
  const size_t smem = (size_t)(ys > ss ? ys : ss) * sizeof(float);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<ssd_chunk_kernel<NP, NN>>();
  if (err != cudaSuccess) return err;
  const int ctas = a.B * nc * (nblk * ((a.H + HG - 1) / HG) + (a.H + HS - 1) / HS);
  ssd_chunk_kernel<NP, NN><<<ctas, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The template widths: P and N rounded up to 16, 32, 64 or 128.
constexpr int width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int NP>
cudaError_t launch_n(const Args& a, cudaStream_t stream) {
  switch (width(a.N)) {
    case 16: return launch<NP, 16>(a, stream);
    case 32: return launch<NP, 32>(a, stream);
    case 64: return launch<NP, 64>(a, stream);
    default: return launch<NP, 128>(a, stream);
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
               static_cast<float*>(chunk_decay), B, S, H, P, N, Q};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width(P)) {
    case 16: return launch_n<16>(a, s);
    case 32: return launch_n<32>(a, s);
    case 64: return launch_n<64>(a, s);
    default: return launch_n<128>(a, s);
  }
}
