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
// Three launches: (1) D, 16-byte vectors of a row over D / 8 (bf16) lanes; (2) dK and dV, one CTA per (b, KV
// head, key block), which walks the group's H / KV query heads and the
// query blocks from the diagonal on, so the GQA sum happens inside the CTA;
// (3) dQ, one CTA per (b, head, query block), which walks the key blocks up
// to the diagonal.  No float atomics: every sum runs in a fixed order, so
// two runs give the same bits.  Rows past S are read as zeros and masked out
// of P, so S need not be a multiple of a block.
//
// What bounds it on an H100: five products of 2 d flops over the causal
// (query, key) pairs (S, dP, dV, dQ, dK) against one pass over q, k, v, O,
// dO and the gradients: at the tinyllama-1.1b train shape (B=8, H 32, KV 4,
// S=1024, d=64) 0.0869 ms of bf16 tensor-core operations, so operations.
// This design does seven: S and dP are formed in both (2) and (3), because
// dQ summed over key blocks in (2) would need float atomics (two runs would
// differ) or a partial per key block (S / 64 x B H S d fp32, ~1 GB at that
// shape), so its floor is 7/5 of the bound, 0.122 ms.
//
// bf16, in the shape of FA3's backward.  (2): one CTA owns 128 keys of one
// (b, KV head): a producer warp (registers handed over with setmaxnreg)
// loads K and V once by TMA and keeps (Q, dO) tiles of 64 query rows in
// flight through a 3-stage ring (full / empty mbarriers), the tile's LSE (in
// log2 units) and D rows beside them; two consumer warpgroups of 64 keys
// each form S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory,
// turn them into P^T and dS^T in registers (exp2 against the LSE, the mask
// only on tiles that cross the diagonal or the end of S), round them once
// to bf16 and feed them to dV += P^T dO and dK += dS^T Q as wgmma's register
// A operand, dO and Q read MN-major (the transpose bit).  (3): one CTA owns
// 128 queries of one (b, head): Q and dO are loaded once, K and V tiles of
// 64 rows stream through the same kind of ring, S and dP run on wgmma, dS is
// formed in registers and dQ += dS K reads K MN-major.  At d <= 64 a
// consumer issues the next tile's S and dP before this tile's dK/dV (or dQ)
// products and forms the next P and dS while they run, and the two consumers
// take turns to issue, so one's exp and masking overlap the other's
// products; at d = 128 the dK and dV accumulators (128 registers a thread)
// leave no room for two tiles in flight, so (2) takes one tile at a time
// there.  Both grids launch their heaviest causal blocks first (key block 0
// in (2), the last query block in (3)), the heads of one KV head side by
// side so they share its tiles in L2.  Every head dim (16, 32, 64, 128)
// takes this route.  Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.420
// ms a call at the train shape, 4.8x the 5-product bound and 3.4x the
// 7-product floor (the mma.sync design before it: 0.970); SDPA's backward
// alone takes 0.718 ms there, eager.
//
// fp32: CUDA-core FFMA only (never TF32), the forward fp32 kernel's layout:
// 128 threads, each owning 4 rows of a 64-row block, P and dS through
// shared memory.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;         // the fp32 route's CTA
constexpr int BR = 64;                // rows of the fp32 route's own block
constexpr float kLog2e = 1.4426950408889634f;

// --------------------------------------------------------------- D = rowsum(dO o O)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// TPR = D / V threads a row, each reading V = 16 / sizeof(T) values of O and
// of dO as one 16-byte vector (O and dO 16-byte aligned)
template <typename T, int TPR>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                int rows) {
  constexpr int V = 16 / sizeof(T);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / TPR, part = threadIdx.x % TPR;
  float s = 0.f;
  if (row < rows) {
    const size_t at = ((size_t)row * TPR + part) * V;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + at);
    const T* ot = reinterpret_cast<const T*>(&ov);
    const T* dt = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < V; ++i) s = fmaf(to_f(ot[i]), to_f(dt[i]), s);
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (row < rows && part == 0) delta[row] = s;
}

// ------------------------------------------------------------------ bf16 route

constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 3;
constexpr int kOwn = 128;         // rows a CTA owns: keys in (2), queries in (3)
constexpr int kRing = 64;         // rows of a ring tile: queries in (2), keys in (3)

// The two consumers take turns to issue their products (named barriers 1
// and 2, consumer 0 first), so that one's exp and masking overlap the
// other's products.
__device__ __forceinline__ void turn_wait(int c) { named_barrier(1 + c, 256); }
__device__ __forceinline__ void turn_pass(int c) { named_barrier_arrive(2 - c, 256); }

// 2^x by the special-function unit (relative error ~2^-22; 0 for x << 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of both bf16 kernels at head dim D.  Each tile is stored as
// column blocks of `kSw`-byte rows (kSw = the swizzle, min(2 D, 128)): the
// CTA's two own tiles (K, V in (2); Q, dO in (3)), then per stage its two
// ring tiles, then per stage 64 LSE and 64 D values ((2) only), then the
// barriers.
template <int D>
struct BwdLayout {
  static constexpr int kSw = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kBlocks = 2 * D / kSw;
  static constexpr int kOwnTile = kOwn * D * 2;
  static constexpr int kTile = kRing * D * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kVecs = 2 * kOwnTile + kStages * kStage;
  static constexpr int kBars = kVecs + kStages * 2 * kRing * (int)sizeof(float);
  static constexpr size_t kSmem = 1024 + kBars + (1 + 2 * kStages) * sizeof(uint64_t);
};

// S = A B^T of one 64 x 64 tile (the k16 steps over d): A's 64 rows from a
// K-major tile of `a_rows` rows at `a`, B's from a K-major ring tile at `b`
template <int D, int SW>
__device__ __forceinline__ void product_s(float (&acc)[32], uint32_t a, int a_rows, uint32_t b) {
  wgmma_ss_n64_first<0>(acc, desc_kmajor(a, a_rows, SW, 0), desc_kmajor(b, kRing, SW, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<64, 0>(acc, desc_kmajor(a, a_rows, SW, kk), desc_kmajor(b, kRing, SW, kk), 1);
}

// out += X Y for X (64 x 64) in registers as A fragments and Y the 64-row
// ring tile at `y`, read MN-major
template <int D, int SW>
__device__ __forceinline__ void product_xy(float (&out)[D / 2], const uint32_t (&x)[4][4],
                                           uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < kRing / 16; ++kk) wgmma_rs<D>(out, x[kk], desc_mnmajor(y, kRing, SW, kk), 1);
}

// A 64 x 64 accumulator (rounded once to bf16) as wgmma A fragments: the k16
// step kk takes the accumulator's values 8 kk .. 8 kk + 7
__device__ __forceinline__ void pack(uint32_t (&f)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[kk][e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
}

// Accumulator layout of a warpgroup's 64 rows: value i of a thread sits at
// row 16 warp + lane / 4 + 8 acc_half(i), column acc_col(i) (of N).
__device__ __forceinline__ int acc_half(int i) { return (i / 2) % 2; }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2; }

// write a 64-row accumulator (times `mul`) as bf16 rows r_lo, r_lo + 8 of (S, D)
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2], int r_lo, int S,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r_lo + 8 * acc_half(i);
    if (r < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * D + acc_col(i)) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

// (2) dK, dV.  q, dout: (BH, S, D) as tensor maps of 64-row boxes; k, v:
// (BH / group, S, D) of 128-row boxes.  blockIdx.x is b * KV + KV head,
// blockIdx.y the key block (block 0, the heaviest under causal, first).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int group, int causal,
                     float scale) {
  using L = BwdLayout<D>;
  constexpr int SW = L::kSw;
  constexpr bool kPipe = D <= 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kOwnTile;
  unsigned char* ring = smem + 2 * L::kOwnTile;
  float* vecs = reinterpret_cast<float*>(smem + L::kVecs);   // per stage: LSE (log2), then D
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * kOwn;
  const int q_first = causal ? k0 : 0;
  const int per_head = (S - q_first + kRing - 1) / kRing;
  const int n_tiles = group * per_head;          // (query head, query block), head-major
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes, after their LSE / D stores
      mbar_init(&empty[s], 2);           // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kOwnTile);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b) {
          tma_load_3d(ks + b * kOwn * SW, &tk, kv_full, b * SW / 2, k0, kvh);
          tma_load_3d(vs + b * kOwn * SW, &tv, kv_full, b * SW / 2, k0, kvh);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int q0 = q_first + (j % per_head) * kRing;
        const size_t bh = (size_t)kvh * group + j / per_head;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) + 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        if (lane == 0) {
          mbar_expect_tx_only(&full[s], L::kStage);
#pragma unroll
          for (int b = 0; b < L::kBlocks; ++b) {
            tma_load_3d(st + b * kRing * SW, &tq, &full[s], b * SW / 2, q0, (int)bh);
            tma_load_3d(st + L::kTile + b * kRing * SW, &tdo, &full[s], b * SW / 2, q0, (int)bh);
          }
        }
        float* vec = vecs + s * 2 * kRing;
        for (int i = lane; i < kRing; i += 32) {
          const bool ok = q0 + i < S;
          vec[i] = ok ? lse[bh * S + q0 + i] * kLog2e : 0.f;
          vec[kRing + i] = ok ? delta[bh * S + q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    regs_alloc<232>();
    const int c = wg - 1;                  // this consumer's keys: k0 + 64 c ..
    const int lane = threadIdx.x % 32;
    const int key_lo = k0 + c * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
    zero(dk_acc);
    zero(dv_acc);
    float st[32], dpt[32];                 // S^T, dP^T: 64 keys x 64 queries
    uint32_t pf[4][4], dsf[4][4];          // P^T, dS^T as A fragments
    const uint32_t ka = smem_u32(ks) + c * 64 * SW, va = smem_u32(vs) + c * 64 * SW;

    auto wait_tile = [&](int j) { mbar_wait(&full[j % kStages], (j / kStages) & 1); };
    auto stage = [&](int j) { return smem_u32(ring + (j % kStages) * L::kStage); };
    auto issue_s = [&](int j) {            // S^T = K Q^T, dP^T = V dO^T
      product_s<D, SW>(st, ka, kOwn, stage(j));
      product_s<D, SW>(dpt, va, kOwn, stage(j) + L::kTile);
    };
    auto issue_dkdv = [&](int j) {         // dV += P^T dO, dK += dS^T Q
      product_xy<D, SW>(dv_acc, pf, stage(j) + L::kTile);
      product_xy<D, SW>(dk_acc, dsf, stage(j));
    };
    // P^T and dS^T of tile j in place; the mask only where the tile crosses
    // the diagonal or the end of S
    auto grads = [&](int j) {
      const int q0 = q_first + (j % per_head) * kRing;
      const float* vec = vecs + (j % kStages) * 2 * kRing;
      const bool edge = q0 + kRing > S || k0 + kOwn > S || (causal && q0 < k0 + kOwn);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = 8 * n + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(vec + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(vec + kRing + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p = fast_exp2(fmaf(st[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
          if (edge) {
            const int key = key_lo + 8 * (e / 2), qry = q0 + qc + e % 2;
            if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - (e % 2 ? d2.y : d2.x));
        }
      }
    };
    auto release = [&](int j) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[j % kStages]);
    };

    mbar_wait(kv_full, 0);
    if constexpr (kPipe) {
      // Each step issues the next tile's S^T and dP^T, then this tile's dK/dV
      // products, and forms the next P^T and dS^T while those run.  The last
      // tile's products are peeled off, so that no wgmma sits under a branch.
      wait_tile(0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grads(0);
      pack(pf, st);
      pack(dsf, dpt);
      if (c == 1) named_barrier_arrive(1, 256);
      for (int j = 0; j + 1 < n_tiles; ++j) {
        wait_tile(j + 1);
        turn_wait(c);
        wgmma_fence();
        issue_s(j + 1);
        wgmma_commit();
        issue_dkdv(j);
        wgmma_commit();
        turn_pass(c);
        wgmma_wait<1>();
        fence_regs(st);
        fence_regs(dpt);
        grads(j + 1);
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        release(j);
        pack(pf, st);
        pack(dsf, dpt);
      }
      turn_wait(c);
      wgmma_fence();
      issue_dkdv(n_tiles - 1);
      wgmma_commit();
      if (c == 0) named_barrier_arrive(2, 256);
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
    } else {
      for (int j = 0; j < n_tiles; ++j) {
        wait_tile(j);
        wgmma_fence();
        issue_s(j);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        grads(j);
        pack(pf, st);
        pack(dsf, dpt);
        wgmma_fence();
        issue_dkdv(j);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        release(j);
      }
    }
    store_acc<D>(dk + (size_t)kvh * S * D, dk_acc, key_lo, S, scale);
    store_acc<D>(dv + (size_t)kvh * S * D, dv_acc, key_lo, S, 1.f);
  }
}

// (3) dQ.  q, dout: (BH, S, D) as tensor maps of 128-row boxes; k, v:
// (BH / group, S, D) of 64-row boxes.  blockIdx.x is bh (the query heads of
// one KV head are neighbours), blockIdx.y counts query blocks from the last
// (heaviest) one.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int S, int group, int causal, float scale) {
  using L = BwdLayout<D>;
  constexpr int SW = L::kSw;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::kOwnTile;
  unsigned char* ring = smem + 2 * L::kOwnTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const int k_end = causal ? min(S, q0 + kOwn) : S;
  const int n_tiles = (k_end + kRing - 1) / kRing;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kOwnTile);
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b) {
        tma_load_3d(qs + b * kOwn * SW, &tq, q_full, b * SW / 2, q0, bh);
        tma_load_3d(dos + b * kOwn * SW, &tdo, q_full, b * SW / 2, q0, bh);
      }
      const int kvh = bh / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) + 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b) {
          tma_load_3d(st + b * kRing * SW, &tk, &full[s], b * SW / 2, j * kRing, kvh);
          tma_load_3d(st + L::kTile + b * kRing * SW, &tv, &full[s], b * SW / 2, j * kRing, kvh);
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int c = wg - 1;                  // this consumer's queries: q0 + 64 c ..
    const int lane = threadIdx.x % 32;
    const int row_lo = q0 + c * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
    const float scale_log2 = scale * kLog2e;
    float lrow[2], drow[2];                // LSE (log2 units) and D of rows row_lo, row_lo + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_lo + 8 * h;
      lrow[h] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      drow[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    float dq_acc[D / 2];
    zero(dq_acc);
    float sa[32], dp[32];                  // S, dP: 64 queries x 64 keys
    uint32_t dsf[4][4];                    // dS as A fragments
    const uint32_t qa = smem_u32(qs) + c * 64 * SW, doa = smem_u32(dos) + c * 64 * SW;

    auto wait_tile = [&](int j) { mbar_wait(&full[j % kStages], (j / kStages) & 1); };
    auto stage = [&](int j) { return smem_u32(ring + (j % kStages) * L::kStage); };
    auto issue_s = [&](int j) {            // S = Q K^T, dP = dO V^T
      product_s<D, SW>(sa, qa, kOwn, stage(j));
      product_s<D, SW>(dp, doa, kOwn, stage(j) + L::kTile);
    };
    auto issue_dq = [&](int j) { product_xy<D, SW>(dq_acc, dsf, stage(j)); };   // dQ += dS K
    auto grads = [&](int j) {              // dS of tile j in place (in dp)
      const int k0 = j * kRing;
      const bool edge = k0 + kRing > S || q0 + kOwn > S || (causal && k0 + kRing > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = acc_half(i);
        float p = fast_exp2(fmaf(sa[i], scale_log2, -lrow[h]));
        if (edge) {
          const int key = k0 + acc_col(i), qry = row_lo + 8 * h;
          if (key >= S || qry >= S || (causal && key > qry)) p = 0.f;
        }
        dp[i] = p * (dp[i] - drow[h]);
      }
    };
    auto release = [&](int j) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[j % kStages]);
    };

    mbar_wait(q_full, 0);
    wait_tile(0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dp);
    grads(0);
    pack(dsf, dp);
    if (c == 1) named_barrier_arrive(1, 256);
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wait_tile(j + 1);
      turn_wait(c);
      wgmma_fence();
      issue_s(j + 1);
      wgmma_commit();
      issue_dq(j);
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<1>();
      fence_regs(sa);
      fence_regs(dp);
      grads(j + 1);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      release(j);
      pack(dsf, dp);
    }
    turn_wait(c);
    wgmma_fence();
    issue_dq(n_tiles - 1);
    wgmma_commit();
    if (c == 0) named_barrier_arrive(2, 256);
    wgmma_wait<0>();
    fence_regs(dq_acc);
    store_acc<D>(dq + (size_t)bh * S * D, dq_acc, row_lo, S, scale);
  }
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

template <typename T, int D>
cudaError_t launch_delta(const Args& a) {
  constexpr int TPR = D * (int)sizeof(T) / 16;
  const int rows = a.BH * a.S, per_block = 256 / TPR;
  flash_bwd_delta<T, TPR><<<(rows + per_block - 1) / per_block, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows);
  return cudaGetLastError();
}

// the fp32 route's three launches: D, then dK and dV (one CTA per key block
// and KV row), then dQ (one CTA per query block and query row)
template <typename T, int D, auto DKDV, auto DQ>
cudaError_t launch(const Args& a, size_t smem_kv, size_t smem_q) {
  cudaError_t err = launch_delta<T, D>(a);
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

// The bf16 route's three launches: D, then dK and dV (one CTA per 128 keys
// of a KV row), then dQ (one CTA per 128 queries of a query row).
template <int D>
cudaError_t launch_wgmma(const Args& a) {
  using L = BwdLayout<D>;
  cudaError_t err = launch_delta<bf16, D>(a);
  if (err != cudaSuccess) return err;
  CUtensorMap q_ring, do_ring, k_own, v_own, q_own, do_own, k_ring, v_ring;
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)a.S, (cuuint64_t)a.BH};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)a.S, (cuuint64_t)(a.BH / a.group)};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)a.S * D * 2};
  const cuuint32_t ring_box[3] = {L::kSw / 2, kRing, 1};
  const cuuint32_t own_box[3] = {L::kSw / 2, kOwn, 1};
  if (!make_tmap(&q_ring, a.q, 3, q_dims, strides, ring_box, L::kSw) ||
      !make_tmap(&do_ring, a.dout, 3, q_dims, strides, ring_box, L::kSw) ||
      !make_tmap(&k_own, a.k, 3, kv_dims, strides, own_box, L::kSw) ||
      !make_tmap(&v_own, a.v, 3, kv_dims, strides, own_box, L::kSw) ||
      !make_tmap(&q_own, a.q, 3, q_dims, strides, own_box, L::kSw) ||
      !make_tmap(&do_own, a.dout, 3, q_dims, strides, own_box, L::kSw) ||
      !make_tmap(&k_ring, a.k, 3, kv_dims, strides, ring_box, L::kSw) ||
      !make_tmap(&v_ring, a.v, 3, kv_dims, strides, ring_box, L::kSw))
    return cudaErrorInvalidValue;
  if ((err = allow_smem<flash_bwd_dkdv_wgmma<D>>()) != cudaSuccess ||
      (err = allow_smem<flash_bwd_dq_wgmma<D>>()) != cudaSuccess)
    return err;
  const float* lse = static_cast<const float*>(a.lse);
  const int blocks = (a.S + kOwn - 1) / kOwn;
  flash_bwd_dkdv_wgmma<D><<<dim3(a.BH / a.group, blocks), kWgThreads, L::kSmem, a.stream>>>(
      q_ring, do_ring, k_own, v_own, lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.group, a.causal, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_wgmma<D><<<dim3(a.BH, blocks), kWgThreads, L::kSmem, a.stream>>>(
      q_own, do_own, k_ring, v_ring, lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.group,
      a.causal, a.scale);
  return cudaGetLastError();
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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma).  q, o, dout, dq:
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
    return dtype == 1 ? launch_wgmma<d>(a) : launch_fp32<d>(a);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
