// Blocked causal GQA attention with online softmax for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_kernel
// (the Pallas TPU kernel, body _flash_kernel).  Same function: scale 1/sqrt(d),
// masked logits set to -1e30, running max / sum and an fp32 accumulator per
// query row, output acc / max(l, 1e-30) in the input type.  Query head h reads
// KV head h / (H / KV), i.e. flattened row bh reads KV row bh / group, as the
// reference's index map does.  Tiles entirely above the causal diagonal are
// skipped (they contribute exactly 0), and the ragged S edge is masked here,
// so S need not be a multiple of the block.
//
// What bounds it on an H100: at the prefill shapes of the models (S = 1024,
// d = 64) the work is ~4 * d flops per causal (query, key) pair against one
// pass over Q, K, V and O, so it is bound by tensor-core operations (989
// TFLOP/s bf16).
//
// bf16 (the models' path): an FA3-style kernel.  One CTA owns 128 query rows
// of one (b, h): a producer warpgroup (registers handed over with setmaxnreg;
// one thread issues) loads the Q tile once and streams K and V tiles of 128
// rows through a 3-stage TMA ring (full / empty mbarriers), 128-byte swizzled
// (64- or 32-byte for d = 32 or 16).  Two consumer warpgroups of 64 rows each
// compute S = Q K^T with wgmma from shared memory, run the online softmax in
// registers (row max and sum over the 4 lanes that share an accumulator row;
// the mask only on the diagonal or ragged tile), and compute O += P V with P
// from registers as wgmma's A operand and V N-major from shared memory.  A
// consumer issues the next tile's S before this tile's P V and runs the next
// softmax while the P V runs, and the two consumers take turns to issue, so
// one's softmax overlaps the other's products; the third stage keeps the
// next tile landed while the lagging consumer still reads the oldest (with
// two, the overlap was lost to waiting on the ring).  P is split into bf16
// hi + lo parts and both go through the P V product, so P keeps ~16 bits (a
// single bf16 P, as FA2/FA3 round it, moves single outputs past the flash
// check's elementwise limit); S and the accumulators are fp32 throughout.
// The output leaves through the Q tile's shared memory by TMA.  The grid
// launches the heaviest causal query blocks first, and the query heads of
// one KV head side by side, so they share its tiles in L2.
// Measured share of the bound (chip_smoke.py on an H100 80GB HBM3 at 700 W):
// 0.046 ms a launch at B 2, H 32, KV 4, S 1024, d 64 against a 0.0087 ms
// bound, 19 % (the split P adds half again to the products the bound
// counts; scaled_dot_product_attention takes 0.037 ms).
//
// Both routes write the fp32 row log-sum-exp of the scaled, masked scores
// (m + log l) when given an `lse` pointer, for the backward kernel
// (flash_attention_bwd.cu); with a null pointer nothing else changes.
//
// fp32: the first version's kernel.  One CTA (128 threads) owns a 64-row
// query block and loops over 64-row KV blocks in fp32 on the CUDA cores (67
// TFLOP/s), so that no fp32 result goes through TF32 or bf16.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;

// Reduce over the 8 lanes that share one query row (lanes 8r .. 8r+7).
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D + (size_t)BQ * (BKV + 1);
}

// ------------------------------------------------------------- fp32 route

// q: (BH, S, D); k, v: (BH / group, S, D); o: (BH, S, D); all contiguous fp32.
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4*ty .. 4*ty+3 of the
// block; for logits it owns KV columns tx + 8*j, for the output dims tx + 8*j.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fp32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int group, int causal, float scale) {
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int LDP = BKV + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float sm[];
  float* qs = sm;              // BQ x LD
  float* ks = qs + BQ * LD;    // BKV x LD
  float* vs = ks + BKV * LD;   // BKV x D
  float* ps = vs + BKV * D;    // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)(bh / group) * S * D;
  const float* vb = v + (size_t)(bh / group) * S * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = (q0 + r < S) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // previous block's ks / vs / ps reads are done
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < S;  // zero rows past S: p = 0 must not meet NaN
      ks[r * LD + c] = ok ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r * D + c] = ok ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        float val = s[i][j] * scale;
        if (kp >= S || (causal && kp > qp)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * LDP + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pa[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(size_t)qp * D + tx + 8 * j] = acc[i][j] / denom;
    if (lse && tx == 0) lse[(size_t)bh * S + qp] = m[i] + logf(denom);
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int S, int group, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem<flash_attention_fp32<D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_attention_fp32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, group, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- bf16 route

constexpr int kWgRows = 128;     // query rows per CTA: two consumer warpgroups of 64
constexpr int kWgKV = 128;       // K / V rows per ring stage
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumers

// 2^x by the special-function unit (relative error ~2^-22; 0 for x << 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the bf16 kernel at head dim D.  Each tile is stored as
// column blocks of `kSw`-byte rows (kSw = the swizzle, min(2 D, 128)): the Q
// tile, then per stage the K tile and the V tile, then the barriers.
template <int D>
struct WgLayout {
  static constexpr int kSw = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kBlocks = 2 * D / kSw;          // column blocks per tile
  static constexpr int kQ = kWgRows * D * 2;
  static constexpr int kTile = kWgKV * D * 2;          // one K or V tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBars = kQ + kWgStages * kStage;
  static constexpr size_t kSmem = 1024 + kBars + (1 + 2 * kWgStages) * sizeof(uint64_t);
};

// q, o: (BH, S, D); k, v: (BH / group, S, D); bf16, contiguous, as 3-D tensor
// maps (D, S, rows).  blockIdx.x is bh (the query heads of one KV head are
// neighbours), blockIdx.y counts query blocks from the last (heaviest) one.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, float* __restrict__ lse, int S,
                      int group, int causal, float scale_log2) {
  using L = WgLayout<D>;
  constexpr int SW = L::kSw;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* kvs = smem + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int kv_end = causal ? min(S, q0 + kWgRows) : S;
  const int n_tiles = (kv_end + kWgKV - 1) / kWgKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b)
        tma_load_3d(qs + b * kWgRows * SW, &tq, q_full, b * SW / 2, q0, bh);
      const int kvh = bh / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kWgStages;
        if (j >= kWgStages) mbar_wait(&empty[s], ((j / kWgStages) + 1) & 1);
        unsigned char* ks = kvs + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b) {
          tma_load_3d(ks + b * kWgKV * SW, &tk, &full[s], b * SW / 2, j * kWgKV, kvh);
          tma_load_3d(ks + L::kTile + b * kWgKV * SW, &tv, &full[s], b * SW / 2, j * kWgKV, kvh);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;                  // this consumer's rows: q0 + 64 c ..
    const int lane = threadIdx.x % 32;
    // this thread's accumulator rows: row_lo and row_lo + 8
    const int row_lo = q0 + c * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};               // this thread's share of each row sum
    float sacc[kWgKV / 2];
    uint32_t p_hi[kWgKV / 16][4], p_lo[kWgKV / 16][4];   // P of the current tile
    const uint32_t qa = smem_u32(qs) + c * 64 * SW;

    // S = Q K^T of tile j into sacc (K is K-major: d contiguous), once the
    // tile has landed
    auto wait_tile = [&](int j) { mbar_wait(&full[j % kWgStages], (j / kWgStages) & 1); };
    auto issue_s = [&](int j) {
      const uint32_t kb = smem_u32(kvs + (j % kWgStages) * L::kStage);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kWgKV, 0>(sacc, desc_kmajor(qa, kWgRows, SW, kk),
                           desc_kmajor(kb, kWgKV, SW, kk), kk > 0);
    };
    // O += P V of tile j (V is N-major: d contiguous)
    auto issue_pv = [&](int j) {
      const uint32_t vb = smem_u32(kvs + (j % kWgStages) * L::kStage) + L::kTile;
#pragma unroll
      for (int kk = 0; kk < kWgKV / 16; ++kk) {
        const uint64_t dv = desc_mnmajor(vb, kWgKV, SW, kk);
        wgmma_rs<D>(oacc, p_hi[kk], dv, 1);
        wgmma_rs<D>(oacc, p_lo[kk], dv, 1);
      }
    };

    // online softmax of tile j in the log2 domain (m is the raw row max,
    // scaled on use), the mask only where a tile crosses the diagonal or the
    // end of S.  Part 1 turns S into P in place and updates m and l; part 2,
    // once the last P V is done, rescales O and leaves P in p_hi + p_lo as
    // wgmma A fragments: the accumulator layout of S is the A layout of P
    // (k16 step kk takes S's values 8 kk .. 8 kk + 7).
    float alpha[2];
    auto softmax_p = [&](int j) {
      const int k0 = j * kWgKV;
      const bool edge = k0 + kWgKV > S || (causal && j == n_tiles - 1);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kWgKV / 2; ++i) {
        if (edge) {
          const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int qp = row_lo + 8 * ((i / 2) % 2);
          if (kp >= S || (causal && kp > qp)) sacc[i] = kNegInf;
        }
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sacc[i]);
      }
      float m_scaled[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        m_scaled[r] = mx[r] * scale_log2;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kWgKV / 2; ++i) {
        const int r = (i / 2) % 2;
        sacc[i] = fast_exp2(fmaf(sacc[i], scale_log2, -m_scaled[r]));
        l[r] += sacc[i];
      }
    };
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int kk = 0; kk < kWgKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p0 = sacc[8 * kk + 2 * e], p1 = sacc[8 * kk + 2 * e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          p_hi[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][e] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
        }
    };

    mbar_wait(q_full, 0);
    wait_tile(0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_p(0);
    rescale_and_pack();

    // Each step issues the next tile's S, then O += P V of this tile, and
    // runs the next tile's softmax while the P V runs.  The two consumers
    // take turns to issue (named barriers 3 and 4, consumer 0 first), so
    // one's softmax also overlaps the other's products.  The last tile's
    // P V is peeled off, so that no wgmma or register it uses sits under a
    // branch (ptxas would serialise the wgmmas).
    if (c == 1) named_barrier_arrive(3, 256);
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wait_tile(j + 1);
      named_barrier(3 + c, 256);
      wgmma_fence();
      issue_s(j + 1);
      wgmma_commit();
      issue_pv(j);
      wgmma_commit();
      named_barrier_arrive(4 - c, 256);
      wgmma_wait<1>();
      fence_regs(sacc);
      softmax_p(j + 1);
      wgmma_wait<0>();
      fence_regs(oacc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[j % kWgStages]);
      rescale_and_pack();
    }
    named_barrier(3 + c, 256);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    if (c == 0) named_barrier_arrive(4, 256);
    wgmma_wait<0>();
    fence_regs(oacc);

    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-30f);
      // ln-sum-exp of the scaled scores: m is the raw row max
      if (lse && lane % 4 == 0 && row_lo + 8 * r < S)
        lse[(size_t)bh * S + row_lo + 8 * r] = m[r] * scale_log2 * 0.6931471805599453f +
                                               logf(denom[r]);
    }
    // the output goes through this warpgroup's rows of the Q tile (its last
    // reader was this warpgroup's last S product), laid out and swizzled as
    // Q is; one thread stores them with TMA, which clips rows past S
    const int row = c * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const uint32_t off = (col / (SW / 2)) * kWgRows * SW +
                           swizzle((row + 8 * r) * SW + (col % (SW / 2)) * 2, SW);
      *reinterpret_cast<uint32_t*>(qs + off) =
          pack_bf16(oacc[i] / denom[r], oacc[i + 1] / denom[r]);
    }
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b)
        tma_store_3d(&to, qs + b * kWgRows * SW + c * 64 * SW, b * SW / 2, q0 + 64 * c, bh);
      bulk_commit();
      bulk_wait<0>();
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int BH, int S, int group, int causal, float scale,
                         cudaStream_t stream) {
  using L = WgLayout<D>;
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)(BH / group)};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t q_box[3] = {L::kSw / 2, kWgRows, 1};
  const cuuint32_t kv_box[3] = {L::kSw / 2, kWgKV, 1};
  const cuuint32_t o_box[3] = {L::kSw / 2, 64, 1};   // one consumer's rows
  if (!make_tmap(&tq, q, 3, q_dims, strides, q_box, L::kSw) ||
      !make_tmap(&to, o, 3, q_dims, strides, o_box, L::kSw) ||
      !make_tmap(&tk, k, 3, kv_dims, strides, kv_box, L::kSw) ||
      !make_tmap(&tv, v, 3, kv_dims, strides, kv_box, L::kSw))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<flash_attention_wgmma<D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + kWgRows - 1) / kWgRows);
  flash_attention_wgmma<D><<<grid, kWgThreads, L::kSmem, stream>>>(
      tq, tk, tv, to, lse, S, group, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int S, int D, int group, int causal, float scale,
                     cudaStream_t stream) {
#define FLASH_CASE(d)                                                                      \
  case d:                                                                                  \
    return dtype == 1                                                                      \
               ? launch_wgmma<d>(q, k, v, o, lse, BH, S, group, causal, scale, stream)    \
               : launch_fp32<d>(q, k, v, o, lse, BH, S, group, causal, scale, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (wgmma kernel).  head_dim
// D in {16, 32, 64, 128}.  lse: null, or fp32 (BH, S) for the rows' log-sum-exp.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int D, int group, int causal, int dtype,
                                      float scale, void* lse, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  return launch_d(dtype, q, k, v, o, static_cast<float*>(lse), BH, S, D, group, causal, scale,
                  static_cast<cudaStream_t>(stream));
}
