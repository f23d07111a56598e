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
// d = 64 or 128) the work is ~4 * d flops per causal (query, key) pair
// against one pass over Q, K, V and O, so it is bound by tensor-core
// operations (989 TFLOP/s bf16 and fp16).
//
// bf16 (the models' path): a pre-pass on V, then an FA3-style kernel.
// The pre-pass (one thread block cluster of 8 CTAs a (b, KV head)) finds the
// head's max |V|, picks e so that max |V| 2^-e lies in (2^14, 2^15], and
// writes V 2^-e as fp16 -- exact for every value that lands in fp16's normal
// range -- and e.  The attention kernel is persistent: one CTA an SM walks
// the work tiles (128 query rows of one (b, h)), the heaviest causal query
// blocks first and the query heads of one KV head side by side, so they
// share its tiles in L2; a CTA's later tiles come from a counter in global
// memory (zeroed by the pre-pass).  It is launched as a programmatic
// dependent of the pre-pass, so its CTAs load Q and K and run the first S
// and softmax while the pre-pass ends.  A producer warpgroup (registers handed
// over with setmaxnreg; one thread issues) loads each tile's Q into one of
// two buffers and streams K and the fp16 V through rings of their own (128
// rows a stage; full / empty mbarriers; 128-byte swizzled, 64- or 32-byte
// for d = 32 or 16), running ahead into the next tile while the consumers
// finish this one.  Two consumer warpgroups of 64 rows each compute S = Q
// K^T with bf16 wgmma from shared memory, run the online softmax in
// registers (row max and sum over the 4 lanes that share an accumulator row;
// the mask only on the diagonal or ragged tile), and compute O += P V with P
// packed once to fp16 as wgmma's register A operand and the fp16 V N-major
// from shared memory: one m64nDk16 f16 product a k-step.  A consumer issues
// the next tile's S before this tile's P V and runs the next softmax while
// the P V runs, and the two consumers take turns to issue, so one's softmax
// overlaps the other's products.  The output, O / l times 2^e, leaves by TMA
// through the tile's Q buffer while the next tile runs.  S and the
// accumulators are fp32 throughout.  Rounding P to fp16 (11 bits, where a
// bf16 P keeps 8 and moves single outputs past the flash check's
// elementwise limit) meets the limit with one product a k-step; the earlier
// design kept ~16 bits by splitting P into bf16 hi + lo and ran two.
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W): 0.0405 ms a call
// at B 2, H 32, KV 4, S 1024, d 64 against a 0.0087 ms bound (21 %; SDPA
// 0.0359; the split design 0.046), 0.0934 at H 56, KV 8, d 128 against
// 0.0304 (33 %; SDPA 0.0731; the split design 0.114); the pre-pass alone
// 0.004-0.007 ms of it.
//
// The forward under autograd (training's) keeps that split: the kernel
// instantiated with kSplit skips the pre-pass (a memset zeroes the
// tile counter), streams the bf16 V as it is and issues two bf16 products a
// k-step, hi then lo.  fp16 P's rounding moves a bf16 output bit more often
// than the split's, and the gradients of a bf16 model carry each move on:
// at one batch zamba2-1.2b's smoke model read a largest relative L2 of 0.46
// against the plain path's gradients with fp16 P (0.40 with one bf16 P),
// 0.020 with this split and 0.027 with the plain forward's own output bits
// (experiments/numerics/grad_sensitivity.py on an H100).  The split costs
// ~16 % of a call at the train shape (B 8, H 32, KV 4, S 1024, d 64).
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

constexpr int kWgRows = 128;     // query rows per work tile: two consumer warpgroups of 64
constexpr int kWgKV = 128;       // K / V rows per ring stage
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumers
// Q buffers and ring stages.  Two Q buffers let the producer load the next
// work tile's Q while the consumers finish this one, and this tile's output
// leave by TMA through its Q buffer while the next tile runs.  K and V have
// rings of their own, so a K stage is free again once its S is done: with
// two stages each, a tile lands one k-step before it is needed (three were
// no faster where they fit, d <= 64, nor one Q buffer with three stages at
// d = 128).
constexpr int kQBufs = 2;
constexpr int kStages = 2;

// 2^n as a float, for n in [-126, 127].
__device__ __forceinline__ float exp2i(int n) { return __int_as_float((n + 127) << 23); }

// ---- the V pre-pass: V of each (b, KV head) as fp16 times 2^-e

constexpr int kVCluster = 8;     // CTAs a (b, KV head): one thread block cluster
constexpr int kVThreads = 256;
constexpr int kVUnroll = 4;      // 16-byte loads in flight a thread

// Two bf16 values (one 32-bit word) as two fp16 values times s1 s2 (powers
// of two: exact unless the result leaves fp16's normal range).
__device__ __forceinline__ uint32_t scaled_f16x2(uint32_t w, float s1, float s2) {
  return pack_f16(__uint_as_float(w << 16) * s1 * s2, __uint_as_float(w & 0xffff0000u) * s1 * s2);
}

// v, v16: (heads, n8 16-byte words) of bf16 and fp16.  Each CTA of a head's
// cluster reads its slice of the head for the largest finite |V| (bf16 bits
// with the sign cleared order as the values do; inf and NaN, 0x7f80 and
// above, count as 0), the CTAs share their maxima through distributed
// shared memory, and each writes its slice times 2^-e, with e the least
// exponent that puts that max 2^-e at or below 2^15 (fp16 reaches 65504) --
// 0 for a head with no finite nonzero value.  inf and NaN stay as they are
// (times a power of two), so they reach P V as in the plain version, and
// the head's finite values keep fp16's range beside them.  The slice's
// second read comes from L2.  vexp[head] = e; next_tile is zeroed for the
// main kernel's tile counter.
__global__ void __cluster_dims__(kVCluster, 1, 1) __launch_bounds__(kVThreads)
flash_v_to_f16(const uint4* __restrict__ v, uint4* __restrict__ v16, int* __restrict__ vexp,
               int* __restrict__ next_tile, int n8) {
  __shared__ uint32_t part[kVCluster];       // the cluster's CTAs' maxima
  __shared__ uint32_t warp_max[kVThreads / 32];
  const int rank = blockIdx.x % kVCluster;   // this CTA's rank in its cluster
  const size_t head = blockIdx.x / kVCluster;
  const int per = (n8 + kVCluster - 1) / kVCluster;
  const int lo = min(n8, rank * per), hi = min(n8, lo + per);
  const uint4* src = v + head * n8;
  uint4* dst = v16 + head * n8;
  griddep_launch_dependents();               // the attention kernel may start (see there)
  cluster_arrive_release();                  // with the wait below: every CTA has started
  // the slice's first kVThreads * kVUnroll words stay in registers for the
  // conversion (at the models' shapes, the whole slice); the rest is read
  // again from L2
  auto load = [&](uint4 (&w)[kVUnroll], int i) {
#pragma unroll
    for (int u = 0; u < kVUnroll; ++u) {
      const int j = i + u * kVThreads;
      w[u] = j < hi ? __ldg(src + j) : make_uint4(0, 0, 0, 0);
    }
  };
  auto convert = [&](const uint4 (&w)[kVUnroll], int i, float s1, float s2) {
#pragma unroll
    for (int u = 0; u < kVUnroll; ++u) {
      const int j = i + u * kVThreads;
      if (j < hi)
        dst[j] = make_uint4(scaled_f16x2(w[u].x, s1, s2), scaled_f16x2(w[u].y, s1, s2),
                            scaled_f16x2(w[u].z, s1, s2), scaled_f16x2(w[u].w, s1, s2));
    }
  };
  auto finite_abs = [](uint32_t x) {        // two |bf16|, inf and NaN as 0
    x &= 0x7fff7fffu;
    return x & __vcmpltu2(x, 0x7f807f80u);
  };
  auto fold = [&](uint32_t mx, const uint4 (&w)[kVUnroll]) {   // two 16-bit maxima
#pragma unroll
    for (int u = 0; u < kVUnroll; ++u)
      mx = __vmaxu2(__vmaxu2(mx, __vmaxu2(finite_abs(w[u].x), finite_abs(w[u].y))),
                    __vmaxu2(finite_abs(w[u].z), finite_abs(w[u].w)));
    return mx;
  };
  constexpr int kChunk = kVThreads * kVUnroll;
  uint4 first[kVUnroll];
  load(first, lo + threadIdx.x);
  uint32_t mx = fold(0, first);
  for (int i = lo + threadIdx.x + kChunk; i < hi; i += kChunk) {
    uint4 w[kVUnroll];
    load(w, i);
    mx = fold(mx, w);
  }
  mx = __reduce_max_sync(0xffffffffu, max(mx & 0xffffu, mx >> 16));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  cluster_wait_acquire();
  if (threadIdx.x < kVCluster) {             // push this CTA's max to every CTA
    uint32_t b = 0;
    for (int w = 0; w < kVThreads / 32; ++w) b = max(b, warp_max[w]);
    st_cluster_u32(cluster_map(smem_u32(&part[rank]), threadIdx.x), b);
  }
  cluster_arrive_release();
  cluster_wait_acquire();
  uint32_t m = 0;
  for (int r = 0; r < kVCluster; ++r) m = max(m, part[r]);
  int e = 0;
  if (m != 0) {
    int x;
    const float f = frexpf(__uint_as_float(m << 16), &x);   // max = f 2^x, f in [0.5, 1)
    e = x - 15 - (f == 0.5f);
  }
  if (rank == 0 && threadIdx.x == 0) {
    vexp[head] = e;
    if (head == 0) *next_tile = 0;
  }
  const float s1 = exp2i(-e / 2), s2 = exp2i(-e - -e / 2);  // both normal: e in [-148, 113]
  convert(first, lo + threadIdx.x, s1, s2);
  for (int i = lo + threadIdx.x + kChunk; i < hi; i += kChunk) {
    uint4 w[kVUnroll];
    load(w, i);
    convert(w, i, s1, s2);
  }
}

// ---- the attention kernel

// 2^x by the special-function unit (relative error ~2^-22; 0 for x << 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the bf16 kernel at head dim D.  Each tile is stored as
// column blocks of `kSw`-byte rows (kSw = the swizzle, min(2 D, 128)): the Q
// buffers, the K ring, the V ring, then the barriers and each Q buffer's
// work tile.
template <int D>
struct WgLayout {
  static constexpr int kSw = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kBlocks = 2 * D / kSw;          // column blocks per tile
  static constexpr int kQ = kWgRows * D * 2;           // one Q buffer
  static constexpr int kTile = kWgKV * D * 2;          // one K or V stage
  static constexpr int kK = kQBufs * kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kNumBars = 2 * kQBufs + 4 * kStages;
  static constexpr size_t kSmem = 1024 + kBars + kNumBars * sizeof(uint64_t) + kQBufs * sizeof(int);
  static_assert(kSmem <= (size_t)kSmemPerBlock, "flash_attention_wgmma: shared memory");
};

// q, o: (BH, S, D) bf16; k: (BH / group, S, D) bf16; v: V as fp16 times
// 2^-vexp[row] (the pre-pass's), or with kSplit the bf16 V itself (vexp
// unread); all contiguous, as 3-D tensor maps (D, S, rows).  Work tile t is
// query block nqb - 1 - t / BH (the heaviest causal blocks first) of row
// bh = t % BH (the query heads of one KV head side by side, so they share
// its tiles in L2).
template <int D, bool kSplit>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                      const int* __restrict__ vexp, int* __restrict__ next_tile, int S, int BH,
                      int group, int causal, float scale_log2) {
  using L = WgLayout<D>;
  constexpr int SW = L::kSw;
  constexpr int QB = kQBufs, ST = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + QB;           // both consumers' outputs have left the buffer
  uint64_t* k_full = q_empty + QB;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  int* tile_of = reinterpret_cast<int*>(v_empty + ST);   // each Q buffer's work tile (-1: none)

  const int nqb = (S + kWgRows - 1) / kWgRows;
  const int n_work = BH * nqb;
  const int wg = threadIdx.x / 128;
  auto kv_tiles = [&](int q0) {              // KV tiles of the query block at q0
    return ((causal ? min(S, q0 + kWgRows) : S) + kWgKV - 1) / kWgKV;
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 2);             // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);
      mbar_init(&v_empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      // the loads in the order the consumers need them: Q, K 0, then K j+1
      // before V j; stage use n of a ring waits for its use n - ST to end
      auto load = [&](const CUtensorMap* map, int base, uint64_t* full, uint64_t* empty, int n,
                      int row, int kvh) {
        const int s = n % ST;
        if (n >= ST) mbar_wait(&empty[s], ((n / ST) + 1) & 1);
        unsigned char* dst = smem + base + s * L::kTile;
        mbar_expect_tx(&full[s], L::kTile);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load_3d(dst + b * kWgKV * SW, map, &full[s], b * SW / 2, row, kvh);
      };
      int it = 0;                            // K (and V) tiles loaded so far
      int t = blockIdx.x;
      for (int n = 0;; ++n) {
        const int b = n % QB;
        if (n >= QB) mbar_wait(&q_empty[b], ((n / QB) + 1) & 1);
        tile_of[b] = t < n_work ? t : -1;
        if (t >= n_work) {
          mbar_arrive(&q_full[b]);
          break;
        }
        const int bh = t % BH, q0 = (nqb - 1 - t / BH) * kWgRows, kvh = bh / group;
        const int nt = kv_tiles(q0);
        mbar_expect_tx(&q_full[b], L::kQ);
#pragma unroll
        for (int blk = 0; blk < L::kBlocks; ++blk)
          tma_load_3d(smem + b * L::kQ + blk * kWgRows * SW, &tq, &q_full[b], blk * SW / 2, q0, bh);
        load(&tk, L::kK, k_full, k_empty, it, 0, kvh);
        for (int j = 0; j < nt; ++j) {
          if (j + 1 < nt) load(&tk, L::kK, k_full, k_empty, it + j + 1, (j + 1) * kWgKV, kvh);
          if (n == 0 && j == 0) griddep_wait();      // V and the tile counter are the pre-pass's
          load(&tv, L::kV, v_full, v_empty, it + j, j * kWgKV, kvh);
        }
        it += nt;
        t = gridDim.x + atomicAdd(next_tile, 1);
      }
    }
  } else {
    regs_alloc<232>();
    const int c = wg - 1;                    // this consumer's rows of a tile: 64 c ..
    const int lane = threadIdx.x % 32;
    const int warp_row = c * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    float sacc[kWgKV / 2];
    uint32_t p[kWgKV / 16][4];               // P of the current tile, A fragments: fp16,
    uint32_t p_lo[kSplit ? kWgKV / 16 : 1][4];   // or with kSplit bf16 hi + lo
    float oacc[D / 2];
    int it = 0;                              // K (and V) tiles consumed so far
    for (int n = 0;; ++n) {
      const int b = n % QB;
      mbar_wait(&q_full[b], (n / QB) & 1);
      const int t = tile_of[b];
      if (t < 0) break;
      const int bh = t % BH, q0 = (nqb - 1 - t / BH) * kWgRows;
      const int n_tiles = kv_tiles(q0);
      unsigned char* qs = smem + b * L::kQ;
      // this thread's accumulator rows: row_lo and row_lo + 8
      const int row_lo = q0 + warp_row;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};               // this thread's share of each row sum
      const uint32_t qa = smem_u32(qs) + c * 64 * SW;

      auto wait_k = [&](int j) { mbar_wait(&k_full[(it + j) % ST], ((it + j) / ST) & 1); };
      auto wait_v = [&](int j) { mbar_wait(&v_full[(it + j) % ST], ((it + j) / ST) & 1); };
      auto release = [&](uint64_t* empty, int j) {
        if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it + j) % ST]);
      };
      // S = Q K^T of tile j into sacc (K is K-major: d contiguous)
      auto issue_s = [&](int j) {
        const uint32_t kb = smem_u32(smem + L::kK + ((it + j) % ST) * L::kTile);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kWgKV, 0>(sacc, desc_kmajor(qa, kWgRows, SW, kk),
                             desc_kmajor(kb, kWgKV, SW, kk), kk > 0);
      };
      // O += P V of tile j (V is N-major: d contiguous): one fp16 product a
      // k16 step, or with kSplit two bf16 products, hi then lo
      auto issue_pv = [&](int j) {
        const uint32_t vb = smem_u32(smem + L::kV + ((it + j) % ST) * L::kTile);
#pragma unroll
        for (int kk = 0; kk < kWgKV / 16; ++kk) {
          const uint64_t dv = desc_mnmajor(vb, kWgKV, SW, kk);
          if constexpr (kSplit) {
            wgmma_rs<D>(oacc, p[kk], dv, 1);
            wgmma_rs<D>(oacc, p_lo[kk], dv, 1);
          } else {
            wgmma_rs_f16<D>(oacc, p[kk], dv, 1);
          }
        }
      };

      // online softmax of tile j in the log2 domain (m is the raw row max,
      // scaled on use), the mask only where a tile crosses the diagonal or
      // the end of S.  Part 1 turns S into P in place and updates m and l;
      // part 2, once the last P V is done, rescales O and leaves P in p as
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
            if constexpr (kSplit) {
              const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
              p[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
              p_lo[kk][e] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
            } else {
              p[kk][e] = pack_f16(p0, p1);
            }
          }
      };

      wait_k(0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      release(k_empty, 0);
      softmax_p(0);
      rescale_and_pack();
      griddep_wait();                        // the pre-pass's exponents
      const int ve = kSplit ? 0 : __ldg(vexp + bh / group);

      // Each step issues the next tile's S, then O += P V of this tile, and
      // runs the next tile's softmax while the P V runs.  The two consumers
      // take turns to issue (named barriers 3 and 4, consumer 0 first), so
      // one's softmax also overlaps the other's products.  The last tile's
      // P V is peeled off, so that no wgmma or register it uses sits under a
      // branch (ptxas would serialise the wgmmas).
      if (c == 1) named_barrier_arrive(3, 256);
      for (int j = 0; j + 1 < n_tiles; ++j) {
        wait_k(j + 1);
        wait_v(j);
        named_barrier(3 + c, 256);
        wgmma_fence();
        issue_s(j + 1);
        wgmma_commit();
        issue_pv(j);
        wgmma_commit();
        named_barrier_arrive(4 - c, 256);
        wgmma_wait<1>();
        fence_regs(sacc);
        release(k_empty, j + 1);
        softmax_p(j + 1);
        wgmma_wait<0>();
        fence_regs(oacc);
        release(v_empty, j);
        rescale_and_pack();
      }
      wait_v(n_tiles - 1);
      named_barrier(3 + c, 256);
      wgmma_fence();
      issue_pv(n_tiles - 1);
      wgmma_commit();
      if (c == 0) named_barrier_arrive(4, 256);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(v_empty, n_tiles - 1);
      it += n_tiles;

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
      // O = (P V16 / l) 2^e (e = 0 with kSplit), the two powers of two normal
      // for e in [-148, 113].
      // The output goes through this warpgroup's rows of the Q buffer (its
      // last reader was this warpgroup's last S product), laid out and
      // swizzled as Q is; one thread stores them with TMA, which clips rows
      // past S, and frees the buffer for the producer once TMA has read it.
      const float s1 = exp2i(ve / 2), s2 = exp2i(ve - ve / 2);
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i / 2) % 2;
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        const uint32_t off = (col / (SW / 2)) * kWgRows * SW +
                             swizzle((warp_row + 8 * r) * SW + (col % (SW / 2)) * 2, SW);
        *reinterpret_cast<uint32_t*>(qs + off) =
            pack_bf16(oacc[i] / denom[r] * s1 * s2, oacc[i + 1] / denom[r] * s1 * s2);
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int blk = 0; blk < L::kBlocks; ++blk)
          tma_store_3d(&to, qs + blk * kWgRows * SW + c * 64 * SW, blk * SW / 2, q0 + 64 * c, bh);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&q_empty[b]);
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();
  }
}

// A null v16 takes the split form: no pre-pass, the tile counter zeroed by
// a memset, the kernel reading the bf16 V in place.
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         void* v16, int* vexp, int* next_tile, int BH, int S, int group,
                         int causal, float scale, cudaStream_t stream) {
  using L = WgLayout<D>;
  const bool split = v16 == nullptr;
  const int heads = BH / group;
  cudaError_t err = split ? cudaMemsetAsync(next_tile, 0, sizeof(int), stream) : cudaSuccess;
  if (err == cudaSuccess && !split) {
    flash_v_to_f16<<<heads * kVCluster, kVThreads, 0, stream>>>(
        static_cast<const uint4*>(v), static_cast<uint4*>(v16), vexp, next_tile, S * D / 8);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t q_box[3] = {L::kSw / 2, kWgRows, 1};
  const cuuint32_t kv_box[3] = {L::kSw / 2, kWgKV, 1};
  const cuuint32_t o_box[3] = {L::kSw / 2, 64, 1};   // one consumer's rows
  if (!make_tmap(&tq, q, 3, q_dims, strides, q_box, L::kSw) ||
      !make_tmap(&to, o, 3, q_dims, strides, o_box, L::kSw) ||
      !make_tmap(&tk, k, 3, kv_dims, strides, kv_box, L::kSw) ||
      !(split ? make_tmap(&tv, v, 3, kv_dims, strides, kv_box, L::kSw)
              : make_tmap(&tv, v16, 3, kv_dims, strides, kv_box, L::kSw,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT16)))
    return cudaErrorInvalidValue;
  auto kernel = split ? flash_attention_wgmma<D, true> : flash_attention_wgmma<D, false>;
  err = split ? allow_smem<flash_attention_wgmma<D, true>>()
              : allow_smem<flash_attention_wgmma<D, false>>();
  if (err != cudaSuccess) return err;
  const int n_work = BH * ((S + kWgRows - 1) / kWgRows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_sms() < n_work ? num_sms() : n_work);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  // a programmatic dependent of the pre-pass (griddep_wait before the first
  // V load and the first read of the exponents); of the memset, a plain one
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = overlap;
  cfg.numAttrs = split ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, to, lse,
                           static_cast<const int*>(vexp), next_tile, S, BH, group, causal,
                           scale * 1.4426950408889634f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
                     float* lse, void* v16, int* vexp, int* next_tile, int BH, int S, int D,
                     int group, int causal, float scale, cudaStream_t stream) {
#define FLASH_CASE(d)                                                                      \
  case d:                                                                                  \
    return dtype == 1 ? launch_wgmma<d>(q, k, v, o, lse, v16, vexp, next_tile, BH, S, group, \
                                        causal, scale, stream)                            \
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

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (the wgmma kernel).
// head_dim D in {16, 32, 64, 128}.  lse: null, or fp32 (BH, S) for the
// rows' log-sum-exp.  bf16 only: v16, fp16 like v for the pre-pass's V, or
// null for the split form; vexp, BH / group int32 (the pre-pass's
// exponents) followed by one int32 (the tile counter).  Returns the first
// cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int D, int group, int causal, int dtype,
                                      float scale, void* lse, void* v16, void* vexp,
                                      void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !vexp))
    return cudaErrorInvalidValue;
  int* e = static_cast<int*>(vexp);
  return launch_d(dtype, q, k, v, o, static_cast<float*>(lse), v16, e,
                  e ? e + BH / group : nullptr, BH, S, D, group, causal, scale,
                  static_cast<cudaStream_t>(stream));
}
