// LTRF-planned blocked matmul for Hopper (sm_90a): out(M,N) = x(M,K) @ w(K,N).
//
// Replaces: src/repro/kernels/ltrf_matmul/kernel.py, ltrf_matmul_kernel (the
// Pallas TPU kernel, body _ltrf_matmul_kernel).  Same function: fp32
// accumulation over K, one rounding to the output type at the end.
//
// What bounds it on an H100: in a prefill (M = 2048) the product is bound by
// tensor-core operations (989 TFLOP/s bf16): ~2 * K flops per weight byte
// against the ~295 flops/byte at which the tensor cores, not HBM, become the
// limit.  In the serving decode step (M = 8 rows) each weight byte is used by
// 8 rows only, so the product is bound by the bytes streamed from HBM
// (3.35 TB/s).
//
// The paper's mapping: the weight matrix in HBM is the large, slow main
// register file; a ring of shared-memory stages is the register-file cache;
// the next interval's weight tiles are in flight while the consumers compute
// on the current ones.  A CTA streams the weight tiles of its work units
// (output tiles, or k-slices of them) through the ring, whose depth is the
// num_slots of the validated per-CTA IntervalPlan the wrapper builds
// (repro_torch/core/plan.py).
// Three routes, chosen by the wrapper from dtype, M and the operands' layout:
//
// wgmma (bf16, M > 64, and the backward's layouts at every M; prefill and
// training).  A 128 x BN tile (BN = 128 or 256) over BK =
// 64 stages.  A producer warpgroup (registers handed to the consumers with
// setmaxnreg; one thread issues) keeps TMA loads of the x tile (K-major) and
// of the weight tile (N-major, as w lies in HBM: no transpose or copy) in
// flight, one full and one empty mbarrier per stage.  Two consumer
// warpgroups of 64 rows each run wgmma m64nBNk16 from shared memory (B with
// the transpose bit) into fp32 registers, keeping one k-stage of wgmma in
// flight.  The grid is persistent (one CTA an SM walks its work units:
// whole output tiles in full waves, and the tiles of a ragged last wave, or
// of less than a wave, cut into k-slices over the SMs that would idle, their
// fp32 partials summed in a fixed order by the tile's last slice), so the
// ring fills the next tile while the consumers finish this one; they
// round the tile into shared memory and store it with TMA, which leaves them
// free for the next tile at once (stores straight from registers, 4 bytes a
// thread and 8 rows a warp instruction, left the tensor cores idle for a
// large part of each tile).  TMA boxes
// are 128-byte swizzled (no row padding), loads are zero-filled and stores
// clipped past M, K and N, so no shape is padded on the host.  Weight rows
// whose length in bytes is an odd multiple of 16 load slower through TMA.
// Measured share of the bound (chip_smoke.py on an H100 80GB HBM3 at 700 W):
// tinyllama-1.1b's prefill mix (155 launches at M = 2048) takes 6.47 ms
// against a 4.28 ms bound, 66 % (cuBLAS: 6.25 ms); mamba2-1.3b's 65 % and
// zamba2-1.2b's 74 %.
// The same route runs the backward's two products with their operands as
// they lie (layouts nt and tn: dX = dY w^T reads w K-major, dW = x^T dY reads
// x with wgmma's A transpose bit), and splits the reduction of products with
// too few output tiles over a fixed-order sum: see the section below.  A
// tinyllama-1.1b train step's 310 backward launches (M = 8192) take 47.9 ms
// against a 34.5 ms bound (cuBLAS: 46.1 ms).
//
// decode (bf16, M <= 64; serving).  The product swapped (the weight is
// wgmma's A operand, the few rows of x its B), K split so that every shape
// fills the card, a TMA ring per CTA and a deterministic reduction of the
// slices inside a thread block cluster (or, past 8 slices, by the last CTA
// of each tile): see the section below.
//
// fp32 (any M): a cp.async ring of padded tiles feeding FFMA in the mma.sync
// register layout (never TF32, which misses fp32 tolerances), bound far from
// the card's limits; PERF.md has its times.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxStages = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp.async.wait_group takes an immediate: switch over the run-time ring depth.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// fp32 route: FFMA over a cp.async ring.  Accumulator layout (the mma.sync
// m16n8 C fragment):
// acc[mt][nt][0..3] holds rows (g, g, g+8, g+8) and columns (2t, 2t+1, 2t, 2t+1)
// of the warp's (mt, nt) 16x8 sub-tile, with g = lane / 4 and t = lane % 4.
template <typename T, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
ltrf_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int M, int K, int N, int stages) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int LDX = BK + CH;        // padded shared-memory row strides
  constexpr int LDW = BN + CH;
  constexpr int kXTile = BM * LDX;
  constexpr int kWTile = BK * LDW;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int MT = WTM / 16;
  constexpr int NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + stages * kXTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm0 = (warp / WN) * WTM;
  const int wn0 = (warp % WN) * WTN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  // One ring slot <- weight tile kt (and the matching x tile), zero-filled
  // past the ragged edges: src-size 0 copies nothing and writes 16 zero bytes.
  auto load_tile = [&](int kt, int slot) {
    const int k0 = kt * BK;
    T* xd = xs + slot * kXTile;
    for (int c = tid; c < BM * (BK / CH); c += kThreads) {
      const int r = c / (BK / CH);
      const int cc = (c % (BK / CH)) * CH;
      const bool ok = (m0 + r < M) && (k0 + cc < K);
      cp_async16(xd + r * LDX + cc, ok ? x + (size_t)(m0 + r) * K + k0 + cc : x, ok ? 16 : 0);
    }
    T* wd = ws + slot * kWTile;
    for (int c = tid; c < BK * (BN / CH); c += kThreads) {
      const int r = c / (BN / CH);
      const int cc = (c % (BN / CH)) * CH;
      const bool ok = (k0 + r < K) && (n0 + cc < N);
      cp_async16(wd + r * LDW + cc, ok ? w + (size_t)(k0 + r) * N + n0 + cc : w, ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Prologue: fill stages - 1 slots ahead.  One commit group per tile (empty
  // past the end), so "tile kt has landed" is always wait_group(stages - 2).
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_k) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait(stages - 2);
    __syncthreads();  // tile kt visible to all; slot (kt - 1) % stages free
    const int ahead = kt + stages - 1;
    if (ahead < n_k) load_tile(ahead, ahead % stages);
    cp_async_commit();

    const T* xt = xs + (kt % stages) * kXTile;
    const T* wt = ws + (kt % stages) * kWTile;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[MT][2];
      float b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a[i][0] = xt[(wm0 + i * 16 + g) * LDX + kk];
        a[i][1] = xt[(wm0 + i * 16 + g + 8) * LDX + kk];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = wt[kk * LDW + wn0 + j * 8 + 2 * t];
        b[j][1] = wt[kk * LDW + wn0 + j * 8 + 2 * t + 1];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[i][j][0] = fmaf(a[i][0], b[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(a[i][0], b[j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(a[i][1], b[j][0], acc[i][j][2]);
          acc[i][j][3] = fmaf(a[i][1], b[j][1], acc[i][j][3]);
        }
    }
  }
  cp_async_wait(0);

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (r < M && c < N) store(out + (size_t)r * N + c, acc[i][j][e]);
      }
}

template <typename T, int BM, int BN, int BK, int WM, int WN>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K, int N,
                   int stages, cudaStream_t stream) {
  constexpr int CH = 16 / sizeof(T);
  const size_t smem = (size_t)stages * (BM * (BK + CH) + BK * (BN + CH)) * sizeof(T);
  auto kernel = ltrf_matmul_kernel<T, BM, BN, BK, WM, WN>;
  cudaError_t err = allow_smem<ltrf_matmul_kernel<T, BM, BN, BK, WM, WN>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                               static_cast<T*>(out), M, K, N, stages);
  return cudaGetLastError();
}

// fp32 tiles for M <= 64: one M-tile of BM rows, 4 warps side by side in N.
cudaError_t launch_fp32_narrow(const void* x, const void* w, void* out, int M, int K, int N,
                               int bm, int stages, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch<float, 16, 32, 64, 1, 4>(x, w, out, M, K, N, stages, stream);
    case 32: return launch<float, 32, 32, 64, 1, 4>(x, w, out, M, K, N, stages, stream);
    case 64: return launch<float, 64, 32, 64, 1, 4>(x, w, out, M, K, N, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- decode route
//
// bf16, M <= 64: out^T (N x M) = w^T (N x K) . x^T (K x M), so the weight is
// wgmma's A operand (64 output columns a CTA, read MN-major with the
// transpose bit from the same 64-column, 128-byte-swizzled TMA boxes as the
// wgmma route: no copy, no padding of the weight) and the M rows of x are
// its B operand (K-major, 64-byte swizzled boxes of 32 K values), padded to
// MP = 8, 16, 32 or 64 by TMA's zero fill.  The product is bound by the
// weight bytes, so what matters is bytes in flight on every SM: K is split
// into `split` slices, so that (N / 64) x split CTAs cover the card, and each
// CTA streams its slice's 32-row weight boxes through a `stages`-deep ring
// (one producer warp issuing TMA, one consumer warpgroup issuing wgmma, full
// and empty mbarriers per stage).  The slices of a tile are summed in the
// fixed order 0 .. split-1 and rounded once to bf16, so two launches give the
// same bits; no float atomics.  With split <= 8 the tile's CTAs form a
// thread block cluster: slices 1 .. split-1 store their fp32 partials into
// slice 0's shared memory and arrive at the cluster barrier, and slice 0
// sums them (through global memory, the fence, the counter and the loads
// cost a round trip each, the largest fixed cost of a launch).  With more
// slices each CTA writes its partial to a workspace and bumps the tile's
// counter; the CTA that arrives last sums the slices and resets the counter
// to 0, so a CUDA graph can replay the launch.  Measured (chip_smoke.py, H100
// 80GB HBM3 at 700 W): a decode step's matmuls at 1.00-1.03x torch.matmul's
// time, ~2.2x their bytes bound; PERF.md has the shapes.

constexpr int kDecBK = 32;                 // K rows of one stage
constexpr int kDecBN = 64;                 // output columns of a CTA (wgmma's M)
constexpr int kDecThreads = 160;           // consumer warpgroup + producer warp
constexpr int kDecMaxStages = 16;
constexpr int kDecMaxCluster = 8;          // the portable cluster size
constexpr int kDecWBytes = kDecBK * kDecBN * 2;   // one weight box, 4 KB

template <int MP>
__host__ __device__ constexpr int dec_x_bytes() { return MP * kDecBK * 2; }
// the x box sits 1024-byte aligned after the weight box
template <int MP>
__host__ __device__ constexpr int dec_stage_bytes() {
  return kDecWBytes + (dec_x_bytes<MP>() < 1024 ? 1024 : dec_x_bytes<MP>());
}
// the ring, its barriers, a flag (16 bytes) and, for a clustered split,
// slice 0's slots for the other slices' partials
template <int MP>
size_t dec_smem_bytes(int stages, int split) {
  const int gather = split > 1 && split <= kDecMaxCluster ? (split - 1) * kDecBN * MP * 4 : 0;
  return 1024 + (size_t)stages * (dec_stage_bytes<MP>() + 2 * sizeof(uint64_t)) + 16 + gather;
}

template <int MP>
__global__ void __launch_bounds__(kDecThreads)
ltrf_matmul_decode(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
                   int* __restrict__ counters, int M, int K, int N, int split, int stages) {
  constexpr int kStage = dec_stage_bytes<MP>();
  constexpr int kTx = kDecWBytes + dec_x_bytes<MP>();
  constexpr int kAcc = MP / 2;             // fp32 accumulators a thread
  // dynamic shared memory only: allow_smem asks for all of it
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * kStage);
  uint64_t* empty = full + stages;
  int* last_cta = reinterpret_cast<int*>(empty + stages);
  float* gather = reinterpret_cast<float*>(empty + stages + 2);

  const int tile = blockIdx.x / split;     // the split CTAs of one tile are neighbours
  const int slice = blockIdx.x % split;
  const int n0 = tile * kDecBN;
  const int n_kb = (K + kDecBK - 1) / kDecBK;
  const int kb0 = (int)((long long)slice * n_kb / split);
  const int nk = (int)((long long)(slice + 1) * n_kb / split) - kb0;   // >= 1: split <= n_kb

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: the i-th stage of the slice goes to slot i % stages once the
    // consumers have released that slot's previous stage
    if (threadIdx.x == 128) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        unsigned char* st = smem + (size_t)s * kStage;
        mbar_expect_tx(&full[s], kTx);
        tma_load_2d(st, &tw, &full[s], n0, (kb0 + i) * kDecBK);
        tma_load_2d(st + kDecWBytes, &tx, &full[s], (kb0 + i) * kDecBK, 0);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const uint32_t wa = smem_u32(smem + (size_t)s * kStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDecBK / 16; ++kk)
      wgmma_ss_tn<MP>(acc, desc_mnmajor(wa, kDecBK, 128, kk),
                      desc_kmajor(wa + kDecWBytes, MP, 64, kk), 1);
    wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0 && tid == 0) mbar_arrive(&empty[(i - 1) % stages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const size_t tile_floats = (size_t)kDecBN * MP;
  if (split > 1 && split <= kDecMaxCluster) {
    // the cluster is the tile's slices: slice s > 0 stores its partial, in
    // the accumulator layout, into slot s - 1 of slice 0's shared memory
    if (slice > 0) {
      const uint32_t dst =
          cluster_map(smem_u32(gather + (slice - 1) * tile_floats + tid * kAcc), 0);
#pragma unroll
      for (int j = 0; j < kAcc; j += 4)
        st_cluster_v4(dst + 4 * j, acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    }
    cluster_arrive_release();
    if (slice > 0) return;
    cluster_wait_acquire();
    for (int sl = 1; sl < split; ++sl) {
#pragma unroll
      for (int j = 0; j < kAcc; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(gather + (sl - 1) * tile_floats + tid * kAcc + j);
        acc[j] += v.x; acc[j + 1] += v.y; acc[j + 2] += v.z; acc[j + 3] += v.w;
      }
    }
  } else if (split > 1) {
    // this slice's partial tile, in the accumulator layout, then the counter
    float4* mine = reinterpret_cast<float4*>(partials + (size_t)blockIdx.x * tile_floats + tid * kAcc);
#pragma unroll
    for (int j = 0; j < kAcc; j += 4)
      mine[j / 4] = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    named_barrier(1, 128);
    if (tid == 0) {
      __threadfence();                      // the CTA's partial before its count
      *last_cta = atomicAdd(&counters[tile], 1) == split - 1;
    }
    named_barrier(1, 128);
    if (!*last_cta) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    // the slices in the fixed order 0 .. split-1, loaded kBatch at a time so
    // that their L2 round trips overlap
    constexpr int kBatch = 16;
    const float* base = partials + (size_t)tile * split * tile_floats + tid * kAcc;
    for (int s0 = 0; s0 < split; s0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kAcc; j += 4) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (s0 + b < split)
            v[b] = __ldcg(reinterpret_cast<const float4*>(base + (s0 + b) * tile_floats + j));
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (s0 + b < split) {
            acc[j] += v[b].x; acc[j + 1] += v[b].y; acc[j + 2] += v[b].z; acc[j + 3] += v[b].w;
          }
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

  // round once into shared memory (MP x 64 bf16, the ring's first stage:
  // every load has landed and been read), then 16-byte rows of out
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int n = 16 * (tid / 32) + lane / 4 + 8 * ((j / 2) % 2);
    const int m = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    o[m * kDecBN + n] = __float2bfloat16_rn(acc[j]);
  }
  named_barrier(1, 128);
  for (int c = tid; c < MP * (kDecBN / 8); c += 128) {
    const int m = c / (kDecBN / 8), nc = (c % (kDecBN / 8)) * 8;
    if (m < M && n0 + nc < N)
      *reinterpret_cast<uint4*>(out + (size_t)m * N + n0 + nc) =
          *reinterpret_cast<const uint4*>(o + m * kDecBN + nc);
  }
}

// ---------------------------------------------------------------- wgmma route
//
// Three operand layouts, all out(M, N) = op(a) . op(b) summed over K, each
// operand read in place from HBM by TMA (no transpose, no copy):
//   nn, the forward:          a = x  (M x K, K-major),  b = w  (K x N, N-major)
//   nt, dX = dY w^T:          a = dY (M x K, K-major),  b = w  (N x K, K-major)
//   tn, dW = x^T dY:          a = x  (K x M, M-major),  b = dY (K x N, N-major)
// An MN-major operand is read with wgmma's transpose bit from 64-column,
// 128-byte swizzled boxes (b of nn and tn, a of tn: two boxes of 64 rows, one
// per consumer); a K-major one from boxes of 64 K values a row (a of nn and
// nt, b of nt), the bit off.  The backward's reduction runs over the M rows
// of x and dY, which are the TMA maps' outer dimension, so its ragged end is
// TMA's zero fill and no row count is padded.
//
// Split reduction: where the output tiles leave SMs idle, the K blocks of
// split_tiles tiles are cut into `split` slices, one work unit a (tile,
// slice); each unit writes its fp32 partial to a workspace and bumps its
// tile's counter, and the unit that arrives last sums the slices in the
// fixed order 0 .. split-1, rounds once and stores the tile, then sets the
// counter back to 0.  No float atomics: two launches give the same bits;
// nothing waits on another CTA, so no residency can deadlock.  The
// backward (nt, tn; the wrapper's split_k) splits every tile when they are
// at most half a wave.  The forward (nn; the wrapper's Schedule, a
// stream-K schedule whose shares are whole-tile k-slices) sends whole tiles
// in full waves, one a CTA, and splits the tiles of a ragged last wave (or
// of less than one wave), so every SM works to the end of the launch.
// Units are numbered slices first (slice-major), then the whole tiles; CTA
// b takes units b, b + gridDim.x, ...

constexpr int kLayoutNN = 0, kLayoutNT = 1, kLayoutTN = 2;
constexpr int kWgBM = 128;                 // two consumer warpgroups of 64 rows
constexpr int kWgBK = 64;                  // one 128-byte swizzled row of bf16
constexpr int kWgThreads = 384;            // producer warpgroup + 2 consumers
constexpr int kXTileBytes = kWgBM * kWgBK * 2;
constexpr int kWBoxBytes = kWgBK * 64 * 2;  // one 64 x 64 box of an operand tile
constexpr int kOutBoxBytes = 64 * 64 * 2;   // one 64 x 64 box of the output
constexpr int kStagingBytes = 2 * kOutBoxBytes;  // per consumer: 64 rows x 128 columns

template <int BN>
__host__ __device__ constexpr int wgmma_stage_bytes() { return kXTileBytes + (BN / 64) * kWBoxBytes; }

// the ring and its barriers, the staging boxes and the split's flag
template <int BN>
size_t wgmma_smem_bytes(int stages) {
  return 1024 + (size_t)stages * (wgmma_stage_bytes<BN>() + 2 * sizeof(uint64_t)) +
         2 * kStagingBytes + 16;
}

// One thread's count of a split tile, at GPU scope: a release of every write
// ordered before it (the CTA barrier before it orders its threads' partial
// stores) and an acquire of the writes released by the earlier counts, in
// place of a sequentially consistent fence in every thread.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// acc (+)= one fp32 partial, as the unit's threads wrote it: 16 bytes a
// thread side by side, read through L2 (another CTA wrote it)
template <bool ADD, int N>
__device__ __forceinline__ void add_partial(float (&acc)[N], const float* p) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p + 128 * j));
    if (ADD) {
      acc[j] += v.x; acc[j + 1] += v.y; acc[j + 2] += v.z; acc[j + 3] += v.w;
    } else {
      acc[j] = v.x; acc[j + 1] = v.y; acc[j + 2] = v.z; acc[j + 3] = v.w;
    }
  }
}

// acc = (acc + p) + q, elementwise in that order, with both partials' loads
// in flight at once (one L2 round trip for two partials; 128-wide tiles,
// whose 64 accumulators leave room for 128 more)
template <int N>
__device__ __forceinline__ void add_two_partials(float (&acc)[N], const float* p, const float* q) {
  float4 v[N / 4], w[N / 4];
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    v[j / 4] = __ldcg(reinterpret_cast<const float4*>(p + 128 * j));
    w[j / 4] = __ldcg(reinterpret_cast<const float4*>(q + 128 * j));
  }
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    acc[j] = (acc[j] + v[j / 4].x) + w[j / 4].x;
    acc[j + 1] = (acc[j + 1] + v[j / 4].y) + w[j / 4].y;
    acc[j + 2] = (acc[j + 2] + v[j / 4].z) + w[j / 4].z;
    acc[j + 3] = (acc[j + 3] + v[j / 4].w) + w[j / 4].w;
  }
}

// One work unit: k-blocks [kb0, kb1) of output tile `tile`; `slot`, its
// number, the workspace slot of its partial where the tile is split.
struct WgUnit {
  int tile, kb0, kb1, slot;
};

// The units of a launch (see above): the first split_tiles tiles' `split`
// k-slices, slice-major, then the other tiles whole, each as one unit.  The
// wrapper's Schedule.unit is the same arithmetic.
struct Walk {
  int n_tiles, n_k, split_tiles, split;
  __device__ bool unit(int i, WgUnit& u) const {
    const int v = blockIdx.x + i * gridDim.x;
    if (v >= split_tiles * split + n_tiles - split_tiles) return false;
    if (v < split_tiles * split) {
      const int slice = v / split_tiles;
      u = {v % split_tiles, (int)((long long)slice * n_k / split),
           (int)((long long)(slice + 1) * n_k / split), v};
    } else {
      u = {v - split_tiles * (split - 1), 0, n_k, -1};
    }
    return true;
  }
  __device__ bool partial(const WgUnit& u) const { return split > 1 && u.slot >= 0; }
};

// Stage s of the ring: the a tile (128 M rows x 64 K values, 16 KB), then
// BN / 64 boxes of the b tile (64 x 64 each).  Each consumer's output staging
// (two 64 x 64 boxes, 128-byte swizzled) and the barriers follow the ring.
// The grid is persistent: each CTA walks its list of work units (the Walk:
// producer and consumers walk the same one), and the ring runs on
// across them, so the producer fills the next unit's stages while the
// consumers store the last one, and the consumers go on while TMA writes
// their staged output.  Tiles are numbered M-tile fastest, so the CTAs
// working at one time share their b tiles and each is read from HBM about
// once.  split and split_tiles give the units; SPLIT: some tile is split.  A
// product with no tile split launches the instantiation without the fixup
// code (PERF.md: a fixup compiled in once slowed every k-block of the
// forward, and the backward's fixup changed with the forward's split).
template <int BN, int LAYOUT, bool SPLIT>
__global__ void __launch_bounds__(kWgThreads, 1)
ltrf_matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tout, float* __restrict__ partials,
                  int* __restrict__ counters, int M, int K, int N, int split, int split_tiles,
                  int stages) {
  constexpr int kStage = wgmma_stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem + (size_t)stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kStagingBytes);
  uint64_t* empty = full + stages;
  int* last_unit = reinterpret_cast<int*>(empty + stages);

  const int wg = threadIdx.x / 128;
  const int m_tiles = (M + kWgBM - 1) / kWgBM;
  const int n_tiles = m_tiles * ((N + BN - 1) / BN);
  const int n_k = (K + kWgBK - 1) / kWgBK;
  const Walk walk{n_tiles, n_k, split_tiles, split};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: the it-th k-stage of this CTA goes to slot it % stages once
    // both consumers have released that slot's previous stage
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      WgUnit u;
      for (int i = 0; walk.unit(i, u); ++i) {
        const int m0 = (u.tile % m_tiles) * kWgBM;
        const int n0 = (u.tile / m_tiles) * BN;
        for (int kt = u.kb0; kt < u.kb1; ++kt, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) + 1) & 1);
          unsigned char* st = smem + (size_t)s * kStage;
          mbar_expect_tx(&full[s], kStage);
          if constexpr (LAYOUT == kLayoutTN) {
            tma_load_2d(st, &ta, &full[s], m0, kt * kWgBK);
            tma_load_2d(st + kXTileBytes / 2, &ta, &full[s], m0 + 64, kt * kWgBK);
          } else {
            tma_load_2d(st, &ta, &full[s], kt * kWgBK, m0);
          }
#pragma unroll
          for (int b = 0; b < BN / 64; ++b) {
            if constexpr (LAYOUT == kLayoutNT)
              tma_load_2d(st + kXTileBytes + b * kWBoxBytes, &tb, &full[s], kt * kWgBK,
                          n0 + b * 64);
            else
              tma_load_2d(st + kXTileBytes + b * kWBoxBytes, &tb, &full[s], n0 + b * 64,
                          kt * kWgBK);
          }
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;                  // this consumer's rows: 64 c .. 64 c + 63
    const int wtid = threadIdx.x % 128;
    unsigned char* stage_out = staging + c * kStagingBytes;
    float acc[BN / 2];
    int it = 0;
    WgUnit u;
    for (int i = 0; walk.unit(i, u); ++i) {
      const int m0 = (u.tile % m_tiles) * kWgBM;
      const int n0 = (u.tile / m_tiles) * BN;
      const int kb0 = u.kb0;
      for (int kt = kb0; kt < u.kb1; ++kt, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t xa = smem_u32(smem + (size_t)s * kStage) + c * 64 * 128;
        const uint32_t wb = smem_u32(smem + (size_t)s * kStage + kXTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {   // the unit's first product overwrites
          const uint64_t da = LAYOUT == kLayoutTN ? desc_mnmajor(xa, kWgBK, 128, kk)
                                                  : desc_kmajor(xa, kWgBM, 128, kk);
          const uint64_t db = LAYOUT == kLayoutNT ? desc_kmajor(wb, BN, 128, kk)
                                                  : desc_mnmajor(wb, kWgBK, 128, kk);
          wgmma_ss<BN, LAYOUT != kLayoutNT, LAYOUT == kLayoutTN>(acc, da, db,
                                                                 kt > kb0 || kk > 0);
        }
        wgmma_commit();
        // keep this stage's products in flight; the previous stage's are
        // done, so its slot goes back to the producer
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > kb0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);

      if (SPLIT && walk.partial(u)) {
        // this unit's fp32 partial, 16 bytes a thread side by side (a warp's
        // stores cover 512 contiguous bytes), then the tile's count
        const size_t rows = (size_t)kWgBM * BN, part = (size_t)c * 64 * BN + 4 * wtid;
        float* mine = partials + (size_t)u.slot * rows + part;
#pragma unroll
        for (int j = 0; j < BN / 2; j += 4)
          *reinterpret_cast<float4*>(mine + 128 * j) =
              make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        // the count releases the partial (the barrier orders every
        // thread's stores before it) and, for the tile's last unit, acquires
        // the others' (the barrier orders the loads below after it)
        named_barrier(3, 256);
        if (threadIdx.x == 128)
          *last_unit = atom_add_acq_rel(&counters[u.tile], 1) == split - 1;
        named_barrier(3, 256);
        if (!*last_unit) continue;
        // the slices in the fixed order 0 .. split-1 (units tile + j *
        // split_tiles), from slice 0's partial (held in acc already where this
        // unit is slice 0: the same values)
        auto at = [&](int j) {
          return partials + (size_t)(u.tile + j * split_tiles) * rows + part;
        };
        if (u.slot != u.tile) add_partial<false>(acc, at(0));
        int j = 1;
        if constexpr (BN == 128)
          for (; j + 1 < split; j += 2) add_two_partials(acc, at(j), at(j + 1));
        for (; j < split; ++j) add_partial<true>(acc, at(j));
        if (threadIdx.x == 128) counters[u.tile] = 0;
      }

      // epilogue, 128 columns at a time: round into the staging boxes (as
      // TMA swizzles them, so the writes miss no bank), then one thread
      // stores them with TMA, which clips rows past M and columns past N
      const int row = (wtid / 32) * 16 + (wtid % 32) / 4;   // + 8 for odd j / 2
#pragma unroll
      for (int half = 0; half < BN / 128; ++half) {
        if (wtid == 0) bulk_wait_read<0>();                 // the last store has read it
        named_barrier(1 + c, 128);
#pragma unroll
        for (int jj = 0; jj < 64; jj += 2) {
          const int j = 64 * half + jj;
          const int r = row + 8 * ((j / 2) % 2);
          const int col = 8 * (jj / 4) + 2 * (wtid % 4);    // within the 128 columns
          const uint32_t off = (col / 64) * kOutBoxBytes + swizzle(r * 128 + (col % 64) * 2, 128);
          *reinterpret_cast<uint32_t*>(stage_out + off) = pack_bf16(acc[j], acc[j + 1]);
        }
        fence_proxy_async();
        named_barrier(1 + c, 128);
        if (wtid == 0) {
          tma_store_2d(&tout, stage_out, n0 + 128 * half, m0 + 64 * c);
          tma_store_2d(&tout, stage_out + kOutBoxBytes, n0 + 128 * half + 64, m0 + 64 * c);
          bulk_commit();
        }
      }
    }
    if (wtid == 0) bulk_wait<0>();
  }
}

// The product's M, K, N; a and b as the layout lays them out (see above).
template <int BN, int LAYOUT, bool SPLIT>
cudaError_t launch_wgmma(const void* a, const void* b, void* out, void* partials, void* counters,
                         int M, int K, int N, int split, int split_tiles, int stages,
                         cudaStream_t stream) {
  constexpr bool kTransA = LAYOUT == kLayoutTN, kKMajorB = LAYOUT == kLayoutNT;
  CUtensorMap ta, tb, tout;
  // a: M x K K-major (rows of K values) or, for tn, K x M (rows of M values)
  const cuuint64_t a_dims[2] = {(cuuint64_t)(kTransA ? M : K), (cuuint64_t)(kTransA ? K : M)};
  const cuuint64_t a_strides[1] = {(cuuint64_t)(kTransA ? M : K) * 2};
  const cuuint32_t a_box[2] = {kWgBK, kTransA ? 64u : (cuuint32_t)kWgBM};
  // b: K x N (rows of N values) or, for nt, N x K (rows of K values)
  const cuuint64_t b_dims[2] = {(cuuint64_t)(kKMajorB ? K : N), (cuuint64_t)(kKMajorB ? N : K)};
  const cuuint64_t b_strides[1] = {(cuuint64_t)(kKMajorB ? K : N) * 2};
  const cuuint32_t b_box[2] = {64, kWgBK};
  const cuuint64_t out_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t out_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t out_box[2] = {64, 64};
  if (!make_tmap(&ta, a, 2, a_dims, a_strides, a_box, 128) ||
      !make_tmap(&tb, b, 2, b_dims, b_strides, b_box, 128) ||
      !make_tmap(&tout, out, 2, out_dims, out_strides, out_box, 128))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<BN>(stages);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<ltrf_matmul_wgmma<BN, LAYOUT, SPLIT>>();
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + BN - 1) / BN);
  const int units = split_tiles * split + tiles - split_tiles;
  const int grid = units < num_sms() ? units : num_sms();
  ltrf_matmul_wgmma<BN, LAYOUT, SPLIT><<<grid, kWgThreads, smem, stream>>>(
      ta, tb, tout, static_cast<float*>(partials), static_cast<int*>(counters), M, K, N, split,
      split_tiles, stages);
  return cudaGetLastError();
}

// nt and tn split all their tiles (or none); nn its first split_tiles (or
// none).  An unsplit product launches the instantiation without the fixup.
template <int BN, int LAYOUT>
cudaError_t launch_wgmma_split(const void* a, const void* b, void* out, void* partials,
                               void* counters, int M, int K, int N, int split, int split_tiles,
                               int stages, cudaStream_t s) {
  if (split > 1)
    return launch_wgmma<BN, LAYOUT, true>(a, b, out, partials, counters, M, K, N, split,
                                          split_tiles, stages, s);
  return launch_wgmma<BN, LAYOUT, false>(a, b, out, partials, counters, M, K, N, 1, 0, stages, s);
}

template <int BN>
cudaError_t launch_wgmma_layout(int layout, const void* a, const void* b, void* out,
                                void* partials, void* counters, int M, int K, int N, int split,
                                int split_tiles, int stages, cudaStream_t s) {
  const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + BN - 1) / BN);
  if (layout == kLayoutNT)
    return launch_wgmma_split<BN, kLayoutNT>(a, b, out, partials, counters, M, K, N, split, tiles,
                                             stages, s);
  if (layout == kLayoutTN)
    return launch_wgmma_split<BN, kLayoutTN>(a, b, out, partials, counters, M, K, N, split, tiles,
                                             stages, s);
  return launch_wgmma_split<BN, kLayoutNN>(a, b, out, partials, counters, M, K, N, split,
                                           split_tiles, stages, s);
}

template <int MP>
cudaError_t launch_decode(const void* x, const void* w, void* out, void* partials, void* counters,
                          int M, int K, int N, int split, int stages, cudaStream_t stream) {
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kDecBK, MP};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {kDecBN, kDecBK};
  if (!make_tmap(&tx, x, 2, x_dims, x_strides, x_box, 64) ||
      !make_tmap(&tw, w, 2, w_dims, w_strides, w_box, 128))
    return cudaErrorInvalidValue;
  const size_t smem = dec_smem_bytes<MP>(stages, split);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<ltrf_matmul_decode<MP>>();
  if (err != cudaSuccess) return err;
  const int tiles = (N + kDecBN - 1) / kDecBN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split > 1 && split <= kDecMaxCluster ? split : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* p = static_cast<float*>(partials);
  int* c = static_cast<int*>(counters);
  void* args[] = {&tx, &tw, &o, &p, &c, &M, &K, &N, &split, &stages};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(ltrf_matmul_decode<MP>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (bm, bk, bn) must be one of the tile
// shapes pick_blocks returns; anything else is refused before launch.
// layout: 0 = nn (out = x . w), 1 = nt (out = a . b^T), 2 = tn (out = a^T . b),
// with M, K, N the product's and each operand row-major as it lies; nt and
// tn only on the wgmma tiles.  split: the decode route (bf16, bk = 32, bn =
// 64) takes 1 .. the number of 32-row K blocks and, when split > 8, an fp32
// workspace of ceil(N / 64) * split * 64 * bm floats; the wgmma route's nt
// and tn take 1 .. the number of 64-row K blocks and, when split > 1, a
// workspace of tiles * split * 128 * bn floats.  Both take ceil(N / 64) (or
// tiles) int counters that are 0 (and are 0 again when the launch ends).
// The wgmma route's nn takes split 1 (whole tiles), or split > 1 with the
// number of tiles split, split_tiles (the wrapper's Schedule), a workspace of
// split_tiles * split * 128 * bn floats and split_tiles zeroed counters.  Other
// routes take split = 1; only nn reads split_tiles.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ltrf_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N,
                                  int dtype, int bm, int bk, int bn, int stages, int split,
                                  void* partials, void* counters, int layout, int split_tiles,
                                  void* stream) {
  if (stages < 2 || M <= 0 || K <= 0 || N <= 0 || split < 1 || layout < kLayoutNN ||
      layout > kLayoutTN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wgmma_tiles = dtype == 1 && bm == kWgBM && bk == kWgBK && (bn == 128 || bn == 256);
  if (layout != kLayoutNN && !wgmma_tiles) return cudaErrorInvalidValue;
  if (dtype == 1 && bk == kDecBK && bn == kDecBN) {
    if (stages > kDecMaxStages || M > bm || split > (K + kDecBK - 1) / kDecBK ||
        (split > kDecMaxCluster && (!partials || !counters)))
      return cudaErrorInvalidValue;
    switch (bm) {
      case 8: return launch_decode<8>(x, w, out, partials, counters, M, K, N, split, stages, s);
      case 16: return launch_decode<16>(x, w, out, partials, counters, M, K, N, split, stages, s);
      case 32: return launch_decode<32>(x, w, out, partials, counters, M, K, N, split, stages, s);
      case 64: return launch_decode<64>(x, w, out, partials, counters, M, K, N, split, stages, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (stages > kMaxStages) return cudaErrorInvalidValue;
  if (wgmma_tiles) {
    // a split needs its workspace; a split forward names its split tiles
    const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + bn - 1) / bn);
    if (split > (K + kWgBK - 1) / kWgBK || (split > 1 && (!partials || !counters)) ||
        (layout == kLayoutNN && split > 1 && (split_tiles < 1 || split_tiles > tiles)))
      return cudaErrorInvalidValue;
    return bn == 128 ? launch_wgmma_layout<128>(layout, x, w, out, partials, counters, M, K, N,
                                                split, split_tiles, stages, s)
                     : launch_wgmma_layout<256>(layout, x, w, out, partials, counters, M, K, N,
                                                split, split_tiles, stages, s);
  }
  if (split != 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (bm == 128 && bk == 32 && bn == 128)
      return launch<float, 128, 128, 32, 2, 4>(x, w, out, M, K, N, stages, s);
    if (bk == 64 && bn == 32)
      return launch_fp32_narrow(x, w, out, M, K, N, bm, stages, s);
  }
  return cudaErrorInvalidValue;
}
