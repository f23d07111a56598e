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
// on the current ones.  One CTA owns one output tile and streams its column
// of weight tiles through the ring, whose depth is the num_slots of the
// validated per-CTA IntervalPlan the wrapper builds (repro_torch/core/plan.py).
// Three routes, chosen by the wrapper from dtype and M:
//
// wgmma (bf16, M > 64; prefill).  A 128 x BN tile (BN = 128 or 256) over BK =
// 64 stages.  A producer warpgroup (registers handed to the consumers with
// setmaxnreg; one thread issues) keeps TMA loads of the x tile (K-major) and
// of the weight tile (N-major, as w lies in HBM: no transpose or copy) in
// flight, one full and one empty mbarrier per stage.  Two consumer
// warpgroups of 64 rows each run wgmma m64nBNk16 from shared memory (B with
// the transpose bit) into fp32 registers, keeping one k-stage of wgmma in
// flight.  The grid is persistent (one CTA an SM walks the output tiles), so
// the ring fills the next tile while the consumers finish this one; they
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
//
// decode (bf16, M <= 64) and fp32 (any M): a cp.async ring of padded tiles
// feeding mma.sync m16n8k16 (bf16) or FFMA in the same register layout (fp32:
// never TF32, which misses fp32 tolerances).  For decode one M-tile covers
// all rows, so each weight byte is read from HBM once per step; narrow
// 32-column tiles give more CTAs to stream weights.  Both are bound far from
// the card's limits; PERF.md has their times.

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

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Accumulator layout (the mma.sync m16n8 C fragment, used by both paths):
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
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MT][4];
        uint32_t b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const T* p = xt + (wm0 + i * 16 + g) * LDX + kk + 2 * t;
          a[i][0] = *reinterpret_cast<const uint32_t*>(p);
          a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDX);
          a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDX + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* q = wt + (kk + 2 * t) * LDW + wn0 + j * 8 + g;
          b[j][0] = pack2(q[0], q[LDW]);
          b[j][1] = pack2(q[8 * LDW], q[9 * LDW]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    } else {
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

// Decode tiles (M <= 64): one M-tile of BM rows, 4 warps side by side in N.
template <typename T, int BK>
cudaError_t launch_decode(const void* x, const void* w, void* out, int M, int K, int N,
                          int bm, int stages, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch<T, 16, 32, BK, 1, 4>(x, w, out, M, K, N, stages, stream);
    case 32: return launch<T, 32, 32, BK, 1, 4>(x, w, out, M, K, N, stages, stream);
    case 64: return launch<T, 64, 32, BK, 1, 4>(x, w, out, M, K, N, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- wgmma route

constexpr int kWgBM = 128;                 // two consumer warpgroups of 64 rows
constexpr int kWgBK = 64;                  // one 128-byte swizzled row of bf16
constexpr int kWgThreads = 384;            // producer warpgroup + 2 consumers
constexpr int kXTileBytes = kWgBM * kWgBK * 2;
constexpr int kWBoxBytes = kWgBK * 64 * 2;  // one 64-column box of the weight tile
constexpr int kOutBoxBytes = 64 * 64 * 2;   // one 64 x 64 box of the output
constexpr int kStagingBytes = 2 * kOutBoxBytes;  // per consumer: 64 rows x 128 columns

template <int BN>
__host__ __device__ constexpr int wgmma_stage_bytes() { return kXTileBytes + (BN / 64) * kWBoxBytes; }

template <int BN>
size_t wgmma_smem_bytes(int stages) {
  return 1024 + (size_t)stages * (wgmma_stage_bytes<BN>() + 2 * sizeof(uint64_t)) +
         2 * kStagingBytes;
}

// Stage s of the ring: the x tile (128 rows x 128 B, K-major), then BN / 64
// weight boxes (64 K rows x 128 B of N each, N-major).  Each consumer's
// output staging (two 64 x 64 boxes, 128-byte swizzled) and the barriers
// follow the ring.  The grid is persistent: CTA b takes output tiles b,
// b + gridDim.x, ..., and the ring runs on across them, so the producer
// fills the next tile's stages while the consumers store the last one, and
// the consumers go on while TMA writes their staged output.  Tiles are
// numbered M-tile fastest, so the CTAs working at one time share their
// weight tiles and each is read from HBM about once.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ltrf_matmul_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tout, int M, int K, int N, int stages) {
  constexpr int kStage = wgmma_stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem + (size_t)stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kStagingBytes);
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x / 128;
  const int m_tiles = (M + kWgBM - 1) / kWgBM;
  const int n_tiles = m_tiles * ((N + BN - 1) / BN);
  const int n_k = (K + kWgBK - 1) / kWgBK;

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
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * kWgBM;
        const int n0 = (tile / m_tiles) * BN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) + 1) & 1);
          unsigned char* st = smem + (size_t)s * kStage;
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(st, &tx, &full[s], kt * kWgBK, m0);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(st + kXTileBytes + b * kWBoxBytes, &tw, &full[s], n0 + b * 64,
                        kt * kWgBK);
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
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kWgBM;
      const int n0 = (tile / m_tiles) * BN;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t xa = smem_u32(smem + (size_t)s * kStage) + c * 64 * 128;
        const uint32_t wb = smem_u32(smem + (size_t)s * kStage + kXTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)   // the tile's first product overwrites
          wgmma_ss<BN, 1>(acc, desc_kmajor(xa, kWgBM, 128, kk),
                          desc_mnmajor(wb, kWgBK, 128, kk), kt > 0 || kk > 0);
        wgmma_commit();
        // keep this stage's products in flight; the previous stage's are
        // done, so its slot goes back to the producer
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);

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

// Streaming multiprocessors of the current device, read once per device.
int num_sms() {
  static int cached[kMaxDevices] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cached[dev]) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int M, int K, int N,
                         int stages, cudaStream_t stream) {
  CUtensorMap tx, tw, tout;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kWgBK, kWgBM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {64, kWgBK};
  const cuuint64_t out_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t out_box[2] = {64, 64};
  if (!make_tmap(&tx, x, 2, x_dims, x_strides, x_box, 128) ||
      !make_tmap(&tw, w, 2, w_dims, w_strides, w_box, 128) ||
      !make_tmap(&tout, out, 2, out_dims, w_strides, out_box, 128))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<BN>(stages);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<ltrf_matmul_wgmma<BN>>();
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + BN - 1) / BN);
  ltrf_matmul_wgmma<BN><<<tiles < num_sms() ? tiles : num_sms(), kWgThreads, smem, stream>>>(
      tx, tw, tout, M, K, N, stages);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (bm, bk, bn) must be one of the tile
// shapes pick_blocks returns; anything else is refused before launch.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ltrf_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N,
                                  int dtype, int bm, int bk, int bn, int stages, void* stream) {
  if (stages < 2 || stages > kMaxStages || M <= 0 || K <= 0 || N <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (bm == kWgBM && bk == kWgBK && bn == 128)
      return launch_wgmma<128>(x, w, out, M, K, N, stages, s);
    if (bm == kWgBM && bk == kWgBK && bn == 256)
      return launch_wgmma<256>(x, w, out, M, K, N, stages, s);
    if (bk == 128 && bn == 32)
      return launch_decode<__nv_bfloat16, 128>(x, w, out, M, K, N, bm, stages, s);
  } else if (dtype == 0) {
    if (bm == 128 && bk == 32 && bn == 128)
      return launch<float, 128, 128, 32, 2, 4>(x, w, out, M, K, N, stages, s);
    if (bk == 64 && bn == 32)
      return launch_decode<float, 64>(x, w, out, M, K, N, bm, stages, s);
  }
  return cudaErrorInvalidValue;
}
