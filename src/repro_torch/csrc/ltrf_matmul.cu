// LTRF-planned blocked matmul for Hopper (sm_90a): out(M,N) = x(M,K) @ w(K,N).
//
// Replaces: src/repro/kernels/ltrf_matmul/kernel.py, ltrf_matmul_kernel (the
// Pallas TPU kernel, body _ltrf_matmul_kernel).  Same function: fp32
// accumulation over K, one rounding to the output type at the end.
//
// What bounds it on an H100: in the serving decode step (M = 8 rows) every
// weight byte is used by 8 rows only, so the product is bound by the bytes
// streamed from HBM (3.35 TB/s): about 2 flops per weight byte, far below the
// ~295 flops/byte at which the bf16 tensor cores become the limit.  In a
// prefill (M = 2048) the same product is bound by tensor-core operations.
//
// What the design does about it: the weight matrix in HBM plays the paper's
// large, slow main register file and a ring of shared-memory stages plays the
// register-file cache.  One CTA owns one (BM x BN) output tile and streams its
// column of (BK x BN) weight tiles through `stages` ring slots filled with
// cp.async, `stages - 1` tiles ahead of the compute -- the paper's "prefetch
// the next interval's working set while other warps compute".  The ring depth
// is passed in at run time: the wrapper picks it (the stages that fit in half
// the shared memory) and launches with the num_slots of the per-CTA
// IntervalPlan built at that depth (repro_torch/core/plan.py).  For decode one M-tile covers all rows (BM >= M), so
// each weight byte is read from HBM once per step.  bf16 inputs go through
// mma.sync m16n8k16 with fp32 accumulators; fp32 inputs go through plain FFMA
// in the same register layout (not TF32, which misses fp32 tolerances).
// Ragged M/K/N edges are masked here with zero-filling copies, not padded on
// the host; rows of x and w must be 16-byte aligned (the wrapper checks).
// Simple and correct first: no TMA, wgmma or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
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
          b[j][0] = pack_bf16(q[0], q[LDW]);
          b[j][1] = pack_bf16(q[8 * LDW], q[9 * LDW]);
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

// Opt the kernel in to the largest dynamic shared memory a block may use, once
// per device; launches then ask for what they need.  (Setting it once keeps the
// launch path free of attribute calls, e.g. while a CUDA graph captures it.)
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
    if (bm == 128 && bk == 32 && bn == 128)
      return launch<__nv_bfloat16, 128, 128, 32, 2, 4>(x, w, out, M, K, N, stages, s);
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
