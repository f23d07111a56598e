// Blocked causal GQA attention with online softmax for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_kernel
// (the Pallas TPU kernel, body _flash_kernel).  Same function: scale 1/sqrt(d),
// masked logits set to -1e30, running max / sum and an fp32 accumulator per
// query row, output acc / max(l, 1e-30) in the input type.  Query head h reads
// KV head h / (H / KV), i.e. flattened row bh reads KV row bh / group, as the
// reference's index map does.
//
// What bounds it on an H100: at the prefill shapes of the serving model
// (S = 1024, d = 64) the work is ~4 * S^2 / 2 * d flops per head against one
// pass over Q, K, V and O, so with tensor cores it would be bound by
// operations.  This first version computes in fp32 on the CUDA cores (67
// TFLOP/s peak), so the CUDA-core rate and shared-memory traffic bound it.
//
// What the design does about it: one CTA (128 threads) owns a 64-row query
// block and loops over 64-row KV blocks, so the (S x S) logits never reach
// HBM: HBM traffic is one pass over Q, K, V and one write of O.  K/V tiles are
// held in shared memory as fp32; each thread computes a 4 x 8 register block
// of logits and a 4 x (d / 8) block of the output, so each shared-memory load
// feeds several FMAs.  Tiles entirely above the causal diagonal are skipped
// (they contribute exactly 0), and the ragged S edge is masked here, so S need
// not be a multiple of the block.  Tensor cores (mma / wgmma), TMA and a
// double-buffered K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory per block
constexpr int kMaxDevices = 64;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// q: (BH, S, D); k, v: (BH / group, S, D); o: (BH, S, D); all contiguous.
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4*ty .. 4*ty+3 of the
// block; for logits it owns KV columns tx + 8*j, for the output dims tx + 8*j.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int group, int causal, float scale) {
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
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)(bh / group) * S * D;
  const T* vb = v + (size_t)(bh / group) * S * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] = (q0 + r < S) ? to_float(qb[(size_t)(q0 + r) * D + c]) : 0.f;
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
      ks[r * LD + c] = ok ? to_float(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * D + c] = ok ? to_float(vb[(size_t)(k0 + r) * D + c]) : 0.f;
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

  T* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + (size_t)qp * D + tx + 8 * j, acc[i][j] / denom);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int group, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = allow_smem<flash_attention_kernel<T, D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), S,
                                           group, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                     int group, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, group, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, group, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, group, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, group, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim D in {16, 32, 64, 128}.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int D, int group, int causal, int dtype,
                                      float scale, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, BH, S, D, group, causal, scale, s);
  if (dtype == 0) return launch_d<float>(q, k, v, o, BH, S, D, group, causal, scale, s);
  return cudaErrorInvalidValue;
}
