// The latency on the card of each kind of dependent step the batch
// simulator's kernel (src/repro_torch/csrc/sim_batch.cu) chains in a tick:
// one warp, one CTA, each step's input the previous step's output, timed
// with clock64 over a chain of N steps.  Built and run by
// experiments/sim_kernel_phases.py (nvcc -arch=sm_90a -shared).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 4096;
enum { S_LDS64, S_REDUX, S_SHFL, S_BALLOT, S_MATCH, S_SYNCWARP, S_DADD, S_DDIV, S_D2L,
       S_CLOCK, NSTEPS };

__global__ void chains(long long* cycles, long long* sink) {
  __shared__ long long ring[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) ring[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  const unsigned full = 0xffffffffu;
  long long acc = 0;
  long long t0, t1;
  // a shared-memory load whose address is the previous load's value
  long long p = threadIdx.x;
  t0 = clock64();
  for (int i = 0; i < N; ++i) p = ring[p];
  t1 = clock64();
  cycles[S_LDS64] = t1 - t0;
  acc += p;
  // __reduce_min_sync on the previous result
  unsigned u = threadIdx.x + static_cast<unsigned>(p);
  t0 = clock64();
  for (int i = 0; i < N; ++i) u = __reduce_min_sync(full, u + threadIdx.x);
  t1 = clock64();
  cycles[S_REDUX] = t1 - t0;
  acc += u;
  // __shfl_sync from a lane the previous value names
  int v = threadIdx.x + static_cast<int>(u);
  t0 = clock64();
  for (int i = 0; i < N; ++i) v = __shfl_sync(full, v + 1, v & 31);
  t1 = clock64();
  cycles[S_SHFL] = t1 - t0;
  acc += v;
  // __ballot_sync of a predicate on the previous mask
  unsigned b = v;
  t0 = clock64();
  for (int i = 0; i < N; ++i) b = __ballot_sync(full, ((b >> threadIdx.x) & 1u) == 0u);
  t1 = clock64();
  cycles[S_BALLOT] = t1 - t0;
  acc += b;
  // __match_any_sync of the previous mask
  unsigned m = b;
  t0 = clock64();
  for (int i = 0; i < N; ++i) m = __match_any_sync(full, (m >> threadIdx.x) & 3u);
  t1 = clock64();
  cycles[S_MATCH] = t1 - t0;
  acc += m;
  // __syncwarp between dependent integer steps (less the steps alone: one add)
  unsigned w = m;
  t0 = clock64();
  for (int i = 0; i < N; ++i) {
    w = w * 3u + 1u;
    __syncwarp();
  }
  t1 = clock64();
  cycles[S_SYNCWARP] = t1 - t0;
  acc += w;
  // float64 add, division, and a float64 to int64 conversion
  double d = static_cast<double>(w & 7u) + 1.5;
  t0 = clock64();
  for (int i = 0; i < N; ++i) d = d + 0.25;
  t1 = clock64();
  cycles[S_DADD] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < N; ++i) d = d / 1.0000001 + 1.0;
  t1 = clock64();
  cycles[S_DDIV] = t1 - t0;
  long long q = static_cast<long long>(d);
  t0 = clock64();
  for (int i = 0; i < N; ++i) q = static_cast<long long>(static_cast<double>(q) * 0.5 + 3.0);
  t1 = clock64();
  cycles[S_D2L] = t1 - t0;
  acc += q;
  // clock64 itself
  long long c = 0;
  t0 = clock64();
  for (int i = 0; i < N; ++i) c += clock64();
  t1 = clock64();
  cycles[S_CLOCK] = t1 - t0;
  acc += c;
  if (threadIdx.x == 0) *sink = acc;
}

}  // namespace

// The cycles a step of each kind takes in a dependent chain (NSTEPS values,
// in the enum's order); 0 or a CUDA error.
extern "C" int step_latency(double* out) {
  long long *cycles, *sink;
  if (cudaMalloc(&cycles, NSTEPS * sizeof(long long)) != cudaSuccess) return 1;
  cudaMalloc(&sink, sizeof(long long));
  chains<<<1, 32>>>(cycles, sink);   // a warm-up, then the measured run
  chains<<<1, 32>>>(cycles, sink);
  long long host[NSTEPS];
  const cudaError_t err = cudaMemcpy(host, cycles, sizeof(host), cudaMemcpyDeviceToHost);
  cudaFree(cycles);
  cudaFree(sink);
  if (err != cudaSuccess) return err;
  for (int s = 0; s < NSTEPS; ++s) out[s] = static_cast<double>(host[s]) / N;
  return 0;
}
