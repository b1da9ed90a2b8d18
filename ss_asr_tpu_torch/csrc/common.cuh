// Shared device helpers for the ss_asr_tpu_torch kernels (float32 only).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ss {

constexpr unsigned kFullMask = 0xffffffffu;

// Sigmoid that never evaluates expf of a large positive argument.
__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.f) {
    return 1.f / (1.f + expf(-x));
  }
  const float e = expf(x);
  return e / (1.f + e);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Warp-wide argmax: the largest value, and among equal values the LOWEST
// index (jnp.argmax's tie rule). Lanes holding no candidate pass -INFINITY
// and a large index.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, o);
    const int oi = __shfl_xor_sync(kFullMask, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// 16 bytes global -> shared by cp.async; with ok false it writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n));
}

// 4 bytes global -> shared by cp.async (through L1); with ok false it writes
// a zero and reads nothing
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n));
}

// The cluster barrier in its two halves: the arrive releases this thread's
// writes (the remote ones too) to the cluster, the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// sigmoid without its branch (a warp's rows take both sides): one expf and
// one division; for x < 0 it gives e * (1 / (1 + e)), within an ulp of e / (1 + e).
__device__ __forceinline__ float sigmoid_sel(float x) {
  const float e = expf(-fabsf(x));
  const float r = 1.f / (1.f + e);
  return x >= 0.f ? r : e * r;
}

}  // namespace ss
