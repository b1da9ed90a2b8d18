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

}  // namespace ss
