// Fused log-mel frontend: frame + windowed DFT + power + mel + log.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/frontend.py::_fe_kernel
// (reached from fbank_pallas, ops.frontend._log_mel_fbank_batch).
//
// Computes, per signal row b and frame t, from the reflect-padded signal:
//   frame  = yp[b, t*hop : t*hop + n_fft]
//   spec   = frame @ W           W [n_fft, 2*n_bins]: the Hann window folded
//                                into the real-DFT basis (cos | -sin)
//   power  = re^2 + im^2         [n_bins]
//   out[b, t] = log(power @ mel + eps)          mel [n_bins, n_mels]
//
// The TPU kernel feeds k hop-shifted copies of the signal and a zero-padded
// basis because its compiler cannot concatenate shifted slices. Here a block
// takes a tile of kTile frames of one row, copies the contiguous span of
// (kTile-1)*hop + n_fft samples into shared memory ONCE and reads frame t at
// offset t*hop: no frame matrix and no copies exist anywhere. The spectrum
// lives in registers, the power tile in shared memory; only [kTile, n_mels]
// is written.
//
// What bounds it on an H100: operations. At sr 22050 (n_fft 551, 276 bins) a
// frame costs 2*551*552 + 2*276*40 = 630 kFLOP against 880 bytes of signal
// and 160 bytes of output; the float32 FMA peak (67 TFLOP/s) binds long before
// the memory does. The DFT product is a register-tiled float32 FMA product:
// a thread owns kFR frames x 4 spectrum columns (32 accumulators); per k it
// reads one float4 of the basis (coalesced over the warp, streamed from L2,
// where the 1.2 MB basis stays resident) and kFR samples from shared memory
// (one address per warp: a broadcast), 32 FMAs for 9 loads. The basis arrives
// with the cos and -sin columns of a bin interleaved (col 2j, 2j+1), so a
// thread holds re and im of two bins and squares them in registers. The mel
// product (3 % of the operations) reads mel through the read-only cache.
// The faster design puts the DFT on the tensor cores (wgmma on 3xTF32 or
// split-bf16 operands, the basis by TMA).

#include "common.cuh"

namespace {

constexpr int kTile = 32;        // frames per block
constexpr int kFR = 8;           // frames per thread
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
fbank_kernel(const float* __restrict__ yp,    // [B, Np]
             const float4* __restrict__ wil,  // [n_fft, ncols / 4] interleaved
             const float* __restrict__ mel,   // [n_bins, n_mels]
             float* __restrict__ out,         // [B, nf, n_mels]
             int Np, int nf, int n_fft, int hop, int n_bins, int ncols,
             int n_mels, float log_eps) {
  extern __shared__ float smem[];
  const int span = (kTile - 1) * hop + n_fft;
  float* sig = smem;                     // [span] samples of this tile
  float* pw = smem + ((span + 3) & ~3);  // [kTile][n_bins] power

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const float* row = yp + (size_t)b * Np;
  const int s0 = f0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int s = s0 + i;
    sig[i] = s < Np ? row[s] : 0.f;  // the last tile's frames past nf read zeros
  }
  __syncthreads();

  // DFT product and power: one item = kFR frames x 4 columns (2 bins)
  const int ngroups = ncols / 4;
  const int nitems = ngroups * (kTile / kFR);
  for (int item = threadIdx.x; item < nitems; item += blockDim.x) {
    const int g = item % ngroups;
    const int fg = item / ngroups;
    const float* x = sig + fg * kFR * hop;
    const float4* w = wil + g;
    float acc[kFR][4];
#pragma unroll
    for (int r = 0; r < kFR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n_fft; ++k) {
      const float4 wv = __ldg(w + (size_t)k * ngroups);
#pragma unroll
      for (int r = 0; r < kFR; ++r) {
        const float xv = x[r * hop + k];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
      }
    }
    const int j = 2 * g;
#pragma unroll
    for (int r = 0; r < kFR; ++r) {
      float* p = pw + (fg * kFR + r) * n_bins;
      if (j < n_bins) p[j] = acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1];
      if (j + 1 < n_bins) p[j + 1] = acc[r][2] * acc[r][2] + acc[r][3] * acc[r][3];
    }
  }
  __syncthreads();

  // mel product and log
  for (int o = threadIdx.x; o < kTile * n_mels; o += blockDim.x) {
    const int f = o / n_mels;
    const int m = o % n_mels;
    if (f0 + f >= nf) continue;
    const float* p = pw + f * n_bins;
    float s = 0.f;
#pragma unroll 4
    for (int jb = 0; jb < n_bins; ++jb) s = fmaf(p[jb], __ldg(mel + jb * n_mels + m), s);
    out[((size_t)b * nf + f0 + f) * n_mels + m] = logf(s + log_eps);
  }
}

}  // namespace

// yp [B, Np] must hold (nf-1)*hop + n_fft samples per row; wil is the basis
// with interleaved (cos, -sin) columns, zero-padded to ncols (a multiple of 4).
extern "C" int ss_fbank(const float* yp, const float* wil, const float* mel, float* out,
                        int B, int Np, int nf, int n_fft, int hop, int n_bins, int ncols,
                        int n_mels, float log_eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ncols % 4 != 0 || ncols < 2 * n_bins) return static_cast<int>(cudaErrorInvalidValue);
  const int span = (kTile - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (((span + 3) & ~3) + (size_t)kTile * n_bins);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as few threads as cover the items in the same number of rounds
  const int nitems = (ncols / 4) * (kTile / kFR);
  const int rounds = (nitems + kMaxThreads - 1) / kMaxThreads;
  const int threads = (((nitems + rounds - 1) / rounds) + 31) / 32 * 32;
  const dim3 grid((nf + kTile - 1) / kTile, B);
  fbank_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      yp, reinterpret_cast<const float4*>(wil), mel, out, Np, nf, n_fft, hop, n_bins, ncols,
      n_mels, log_eps);
  return static_cast<int>(cudaGetLastError());
}
