// Packed LSTM time loop (backward pass), both directions of a layer in one
// launch.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/lstm.py::_make_bwd_kernel
// (the backward of lstm_seq_pallas_vjp, reached from
// lstm_scan_pallas_trainable), forward and reverse; with both directions in
// one grid it also covers ss_asr_tpu/ops/pallas/bilstm.py::_bi_bwd_kernel.
//
// Computes, per direction d and batch row b, walking time opposite to the
// forward (t = T-1 .. 0 for a forward direction, 0 .. T-1 for a reversed
// one), from the forward's y and cs and the cotangent dy:
//   h_p, c_p = y, cs at the processing predecessor (t-1 forward, t+1
//     reversed; zero at the sequence edge)
//   gates = gx[d, t, b] + h_p @ W_hh[d]                (recomputed)
//   dh = dh_carry + dy[t];  dct = dh * o * (1 - tanh(c_t)^2) + dc_carry
//   dgates = (dct g i(1-i), dct c_p f(1-f), dct i (1-g^2), dh tanh(c_t) o(1-o))
//   valid = t < len[b]: dgates = 0 past the length, where the carries hold;
//   dh_carry' = dgates @ W_hh^T,  dc_carry' = dct * f   (when valid)
// and writes dgx[d, t, b] = dgates. dW_hh = sum_t h_p^T dgates is one batched
// product outside the kernel, as in the JAX package.
//
// What bounds it on an H100: as the forward kernel (lstm_fwd.cu), the loop
// is sequential in t and one block walks it for one direction and a tile of
// kRows batch rows, so W_hh (1 MB at H = 256) streams from L2 into one SM,
// now twice per step: once for the gate recompute (h_p @ W_hh, the forward
// kernel's product and its split reduction) and once for dgates @ W_hh^T,
// which reads W_hh's row k contiguously along 4H: a warp per unit k, lanes
// along 4H, then a shuffle reduction. About 2 MB a step, twice the forward
// kernel's bytes, so about twice its step time. The later option is to let
// the forward kernel write the gate activations ([T, B, 4H], 4x the bytes of
// y), so that this kernel skips the recompute and streams W_hh once.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;  // batch rows per block

// k-slices per hidden unit of the gate recompute (as lstm_fwd.cu)
__host__ __device__ inline int slices(int H) { return H >= kThreads ? 1 : kThreads / H; }

__host__ __device__ inline size_t smem_floats(int H) {
  // h_p, dh and dc carries [kRows][H] each; dgates [kRows][4H]; partial
  // gate sums [P][4][kRows][H]
  return (3 + 4 + 4 * (size_t)slices(H)) * kRows * H;
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ gx,     // [D, T, B, 4H]
                const float* __restrict__ whh,    // [D, H, 4H]
                const int* __restrict__ lengths,  // [B]
                const float* __restrict__ y,      // [D, T, B, H]
                const float* __restrict__ cs,     // [D, T, B, H]
                const float* __restrict__ dy,     // [D, T, B, H]
                float* __restrict__ dgx,          // [D, T, B, 4H]
                int T, int B, int H, unsigned rev_bits) {
  extern __shared__ float smem[];
  const int P = slices(H);
  const int G = 4 * H;
  float* h_p = smem;              // [kRows][H]
  float* dh_c = h_p + kRows * H;  // [kRows][H]
  float* dc_c = dh_c + kRows * H;  // [kRows][H]
  float* dg = dc_c + kRows * H;   // [kRows][4H]
  float* part = dg + kRows * G;   // [P][4][kRows][H]

  const int d = blockIdx.y;
  const bool reverse = (rev_bits >> d) & 1u;
  const int b0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* W = whh + (size_t)d * H * G;
  const size_t plane = (size_t)T * B;
  const float* gxd = gx + (size_t)d * plane * G;
  const float* yd = y + (size_t)d * plane * H;
  const float* csd = cs + (size_t)d * plane * H;
  const float* dyd = dy + (size_t)d * plane * H;
  float* dgxd = dgx + (size_t)d * plane * G;

  for (int i = threadIdx.x; i < 2 * kRows * H; i += blockDim.x) dh_c[i] = 0.f;  // dh_c, dc_c
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;  // the processing predecessor
    const bool has_p = tp >= 0 && tp < T;

    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H, u = idx % H, b = b0 + r;
      h_p[idx] = (has_p && b < B) ? yd[((size_t)tp * B + b) * H + u] : 0.f;
    }
    __syncthreads();

    // partial sums of h_p @ W_hh over one k-slice, for every gate and row
    for (int idx = threadIdx.x; idx < P * H; idx += blockDim.x) {
      const int u = idx % H;
      const int p = idx / H;
      const int k1 = (p + 1) * H / P;
      float acc[4][kRows];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;
#pragma unroll 8
      for (int k = p * H / P; k < k1; ++k) {
        const float* wk = W + (size_t)k * G + u;
        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = h_p[r * H + k];
          acc[0][r] = fmaf(hv, w0, acc[0][r]);
          acc[1][r] = fmaf(hv, w1, acc[1][r]);
          acc[2][r] = fmaf(hv, w2, acc[2][r]);
          acc[3][r] = fmaf(hv, w3, acc[3][r]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[((p * 4 + q) * kRows + r) * H + u] = acc[q][r];
    }
    __syncthreads();

    // one thread per (row, unit): the gates, the cell's adjoint, dgates
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H, u = idx % H, b = b0 + r;
      float dgv[4] = {0.f, 0.f, 0.f, 0.f};
      if (b < B) {
        const size_t o_h = ((size_t)t * B + b) * H + u;
        const float* g = gxd + ((size_t)t * B + b) * G + u;
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = g[q * H];
          for (int p = 0; p < P; ++p) a[q] += part[((p * 4 + q) * kRows + r) * H + u];
        }
        const float ig = ss::sigmoid(a[0]), fg = ss::sigmoid(a[1]);
        const float gg = tanhf(a[2]), og = ss::sigmoid(a[3]);
        const float c_t = csd[o_h];
        const float c_p = has_p ? csd[((size_t)tp * B + b) * H + u] : 0.f;
        const float tanh_c = tanhf(c_t);
        const float dh = dh_c[idx] + dyd[o_h];
        const float dc = dc_c[idx];
        const float dct = dh * og * (1.f - tanh_c * tanh_c) + dc;
        if (t < lengths[b]) {
          dgv[0] = dct * gg * ig * (1.f - ig);
          dgv[1] = dct * c_p * fg * (1.f - fg);
          dgv[2] = dct * ig * (1.f - gg * gg);
          dgv[3] = dh * tanh_c * og * (1.f - og);
          dc_c[idx] = dct * fg;
        }
        float* out = dgxd + ((size_t)t * B + b) * G + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * H] = dgv[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dg[r * G + q * H + u] = dgv[q];
    }
    __syncthreads();

    // dh carry: dgates @ W_hh^T, a warp per unit k reading W_hh's row k
    for (int k = warp; k < H; k += kWarps) {
      const float* wk = W + (size_t)k * G;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int j = lane; j < G; j += 32) {
        const float w = wk[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dg[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = ss::warp_sum(acc[r]);
        const int b = b0 + r;
        if (lane == 0 && b < B && t < lengths[b]) dh_c[r * H + k] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// rev_bits: bit d set -> direction d was computed newest-first.
extern "C" int ss_lstm_bwd(const float* gx, const float* whh, const int* lengths,
                           const float* y, const float* cs, const float* dy, float* dgx,
                           int D, int T, int B, int H, unsigned rev_bits, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * smem_floats(H);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + kRows - 1) / kRows, D);
  lstm_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gx, whh, lengths, y, cs, dy, dgx, T, B, H, rev_bits);
  return static_cast<int>(cudaGetLastError());
}
