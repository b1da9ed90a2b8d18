// Packed LSTM time loop (forward pass), both directions of a layer in one
// launch.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/lstm.py::_make_fwd_kernel
// (reached from lstm_scan_pallas_trainable, rnn.bilstm_scan), forward and
// reverse; with both directions in one grid it also covers the forward of
// ss_asr_tpu/ops/pallas/bilstm.py::_bi_fwd_kernel.
//
// Computes, per direction d and batch row b, over time-major inputs:
//   gates = gx[d, t, b] + h @ W_hh[d]          (i, f, g, o blocks of H)
//   c' = sig(f) * c + sig(i) * tanh(g);  h' = sig(o) * tanh(c')
//   valid = t < len[b]: the carry takes (h', c') only when valid, so it
//   freezes past the length; y[d, t, b] = valid ? h' : 0; cs = the carry c.
// A reversed direction walks t = T-1 .. 0: its padded steps come first and
// keep the zero carry, which is packed-reverse semantics without gathers.
//
// What bounds it on an H100: the recurrence is sequential in t, and each
// step reads all of W_hh (H x 4H f32 = 1 MB at H = 256) for a [rows, H] x
// [H, 4H] product. One block walks the whole time loop for one direction and
// a tile of kRows batch rows, so W_hh streams from L2 (where it stays
// resident across steps) into ONE SM every step: the step time is bound by
// how many bytes of W_hh one SM keeps in flight from L2 (measured on an H100
// SXM at B = 16: about 14 us per step, 70 GB/s into the SM). To keep many
// loads in flight, the block has 1024 threads and each hidden unit's
// reduction over k is split into kThreads / H slices whose partial gate sums
// meet in shared memory, where one thread per (row, unit) adds them and
// updates the cell; the row tile is small (2) so the registers go to weights
// in flight rather than accumulators. h and c stay in shared memory for the
// whole loop (h double-buffered). The faster design splits W_hh over a
// cluster of CTAs, each holding its share in shared memory, and exchanges
// h_t through distributed shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 2;  // batch rows per block

// k-slices per hidden unit: as many as the block's threads allow
__host__ __device__ inline int slices(int H) { return H >= kThreads ? 1 : kThreads / H; }

__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ gx,      // [D, T, B, 4H]
                const float* __restrict__ whh,     // [D, H, 4H]
                const int* __restrict__ lengths,   // [B]
                float* __restrict__ y,             // [D, T, B, H]
                float* __restrict__ cs,            // [D, T, B, H]
                int T, int B, int H, unsigned rev_bits) {
  extern __shared__ float smem[];
  const int P = slices(H);
  float* h_buf = smem;                  // [2][kRows][H]
  float* c_buf = smem + 2 * kRows * H;  // [kRows][H]
  float* part = c_buf + kRows * H;      // [P][4][kRows][H] partial gate sums

  const int d = blockIdx.y;
  const bool reverse = (rev_bits >> d) & 1u;
  const int b0 = blockIdx.x * kRows;
  const int G = 4 * H;
  const float* W = whh + (size_t)d * H * G;
  const float* gxd = gx + (size_t)d * T * B * G;
  float* yd = y + (size_t)d * T * B * H;
  float* csd = cs + (size_t)d * T * B * H;

  for (int i = threadIdx.x; i < 3 * kRows * H; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_in = h_buf + (s & 1) * kRows * H;
    float* h_out = h_buf + ((s & 1) ^ 1) * kRows * H;

    // partial sums of h @ W_hh over one k-slice, for every gate and row
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
          const float hv = h_in[r * H + k];
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

    // one thread per (row, unit): gx + the slices' sums, then the cell
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H;
      const int u = idx % H;
      const int b = b0 + r;
      if (b >= B) continue;
      const float* g = gxd + ((size_t)t * B + b) * G + u;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = g[q * H];
        for (int p = 0; p < P; ++p) a[q] += part[((p * 4 + q) * kRows + r) * H + u];
      }
      const float c_old = c_buf[r * H + u];
      const float h_old = h_in[r * H + u];
      const float c_new = ss::sigmoid(a[1]) * c_old + ss::sigmoid(a[0]) * tanhf(a[2]);
      const float h_new = ss::sigmoid(a[3]) * tanhf(c_new);
      const bool valid = t < lengths[b];
      const float c_keep = valid ? c_new : c_old;
      c_buf[r * H + u] = c_keep;
      h_out[r * H + u] = valid ? h_new : h_old;
      const size_t o = ((size_t)t * B + b) * H + u;
      yd[o] = valid ? h_new : 0.f;
      csd[o] = c_keep;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rev_bits: bit d set -> direction d walks time newest-first.
extern "C" int ss_lstm_fwd(const float* gx, const float* whh, const int* lengths,
                           float* y, float* cs, int D, int T, int B, int H,
                           unsigned rev_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (3 + 4 * (size_t)slices(H)) * kRows * H;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + kRows - 1) / kRows, D);
  lstm_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gx, whh, lengths, y, cs, T, B, H, rev_bits);
  return static_cast<int>(cudaGetLastError());
}
