// Device functions of the one-row attend-and-spell step, shared by the
// greedy decode kernels (greedy_decode.cu), the teacher-forced forward
// (spell_fwd.cu) and its backward (spell_bwd.cu): block-wide matrix-vector
// products (and the transposed product), the LSTM and GRU cells, and the
// log-softmax terms. Every function is called by all threads of a
// kThreads-thread block and ends with a barrier where it says so. float32.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSOS = 0;
constexpr int kEOS = 1;

struct CharLM {
  const float* emb;  // [V, HL]
  const float* wih1;  // [HL, 3HL]
  const float* whh1;  // [HL, 3HL]
  const float* bih1;  // [3HL]
  const float* bhh1;  // [3HL]
  const float* wih2;
  const float* whh2;
  const float* bih2;
  const float* bhh2;
  const float* out_w;  // [HL, V]
  const float* out_b;  // [V]
  int HL;
  float weight;
};

// k-slices per output column: as many as the block's threads allow
__host__ __device__ inline int slices(int ncols) {
  return ncols >= kThreads ? 1 : kThreads / ncols;
}

// out[v] = act(bias[v] + sum_k x[k] * W[k * ncols + v]) for v < ncols.
// Narrow outputs split the k range over kThreads / ncols thread groups,
// whose partial sums meet in `part` ([kThreads]). Ends with a barrier.
__device__ void matvec(const float* x, int n, const float* __restrict__ W, int ncols,
                       const float* __restrict__ bias, float* part, float* out,
                       bool tanh_act) {
  const int parts = slices(ncols);
  if (parts == 1) {
    for (int v = threadIdx.x; v < ncols; v += blockDim.x) {
      float acc = bias ? bias[v] : 0.f;
#pragma unroll 8
      for (int k = 0; k < n; ++k) acc = fmaf(x[k], W[(size_t)k * ncols + v], acc);
      out[v] = tanh_act ? tanhf(acc) : acc;
    }
    __syncthreads();
    return;
  }
  for (int idx = threadIdx.x; idx < parts * ncols; idx += blockDim.x) {
    const int v = idx % ncols;
    const int p = idx / ncols;
    float acc = 0.f;
#pragma unroll 8
    for (int k = p; k < n; k += parts) acc = fmaf(x[k], W[(size_t)k * ncols + v], acc);
    part[idx] = acc;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < ncols; v += blockDim.x) {
    float acc = bias ? bias[v] : 0.f;
    for (int p = 0; p < parts; ++p) acc += part[p * ncols + v];
    out[v] = tanh_act ? tanhf(acc) : acc;
  }
  __syncthreads();
}

// LSTM cell over hidden units: gates = bias + [x | h] @ [Wx ; Wh] (4H
// columns, i f g o). The nx + H inputs are split into slices(H) slices per
// unit; the partial sums meet in `part` ([slices][4][H]). c is updated in
// place by the unit's owner, h_new gets the output. Ends with a barrier.
__device__ void lstm_cell(const float* x, int nx, const float* __restrict__ Wx,
                          const float* h, const float* __restrict__ Wh,
                          const float* __restrict__ bias, int H, float* c, float* h_new,
                          float* part) {
  const int G = 4 * H, n = nx + H, P = slices(H);
  for (int idx = threadIdx.x; idx < P * H; idx += blockDim.x) {
    const int u = idx % H;
    const int p = idx / H;
    const int k0 = p * n / P, k1 = (p + 1) * n / P;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int k = k0; k < min(k1, nx); ++k) {
      const float xv = x[k];
      const float* w = Wx + (size_t)k * G + u;
      a0 = fmaf(xv, w[0], a0);
      a1 = fmaf(xv, w[H], a1);
      a2 = fmaf(xv, w[2 * H], a2);
      a3 = fmaf(xv, w[3 * H], a3);
    }
#pragma unroll 8
    for (int k = max(k0, nx); k < k1; ++k) {
      const float hv = h[k - nx];
      const float* w = Wh + (size_t)(k - nx) * G + u;
      a0 = fmaf(hv, w[0], a0);
      a1 = fmaf(hv, w[H], a1);
      a2 = fmaf(hv, w[2 * H], a2);
      a3 = fmaf(hv, w[3 * H], a3);
    }
    float* pp = part + (size_t)p * 4 * H + u;
    pp[0] = a0;
    pp[H] = a1;
    pp[2 * H] = a2;
    pp[3 * H] = a3;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = bias[q * H + u];
      for (int p = 0; p < P; ++p) a[q] += part[((size_t)p * 4 + q) * H + u];
    }
    const float c_new = ss::sigmoid(a[1]) * c[u] + ss::sigmoid(a[0]) * tanhf(a[2]);
    c[u] = c_new;
    h_new[u] = ss::sigmoid(a[3]) * tanhf(c_new);
  }
  __syncthreads();
}

// LSTM gate pre-activations, as lstm_cell computes them: out[0:4H] = bias +
// [x | h] @ [Wx ; Wh] (i f g o), with no cell update; `part` as lstm_cell's.
// Ends with a barrier.
__device__ void lstm_gates(const float* x, int nx, const float* __restrict__ Wx,
                           const float* h, const float* __restrict__ Wh,
                           const float* __restrict__ bias, int H, float* part, float* out) {
  const int G = 4 * H, n = nx + H, P = slices(H);
  for (int idx = threadIdx.x; idx < P * H; idx += blockDim.x) {
    const int u = idx % H;
    const int p = idx / H;
    const int k0 = p * n / P, k1 = (p + 1) * n / P;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int k = k0; k < min(k1, nx); ++k) {
      const float xv = x[k];
      const float* w = Wx + (size_t)k * G + u;
      a0 = fmaf(xv, w[0], a0);
      a1 = fmaf(xv, w[H], a1);
      a2 = fmaf(xv, w[2 * H], a2);
      a3 = fmaf(xv, w[3 * H], a3);
    }
#pragma unroll 8
    for (int k = max(k0, nx); k < k1; ++k) {
      const float hv = h[k - nx];
      const float* w = Wh + (size_t)(k - nx) * G + u;
      a0 = fmaf(hv, w[0], a0);
      a1 = fmaf(hv, w[H], a1);
      a2 = fmaf(hv, w[2 * H], a2);
      a3 = fmaf(hv, w[3 * H], a3);
    }
    float* pp = part + (size_t)p * G + u;
    pp[0] = a0;
    pp[H] = a1;
    pp[2 * H] = a2;
    pp[3 * H] = a3;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    float a = bias[i];
    for (int p = 0; p < P; ++p) a += part[(size_t)p * G + i];
    out[i] = a;
  }
  __syncthreads();
}

// The product with W transposed: out[k] = (add ? add[k] : 0) + sum_j x[j] *
// W[k * ncols + j] for k < nrows. Row k of W is read contiguously: a warp
// per row, lanes along it, then a shuffle reduction. `out` may be `add`
// (an in-place accumulation), never `x`. Ends with a barrier.
__device__ void rowdot(const float* x, int ncols, const float* __restrict__ W, int nrows,
                       const float* add, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < nrows; k += kWarps) {
    const float* wk = W + (size_t)k * ncols;
    float acc = 0.f;
#pragma unroll 8
    for (int j = lane; j < ncols; j += 32) acc = fmaf(x[j], wk[j], acc);
    acc = ss::warp_sum(acc);
    if (lane == 0) out[k] = (add ? add[k] : 0.f) + acc;
  }
  __syncthreads();
}

// GRU cell (torch GRUCell): r, z, n blocks of 3HL columns. The input and
// hidden products stay apart (n needs r * (h @ W_hn + b_hn)); the 2 HL
// inputs are split into slices(HL) slices per unit, whose partial sums
// meet in `part` ([slices][6][HL]). Ends with a barrier.
__device__ void gru_cell(const float* x, const float* h, const float* __restrict__ Wi,
                         const float* __restrict__ Wh, const float* __restrict__ bi,
                         const float* __restrict__ bh, int HL, float* h_new, float* part) {
  const int G = 3 * HL, n = 2 * HL, P = slices(HL);
  for (int idx = threadIdx.x; idx < P * HL; idx += blockDim.x) {
    const int u = idx % HL;
    const int p = idx / HL;
    const int k0 = p * n / P, k1 = (p + 1) * n / P;
    float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = k0; k < min(k1, HL); ++k) {
      const float xv = x[k];
      const float* w = Wi + (size_t)k * G + u;
      a[0] = fmaf(xv, w[0], a[0]);
      a[1] = fmaf(xv, w[HL], a[1]);
      a[2] = fmaf(xv, w[2 * HL], a[2]);
    }
#pragma unroll 8
    for (int k = max(k0, HL); k < k1; ++k) {
      const float hv = h[k - HL];
      const float* w = Wh + (size_t)(k - HL) * G + u;
      a[3] = fmaf(hv, w[0], a[3]);
      a[4] = fmaf(hv, w[HL], a[4]);
      a[5] = fmaf(hv, w[2 * HL], a[5]);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) part[((size_t)p * 6 + j) * HL + u] = a[j];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < HL; u += blockDim.x) {
    float a[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a[j] = (j < 3 ? bi : bh)[(j % 3) * HL + u];
      for (int p = 0; p < P; ++p) a[j] += part[((size_t)p * 6 + j) * HL + u];
    }
    const float r = ss::sigmoid(a[0] + a[3]);
    const float z = ss::sigmoid(a[1] + a[4]);
    const float nn = tanhf(a[2] + r * a[5]);
    h_new[u] = (1.f - z) * nn + z * h[u];
  }
  __syncthreads();
}

// max and log-sum-exp of v[0:n], within one warp.
__device__ __forceinline__ void warp_log_softmax_terms(const float* v, int n, float& mx,
                                                       float& lse) {
  const int lane = threadIdx.x & 31;
  mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, v[i]);
  mx = ss::warp_max(mx);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += expf(v[i] - mx);
  lse = logf(ss::warp_sum(s));
}

}  // namespace
