// Device functions of the one-row attend-and-spell step, shared by the
// greedy decode kernels (greedy_decode.cu), the teacher-forced forward
// (spell_fwd.cu) and its backward (spell_bwd.cu): block-wide matrix-vector
// products (and the transposed product), the LSTM and GRU cells, and the
// log-softmax terms. Every function is called by all threads of a
// kThreads-thread block and ends with a barrier where it says so. float32.
// At the end, the products of the teacher-forced kernels' cluster route
// (sp_*), which serve a tile of R batch rows from one read of each weight.
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

// ---------------------------------------------------------------------------
// The cluster route of the teacher-forced speller (spell_fwd.cu, spell_bwd.cu)
// ---------------------------------------------------------------------------
// A thread-block cluster of C = H / 32 CTAs serves a tile of R batch rows.
// CTA c owns the hidden units [32c, 32c + 32) of both cells and their 128
// gate columns q * H + 32c + j (gate q, unit j), stored at own column q * 32
// + j. Every function below is called by all kSpThreads threads of a CTA;
// each weight element it reads from device memory serves all R rows.

constexpr int kSpThreads = 512;
constexpr int kSpWarps = kSpThreads / 32;
constexpr int kSpUnits = 32;             // units a CTA owns
constexpr int kSpCols = 4 * kSpUnits;    // its gate columns

// Weight rows a warp (sp_gate_acc) or a thread (sp_tprod) keeps in flight.
// Eight already reach what an SM draws from L2 (about 100 GB/s): sixteen
// measured the same.
constexpr int kSpDepth = 8;

// acc[r][0:4] += sum_{k < K} x[r * ldx + k] * W[k * ldw + col : +4] for the
// rows k of this warp (warp, warp + kSpWarps, ...): a warp reads 128 B of
// each of the four gates' column blocks of a row, kSpDepth rows in flight.
template <int R>
__device__ __forceinline__ void sp_gate_acc(const float* __restrict__ W, int ldw, int col,
                                            const float* x, int ldx, int K,
                                            float (&acc)[R][4]) {
  constexpr int U = kSpDepth;
  int k = threadIdx.x >> 5;
  for (; k + (U - 1) * kSpWarps < K; k += U * kSpWarps) {
    float4 w[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      w[i] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k + i * kSpWarps) * ldw + col));
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = x[r * ldx + k + i * kSpWarps];
        acc[r][0] = fmaf(xv, w[i].x, acc[r][0]);
        acc[r][1] = fmaf(xv, w[i].y, acc[r][1]);
        acc[r][2] = fmaf(xv, w[i].z, acc[r][2]);
        acc[r][3] = fmaf(xv, w[i].w, acc[r][3]);
      }
    }
  }
  for (; k < K; k += kSpWarps) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * ldw + col));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = x[r * ldx + k];
      acc[r][0] = fmaf(xv, w.x, acc[r][0]);
      acc[r][1] = fmaf(xv, w.y, acc[r][1]);
      acc[r][2] = fmaf(xv, w.z, acc[r][2]);
      acc[r][3] = fmaf(xv, w.w, acc[r][3]);
    }
  }
}

// This lane's first own gate column (lane l holds own columns 4l .. 4l + 3:
// gate l / 8, units 4 (l % 8) .. + 3) as a column of the [., 4H] weights.
__device__ __forceinline__ int sp_gate_col(int H, int u0) {
  const int lane = threadIdx.x & 31;
  return (lane >> 3) * H + u0 + (lane & 7) * 4;
}

// The warp's gate partials to part[warp][r][own column] ([kSpWarps][R][128]).
template <int R>
__device__ __forceinline__ void sp_gate_store(float* part, const float (&acc)[R][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(part + (warp * R + r) * kSpCols + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// gates[r * 128 + l] = bias[l] + the warps' partials of own column l, in warp
// order: a thread a (row, column). Ends with a barrier.
template <int R>
__device__ void sp_gate_reduce(const float* part, const float* bias, float* gates) {
  for (int idx = threadIdx.x; idx < R * kSpCols; idx += kSpThreads) {
    const int r = idx / kSpCols, l = idx % kSpCols;
    float a = bias[l];
#pragma unroll
    for (int w = 0; w < kSpWarps; ++w) a += part[(w * R + r) * kSpCols + l];
    gates[idx] = a;
  }
  __syncthreads();
}

// sink(r, j, bias[j] + sum_{k < K} x[r * ldx + k] * W[k * ldw + j]) for j < n
// (n <= kSpThreads): the k range in P = kSpThreads / n interleaved slices
// whose partials meet in `part` ([P][R][n], at most kSpThreads * R floats).
// W and bias may lie in shared memory. Ends with a barrier.
template <int R, class Sink>
__device__ void sp_colprod(const float* x, int ldx, int K, const float* W, int ldw, int n,
                           const float* bias, float* part, Sink sink) {
  const int P = max(1, kSpThreads / n);
  for (int idx = threadIdx.x; idx < P * n; idx += kSpThreads) {
    const int j = idx % n, p = idx / n;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = p; k < K; k += P) {
      const float w = W[(size_t)k * ldw + j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r * ldx + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part[(p * R + r) * n + j] = acc[r];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * n; idx += kSpThreads) {
    const int r = idx / n, j = idx % n;
    float s = bias ? bias[j] : 0.f;
    for (int p = 0; p < P; ++p) s += part[(p * R + r) * n + j];
    sink(r, j, s);
  }
  __syncthreads();
}

// sink(r, j, sum_{s < S} w[r * ldw + s] * X[rows[r] * xrow + s * ldx + col0 + j])
// for j < n (n and col0 multiples of 4): a float4 of columns a thread, the s
// range in P interleaved slices meeting in `part` ([P][R][n], at most
// max(4 kSpThreads, R n) floats). Ends with a barrier.
template <int R, class Sink>
__device__ void sp_rowsum(const float* w, int ldw, int S, const float* __restrict__ X,
                          const int* rows, size_t xrow, int ldx, int col0, int n, float* part,
                          Sink sink) {
  const int n4 = n / 4, items = R * n4, P = max(1, kSpThreads / items);
  for (int idx = threadIdx.x; idx < P * items; idx += kSpThreads) {
    const int it = idx % items, p = idx / items, r = it / n4, j4 = it % n4;
    const float* xr = X + rows[r] * xrow + col0 + 4 * j4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = p; s < S; s += P) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + (size_t)s * ldx));
      const float a = w[r * ldw + s];
      acc.x = fmaf(a, v.x, acc.x);
      acc.y = fmaf(a, v.y, acc.y);
      acc.z = fmaf(a, v.z, acc.z);
      acc.w = fmaf(a, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(part + (p * R + r) * n + 4 * j4) = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * n; idx += kSpThreads) {
    const int r = idx / n, j = idx % n;
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(p * R + r) * n + j];
    sink(r, j, s);
  }
  __syncthreads();
}

// sink(r, s, sum_{j < n} y[r * ldy + j] * X[rows[r] * xrow + s * ldx + col0 + j])
// for r < R and s = s0 + i * sstep, i < ns (n and col0 multiples of 4): four
// lanes an item, four float4s a lane in flight, two shuffles; the lane with
// (lane % 4) == 0 calls the sink. No barrier.
template <class Sink>
__device__ void sp_dots(int R, int ns, int s0, int sstep, const float* y, int ldy,
                        const float* __restrict__ X, const int* rows, size_t xrow, int ldx,
                        int col0, int n, Sink sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane & 3;
  const int items = R * ns, n4 = n / 4;
  for (int base = warp * 8; base < items; base += kSpWarps * 8) {
    const int it = base + (lane >> 2);
    const bool ok = it < items;
    const int r = ok ? it / ns : 0, s = s0 + (ok ? it % ns : 0) * sstep;
    float acc = 0.f;
    if (ok) {
      const float4* xr = reinterpret_cast<const float4*>(X + rows[r] * xrow + (size_t)s * ldx +
                                                         col0);
#pragma unroll 4
      for (int j4 = sub; j4 < n4; j4 += 4) {
        const float4 v = __ldg(xr + j4);
        const float* yr = y + r * ldy + 4 * j4;
        acc = fmaf(yr[0], v.x, acc);
        acc = fmaf(yr[1], v.y, acc);
        acc = fmaf(yr[2], v.z, acc);
        acc = fmaf(yr[3], v.w, acc);
      }
    }
    acc += __shfl_xor_sync(ss::kFullMask, acc, 2);
    acc += __shfl_xor_sync(ss::kFullMask, acc, 1);
    if (ok && sub == 0) sink(r, s, acc);
  }
}

}  // namespace
