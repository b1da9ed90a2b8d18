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
// What bounds it on an H100: the loop is sequential in t, so the card's time
// is (steps) x (one step's latency), and a step is two small products with
// W_hh[d] ([R, H] x [H, 4H] for the gate recompute, [R, 4H] x [4H, H] for the
// carry) whose operand W_hh (1 MB at H = 256) is too large for one SM's shared
// memory. Two routes; the shape decides (ops/kernels/lstm.py::lstm_bwd_route):
//
// * The cluster route (lstm_bwd_cluster_kernel). A thread-block cluster of C
//   CTAs takes one (direction, tile of R batch rows); CTA c owns the hidden
//   units [c*H/C, (c+1)*H/C) and keeps the columns of W_hh[d] that belong to
//   them (all four gates: [H, 4H/C] float32, 128 KB at H = 256, C = 8) in
//   shared memory for the whole time loop: W_hh is read from L2 once per
//   launch. The same slice serves both products. The gate recompute for the
//   CTA's units needs all of h_p, which is no recurrence in the backward (it
//   is y at the predecessor step), so it is prefetched a step ahead by
//   cp.async together with the step's gx, cs and dy. The carry dh' = dgates @
//   W_hh^T sums over all 4H columns: each CTA computes its partial [R, H]
//   from its own columns and a reduce-scatter through distributed shared
//   memory gives CTA j the dh' of its units: every CTA writes the [R, H/C]
//   piece owed to CTA j into slot [src] of j's shared memory, one cluster
//   barrier per step (arrive after the remote writes, wait only before the
//   next step's cell phase, with that step's gate recompute between them),
//   then j adds its C slots in a fixed order. The slots are double-buffered,
//   so one barrier a step is enough.
//   Within a step the pace is set by shared-memory reads as much as by the
//   FMAs: a value that a whole warp reads (an h_p or a dgates element) costs
//   a wavefront like 32 distinct ones. So both products are register-tiled
//   8 x R (8 columns of the slice, or 8 units, by R rows: 8 R FMAs for 8 + R
//   values read), each W element is read from shared memory once per step
//   and product, partial sums meet by warp shuffles, and the slice's row
//   pitch (4H/C + 4 floats) keeps the carry product's float4 reads, which
//   walk W's rows, off each other's banks. The two products of a step do
//   not wait for each other: the gate recompute of step s+1 needs no carry,
//   so after the cell phase of step s half of the warps (group A) turn
//   dgates into the carry (product, reduce-scatter, cluster arrive) while
//   the other half (group B) fetch the operands of step s+2 and recompute
//   the gate sums of step s+1; each scheduler then has a warp of either.
//   R is 4, 5, 6 or 8: a step's time grows with R, but the clusters must
//   all be resident at once (an H100 holds 15 clusters of 8 CTAs), so the
//   wrapper takes the smallest R that fits: 5 at B = 32 (14 clusters).
//   Every CTA of a cluster walks the same steps (rows past B or past their
//   length are masked, never skipped); steps where ALL rows of the tile are
//   past their length are the same for the whole cluster and are skipped.
// * The streaming route (lstm_bwd_kernel), for shapes no cluster serves (an
//   H the split does not divide into warps, or a slice that does not fit):
//   one block per (direction, 2 batch rows) streams W_hh from L2 twice per
//   step, once for the gate recompute and once for dgates @ W_hh^T (a warp
//   per unit k, lanes along 4H, then a shuffle reduction).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kKSlices = 8;  // gate recompute: k-slices, a pair to a warp
constexpr int kUnits = 8;    // carry product: units (k, k + H/8, ...) a thread

// How a cluster CTA lays out its shared memory (offsets in floats).
struct ClusterPlan {
  int Hc, LC, pitch;  // units and gate columns of one CTA; the W slice's row pitch
  size_t w, hp, gxs, cst, csp, dys, dcc, dg, part, pd, slots, lens, total;
};

__host__ __device__ inline ClusterPlan cluster_plan(int H, int C, int R) {
  ClusterPlan p;
  p.Hc = H / C;
  p.LC = 4 * p.Hc;
  p.pitch = p.LC + 4;
  size_t o = 0;
  p.w = o, o += (size_t)H * p.pitch;
  p.hp = o, o += 2 * (size_t)R * H;
  p.gxs = o, o += 2 * (size_t)R * p.LC;
  p.cst = o, o += 2 * (size_t)R * p.Hc;
  p.csp = o, o += 2 * (size_t)R * p.Hc;
  p.dys = o, o += 2 * (size_t)R * p.Hc;
  p.dcc = o, o += (size_t)R * p.Hc;
  p.dg = o, o += (size_t)R * p.LC;
  // the partial gate sums of the next step (a pair of k-slices each) and, live at the
  // same time, this CTA's partial of the carry
  p.part = o, o += (size_t)(kKSlices / 2) * R * p.LC;
  p.pd = o, o += (size_t)R * H;
  p.slots = o, o += 2 * (size_t)C * R * p.Hc;
  p.lens = o, o += R;
  p.total = o;
  return p;
}

template <int R>
__global__ void __launch_bounds__(kCThreads, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ gx,     // [D, T, B, 4H]
                        const float* __restrict__ whh,    // [D, H, 4H]
                        const int* __restrict__ lengths,  // [B]
                        const float* __restrict__ y,      // [D, T, B, H]
                        const float* __restrict__ cs,     // [D, T, B, H]
                        const float* __restrict__ dy,     // [D, T, B, H]
                        float* __restrict__ dgx,          // [D, T, B, 4H]
                        int T, int B, int H, unsigned rev_bits) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;   // the cluster spans the grid's x
  const int c = blockIdx.x;  // this CTA's rank: it owns units [c*Hc, (c+1)*Hc)
  const ClusterPlan P = cluster_plan(H, C, R);
  const int Hc = P.Hc, LC = P.LC, pitch = P.pitch, G = 4 * H;
  float* Ws = smem + P.w;          // [H][pitch]: W_hh[d][:, q*H + c*Hc + j] at column q*Hc + j
  float* hp = smem + P.hp;         // [2][R][H] h at the predecessor step
  float* gxs = smem + P.gxs;       // [2][R][LC]
  float* cst = smem + P.cst;       // [2][R][Hc] c_t
  float* csp = smem + P.csp;       // [2][R][Hc] c at the predecessor step
  float* dys = smem + P.dys;       // [2][R][Hc]
  float* dcc = smem + P.dcc;       // [R][Hc] the dc carry
  float* dg = smem + P.dg;         // [R][LC] dgates of this CTA's columns
  float* part = smem + P.part;     // [kKSlices / 2][R][LC] partial gate sums
  float* pd = smem + P.pd;         // [R][H] this CTA's partial of the carry
  float* slots = smem + P.slots;   // [2][C][R][Hc] the carry pieces the cluster owes this CTA
  int* lens = reinterpret_cast<int*>(smem + P.lens);  // [R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.z;
  const bool reverse = (rev_bits >> d) & 1u;
  const int b0 = blockIdx.y * R;
  const size_t plane = (size_t)T * B;
  const float* W = whh + (size_t)d * H * G;
  const float* gxd = gx + (size_t)d * plane * G;
  const float* yd = y + (size_t)d * plane * H;
  const float* csd = cs + (size_t)d * plane * H;
  const float* dyd = dy + (size_t)d * plane * H;
  float* dgxd = dgx + (size_t)d * plane * G;

  // the resident slice of W_hh, the zeroed carries, the tile's lengths
  for (int idx = tid; idx < H * (LC / 4); idx += kCThreads) {
    const int k = idx / (LC / 4), l = (idx - k * (LC / 4)) * 4;
    const int q = l / Hc, j = l - q * Hc;
    *reinterpret_cast<float4*>(Ws + k * pitch + l) =
        *reinterpret_cast<const float4*>(W + (size_t)k * G + q * H + c * Hc + j);
  }
  for (int idx = tid; idx < 2 * C * R * Hc; idx += kCThreads) slots[idx] = 0.f;
  for (int idx = tid; idx < R * Hc; idx += kCThreads) dcc[idx] = 0.f;
  if (tid < R) lens[tid] = b0 + tid < B ? min(max(lengths[b0 + tid], 0), T) : 0;
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) maxlen = max(maxlen, lens[r]);
  // the steps on which some row of the tile is inside its length: the same for
  // every CTA of the cluster. Elsewhere dgates is zero and no carry moves.
  const int s_lo = reverse ? 0 : T - maxlen, s_hi = reverse ? maxlen : T;
  for (int s = reverse ? s_hi : 0; s < (reverse ? T : s_lo); ++s) {
    const int t = reverse ? s : T - 1 - s;
    for (int idx = tid; idx < R * LC; idx += kCThreads) {
      const int r = idx / LC, l = idx - r * LC, q = l / Hc, j = l - q * Hc;
      if (b0 + r < B) dgxd[((size_t)t * B + b0 + r) * G + q * H + c * Hc + j] = 0.f;
    }
  }

  // gx, h_p, c_t, c_p and dy of step s -> buffer buf, by cp.async (none depends on the
  // carry), issued by nw warps of which this is warp w: a warp per row, lanes along it
  auto prefetch = [&](int s, int buf, int w, int nw) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;
    const bool has_p = tp >= 0 && tp < T;
    for (int r = w; r < R; r += nw) {
      const bool ok = b0 + r < B;
      const size_t row_t = ((size_t)t * B + b0 + r), row_p = ((size_t)tp * B + b0 + r);
      for (int k4 = lane; k4 < H / 4; k4 += 32)
        ss::cp_async16_zfill(hp + (buf * R + r) * H + k4 * 4,
                         ok && has_p ? yd + row_p * H + k4 * 4 : yd, ok && has_p);
      for (int l4 = lane; l4 < LC / 4; l4 += 32) {
        const int l = l4 * 4, q = (l >= Hc) + (l >= 2 * Hc) + (l >= 3 * Hc), j = l - q * Hc;
        ss::cp_async16_zfill(gxs + (buf * R + r) * LC + l,
                         ok ? gxd + row_t * G + q * H + c * Hc + j : gxd, ok);
      }
      for (int j4 = lane; j4 < Hc / 4; j4 += 32) {
        const int o = (buf * R + r) * Hc + j4 * 4, u = c * Hc + j4 * 4;
        ss::cp_async16_zfill(cst + o, ok ? csd + row_t * H + u : csd, ok);
        ss::cp_async16_zfill(dys + o, ok ? dyd + row_t * H + u : dyd, ok);
        ss::cp_async16_zfill(csp + o, ok && has_p ? csd + row_p * H + u : csd, ok && has_p);
      }
    }
    asm volatile("cp.async.commit_group;");
  };

  // Partial sums of h_p @ W[:, own columns] for the step whose operands are in buffer
  // buf, by nw warps of which this is warp w. A warp takes a pair of k-slices (one on
  // each half-warp) and 128 of the columns: R rows x 8 columns a thread (two float4s,
  // half the slice apart, so that a half-warp's reads are contiguous). The pair's sums
  // meet by one shuffle, so the cell phase adds kKSlices / 2 partials.
  const int KS = H / kKSlices, NG = LC / 128;
  auto recompute = [&](int buf, int w, int nw) {
    const float* hrow = hp + buf * R * H;
    for (int item = w; item < NG * (kKSlices / 2); item += nw) {
      const int cg = item % NG, pair = item / NG;
      const int ks = 2 * pair + (lane >> 4), cl = cg * 16 + (lane & 15);
      const float* w0 = Ws + cl * 4;
      const float* w1 = w0 + LC / 2;
      float acc[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 2
      for (int k = ks * KS; k < (ks + 1) * KS; k += 4) {
        float4 hv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) hv[r] = *reinterpret_cast<const float4*>(hrow + r * H + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 u = *reinterpret_cast<const float4*>(w0 + (k + kk) * pitch);
          const float4 v = *reinterpret_cast<const float4*>(w1 + (k + kk) * pitch);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float h = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
            acc[r][0] = fmaf(h, u.x, acc[r][0]);
            acc[r][1] = fmaf(h, u.y, acc[r][1]);
            acc[r][2] = fmaf(h, u.z, acc[r][2]);
            acc[r][3] = fmaf(h, u.w, acc[r][3]);
            acc[r][4] = fmaf(h, v.x, acc[r][4]);
            acc[r][5] = fmaf(h, v.y, acc[r][5]);
            acc[r][6] = fmaf(h, v.z, acc[r][6]);
            acc[r][7] = fmaf(h, v.w, acc[r][7]);
          }
        }
      }
      // the other half-warp's slice; then each half stores one of the two float4s
      const bool upper = lane >= 16;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] += __shfl_xor_sync(ss::kFullMask, acc[r][q], 16);
        float* o = part + (pair * R + r) * LC + cl * 4 + (upper ? LC / 2 : 0);
        *reinterpret_cast<float4*>(o) =
            upper ? make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7])
                  : make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  };

  if (s_lo < s_hi) prefetch(s_lo, 0, warp, kCWarps);
  if (s_lo + 1 < s_hi) prefetch(s_lo + 1, 1, warp, kCWarps);
  asm volatile("cp.async.wait_all;");
  __syncthreads();
  if (s_lo < s_hi) recompute(0, warp, kCWarps);
  __syncthreads();
  cluster.sync();  // every CTA's slots are zeroed before the first remote write

  // From here the warps work in two groups. Group A (the first half) turns a step's
  // dgates into the carry: its share of dgates @ W_hh^T, the reduce-scatter, the
  // cluster arrive. Group B meanwhile fetches the operands of the step after next and
  // recomputes the gate sums of the next step, which need no carry. Between them
  // every warp takes part in the cell phase.
  constexpr int kGroupWarps = kCWarps / 2, kGroupThreads = kCThreads / 2;
  const bool group_a = warp < kGroupWarps;
  const int gw = group_a ? warp : warp - kGroupWarps, gt = gw * 32 + lane;
  const int KU = H / kUnits;
  for (int s = s_lo; s < s_hi; ++s) {
    const int n = s - s_lo, buf = n & 1;
    const int t = reverse ? s : T - 1 - s;
    // the pieces of the carry that the cluster wrote during the last step
    if (n > 0) ss::cluster_wait();

    // one item per (row, own unit): the gates, the cell's adjoint, dgates
    for (int idx = tid; idx < R * Hc; idx += kCThreads) {
      const int r = idx / Hc, j = idx - r * Hc, b = b0 + r;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* pq = part + r * LC + q * Hc + j;
        float even = gxs[(buf * R + r) * LC + q * Hc + j], odd = 0.f;
#pragma unroll
        for (int pr = 0; pr < kKSlices / 2; pr += 2) {
          even += pq[pr * R * LC];
          odd += pq[(pr + 1) * R * LC];
        }
        a[q] = even + odd;
      }
      float dh = dys[(buf * R + r) * Hc + j];
      {
        const float* sl = slots + ((buf ^ 1) * C * R + r) * Hc + j;
        float sum = 0.f;
        for (int src = 0; src < C; ++src) sum += sl[src * R * Hc];
        dh += sum;
      }
      const float ig = ss::sigmoid_sel(a[0]), fg = ss::sigmoid_sel(a[1]);
      const float gg = tanhf(a[2]), og = ss::sigmoid_sel(a[3]);
      const float c_t = cst[(buf * R + r) * Hc + j];
      const float c_p = csp[(buf * R + r) * Hc + j];
      const float tanh_c = tanhf(c_t);
      const float dc = dcc[idx];
      const float dct = dh * og * (1.f - tanh_c * tanh_c) + dc;
      float dgv[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < lens[r]) {
        dgv[0] = dct * gg * ig * (1.f - ig);
        dgv[1] = dct * c_p * fg * (1.f - fg);
        dgv[2] = dct * ig * (1.f - gg * gg);
        dgv[3] = dh * tanh_c * og * (1.f - og);
        dcc[idx] = dct * fg;
      }
      if (b < B) {
        float* out = dgxd + ((size_t)t * B + b) * G + c * Hc + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * H] = dgv[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dg[r * LC + q * Hc + j] = dgv[q];
    }
    __syncthreads();  // dgates are complete; part and this step's operand buffer are free

    if (group_a) {
      // This CTA's share of dgates @ W_hh^T: 8 units (k, k + H/8, ...) x R rows a thread
      // over a quarter of the own columns; a warp takes 8 unit offsets x the 4 quarters
      // (8 lanes walk 8 rows of W: conflict-free float4 reads at the slice's pitch) and
      // two shuffles join the quarters. A row past its length has dgates = 0 and so
      // contributes 0: the carry it would hold is 0 on a forward direction (the steps
      // past a length come first) and is read by no later step on a reversed one.
      for (int item = gw; item < KU / 8; item += kGroupWarps) {
        const int kq = item * 8 + (lane & 7), ls = lane >> 3;
        const float* wk = Ws + kq * pitch + ls * Hc;
        const float* dl = dg + ls * Hc;
        float acc[kUnits][R];
#pragma unroll
        for (int m = 0; m < kUnits; ++m)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[m][r] = 0.f;
        for (int l = 0; l < Hc; l += 4) {
          float4 w[kUnits];
#pragma unroll
          for (int m = 0; m < kUnits; ++m)
            w[m] = *reinterpret_cast<const float4*>(wk + m * KU * pitch + l);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 g4 = *reinterpret_cast<const float4*>(dl + r * LC + l);
#pragma unroll
            for (int m = 0; m < kUnits; ++m)
              acc[m][r] = fmaf(g4.w, w[m].w,
                               fmaf(g4.z, w[m].z, fmaf(g4.y, w[m].y, fmaf(g4.x, w[m].x, acc[m][r]))));
          }
        }
#pragma unroll
        for (int m = 0; m < kUnits; ++m)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[m][r] += __shfl_xor_sync(ss::kFullMask, acc[m][r], 8);
            acc[m][r] += __shfl_xor_sync(ss::kFullMask, acc[m][r], 16);
          }
        // every lane holds the sums of its 8 units; quarter ls stores units 2 ls, 2 ls + 1
#pragma unroll
        for (int m = 0; m < kUnits; ++m)
          if ((m >> 1) == ls) {
#pragma unroll
            for (int r = 0; r < R; ++r) pd[r * H + kq + m * KU] = acc[m][r];
          }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kGroupThreads));
      // reduce-scatter: the [R, Hc] piece of the partial owed to CTA j goes to slot [c] there
      for (int item = gt; item < R * (H / 4); item += kGroupThreads) {
        const int r = item / (H / 4), k = (item - r * (H / 4)) * 4;
        const int dst = k / Hc, j = k - dst * Hc;
        float* remote = cluster.map_shared_rank(slots, dst);
        *reinterpret_cast<float4*>(remote + ((buf * C + c) * R + r) * Hc + j) =
            *reinterpret_cast<const float4*>(pd + r * H + k);
      }
    } else if (s + 1 < s_hi) {
      // the next step's operands (fetched a step ago by this group) have landed
      asm volatile("cp.async.wait_all;");
      asm volatile("bar.sync 2, %0;" ::"n"(kGroupThreads));
      if (s + 2 < s_hi) prefetch(s + 2, buf, gw, kGroupWarps);
      recompute(buf ^ 1, gw, kGroupWarps);
    }
    ss::cluster_arrive();
    __syncthreads();  // the next step's gate sums are complete; pd and dgates are free
  }
  // no CTA leaves while a neighbour may still write into it
  if (s_hi > s_lo) ss::cluster_wait();
  cluster.sync();
}

// The launch of the cluster route; with `resident` the launch is not made and
// the clusters the card holds at once are counted instead.
template <int R>
cudaError_t launch_cluster(const float* gx, const float* whh, const int* lengths, const float* y,
                           const float* cs, const float* dy, float* dgx, int D, int T, int B, int H,
                           unsigned rev_bits, int C, cudaStream_t stream, int* resident = nullptr) {
  const size_t smem = sizeof(float) * cluster_plan(H, C, R).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_bwd_cluster_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + R - 1) / R, D);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr)
    return cudaOccupancyMaxActiveClusters(resident, lstm_bwd_cluster_kernel<R>, &cfg);
  return cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<R>, gx, whh, lengths, y, cs, dy, dgx, T,
                            B, H, rev_bits);
}

// The shapes the cluster route is written for.
inline bool cluster_serves(int H, int C, int R) {
  return (C == 1 || C == 2 || C == 4 || C == 8) && (R == 4 || R == 5 || R == 6 || R == 8) &&
         H % C == 0 &&
         H / C > 0 && (H / C) % 32 == 0 && H % 64 == 0;
}

}  // namespace

// rev_bits: bit d set -> direction d was computed newest-first. cluster = 0
// takes the streaming route; cluster = C in {1, 2, 4, 8} the cluster route with
// tiles of `rows` (4, 5, 6 or 8) batch rows, which needs H / C a multiple of 32 and a
// slice that fits (the wrapper's lstm_bwd_route decides; a shape the route
// does not serve is refused here, never rerouted).
extern "C" int ss_lstm_bwd(const float* gx, const float* whh, const int* lengths,
                           const float* y, const float* cs, const float* dy, float* dgx,
                           int D, int T, int B, int H, unsigned rev_bits, int cluster, int rows,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if (!cluster_serves(H, cluster, rows)) return static_cast<int>(cudaErrorInvalidValue);
#define SS_CLUSTER(R) \
  launch_cluster<R>(gx, whh, lengths, y, cs, dy, dgx, D, T, B, H, rev_bits, cluster, st)
    err = rows == 4 ? SS_CLUSTER(4) : rows == 5 ? SS_CLUSTER(5) : rows == 6 ? SS_CLUSTER(6)
                                                                           : SS_CLUSTER(8);
#undef SS_CLUSTER
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * smem_floats(H);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + kRows - 1) / kRows, D);
  lstm_bwd_kernel<<<grid, kThreads, smem, st>>>(gx, whh, lengths, y, cs, dy, dgx, T, B, H,
                                                rev_bits);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` CTAs with tiles of `rows` rows the card holds
// at once for hidden size H -> *resident (cudaOccupancyMaxActiveClusters).
extern "C" int ss_lstm_bwd_resident_clusters(int H, int cluster, int rows, int device,
                                             int* resident) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cluster_serves(H, cluster, rows)) return static_cast<int>(cudaErrorInvalidValue);
#define SS_RESIDENT(R)                                                                        \
  launch_cluster<R>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, rows, H, \
                    0u, cluster, nullptr, resident)
  err = rows == 4 ? SS_RESIDENT(4) : rows == 5 ? SS_RESIDENT(5) : rows == 6 ? SS_RESIDENT(6)
                                                                         : SS_RESIDENT(8);
#undef SS_RESIDENT
  return static_cast<int>(err);
}

