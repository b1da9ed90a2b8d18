// Packed LSTM time loop (forward pass), both directions of a layer in one
// launch.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/lstm.py::_make_fwd_kernel
// (reached from lstm_scan_pallas_trainable, rnn.bilstm_scan), forward and
// reverse; with one direction it is also ::_lstm_kernel, and with both
// directions in one grid it also covers the forward of
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
// What bounds it on an H100: the recurrence is sequential in t, so the
// card's time is (steps) x (one step's latency), and each step is a [rows, H]
// x [H, 4H] product whose operand W_hh (H x 4H f32 = 1 MB at H = 256) is too
// large for one SM's shared memory. Two routes; the shape decides
// (ops/kernels/lstm.py::lstm_fwd_route):
//
// * The cluster route (lstm_fwd_cluster_kernel). A thread-block cluster of C
//   CTAs takes one (direction, tile of R batch rows); CTA c owns the hidden
//   units [c*H/C, (c+1)*H/C) and keeps the columns of W_hh[d] that feed them
//   (all four gates: [H, 4H/C] float32, 128 KB at H = 256, C = 8) in shared
//   memory for the whole time loop: W_hh is read from L2 once per launch. A
//   step: the gate sums of the CTA's units from all of h_{t-1} (register-
//   tiled 8 columns x R rows a thread, every W element read once per step,
//   16 k-slices whose pairs meet by a shuffle), plus the step's gx columns,
//   prefetched two steps ahead by cp.async into a ring of three; the cell
//   update of the CTA's units, whose y and cs go straight to device memory;
//   then an all-gather: each thread writes its h_t element into the double-
//   buffered h of every CTA of the cluster through distributed shared
//   memory, and one cluster barrier a step, split: the arrive follows the
//   remote writes, the wait precedes the next step's product, with the gx
//   prefetch between them. h_t is a true recurrence, so no part of the
//   product runs ahead of the barrier. Every CTA of a cluster walks the same
//   steps (rows past B or past their length are masked); the steps that no
//   row of the tile reaches are skipped by the whole cluster and written
//   after the loop (y = 0, cs the frozen carry). R is 4, 5, 6 or 8; the
//   clusters must all be resident at once (an H100 holds 15 clusters of 8).
// * The streaming route (lstm_fwd_kernel), for shapes no cluster serves (an
//   H the split does not divide into warps, or a slice that does not fit):
//   one block walks the whole time loop for one direction and a tile of
//   kRows batch rows, so W_hh streams from L2 (where it stays resident
//   across steps) into ONE SM every step: the step time is bound by how
//   many bytes of W_hh one SM keeps in flight from L2 (about 14 us per step
//   at H = 256, 70 GB/s into the SM, on an H100 SXM). To keep many loads in
//   flight, the block has 1024 threads and each hidden unit's reduction over
//   k is split into kThreads / H slices whose partial gate sums meet in
//   shared memory, where one thread per (row, unit) adds them and updates
//   the cell; h and c stay in shared memory for the whole loop (h double-
//   buffered).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kKSlices = 16;  // k-slices of the gate product, a pair to a warp
constexpr int kPairs = kKSlices / 2;
constexpr int kGxStages = 3;  // the ring of prefetched gx steps

// How a cluster CTA lays out its shared memory (offsets in floats).
struct FwdPlan {
  int Hc, LC;  // units and gate columns of one CTA
  size_t w, h, gxs, part, cc, lens, total;
};

__host__ __device__ inline FwdPlan fwd_plan(int H, int C, int R) {
  FwdPlan p;
  p.Hc = H / C;
  p.LC = 4 * p.Hc;
  size_t o = 0;
  p.w = o, o += (size_t)H * p.LC;
  p.h = o, o += 2 * (size_t)R * H;
  p.gxs = o, o += (size_t)kGxStages * R * p.LC;
  p.part = o, o += (size_t)kPairs * R * p.LC;
  p.cc = o, o += (size_t)R * p.Hc;
  p.lens = o, o += R;
  p.total = o;
  return p;
}

template <int R>
__global__ void __launch_bounds__(kCThreads, 1)
lstm_fwd_cluster_kernel(const float* __restrict__ gx,      // [D, T, B, 4H]
                        const float* __restrict__ whh,     // [D, H, 4H]
                        const int* __restrict__ lengths,   // [B]
                        float* __restrict__ y,             // [D, T, B, H]
                        float* __restrict__ cs,            // [D, T, B, H]
                        int T, int B, int H, unsigned rev_bits) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;   // the cluster spans the grid's x
  const int c = blockIdx.x;  // this CTA's rank: it owns units [c*Hc, (c+1)*Hc)
  const FwdPlan P = fwd_plan(H, C, R);
  const int Hc = P.Hc, LC = P.LC, G = 4 * H;
  float* Ws = smem + P.w;      // [H][LC]: W_hh[d][:, q*H + c*Hc + j] at column q*Hc + j
  float* hb = smem + P.h;      // [2][R][H] h of the last step, gathered from the cluster
  float* gxs = smem + P.gxs;   // [kGxStages][R][LC] the step's gx, this CTA's columns
  float* part = smem + P.part;  // [kPairs][R][LC] partial gate sums
  float* cc = smem + P.cc;     // [R][Hc] the cell carry of this CTA's units
  int* lens = reinterpret_cast<int*>(smem + P.lens);  // [R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.z;
  const bool reverse = (rev_bits >> d) & 1u;
  const int b0 = blockIdx.y * R;
  const size_t plane = (size_t)T * B;
  const float* W = whh + (size_t)d * H * G;
  const float* gxd = gx + (size_t)d * plane * G;
  float* yd = y + (size_t)d * plane * H;
  float* csd = cs + (size_t)d * plane * H;

  // the resident slice of W_hh, the zeroed carries, the tile's lengths
  for (int idx = tid; idx < H * (LC / 4); idx += kCThreads) {
    const int k = idx / (LC / 4), l = (idx - k * (LC / 4)) * 4;
    const int q = l / Hc, j = l - q * Hc;
    *reinterpret_cast<float4*>(Ws + k * LC + l) =
        *reinterpret_cast<const float4*>(W + (size_t)k * G + q * H + c * Hc + j);
  }
  for (int idx = tid; idx < 2 * R * H; idx += kCThreads) hb[idx] = 0.f;
  for (int idx = tid; idx < R * Hc; idx += kCThreads) cc[idx] = 0.f;
  if (tid < R) lens[tid] = b0 + tid < B ? min(max(lengths[b0 + tid], 0), T) : 0;
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) maxlen = max(maxlen, lens[r]);
  // the steps on which some row of the tile is inside its length (the same for
  // every CTA of the cluster): t < maxlen
  const int s_lo = reverse ? T - maxlen : 0, s_hi = reverse ? T : maxlen;

  // this CTA's gx columns of step s -> ring slot `slot` by cp.async, a float4 a
  // thread; one commit group per call, empty past the last step
  auto prefetch = [&](int s, int slot) {
    if (s < s_hi) {
      const int t = reverse ? T - 1 - s : s;
      for (int idx = tid; idx < R * (LC / 4); idx += kCThreads) {
        const int r = idx / (LC / 4), l = (idx - r * (LC / 4)) * 4;
        const int q = l / Hc, j = l - q * Hc;
        const bool ok = b0 + r < B;
        ss::cp_async16_zfill(gxs + (slot * R + r) * LC + l,
                             ok ? gxd + ((size_t)t * B + b0 + r) * G + q * H + c * Hc + j : gxd,
                             ok);
      }
    }
    asm volatile("cp.async.commit_group;");
  };

  // Partial sums of h @ W[:, own columns] into part. A warp takes a pair of
  // k-slices (one on each half-warp) and 128 of the columns: R rows x 8 columns
  // a thread (two float4s, half the slice apart, so that a half-warp's reads are
  // contiguous); the pair's sums meet by one shuffle.
  const int KS = H / kKSlices, NG = LC / 128;
  auto gate_sums = [&](const float* hrow) {
    for (int item = warp; item < NG * kPairs; item += kCWarps) {
      const int cgp = item % NG, pair = item / NG;
      const int ks = 2 * pair + (lane >> 4), cl = cgp * 16 + (lane & 15);
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
          const float4 u = *reinterpret_cast<const float4*>(w0 + (k + kk) * LC);
          const float4 v = *reinterpret_cast<const float4*>(w1 + (k + kk) * LC);
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

  prefetch(s_lo, 0);
  prefetch(s_lo + 1, 1);
  cluster.sync();  // every CTA's h buffers are zeroed before the first remote write

  for (int s = s_lo; s < s_hi; ++s) {
    const int n = s - s_lo, buf = n & 1, slot = n % kGxStages;
    const int t = reverse ? T - 1 - s : s;
    // h_{t-1}: the pieces the cluster wrote during the last step
    if (n > 0) ss::cluster_wait();
    gate_sums(hb + buf * R * H);
    asm volatile("cp.async.wait_group 1;");  // this step's gx; the next step's may be in flight
    __syncthreads();

    // one item per (row, own unit): the gates, the cell, y and cs, and h_t to
    // every CTA of the cluster
    for (int idx = tid; idx < R * Hc; idx += kCThreads) {
      const int r = idx / Hc, j = idx - r * Hc, b = b0 + r, u = c * Hc + j;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* pq = part + r * LC + q * Hc + j;
        float even = gxs[(slot * R + r) * LC + q * Hc + j], odd = 0.f;
#pragma unroll
        for (int p = 0; p < kPairs; p += 2) {
          even += pq[p * R * LC];
          odd += pq[(p + 1) * R * LC];
        }
        a[q] = even + odd;
      }
      const float c_old = cc[idx];
      const float h_old = hb[(buf * R + r) * H + u];
      const float c_new = ss::sigmoid_sel(a[1]) * c_old + ss::sigmoid_sel(a[0]) * tanhf(a[2]);
      const float h_new = ss::sigmoid_sel(a[3]) * tanhf(c_new);
      const bool valid = t < lens[r];
      const float c_keep = valid ? c_new : c_old;
      const float h_keep = valid ? h_new : h_old;
      cc[idx] = c_keep;
      if (b < B) {
        const size_t o = ((size_t)t * B + b) * H + u;
        yd[o] = valid ? h_new : 0.f;
        csd[o] = c_keep;
      }
      for (int dst = 0; dst < C; ++dst)
        cluster.map_shared_rank(hb, dst)[((buf ^ 1) * R + r) * H + u] = h_keep;
    }
    ss::cluster_arrive();
    // the slot of step s - 1, which every thread of the cluster has read: the
    // wait that let this step start saw them all arrive after it
    prefetch(s + 2, (n + 2) % kGxStages);
  }
  // no CTA leaves while a neighbour may still write into it
  if (s_hi > s_lo) ss::cluster_wait();

  // the steps past every row's length: y = 0; cs the frozen carry (zero on a
  // reversed direction, whose such steps came first)
  for (int idx = tid; idx < (T - maxlen) * R * Hc; idx += kCThreads) {
    const int t = maxlen + idx / (R * Hc), rj = idx % (R * Hc), r = rj / Hc, j = rj - r * Hc;
    if (b0 + r < B) {
      const size_t o = ((size_t)t * B + b0 + r) * H + c * Hc + j;
      yd[o] = 0.f;
      csd[o] = reverse ? 0.f : cc[rj];
    }
  }
  asm volatile("cp.async.wait_all;");
}

// The launch of the cluster route; with `resident` the launch is not made and
// the clusters the card holds at once are counted instead.
template <int R>
cudaError_t launch_cluster(const float* gx, const float* whh, const int* lengths, float* y,
                           float* cs, int D, int T, int B, int H, unsigned rev_bits, int C,
                           cudaStream_t stream, int* resident = nullptr) {
  const size_t smem = sizeof(float) * fwd_plan(H, C, R).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_cluster_kernel<R>,
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
    return cudaOccupancyMaxActiveClusters(resident, lstm_fwd_cluster_kernel<R>, &cfg);
  return cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<R>, gx, whh, lengths, y, cs, T, B, H,
                            rev_bits);
}

// The shapes the cluster route is written for.
inline bool cluster_serves(int H, int C, int R) {
  return (C == 1 || C == 2 || C == 4 || C == 8) && (R == 4 || R == 5 || R == 6 || R == 8) &&
         H % C == 0 && H / C > 0 && (H / C) % 32 == 0 && H % 64 == 0;
}

}  // namespace

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rev_bits: bit d set -> direction d walks time newest-first. cluster = 0
// takes the streaming route; cluster = C in {1, 2, 4, 8} the cluster route with
// tiles of `rows` (4, 5, 6 or 8) batch rows, which needs H / C a multiple of 32,
// H a multiple of 64 and a slice that fits (the wrapper's lstm_fwd_route
// decides; a shape the route does not serve is refused here, never rerouted).
extern "C" int ss_lstm_fwd(const float* gx, const float* whh, const int* lengths,
                           float* y, float* cs, int D, int T, int B, int H,
                           unsigned rev_bits, int cluster, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if (!cluster_serves(H, cluster, rows)) return static_cast<int>(cudaErrorInvalidValue);
#define SS_CLUSTER(R) launch_cluster<R>(gx, whh, lengths, y, cs, D, T, B, H, rev_bits, cluster, st)
    err = rows == 4 ? SS_CLUSTER(4) : rows == 5 ? SS_CLUSTER(5) : rows == 6 ? SS_CLUSTER(6)
                                                                           : SS_CLUSTER(8);
#undef SS_CLUSTER
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * (3 + 4 * (size_t)slices(H)) * kRows * H;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + kRows - 1) / kRows, D);
  lstm_fwd_kernel<<<grid, kThreads, smem, st>>>(gx, whh, lengths, y, cs, T, B, H, rev_bits);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` CTAs with tiles of `rows` rows the card holds
// at once for hidden size H -> *resident (cudaOccupancyMaxActiveClusters).
extern "C" int ss_lstm_fwd_resident_clusters(int H, int cluster, int rows, int device,
                                             int* resident) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cluster_serves(H, cluster, rows)) return static_cast<int>(cudaErrorInvalidValue);
#define SS_RESIDENT(R) \
  launch_cluster<R>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, rows, H, 0u, cluster, \
                    nullptr, resident)
  err = rows == 4 ? SS_RESIDENT(4) : rows == 5 ? SS_RESIDENT(5) : rows == 6 ? SS_RESIDENT(6)
                                                                         : SS_RESIDENT(8);
#undef SS_RESIDENT
  return static_cast<int>(err);
}
