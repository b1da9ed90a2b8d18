// Attend-and-spell backward over L steps, in one kernel: the adjoint of
// spell_fwd.cu.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/spell.py::_bwd_kernel (the
// backward of attend_and_spell_pallas). Per batch row, walking t = L-1 .. 0,
// from the forward's streams (a, h1s, c1s, h2s, c2s, fed; the predecessor
// state of step t is step t-1's, zero at t = 0, and the embedding fed into
// step t is fed[t-1], emb[SOS] at t = 0), the cotangents dlogits [L, B, V]
// and daext [L, B, S] (on the returned attention maps):
//   recompute  q = tanh(h1_p @ phi), ctx = a @ enc, gates1 = b1 + [fed_p |
//              ctx] @ W_ih1 + h1_p @ W_hh1, gates2 = b2 + h1 @ W_ih2 + h2_p @ W_hh2;
//   layer 2    dh2 = dh2_carry + dlogits @ ct_w^T; the LSTM cell adjoint ->
//              dgates2, dc2_carry = dct2 * f2; dh2_carry = dgates2 @ W_hh2^T;
//   layer 1    dh1 = dh1_carry + dgates2 @ W_ih2^T; the cell adjoint ->
//              dgates1, dc1_carry; dx = dgates1 @ W_ih1^T = [demb | dctx];
//   attention  da = enc @ dctx + daext; de = a * da - a * sum(a * da);
//              dqpre = (de @ comp) * (1 - q^2);
//              dh1_carry = dgates1 @ W_hh1^T + dqpre @ phi^T
// and writes per step dgates1, dgates2 [L, B, 4H], de [L, B, S], dqpre
// [L, B, M] and demb [L, B, H]. Every weight gradient, d_enc, d_comp and the
// routing of demb to the embedding table are batched products outside the
// kernel, as in the JAX package.
//
// On the cluster route the gates come from the forward (spell_fwd.cu writes
// them), so no step recomputes them.
//
// What bounds it on an H100: each step runs the transposed products of the
// speller's weights (about 6.3 MB f32 at the flagship size) for a handful
// of rows; the TPU kernel's batch block (up to 48 rows a grid step) makes
// each weight read serve the block's rows. Two routes; the shape decides
// (ops/kernels/spell.py::spell_route):
//
// * The cluster route (spell_bwd_cluster_kernel). A thread-block cluster of
//   C = H / 32 CTAs takes a tile of R batch rows (4, 5, 6 or 8), CTA c
//   owning 32 units of each cell and their 128 gate columns, as in the
//   forward's cluster route. The products with a transposed weight read a
//   transposed copy made once per call (pack_transpose: [W_ih1 | W_hh1]^T
//   and [W_ih2 | W_hh2]^T, 6.3 MB each way, a few microseconds), so that
//   a CTA's 128 gate rows of it are contiguous: each thread keeps R x 4
//   partial sums of a float4 of outputs over its share of the 128 rows, and
//   the cluster reduce-scatters the partials through distributed shared
//   memory (each CTA sums the C partials of the outputs it owns: its units
//   of dh1 / dh2 / demb and its F / C columns of the context's cotangent).
//   Three cluster barriers a step: (1) after dg2 @ [W_ih2 | W_hh2]^T (the
//   query's own columns run behind it), (2) after dg1 @ [W_ih1 | W_hh1]^T,
//   (3) after the context's cotangent times the CTA's enc columns, all-
//   reduced into da; then the softmax adjoint (every CTA alike), dqpre of
//   the own query columns and its product with phi^T, whose partials reach
//   the owners before the next step's first barrier. The step's stream rows
//   are fetched at once by cp.async; ct_w's own rows and phi's own columns
//   stay in shared memory. What bounds it (ops/kernels/spell_probe.py
//   --trace): the transposed products, each CTA's 768 KB of transposed-weight
//   rows a step, take 45 % of a step at about half the rate K9 draws from
//   L2; the rest is the chain of phases around the three barriers.
// * The one-row route (spell_bwd_kernel), for shapes no cluster serves: one
//   block of 1024 threads per batch row with the step loop inside, the
//   row's state and carries in shared memory; it recomputes the forward's
//   gates (lstm_gates) and runs the six transposed products with rowdot (a
//   warp per output, reading the weight's row contiguously). Each step
//   streams every speller weight twice from L2 into one SM for a single
//   row: about 12.5 MB f32 per row-step at the flagship.

#include <cooperative_groups.h>

#include "common.cuh"
#include "speller.cuh"

namespace cg = cooperative_groups;

namespace {

struct SpellBwd {
  const float* enc;      // [B, S, F] listener output
  const float* comp;     // [B, S, M] tanh(psi(enc))
  const float* dlogits;  // [L, B, V]
  const float* daext;    // [L, B, S] cotangent on the attention maps
  const float* att;      // [L, B, S] the forward's streams
  const float* h1s;      // [L, B, H]
  const float* c1s;
  const float* h2s;
  const float* c2s;
  const float* fed;      // [L, B, H] embedding fed after each step
  const float* phi;      // [H, M]
  const float* wih1;     // [H + F, 4H]
  const float* whh1;     // [H, 4H]
  const float* b1;       // [4H]
  const float* wih2;     // [H, 4H]
  const float* whh2;     // [H, 4H]
  const float* b2;       // [4H]
  const float* ct_w;     // [H, V]
  const float* emb;      // [V, H]
  const float* g1s;      // [L, B, 4H] the forward's gate pre-activations (cluster route)
  const float* g2s;
  const float* wt1;      // [4H, 2H + F] [W_ih1 | W_hh1]^T (cluster route)
  const float* wt2;      // [4H, 2H] [W_ih2 | W_hh2]^T
  float* dg1;            // [L, B, 4H]
  float* dg2;            // [L, B, 4H]
  float* de;             // [L, B, S]
  float* dqp;            // [L, B, M]
  float* demb;           // [L, B, H]
  int B, S, F, M, H, V, L;
};

__host__ __device__ inline int part_floats(int H) {
  return 4 * H * slices(H) > kThreads ? 4 * H * slices(H) : kThreads;
}

size_t smem_floats(const SpellBwd& p) {
  return 2 * (size_t)p.M + 2 * (size_t)p.S + 2 * ((size_t)p.H + p.F) + 24 * (size_t)p.H +
         p.V + 4 + part_floats(p.H);
}

// The LSTM cell's adjoint for unit u of one row, from its gate
// pre-activations g [4H], its cell state c and predecessor c_p: writes
// dgates to dg[4H] and the stream `out`, and updates the dc carry.
__device__ __forceinline__ void cell_adjoint(const float* g, int H, int u, float dh, float c,
                                             float c_p, float* dc, float* dg, float* out) {
  const float ig = ss::sigmoid(g[u]), fg = ss::sigmoid(g[H + u]);
  const float gg = tanhf(g[2 * H + u]), og = ss::sigmoid(g[3 * H + u]);
  const float tanh_c = tanhf(c);
  const float dct = dh * og * (1.f - tanh_c * tanh_c) + dc[u];
  const float v[4] = {dct * gg * ig * (1.f - ig), dct * c_p * fg * (1.f - fg),
                      dct * ig * (1.f - gg * gg), dh * tanh_c * og * (1.f - og)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dg[q * H + u] = v[q];
    out[q * H + u] = v[q];
  }
  dc[u] = dct * fg;
}

__global__ void __launch_bounds__(kThreads) spell_bwd_kernel(SpellBwd p) {
  extern __shared__ float smem[];
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, B = p.B, G = 4 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q = smem;          // [M] attention query
  float* dq = q + M;        // [M] query cotangent, then dqpre
  float* a = dq + M;        // [S] attention weights
  float* da = a + S;        // [S] their cotangent, then de
  float* x = da + S;        // [H + F] fed embedding | context
  float* dx = x + H + F;    // [H + F] demb | dctx
  float* h1p = dx + H + F;  // [H]
  float* h2p = h1p + H;     // [H]
  float* h1 = h2p + H;      // [H]
  float* dh1 = h1 + H;      // [H]
  float* dh1c = dh1 + H;    // [H] carries
  float* dc1c = dh1c + H;
  float* dh2c = dc1c + H;
  float* dc2c = dh2c + H;
  float* g1 = dc2c + H;     // [4H] gate pre-activations
  float* g2 = g1 + G;
  float* dg1 = g2 + G;      // [4H] gate cotangents
  float* dg2 = dg1 + G;
  float* dlog = dg2 + G;    // [V]
  float* red = dlog + V;    // [4]
  float* part = red + 4;    // partial sums of the split reductions

  const int b = blockIdx.x;
  const float* enc = p.enc + (size_t)b * S * F;
  const float* comp = p.comp + (size_t)b * S * M;

  for (int i = tid; i < 4 * H; i += blockDim.x) dh1c[i] = 0.f;  // the four carries
  __syncthreads();

  for (int t = p.L - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b;     // this row's slot in the [L, B, .] streams
    const size_t prow = row - (size_t)B;      // step t-1's (used only when t > 0)

    for (int i = tid; i < H; i += blockDim.x) {
      h1p[i] = t > 0 ? p.h1s[prow * H + i] : 0.f;
      h2p[i] = t > 0 ? p.h2s[prow * H + i] : 0.f;
      h1[i] = p.h1s[row * H + i];
      x[i] = t > 0 ? p.fed[prow * H + i] : p.emb[(size_t)kSOS * H + i];
    }
    for (int s = tid; s < S; s += blockDim.x) a[s] = p.att[row * S + s];
    for (int v = tid; v < V; v += blockDim.x) dlog[v] = p.dlogits[row * V + v];
    __syncthreads();

    // recompute the forward's query, context and gate pre-activations
    matvec(h1p, H, p.phi, M, nullptr, part, q, true);
    matvec(a, S, enc, F, nullptr, part, x + H, false);
    lstm_gates(x, H + F, p.wih1, h1p, p.whh1, p.b1, H, part, g1);
    lstm_gates(h1, H, p.wih2, h2p, p.whh2, p.b2, H, part, g2);

    // layer 2
    rowdot(dlog, V, p.ct_w, H, dh2c, dh2c);  // dh2 = carry + dlogits @ ct_w^T
    for (int u = tid; u < H; u += blockDim.x) {
      const float c_p = t > 0 ? p.c2s[prow * H + u] : 0.f;
      cell_adjoint(g2, H, u, dh2c[u], p.c2s[row * H + u], c_p, dc2c, dg2, p.dg2 + row * G);
    }
    __syncthreads();
    rowdot(dg2, G, p.whh2, H, nullptr, dh2c);
    rowdot(dg2, G, p.wih2, H, dh1c, dh1);

    // layer 1
    for (int u = tid; u < H; u += blockDim.x) {
      const float c_p = t > 0 ? p.c1s[prow * H + u] : 0.f;
      cell_adjoint(g1, H, u, dh1[u], p.c1s[row * H + u], c_p, dc1c, dg1, p.dg1 + row * G);
    }
    __syncthreads();
    rowdot(dg1, G, p.whh1, H, nullptr, dh1c);
    rowdot(dg1, G, p.wih1, H + F, nullptr, dx);
    for (int i = tid; i < H; i += blockDim.x) p.demb[row * H + i] = dx[i];

    // attention: the context path plus the maps' own cotangent, softmax VJP
    rowdot(dx + H, F, enc, S, p.daext + row * S, da);
    if (warp == 0) {
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) sum += a[s] * da[s];
      sum = ss::warp_sum(sum);
      if (lane == 0) red[0] = sum;
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
      const float e = a[s] * da[s] - a[s] * red[0];
      da[s] = e;
      p.de[row * S + s] = e;
    }
    __syncthreads();
    matvec(da, S, comp, M, nullptr, part, dq, false);
    for (int m = tid; m < M; m += blockDim.x) {
      const float v = dq[m] * (1.f - q[m] * q[m]);
      dq[m] = v;
      p.dqp[row * M + m] = v;
    }
    __syncthreads();
    rowdot(dq, M, p.phi, H, dh1c, dh1c);  // dh1 carry += dqpre @ phi^T
  }
}

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// Partials of one transposed product over the K columns of a [4H, K] copy.
__host__ __device__ inline size_t tprod_floats(int K, int R) {
  const int P = kSpThreads / (K / 4) > 1 ? kSpThreads / (K / 4) : 1;
  return (size_t)P * R * K;
}

// How a cluster CTA lays out its shared memory (offsets in floats); the
// wrapper's spell_bwd_smem_bytes mirrors it.
struct BwdPlan {
  size_t dlog, a, da, h1p, qs, dq, dg, carry, dctx, part, spart, sa, sb, sc, sd, ctwo, phis,
      gates, cells, dax, rows, total;
};

__host__ __device__ inline BwdPlan bwd_plan(int H, int F, int M, int S, int V, int R) {
  const int C = H / 32, Fc = F / C, Mc = M / C;
  const size_t t1 = tprod_floats(2 * H + F, R), t2 = tprod_floats(2 * H, R);
  BwdPlan p;
  size_t o = 0;
  p.dlog = o, o += round4((size_t)R * V);
  p.a = o, o += round4((size_t)R * S);
  p.da = o, o += round4((size_t)R * S);
  p.h1p = o, o += round4((size_t)R * H);
  p.qs = o, o += round4((size_t)R * Mc);
  p.dq = o, o += round4((size_t)R * Mc);
  p.dg = o, o += round4((size_t)R * kSpCols);
  p.carry = o, o += round4(4 * (size_t)R * kSpUnits);  // dh1, dc1, dh2, dc2 of the own units
  p.dctx = o, o += round4((size_t)R * Fc);
  p.part = o, o += round4(t1 > t2 ? t1 : t2);
  p.spart = o, o += round4((size_t)kSpThreads * (R > 4 ? R : 4));
  p.sa = o, o += round4((size_t)C * R * 2 * kSpUnits);     // [src][R][dh1 | dh2 parts]
  p.sb = o, o += round4((size_t)C * R * (2 * kSpUnits + Fc));  // [src][R][demb | dctx | dh1]
  p.sc = o, o += round4((size_t)C * R * S);                // [src][R][da part]
  p.sd = o, o += round4((size_t)C * R * kSpUnits);         // [src][R][dqpre @ phi^T part]
  p.ctwo = o, o += round4((size_t)kSpUnits * V);           // ct_w's own rows, resident
  p.phis = o, o += round4((size_t)H * (Mc + 1));           // phi's own columns, resident
  p.gates = o, o += 2 * (size_t)R * kSpCols;               // the step's g1, g2 own columns
  p.cells = o, o += 4 * (size_t)R * kSpUnits;              // c1, c1 of t-1, c2, c2 of t-1
  p.dax = o, o += round4((size_t)R * S);                   // daext
  p.rows = o, o += round4(R);
  p.total = o;
  return p;
}

inline bool bwd_cluster_serves(int H, int F, int M, int S, int V, int R) {
  const int C = H / 32;
  return H % 32 == 0 && (C == 1 || C == 2 || C == 4 || C == 8) && F % (4 * C) == 0 &&
         F / C <= kSpThreads && M % (4 * C) == 0 && M / C <= kSpThreads && V >= 1 &&
         V <= kSpThreads && S >= 1 && (R == 4 || R == 5 || R == 6 || R == 8) &&
         sizeof(float) * bwd_plan(H, F, M, S, V, R).total <= kMaxSmem;
}

// dst[g * ldd + koff + k] = src[k * cols + g] for k < rows, g < cols: a
// 32 x 32 tile a block, through shared memory.
__global__ void pack_transpose(const float* __restrict__ src, int rows, int cols, float* dst,
                               int ldd, int koff) {
  __shared__ float tile[32][33];
  const int g0 = blockIdx.x * 32, k0 = blockIdx.y * 32, tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8)
    if (k0 + j < rows && g0 + tx < cols) tile[j][tx] = src[(size_t)(k0 + j) * cols + g0 + tx];
  __syncthreads();
  for (int j = ty; j < 32; j += 8)
    if (g0 + j < cols && k0 + tx < rows) dst[(size_t)(g0 + j) * ldd + koff + k0 + tx] = tile[tx][j];
}

// The partial sums over this CTA's 128 gate rows of dg @ WT, WT a [4H, K]
// transposed copy: out[r][k] = sum_i dg[r * 128 + i] * WT[g(i) * K + k], g(i)
// = (i / 32) H + u0 + i % 32. A thread takes a float4 of outputs and a slice
// of the rows (P = kSpThreads / (K / 4) interleaved slices, meeting in
// part); sink(r, k, float4) gets each four outputs. Ends with a barrier.
template <int R, class Sink>
__device__ void sp_tprod(const float* dg, const float* __restrict__ WT, int K, int H, int u0,
                         float* part, Sink sink) {
  constexpr int U = kSpDepth;
  const int K4 = K / 4, P = max(1, kSpThreads / K4);
  for (int idx = threadIdx.x; idx < P * K4; idx += kSpThreads) {
    const int k4 = idx % K4, pp = idx / K4;
    const float4* wt = reinterpret_cast<const float4*>(WT) + k4;
    auto row = [&](int i) { return (size_t)((i >> 5) * H + u0 + (i & 31)) * K4; };
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    auto fma4 = [&](int i, const float4& w) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = dg[r * kSpCols + i];
        acc[r][0] = fmaf(d, w.x, acc[r][0]);
        acc[r][1] = fmaf(d, w.y, acc[r][1]);
        acc[r][2] = fmaf(d, w.z, acc[r][2]);
        acc[r][3] = fmaf(d, w.w, acc[r][3]);
      }
    };
    int i = pp;
    for (; i + (U - 1) * P < kSpCols; i += U * P) {
      float4 w[U];
#pragma unroll
      for (int m = 0; m < U; ++m) w[m] = __ldg(wt + row(i + m * P));
#pragma unroll
      for (int m = 0; m < U; ++m) fma4(i + m * P, w[m]);
    }
    for (; i < kSpCols; i += P) fma4(i, __ldg(wt + row(i)));
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(part + (size_t)(pp * R + r) * K + 4 * k4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * K4; idx += kSpThreads) {
    const int r = idx / K4, k4 = idx % K4;
    float4 s = *reinterpret_cast<const float4*>(part + (size_t)r * K + 4 * k4);
    for (int pp = 1; pp < P; ++pp) {
      const float4 v = *reinterpret_cast<const float4*>(part + (size_t)(pp * R + r) * K + 4 * k4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    sink(r, 4 * k4, s);
  }
  __syncthreads();
}

// The LSTM cell's adjoint for own unit j of a row from the forward's gates
// at the own columns g ([128], q * 32 + j): the own gates' cotangents to
// dg[q * 32] and, for a real row, to the stream `out` (at out[q * H]); the
// dc carry updated in place.
__device__ __forceinline__ void cell_adjoint_own(const float* g, int j, float dh, float c,
                                                 float c_p, float* dc, float* dg, float* out,
                                                 int H) {
  const float ig = ss::sigmoid(g[j]), fg = ss::sigmoid(g[kSpUnits + j]);
  const float gg = tanhf(g[2 * kSpUnits + j]), og = ss::sigmoid(g[3 * kSpUnits + j]);
  const float tanh_c = tanhf(c);
  const float dct = dh * og * (1.f - tanh_c * tanh_c) + *dc;
  const float v[4] = {dct * gg * ig * (1.f - ig), dct * c_p * fg * (1.f - fg),
                      dct * ig * (1.f - gg * gg), dh * tanh_c * og * (1.f - og)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dg[q * kSpUnits] = v[q];
    if (out) out[q * H] = v[q];
  }
  *dc = dct * fg;
}

template <int R>
__global__ void __launch_bounds__(kSpThreads, 1) spell_bwd_cluster_kernel(SpellBwd p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, c = blockIdx.x;  // the cluster spans the grid's x
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, B = p.B, G = 4 * H;
  const int Fc = F / C, f0 = c * Fc, Mc = M / C, m0 = c * Mc, u0 = c * kSpUnits;
  const int K1 = 2 * H + F, K2 = 2 * H, NB = 2 * kSpUnits + Fc;
  const BwdPlan P = bwd_plan(H, F, M, S, V, R);
  float* dlog = smem + P.dlog;  // [R][V]
  float* a = smem + P.a;        // [R][S] attention weights
  float* da = smem + P.da;      // [R][S] their cotangent, then de
  float* h1p = smem + P.h1p;    // [R][H] h1 entering the step
  float* qs = smem + P.qs;      // [R][Mc] the own query columns
  float* dq = smem + P.dq;      // [R][Mc] dqpre of the own columns
  float* dg = smem + P.dg;      // [R][128] the own gate cotangents (cell 2, then cell 1)
  float* dh1c = smem + P.carry;  // [R][32] carries of the own units
  float* dc1c = dh1c + R * kSpUnits;
  float* dh2c = dc1c + R * kSpUnits;
  float* dc2c = dh2c + R * kSpUnits;
  float* dctx = smem + P.dctx;   // [R][Fc] the own context columns' cotangent
  float* part = smem + P.part;   // sp_tprod partials
  float* spart = smem + P.spart;  // sp_colprod / sp_rowsum partials
  float* sa = smem + P.sa;       // reduce-scatter slots, written by every CTA
  float* sb = smem + P.sb;
  float* sc = smem + P.sc;
  float* sd = smem + P.sd;
  float* ctwo = smem + P.ctwo;    // [32][V] ct_w's rows of the own units
  float* phis = smem + P.phis;    // [H][Mc + 1] phi[:, m0 : m0 + Mc], padded against bank conflicts
  float* g2o = smem + P.gates;    // [R][128] the step's gates at the own columns
  float* g1o = g2o + R * kSpCols;
  float* c1t = smem + P.cells;    // [R][32] c1 of the own units at t, then at t - 1
  float* c1p = c1t + R * kSpUnits;
  float* c2t = c1p + R * kSpUnits;
  float* c2p = c2t + R * kSpUnits;
  float* dax = smem + P.dax;      // [R][S] daext
  int* rows = reinterpret_cast<int*>(smem + P.rows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * R;
  if (tid < R) rows[tid] = min(b0 + tid, B - 1);
  for (int i = tid; i < 4 * R * kSpUnits; i += kSpThreads) dh1c[i] = 0.f;  // the four carries
  for (int i = tid; i < C * R * kSpUnits; i += kSpThreads) sd[i] = 0.f;
  for (int i = tid; i < kSpUnits * V; i += kSpThreads) ctwo[i] = p.ct_w[(size_t)u0 * V + i];
  for (int i = tid; i < H * Mc; i += kSpThreads)
    phis[(i / Mc) * (Mc + 1) + i % Mc] = p.phi[(size_t)(i / Mc) * M + m0 + i % Mc];
  cluster.sync();  // every CTA is running and initialised before the first remote write

  for (int t = p.L - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * B;  // + batch row: a slot of the [L, B, .] streams
    // every stream row the step reads, all in flight at once (cp.async)
    for (int i = tid; i < R * V; i += kSpThreads)
      ss::cp_async4_zfill(dlog + i, p.dlogits + (row0 + rows[i / V]) * V + i % V, true);
    for (int i = tid; i < R * S; i += kSpThreads) {
      const size_t o = (row0 + rows[i / S]) * S + i % S;
      ss::cp_async4_zfill(a + i, p.att + o, true);
      ss::cp_async4_zfill(dax + i, p.daext + o, true);
    }
    for (int i = tid; i < R * H; i += kSpThreads)
      ss::cp_async4_zfill(h1p + i, t > 0 ? p.h1s + (row0 - B + rows[i / H]) * H + i % H : p.h1s,
                          t > 0);
    for (int i = tid; i < 2 * R * kSpCols; i += kSpThreads) {
      const int r = (i / kSpCols) % R, l = i % kSpCols;
      const size_t g = (row0 + rows[r]) * G + (l / kSpUnits) * H + u0 + l % kSpUnits;
      ss::cp_async4_zfill(g2o + i, (i < R * kSpCols ? p.g2s : p.g1s) + g, true);
    }
    for (int i = tid; i < R * kSpUnits; i += kSpThreads) {
      const size_t o = (row0 + rows[i / kSpUnits]) * H + u0 + i % kSpUnits;
      ss::cp_async4_zfill(c1t + i, p.c1s + o, true);
      ss::cp_async4_zfill(c2t + i, p.c2s + o, true);
      ss::cp_async4_zfill(c1p + i, t > 0 ? p.c1s + o - (size_t)B * H : p.c1s, t > 0);
      ss::cp_async4_zfill(c2p + i, t > 0 ? p.c2s + o - (size_t)B * H : p.c2s, t > 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // (1) cell 2: dh2 = carry + dlogits @ ct_w^T (own units); the cell adjoint;
    // then dg2 @ [W_ih2 | W_hh2]^T, reduce-scattered
    for (int idx = tid; idx < R * kSpUnits; idx += kSpThreads) {
      const int r = idx / kSpUnits, j = idx % kSpUnits, u = u0 + j;
      const size_t o = row0 + rows[r];
      float dh = dh2c[idx];
      for (int v = 0; v < V; ++v) dh = fmaf(dlog[r * V + v], ctwo[j * V + v], dh);
      cell_adjoint_own(g2o + r * kSpCols, j, dh, c2t[idx], c2p[idx], dc2c + idx,
                       dg + r * kSpCols + j, b0 + r < B ? p.dg2 + o * G + u : nullptr, H);
    }
    __syncthreads();
    sp_tprod<R>(dg, p.wt2, K2, H, u0, part, [&](int r, int k, float4 v) {
      const int d = (k % H) / kSpUnits, off = (k >= H ? kSpUnits : 0) + k % kSpUnits;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(sa, d) + (c * R + r) * 2 * kSpUnits +
                                 off) = v;
    });
    ss::cluster_arrive();
    sp_colprod<R>(h1p, H, H, phis, Mc + 1, Mc, nullptr, spart,
                  [&](int r, int j, float v) { qs[r * Mc + j] = tanhf(v); });
    ss::cluster_wait();

    // (2) cell 1: dh1 = carry + the cluster's sums; the cell adjoint; then dg1 @
    // [W_ih1 | W_hh1]^T, reduce-scattered: demb, the context's cotangent, the
    // dh1 carry
    for (int idx = tid; idx < R * kSpUnits; idx += kSpThreads) {
      const int r = idx / kSpUnits, j = idx % kSpUnits, u = u0 + j;
      const size_t o = row0 + rows[r];
      float dh2 = 0.f, dh = dh1c[idx];
      for (int src = 0; src < C; ++src) {
        const float* s = sa + (src * R + r) * 2 * kSpUnits;
        dh += s[j];
        dh2 += s[kSpUnits + j];
      }
      for (int src = 0; src < C; ++src) dh += sd[(src * R + r) * kSpUnits + j];
      dh2c[idx] = dh2;
      cell_adjoint_own(g1o + r * kSpCols, j, dh, c1t[idx], c1p[idx], dc1c + idx,
                       dg + r * kSpCols + j, b0 + r < B ? p.dg1 + o * G + u : nullptr, H);
    }
    __syncthreads();
    sp_tprod<R>(dg, p.wt1, K1, H, u0, part, [&](int r, int k, float4 v) {
      int d, off;
      if (k < H) {
        d = k / kSpUnits, off = k % kSpUnits;
      } else if (k < H + F) {
        d = (k - H) / Fc, off = kSpUnits + (k - H) % Fc;
      } else {
        d = (k - H - F) / kSpUnits, off = kSpUnits + Fc + (k - H - F) % kSpUnits;
      }
      *reinterpret_cast<float4*>(cluster.map_shared_rank(sb, d) + (c * R + r) * NB + off) = v;
    });
    ss::cluster_arrive();
    ss::cluster_wait();
    for (int idx = tid; idx < R * NB; idx += kSpThreads) {
      const int r = idx / NB, o = idx % NB;
      float s = 0.f;
      for (int src = 0; src < C; ++src) s += sb[(src * R + r) * NB + o];
      if (o < kSpUnits) {
        if (b0 + r < B) p.demb[(row0 + rows[r]) * H + u0 + o] = s;
      } else if (o < kSpUnits + Fc) {
        dctx[r * Fc + o - kSpUnits] = s;
      } else {
        dh1c[r * kSpUnits + o - kSpUnits - Fc] = s;
      }
    }
    __syncthreads();

    // (3) da: the context's share (enc's own columns . dctx), all-reduced
    sp_dots(R, S, 0, 1, dctx, Fc, p.enc, rows, (size_t)S * F, F, f0, Fc,
            [&](int r, int s, float v) {
              for (int d = 0; d < C; ++d) cluster.map_shared_rank(sc, d)[(c * R + r) * S + s] = v;
            });
    ss::cluster_arrive();
    ss::cluster_wait();

    // (4) the softmax adjoint (every CTA alike); dqpre of the own query columns
    for (int r = warp; r < R; r += kSpWarps) {
      const size_t o = row0 + rows[r];
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        float v = dax[r * S + s];
        for (int src = 0; src < C; ++src) v += sc[(src * R + r) * S + s];
        const float ada = a[r * S + s] * v;
        da[r * S + s] = ada;
        sum += ada;
      }
      sum = ss::warp_sum(sum);
      for (int s = lane; s < S; s += 32) {
        const float e = da[r * S + s] - a[r * S + s] * sum;
        da[r * S + s] = e;
        if (s % C == c && b0 + r < B) p.de[o * S + s] = e;
      }
    }
    __syncthreads();
    sp_rowsum<R>(da, S, S, p.comp, rows, (size_t)S * M, M, m0, Mc, spart,
                 [&](int r, int j, float v) {
                   const float qv = qs[r * Mc + j];
                   const float d = v * (1.f - qv * qv);
                   dq[r * Mc + j] = d;
                   if (b0 + r < B) p.dqp[(row0 + rows[r]) * M + m0 + j] = d;
                 });

    // (5) dqpre @ phi^T over the own columns, to the owners of the units, for
    // the next step's dh1 (none after the last)
    if (t > 0) {
      for (int idx = tid; idx < R * H; idx += kSpThreads) {
        const int r = idx / H, k = idx % H;
        const float* ph = phis + k * (Mc + 1);
        float s = 0.f;
        for (int j = 0; j < Mc; ++j) s = fmaf(dq[r * Mc + j], ph[j], s);
        cluster.map_shared_rank(sd, k / kSpUnits)[(c * R + r) * kSpUnits + k % kSpUnits] = s;
      }
    }
  }
}

template <int R>
cudaError_t launch_bwd_cluster(const SpellBwd& p, cudaStream_t stream) {
  const int C = p.H / 32;
  const size_t smem = sizeof(float) * bwd_plan(p.H, p.F, p.M, p.S, p.V, R).total;
  cudaError_t err = cudaFuncSetAttribute(spell_bwd_cluster_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (p.B + R - 1) / R, 1);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, spell_bwd_cluster_kernel<R>, p);
}

// The transposed copies of the cells' weights into wt1 [4H, 2H + F] and wt2
// [4H, 2H].
cudaError_t pack_weights(const SpellBwd& p, cudaStream_t st) {
  const int H = p.H, F = p.F, G = 4 * H, K1 = 2 * H + F, K2 = 2 * H;
  float* wt1 = const_cast<float*>(p.wt1);
  float* wt2 = const_cast<float*>(p.wt2);
  const dim3 block(32, 8);
  auto grid = [&](int rows) { return dim3((G + 31) / 32, (rows + 31) / 32); };
  pack_transpose<<<grid(H + F), block, 0, st>>>(p.wih1, H + F, G, wt1, K1, 0);
  pack_transpose<<<grid(H), block, 0, st>>>(p.whh1, H, G, wt1, K1, H + F);
  pack_transpose<<<grid(H), block, 0, st>>>(p.wih2, H, G, wt2, K2, 0);
  pack_transpose<<<grid(H), block, 0, st>>>(p.whh2, H, G, wt2, K2, H);
  return cudaGetLastError();
}

}  // namespace

// rows = 0 takes the one-row route (g1s, g2s, wt1, wt2 unused); rows in {4,
// 5, 6, 8} the cluster route with tiles of that many batch rows and
// clusters of H / 32 CTAs, which reads the forward's gates g1s / g2s and
// first fills the scratch wt1 [4H, 2H + F] and wt2 [4H, 2H] with the
// transposed cell weights. The wrapper's spell_route decides; a shape the
// cluster route does not serve is refused here, never rerouted.
extern "C" int ss_spell_bwd(const float* enc, const float* comp, const float* dlogits,
                            const float* daext, const float* att, const float* h1s,
                            const float* c1s, const float* h2s, const float* c2s,
                            const float* fed, const float* phi, const float* wih1,
                            const float* whh1, const float* b1, const float* wih2,
                            const float* whh2, const float* b2, const float* ct_w,
                            const float* emb, const float* g1s, const float* g2s, float* wt1,
                            float* wt2, float* dg1, float* dg2, float* de, float* dqp,
                            float* demb, int B, int S, int F, int M, int H, int V, int L,
                            int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SpellBwd p{enc,  comp, dlogits, daext, att, h1s, c1s, h2s,  c2s, fed, phi, wih1,
                   whh1, b1,   wih2,    whh2,  b2,  ct_w, emb, g1s,  g2s, wt1, wt2, dg1,
                   dg2,  de,   dqp,     demb,  B,   S,    F,   M,    H,   V,   L};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 0) {
    if (!bwd_cluster_serves(H, F, M, S, V, rows) || !g1s || !g2s || !wt1 || !wt2)
      return static_cast<int>(cudaErrorInvalidValue);
    err = pack_weights(p, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = rows == 4 ? launch_bwd_cluster<4>(p, st)
        : rows == 5 ? launch_bwd_cluster<5>(p, st)
        : rows == 6 ? launch_bwd_cluster<6>(p, st)
                    : launch_bwd_cluster<8>(p, st);
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * smem_floats(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spell_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spell_bwd_kernel<<<B, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
