// Attend-and-spell forward over L steps with teacher forcing / scheduled
// sampling, in one kernel.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/spell.py::_fwd_kernel (the
// forward of attend_and_spell_pallas). Per step t, for each batch row:
//   q = tanh(h1 @ phi); a = softmax(comp . q), -inf past max(len, 1);
//   context = a @ enc; (h1, c1) = LSTM([fed | context], h1, c1);
//   (h2, c2) = LSTM(h1, h2, c2); logits = h2 @ ct_w + ct_b;
//   sampled = argmax(logits + gumbel[t]) (lowest index among equal maxima);
//   fed = tf[t] > 0.5 ? teacher_emb[t] : emb[sampled]  (fed at step 0: emb[SOS])
// and writes the seven streams the backward needs: logits, a, h1, c1, h2,
// c2 and fed, each [L, B, .]. The random numbers (one Bernoulli draw per
// step shared by the batch, Gumbel noise per row) are inputs, drawn by the
// caller as the JAX package draws them outside its kernel. With tf = 0 and
// zero noise the feedback is greedy. The cluster route also writes, where
// asked, the gate pre-activations of both cells [L, B, 4H] (g1s, g2s), from
// which the backward (spell_bwd.cu) takes its gates instead of recomputing
// them.
//
// What bounds it on an H100: each step is a chain of dependent products
// over the speller's weights (about 6.3 MB f32 at the flagship size) for a
// handful of rows: the whole batch's step is about 100 MFLOP, but the
// weights must be read once per step. The TPU kernel's batch block (up to
// 48 rows a grid step, ss_asr_tpu/ops/pallas/spell.py:_batch_block) is
// exactly that reuse: every weight read serves the block's rows. Two routes;
// the shape decides (ops/kernels/spell.py::spell_route):
//
// * The cluster route (spell_fwd_cluster_kernel). A thread-block cluster of
//   C = H / 32 CTAs takes a tile of R batch rows (4, 5, 6 or 8; B = 32 takes
//   8 clusters of 4 rows). CTA c owns 32 hidden units of each cell and their
//   128 gate columns, and streams only those columns of W_ih1, W_hh1, W_ih2,
//   W_hh2 from L2 each step (786 KB at the flagship, an eighth), each
//   element serving the tile's R rows from registers (R x 4 FMA per float4).
//   The attention is split too: CTA c scores the positions s = c (mod C)
//   and forms the context's F / C columns. Four cluster barriers a step,
//   each split so that independent work runs between arrive and wait:
//   (1) the energies all-gathered (the gate product with the fed embedding
//   runs behind it), (2) the context all-gathered, (3) h1_t all-gathered
//   (the h2 product of cell 2 behind it), (4) h2_t and the next query's
//   columns all-gathered (the next step's h1 @ W_hh1 behind it). The logits
//   (a [H, V] product with ct_w resident in shared memory) and the sampling
//   argmax run in every CTA alike, so every CTA feeds the same embedding
//   without a fifth barrier; the fed embedding and the noise are fetched by
//   cp.async behind the first barrier, the streams stored behind the others.
//   What bounds it (a phase trace, ops/kernels/spell_probe.py --trace): about
//   a third of a step streams the CTA's weight columns at the rate one SM
//   draws from L2 (~100 GB/s; eight or sixteen rows in flight measure the
//   same), the rest is the chain of short dependent phases between the
//   barriers (the attention over device memory, the cells, the logits); the
//   FMA issue (R x 200 K a CTA a step) is below both.
// * The one-row route (spell_fwd_kernel), for shapes no cluster serves (H
//   not a multiple of 32, more than 8 CTAs, or buffers past shared memory):
//   one block of 1024 threads per batch row with the step loop inside, as the
//   greedy decode kernel (greedy_decode.cu), whose device functions it shares
//   (speller.cuh). Each step streams all speller weights from L2 into one
//   SM for a single row: about 80 us a step at the flagship.

#include <climits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "speller.cuh"

namespace cg = cooperative_groups;

namespace {

struct Spell {
  const float* enc;     // [B, S, F] listener output
  const float* comp;    // [B, S, M] tanh(psi(enc))
  const int* lens;      // [B] listener lengths, clamped to >= 1
  const float* tf;      // [L] teacher-forcing draws, 0 or 1
  const float* gumbel;  // [L, B, V] sampling noise
  const float* temb;    // [L, B, H] teacher embeddings to feed after each step
  const float* phi;     // [H, M]
  const float* wih1;    // [H + F, 4H]
  const float* whh1;    // [H, 4H]
  const float* b1;      // [4H]
  const float* wih2;    // [H, 4H]
  const float* whh2;    // [H, 4H]
  const float* b2;      // [4H]
  const float* ct_w;    // [H, V]
  const float* ct_b;    // [V]
  const float* emb;     // [V, H]
  float* logits;        // [L, B, V]
  float* att;           // [L, B, S]
  float* h1s;           // [L, B, H]
  float* c1s;
  float* h2s;
  float* c2s;
  float* fed;           // [L, B, H]
  float* g1s;           // [L, B, 4H] gate pre-activations (cluster route; may be null)
  float* g2s;
  int B, S, F, M, H, V, L;
};

__host__ __device__ inline int part_floats(int H) {
  return 4 * H * slices(H) > kThreads ? 4 * H * slices(H) : kThreads;
}

size_t smem_floats(const Spell& p) {
  return (size_t)p.M + p.S + 7 * (size_t)p.H + p.F + p.V + 4 + part_floats(p.H);
}

__global__ void __launch_bounds__(kThreads) spell_fwd_kernel(Spell p) {
  extern __shared__ float smem[];
  __shared__ int next_id;
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, B = p.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q = smem;        // [M] attention query
  float* e = q + M;       // [S] energies, then attention weights
  float* x = e + S;       // [H + F] fed embedding | context
  float* h1 = x + H + F;  // [H]
  float* h1n = h1 + H;    // [H]
  float* c1 = h1n + H;    // [H]
  float* h2 = c1 + H;     // [H]
  float* h2n = h2 + H;    // [H]
  float* c2 = h2n + H;    // [H]
  float* logit = c2 + H;  // [V]
  float* red = logit + V;  // [4] softmax max and sum
  float* part = red + 4;   // partial sums of the split reductions

  const int b = blockIdx.x;
  const int len = max(p.lens[b], 1);
  const float* enc = p.enc + (size_t)b * S * F;
  const float* comp = p.comp + (size_t)b * S * M;

  for (int i = tid; i < H; i += blockDim.x) {
    x[i] = p.emb[(size_t)kSOS * H + i];
    h1[i] = 0.f;
    c1[i] = 0.f;
    h2[i] = 0.f;
    c2[i] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < p.L; ++t) {
    const size_t row = (size_t)t * B + b;  // this row's slot in the [L, B, .] streams

    // attention: query, masked energies, softmax, context
    matvec(h1, H, p.phi, M, nullptr, part, q, true);
    for (int s = warp; s < S; s += kWarps) {
      const float* cr = comp + (size_t)s * M;
      float acc = 0.f;
      for (int m = lane; m < M; m += 32) acc = fmaf(cr[m], q[m], acc);
      acc = ss::warp_sum(acc);
      if (lane == 0) e[s] = (s < len) ? acc : -INFINITY;
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, e[s]);
      mx = ss::warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) sum += expf(e[s] - mx);
      sum = ss::warp_sum(sum);
      if (lane == 0) {
        red[0] = mx;
        red[1] = sum;
      }
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
      const float a = expf(e[s] - red[0]) / red[1];
      e[s] = a;
      p.att[row * S + s] = a;
    }
    __syncthreads();
    matvec(e, S, enc, F, nullptr, part, x + H, false);

    // speller: two LSTM cells, then the character logits
    lstm_cell(x, H + F, p.wih1, h1, p.whh1, p.b1, H, c1, h1n, part);
    lstm_cell(h1n, H, p.wih2, h2, p.whh2, p.b2, H, c2, h2n, part);
    matvec(h2n, H, p.ct_w, V, p.ct_b, part, logit, false);
    for (int i = tid; i < H; i += blockDim.x) {
      p.h1s[row * H + i] = h1n[i];
      p.c1s[row * H + i] = c1[i];
      p.h2s[row * H + i] = h2n[i];
      p.c2s[row * H + i] = c2[i];
    }

    // scheduled sampling: Gumbel-argmax of the logits, or the teacher
    if (warp == 0) {
      const float* g = p.gumbel + row * V;
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int v = lane; v < V; v += 32) {
        p.logits[row * V + v] = logit[v];
        const float sc = logit[v] + g[v];
        if (sc > best) {
          best = sc;
          best_i = v;
        }
      }
      ss::warp_argmax(best, best_i);
      if (lane == 0) next_id = best_i;
    }
    __syncthreads();
    const bool use_tf = p.tf[t] > 0.5f;
    const float* src = use_tf ? p.temb + row * H : p.emb + (size_t)next_id * H;
    for (int i = tid; i < H; i += blockDim.x) {
      const float f = src[i];
      x[i] = f;
      p.fed[row * H + i] = f;
    }
    float* tmp = h1;
    h1 = h1n;
    h1n = tmp;
    tmp = h2;
    h2 = h2n;
    h2n = tmp;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// How a cluster CTA lays out its shared memory (offsets in floats); the
// wrapper's spell_fwd_smem_bytes mirrors it.
struct FwdPlan {
  size_t h1, h2, fed, ctx, q, e, c1, c2, part, spart, gts, logit, gum, ctw, ctb, phis, bias, rows,
      lens, ids, total;
};

__host__ __device__ inline FwdPlan fwd_plan(int H, int F, int M, int S, int V, int R) {
  FwdPlan p;
  size_t o = 0;
  p.h1 = o, o += round4(2 * (size_t)R * H);   // double-buffered by step parity
  p.h2 = o, o += round4(2 * (size_t)R * H);
  p.fed = o, o += round4((size_t)R * H);
  p.ctx = o, o += round4((size_t)R * F);
  p.q = o, o += round4((size_t)R * M);
  p.e = o, o += round4((size_t)R * S);
  p.c1 = o, o += round4((size_t)R * kSpUnits);
  p.c2 = o, o += round4((size_t)R * kSpUnits);
  p.part = o, o += round4((size_t)kSpWarps * R * kSpCols);
  p.spart = o, o += round4((size_t)kSpThreads * (R > 4 ? R : 4));
  p.gts = o, o += (size_t)R * kSpCols;
  p.logit = o, o += round4((size_t)R * V);
  p.gum = o, o += round4((size_t)R * V);
  p.ctw = o, o += round4((size_t)H * V);            // ct_w, resident
  p.ctb = o, o += round4(V);
  p.phis = o, o += round4((size_t)H * (M / (H / 32)));  // phi's own columns, resident
  p.bias = o, o += 2 * kSpCols;                      // b1, b2 at the own columns
  p.rows = o, o += round4(R);
  p.lens = o, o += round4(R);
  p.ids = o, o += round4(R);
  p.total = o;
  return p;
}

// The shapes the cluster route is written for: C = H / 32 CTAs of at most 8,
// the context's and the query's columns split evenly in float4s, the logits
// one column a thread, and the buffers inside a block's shared memory.
inline bool fwd_cluster_serves(int H, int F, int M, int S, int V, int R) {
  const int C = H / 32;
  return H % 32 == 0 && (C == 1 || C == 2 || C == 4 || C == 8) && F % (4 * C) == 0 &&
         F / C <= kSpThreads && M % 4 == 0 && M % C == 0 && M / C <= kSpThreads && V >= 1 &&
         V <= kSpThreads && S >= 1 &&
         (R == 4 || R == 5 || R == 6 || R == 8) &&
         sizeof(float) * fwd_plan(H, F, M, S, V, R).total <= kMaxSmem;
}

template <int R>
__global__ void __launch_bounds__(kSpThreads, 1) spell_fwd_cluster_kernel(Spell p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, c = blockIdx.x;  // the cluster spans the grid's x
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, B = p.B, G = 4 * H;
  const FwdPlan P = fwd_plan(H, F, M, S, V, R);
  float* h1b = smem + P.h1;   // [2][R][H] h1 of the last step / this step
  float* h2b = smem + P.h2;   // [2][R][H]
  float* fed = smem + P.fed;  // [R][H] the embedding fed into this step
  float* ctx = smem + P.ctx;  // [R][F] the context, gathered
  float* q = smem + P.q;      // [R][M] the attention query, gathered
  float* e = smem + P.e;      // [R][S] energies, gathered; then the weights
  float* c1 = smem + P.c1;    // [R][32] the cell carries of the own units
  float* c2 = smem + P.c2;
  float* part = smem + P.part;    // [kSpWarps][R][128] gate partials
  float* spart = smem + P.spart;  // partials of sp_colprod / sp_rowsum
  float* gts = smem + P.gts;      // [R][128] the gates of the own columns
  float* logit = smem + P.logit;  // [R][V]
  float* gum = smem + P.gum;      // [R][V] the step's sampling noise
  float* ctw = smem + P.ctw;      // [H][V] ct_w
  float* ctb = smem + P.ctb;      // [V]
  float* phis = smem + P.phis;    // [H][Mc] phi[:, m0 : m0 + Mc]
  float* bias = smem + P.bias;    // [2][128] b1, b2 at the own columns (q * 32 + j)
  int* rows = reinterpret_cast<int*>(smem + P.rows);  // [R] batch row read (clamped)
  int* lens = reinterpret_cast<int*>(smem + P.lens);  // [R]
  int* ids = reinterpret_cast<int*>(smem + P.ids);    // [R] sampled ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * R, u0 = c * kSpUnits;
  const int Fc = F / C, f0 = c * Fc, Mc = M / C, m0 = c * Mc;
  const int col = sp_gate_col(H, u0);

  if (tid < R) {
    const int b = min(b0 + tid, B - 1);
    rows[tid] = b;
    lens[tid] = max(p.lens[b], 1);
  }
  for (int i = tid; i < 4 * R * H; i += kSpThreads) h1b[i] = 0.f;  // h1b and h2b
  for (int i = tid; i < R * M; i += kSpThreads) q[i] = 0.f;  // tanh(0 @ phi)
  for (int i = tid; i < R * kSpUnits; i += kSpThreads) c1[i] = c2[i] = 0.f;
  for (int i = tid; i < R * H; i += kSpThreads) fed[i] = p.emb[(size_t)kSOS * H + i % H];
  for (int i = tid; i < H * V; i += kSpThreads) ctw[i] = p.ct_w[i];
  for (int i = tid; i < V; i += kSpThreads) ctb[i] = p.ct_b[i];
  for (int i = tid; i < H * Mc; i += kSpThreads)
    phis[i] = p.phi[(size_t)(i / Mc) * M + m0 + i % Mc];
  for (int i = tid; i < 2 * kSpCols; i += kSpThreads) {
    const int l = i % kSpCols, g = (l / kSpUnits) * H + u0 + l % kSpUnits;
    bias[i] = (i < kSpCols ? p.b1 : p.b2)[g];
  }
  cluster.sync();  // every CTA is running and initialised before the first remote write

  // acc: this CTA's gate partials; at a step's start they hold h1_{t-1} @ W_hh1
  // (zero at t = 0)
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  const int ns = (S - c + C - 1) / C;  // the positions s = c (mod C)
  for (int t = 0; t < p.L; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    float* h1n = h1b + nxt * R * H;
    float* h2c = h2b + cur * R * H;
    float* h2n = h2b + nxt * R * H;
    const size_t row0 = (size_t)t * B + b0;  // the tile's first slot in the [L, B, .] streams

    // (1) the energies of the own positions, to every CTA; masked past the length
    sp_dots(R, ns, c, C, q, M, p.comp, rows, (size_t)S * M, M, 0, M,
            [&](int r, int s, float v) {
              const float ev = s < lens[r] ? v : -INFINITY;
              for (int d = 0; d < C; ++d) cluster.map_shared_rank(e, d)[r * S + s] = ev;
            });
    ss::cluster_arrive();
    // the embedding fed into this step, from the last step's draw, and this
    // step's noise, all in flight at once (cp.async)
    const bool use_tf = t > 0 && p.tf[t - 1] > 0.5f;
    if (t > 0)
      for (int idx = tid; idx < R * H; idx += kSpThreads) {
        const int r = idx / H, i = idx % H;
        ss::cp_async4_zfill(fed + idx,
                            use_tf ? p.temb + ((size_t)(t - 1) * B + rows[r]) * H + i
                                   : p.emb + (size_t)ids[r] * H + i, true);
      }
    for (int idx = tid; idx < R * V; idx += kSpThreads)
      ss::cp_async4_zfill(gum + idx, p.gumbel + ((size_t)t * B + rows[idx / V]) * V + idx % V,
                          true);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (t > 0 && c == 0)
      for (int idx = tid; idx < R * H; idx += kSpThreads)
        if (b0 + idx / H < B) p.fed[(row0 - B + idx / H) * H + idx % H] = fed[idx];
    sp_gate_acc<R>(p.wih1, G, col, fed, H, H, acc);  // the fed embedding's rows of W_ih1
    ss::cluster_wait();

    // (2) the softmax of every row (each CTA alike), the context's own columns
    for (int r = warp; r < R; r += kSpWarps) {
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, e[r * S + s]);
      mx = ss::warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float x = expf(e[r * S + s] - mx);
        e[r * S + s] = x;
        sum += x;
      }
      sum = ss::warp_sum(sum);
      for (int s = lane; s < S; s += 32) e[r * S + s] /= sum;
    }
    __syncthreads();
    sp_rowsum<R>(e, S, S, p.enc, rows, (size_t)S * F, F, f0, Fc, spart,
                 [&](int r, int j, float v) {
                   for (int d = 0; d < C; ++d) cluster.map_shared_rank(ctx, d)[r * F + f0 + j] = v;
                 });
    ss::cluster_arrive();
    // the attention stream of the own positions, behind the barrier (e holds the
    // weights until the next step's energies)
    for (int idx = tid; idx < R * S; idx += kSpThreads) {
      const int r = idx / S, s = idx % S;
      if (s % C == c && b0 + r < B) p.att[(row0 + r) * S + s] = e[idx];
    }
    ss::cluster_wait();

    // (3) the context's rows of W_ih1; cell 1 of the own units; h1_t to every CTA
    sp_gate_acc<R>(p.wih1 + (size_t)H * G, G, col, ctx, F, F, acc);
    sp_gate_store<R>(part, acc);
    __syncthreads();
    sp_gate_reduce<R>(part, bias, gts);
    // a thread a (row, own unit): R * 32 <= kSpThreads
    const bool own = tid < R * kSpUnits;
    const int r_own = tid / kSpUnits, j_own = tid % kSpUnits, u_own = u0 + j_own;
    const bool real = own && b0 + r_own < B;
    const size_t o_own = row0 + r_own;
    float cn = 0.f, hn = 0.f;
    if (own) {
      const float* a = gts + r_own * kSpCols + j_own;
      cn = ss::sigmoid(a[kSpUnits]) * c1[tid] + ss::sigmoid(a[0]) * tanhf(a[2 * kSpUnits]);
      hn = ss::sigmoid(a[3 * kSpUnits]) * tanhf(cn);
      c1[tid] = cn;
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(h1n, d)[r_own * H + u_own] = hn;
    }
    ss::cluster_arrive();
    if (real) {  // the streams, behind the barrier
      p.h1s[o_own * H + u_own] = hn;
      p.c1s[o_own * H + u_own] = cn;
      if (p.g1s)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          p.g1s[o_own * G + g * H + u_own] = gts[r_own * kSpCols + g * kSpUnits + j_own];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    sp_gate_acc<R>(p.whh2, G, col, h2c, H, H, acc);  // h2_{t-1}'s rows of cell 2
    ss::cluster_wait();

    // (4) h1_t's rows of cell 2; the next query's own columns and h2_t to every CTA
    sp_gate_acc<R>(p.wih2, G, col, h1n, H, H, acc);
    sp_gate_store<R>(part, acc);
    sp_colprod<R>(h1n, H, H, phis, Mc, Mc, nullptr, spart, [&](int r, int j, float v) {
      const float qv = tanhf(v);
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(q, d)[r * M + m0 + j] = qv;
    });
    sp_gate_reduce<R>(part, bias + kSpCols, gts);
    if (own) {
      const float* a = gts + r_own * kSpCols + j_own;
      cn = ss::sigmoid(a[kSpUnits]) * c2[tid] + ss::sigmoid(a[0]) * tanhf(a[2 * kSpUnits]);
      hn = ss::sigmoid(a[3 * kSpUnits]) * tanhf(cn);
      c2[tid] = cn;
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(h2n, d)[r_own * H + u_own] = hn;
    }
    ss::cluster_arrive();
    if (real) {
      p.h2s[o_own * H + u_own] = hn;
      p.c2s[o_own * H + u_own] = cn;
      if (p.g2s)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          p.g2s[o_own * G + g * H + u_own] = gts[r_own * kSpCols + g * kSpUnits + j_own];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (t + 1 < p.L) sp_gate_acc<R>(p.whh1, G, col, h1n, H, H, acc);  // the next step's
    ss::cluster_wait();

    // (5) the logits and the sampling argmax in every CTA alike (the next fed
    // embedding is fetched behind the next step's first barrier)
    sp_colprod<R>(h2n, H, H, ctw, V, V, ctb, spart,
                  [&](int r, int j, float v) { logit[r * V + j] = v; });
    for (int r = warp; r < R; r += kSpWarps) {
      const size_t o = row0 + r;
      const float* g = gum + r * V;
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int v = lane; v < V; v += 32) {
        const float lv = logit[r * V + v];
        if (c == 0 && b0 + r < B) p.logits[o * V + v] = lv;
        const float sc = lv + g[v];
        if (sc > best) {
          best = sc;
          best_i = v;
        }
      }
      ss::warp_argmax(best, best_i);
      if (lane == 0) ids[r] = best_i;
    }
    __syncthreads();
  }
  // the embedding fed after the last step (its stream only)
  if (c == 0) {
    const int t = p.L - 1;
    const bool use_tf = p.tf[t] > 0.5f;
    for (int idx = tid; idx < R * H; idx += kSpThreads) {
      const int r = idx / H, i = idx % H;
      if (b0 + r < B)
        p.fed[((size_t)t * B + b0 + r) * H + i] =
            use_tf ? p.temb[((size_t)t * B + rows[r]) * H + i] : p.emb[(size_t)ids[r] * H + i];
    }
  }
}

template <int R>
cudaError_t launch_fwd_cluster(const Spell& p, cudaStream_t stream) {
  const int C = p.H / 32;
  const size_t smem = sizeof(float) * fwd_plan(p.H, p.F, p.M, p.S, p.V, R).total;
  cudaError_t err = cudaFuncSetAttribute(spell_fwd_cluster_kernel<R>,
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
  return cudaLaunchKernelEx(&cfg, spell_fwd_cluster_kernel<R>, p);
}

}  // namespace

// rows = 0 takes the one-row route (g1s, g2s must be null: it writes no
// gates); rows in {4, 5, 6, 8} the cluster route with tiles of that many
// batch rows and clusters of H / 32 CTAs, writing the gates where g1s / g2s
// are not null. The wrapper's spell_route decides; a shape the cluster route
// does not serve is refused here, never rerouted.
extern "C" int ss_spell_fwd(const float* enc, const float* comp, const int* lens, const float* tf,
                            const float* gumbel, const float* temb, const float* phi,
                            const float* wih1, const float* whh1, const float* b1,
                            const float* wih2, const float* whh2, const float* b2,
                            const float* ct_w, const float* ct_b, const float* emb, float* logits,
                            float* att, float* h1s, float* c1s, float* h2s, float* c2s,
                            float* fed, float* g1s, float* g2s, int B, int S, int F, int M, int H,
                            int V, int L, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Spell p{enc,  comp, lens, tf,     gumbel, temb, phi, wih1, whh1, b1,  wih2, whh2, b2,
                ct_w, ct_b, emb,  logits, att,    h1s,  c1s, h2s,  c2s,  fed, g1s,  g2s,  B,
                S,    F,    M,    H,      V,      L};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 0) {
    if (!fwd_cluster_serves(H, F, M, S, V, rows)) return static_cast<int>(cudaErrorInvalidValue);
    err = rows == 4 ? launch_fwd_cluster<4>(p, st)
        : rows == 5 ? launch_fwd_cluster<5>(p, st)
        : rows == 6 ? launch_fwd_cluster<6>(p, st)
                    : launch_fwd_cluster<8>(p, st);
    return static_cast<int>(err);
  }
  if (g1s != nullptr || g2s != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spell_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spell_fwd_kernel<<<B, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
