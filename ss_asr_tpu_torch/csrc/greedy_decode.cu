// Whole greedy attend-and-spell decode in one kernel, with and without
// char-LM shallow fusion (one template, kUseLM).
//
// Replaces the TPU kernels ss_asr_tpu/ops/pallas/decode.py::_decode_kernel
// (greedy_decode_pallas) and ::_decode_lm_kernel (greedy_decode_lm_pallas).
//
// Each batch row, for up to max_steps steps:
//   q = tanh(h1 @ phi); energy[s] = comp[s] . q, -inf past max(len, 1);
//   score = softmax(energy); context = score @ enc;
//   (h1, c1) = LSTM([emb(last) | context], h1, c1); (h2, c2) = LSTM(h1, h2, c2)
//   logits = h2 @ ct_w + ct_b
//   LM: (g1, g2) = 2 x GRU(lm_emb(last)); lm_logits = g2 @ out_w + out_b;
//       score = log_softmax(logits) + lm_weight * log_softmax(lm_logits)
//   id = argmax (lowest index among equal maxima, as jnp.argmax); last = id.
// The TPU kernel steps the whole batch and, once every row is done, pads
// with SOS; here a row that emits EOS writes SOS for its remaining steps,
// and a block (one-row route) or a tile (cluster route) stops once all its
// rows are done. The tokens are the same, because a done row emits SOS
// either way.
//
// What bounds it on an H100: every step reads all speller weights (W_ih1
// [768, 1024], W_hh1 / W_ih2 / W_hh2 [256, 1024], phi, ct_w: about 6.3 MB
// f32 at the flagship size, plus 786 KB for the LM's two GRUs at HL = 128)
// for a handful of rows' matrix-vector products, and the steps are
// sequential. The weights stay resident in the 50 MB L2 across steps, so a
// step costs the time the SMs take to pull them from L2 and the chain of
// dependent phases around them. The TPU kernel steps the whole batch at
// once (decode.py: grid over the steps, the weights' blocks fixed), so each
// weight read serves every row. Two routes; the shape decides
// (ops/kernels/decode.py::greedy_route):
//
// * The cluster route (greedy_cluster_kernel), K9's cluster route
//   (spell_fwd.cu) without its streams and noise: a thread-block cluster of
//   C = H / 32 CTAs takes a tile of R batch rows (1, 2 or 4). CTA c owns
//   32 hidden units of each cell and their 128 gate columns, and streams
//   only those columns of W_ih1, W_hh1, W_ih2, W_hh2 from L2 each step (786
//   KB at the flagship, an eighth), each element serving the tile's R rows
//   from registers. With the LM it also owns HL / C units of each GRU and
//   streams their r, z, n columns of W_ih and W_hh (98 KB at C = 8), and
//   the LM's output layer out_w stays resident beside ct_w. The attention is
//   split as in K9: CTA c scores the positions s = c (mod C) and forms the
//   context's F / C columns. Four cluster barriers a step, each split so
//   that independent work runs between arrive and wait: (1) the energies
//   all-gathered (behind it the fed embedding's rows of W_ih1 and the LM's
//   first GRU cell, whose output is all-gathered with the context), (2) the
//   context all-gathered, (3) h1_t all-gathered (behind it h2_{t-1}'s rows
//   of cell 2 and the LM's second GRU cell, all-gathered with h2), (4) h2_t
//   and the next query's columns all-gathered (behind it the next step's h1
//   @ W_hh1). The logits, the LM's logits, the fused score and the argmax
//   run in every CTA alike on identical inputs, so every CTA feeds the same
//   embedding and takes the same early-exit decision without a fifth
//   barrier. The tile height is the smallest whose clusters all fit on the
//   card at once (R = 1 up to B = 15 at the flagship), else 4 in waves: a
//   row costs FMAs and attention bytes in every CTA, a cluster only SMs
//   (tiles of 8 were slower at every batch measured). What bounds it (a
//   phase trace at B = 16, ops/kernels/spell_probe.py --trace): a third of
//   a step streams the CTA's weight columns at the rate one SM draws from
//   L2 (~100 GB/s); the rest is the chain of short dependent phases between
//   the barriers (the attention over device memory, the barriers' own
//   arrive and wait, the cells, the logits and the argmax, the query's
//   columns). With the LM the two GRU cells (each a product, a reduction
//   and a gathered update), the LM's logits and the fused score add about a
//   third to the step.
// * The one-row route (greedy_decode_kernel), for shapes no cluster serves
//   (H not a multiple of 32 or above 256, an LM whose HL / C units do not
//   split into float4s, or buffers past shared memory): one block of 1024
//   threads decodes one batch row, its products split over thread groups
//   whose partial sums meet in shared memory (speller.cuh). Each step
//   streams all speller weights from L2 into one SM for a single row: about
//   69 us a step at the flagship (90 GB/s into the SM), and only B of 132
//   SMs work. It can go once the cluster route serves every speller width
//   the JAX package accepts (H a multiple of 32 up to 256 today; clusters of
//   16 or a two-pass reduction above), or once the port fixes H to the
//   configs' widths.

#include <climits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "speller.cuh"

namespace cg = cooperative_groups;

namespace {

struct Speller {
  const float* enc;   // [B, S, F] listener output
  const float* comp;  // [B, S, M] tanh(psi(enc))
  const int* lens;    // [B] listener lengths
  const float* phi;   // [H, M]
  const float* wih1;  // [H + F, 4H]
  const float* whh1;  // [H, 4H]
  const float* b1;    // [4H]
  const float* wih2;  // [H, 4H]
  const float* whh2;  // [H, 4H]
  const float* b2;    // [4H]
  const float* ct_w;  // [H, V]
  const float* ct_b;  // [V]
  const float* emb;   // [V, H]
  int* out;           // [B, max_steps]
  int B, S, F, M, H, V, max_steps;
};

// partial-sum buffer: the largest of matvec's, lstm_cell's and gru_cell's
__host__ __device__ inline int part_floats(int H, int HL, bool use_lm) {
  int n = kThreads;
  if (4 * H * slices(H) > n) n = 4 * H * slices(H);
  if (use_lm && 6 * HL * slices(HL) > n) n = 6 * HL * slices(HL);
  return n;
}

size_t smem_floats(const Speller& p, int HL, bool use_lm) {
  size_t n = (size_t)p.M + p.S + 7 * (size_t)p.H + p.F + p.V + 4 + part_floats(p.H, HL, use_lm);
  if (use_lm) n += 5 * (size_t)HL + p.V;
  return n;
}

template <bool kUseLM>
__global__ void __launch_bounds__(kThreads) greedy_decode_kernel(Speller p, CharLM lm) {
  extern __shared__ float smem[];
  __shared__ int next_id;
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, HL = lm.HL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q = smem;               // [M] attention query
  float* e = q + M;              // [S] energies, then scores
  float* x = e + S;              // [H + F] last char embedding | context
  float* h1 = x + H + F;         // [H]
  float* h1n = h1 + H;           // [H]
  float* c1 = h1n + H;           // [H]
  float* h2 = c1 + H;            // [H]
  float* h2n = h2 + H;           // [H]
  float* c2 = h2n + H;           // [H]
  float* logit = c2 + H;         // [V]
  float* part = logit + V;       // partial sums of the split reductions
  float* red = part + part_floats(H, HL, kUseLM);  // [2] softmax max and sum
  float* lx = red + 4;           // [HL] LM input embedding
  float* g1 = lx + HL;           // [HL]
  float* g1n = g1 + HL;          // [HL]
  float* g2 = g1n + HL;          // [HL]
  float* g2n = g2 + HL;          // [HL]
  float* llogit = g2n + HL;      // [V]

  const int b = blockIdx.x;
  const int len = max(p.lens[b], 1);
  const float* enc = p.enc + (size_t)b * S * F;
  const float* comp = p.comp + (size_t)b * S * M;
  int* out = p.out + (size_t)b * p.max_steps;

  for (int i = tid; i < H; i += blockDim.x) {
    x[i] = p.emb[(size_t)kSOS * H + i];
    h1[i] = 0.f;
    c1[i] = 0.f;
    h2[i] = 0.f;
    c2[i] = 0.f;
  }
  if (kUseLM) {
    for (int i = tid; i < HL; i += blockDim.x) {
      lx[i] = lm.emb[(size_t)kSOS * HL + i];
      g1[i] = 0.f;
      g2[i] = 0.f;
    }
  }
  __syncthreads();

  for (int t = 0; t < p.max_steps; ++t) {
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
    for (int s = tid; s < S; s += blockDim.x) e[s] = expf(e[s] - red[0]) / red[1];
    __syncthreads();
    matvec(e, S, enc, F, nullptr, part, x + H, false);

    // speller: two LSTM cells, then the character logits
    lstm_cell(x, H + F, p.wih1, h1, p.whh1, p.b1, H, c1, h1n, part);
    lstm_cell(h1n, H, p.wih2, h2, p.whh2, p.b2, H, c2, h2n, part);
    matvec(h2n, H, p.ct_w, V, p.ct_b, part, logit, false);

    if (kUseLM) {
      gru_cell(lx, g1, lm.wih1, lm.whh1, lm.bih1, lm.bhh1, HL, g1n, part);
      gru_cell(g1n, g2, lm.wih2, lm.whh2, lm.bih2, lm.bhh2, HL, g2n, part);
      matvec(g2n, HL, lm.out_w, V, lm.out_b, part, llogit, false);
    }

    if (warp == 0) {
      float mxa = 0.f, lsa = 0.f, mxl = 0.f, lsl = 0.f;
      if (kUseLM) {
        warp_log_softmax_terms(logit, V, mxa, lsa);
        warp_log_softmax_terms(llogit, V, mxl, lsl);
      }
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int v = lane; v < V; v += 32) {
        const float sc = kUseLM ? ((logit[v] - mxa) - lsa) + lm.weight * ((llogit[v] - mxl) - lsl)
                                : logit[v];
        if (sc > best) {
          best = sc;
          best_i = v;
        }
      }
      ss::warp_argmax(best, best_i);
      if (lane == 0) {
        next_id = best_i;
        out[t] = best_i;
      }
    }
    __syncthreads();

    // feedback the emitted id; advance the carries
    const int id = next_id;
    for (int i = tid; i < H; i += blockDim.x) x[i] = p.emb[(size_t)id * H + i];
    if (kUseLM) {
      for (int i = tid; i < HL; i += blockDim.x) lx[i] = lm.emb[(size_t)id * HL + i];
      float* tmp = g1;
      g1 = g1n;
      g1n = tmp;
      tmp = g2;
      g2 = g2n;
      g2n = tmp;
    }
    float* tmp = h1;
    h1 = h1n;
    h1n = tmp;
    tmp = h2;
    h2 = h2n;
    h2n = tmp;
    if (id == kEOS) {
      for (int r = t + 1 + tid; r < p.max_steps; r += blockDim.x) out[r] = kSOS;
      break;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// How a cluster CTA lays out its shared memory (offsets in floats); the
// wrapper's greedy_smem_bytes mirrors it. Without the LM (HL = 0) its
// buffers are empty.
struct GreedyPlan {
  size_t h1, h2, fed, ctx, q, e, c1, c2, part, spart, gts, logit, ctw, ctb, phis, bias, rows,
      lens, ids, done, lx, g1, g2, gg, llogit, low, lob, gbias, total;
};

__host__ __device__ inline GreedyPlan greedy_plan(int H, int F, int M, int S, int V, int HL,
                                                  int R) {
  GreedyPlan p;
  const size_t lm = HL > 0;
  size_t o = 0;
  p.h1 = o, o += round4(2 * (size_t)R * H);  // double-buffered by step parity
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
  p.ctw = o, o += round4((size_t)H * V);                // ct_w, resident
  p.ctb = o, o += round4(V);
  p.phis = o, o += round4((size_t)H * (M / (H / 32)));  // phi's own columns, resident
  p.bias = o, o += 2 * kSpCols;                          // b1, b2 at the own columns
  p.rows = o, o += round4(R);
  p.lens = o, o += round4(R);
  p.ids = o, o += round4(R);
  p.done = o, o += round4(R);
  p.lx = o, o += round4((size_t)R * HL);
  p.g1 = o, o += round4(2 * (size_t)R * HL);  // double-buffered by step parity
  p.g2 = o, o += round4(2 * (size_t)R * HL);
  p.gg = o, o += lm * R * kSpCols;
  p.llogit = o, o += lm * round4((size_t)R * V);
  p.low = o, o += round4((size_t)HL * V);  // the LM's out_w, resident
  p.lob = o, o += lm * round4(V);
  p.gbias = o, o += lm * 2 * kSpCols;  // both GRUs' b_ih | b_hh at the own columns
  p.total = o;
  return p;
}

// The shapes the cluster route is written for: C = H / 32 CTAs of at most 8,
// the context's and the query's columns split evenly in float4s, the logits
// one column a thread; with the LM, HL / C units a CTA in float4s whose six
// gate blocks fit the 128 partial columns; the buffers inside a block's
// shared memory.
inline bool greedy_cluster_serves(int H, int F, int M, int S, int V, int HL, int R) {
  const int C = H / 32;
  if (H % 32 != 0 || !(C == 1 || C == 2 || C == 4 || C == 8)) return false;
  return F % (4 * C) == 0 && F / C <= kSpThreads && M % (4 * C) == 0 && M / C <= kSpThreads &&
         V >= 1 && V <= kSpThreads && S >= 1 && (R == 1 || R == 2 || R == 4) &&
         (HL == 0 || (HL % (4 * C) == 0 && 6 * (HL / C) <= kSpCols)) &&
         sizeof(float) * greedy_plan(H, F, M, S, V, HL, R).total <= kMaxSmem;
}

template <int R, bool kUseLM>
__global__ void __launch_bounds__(kSpThreads, 1) greedy_cluster_kernel(Speller p, CharLM lm) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, c = blockIdx.x;  // the cluster spans the grid's x
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, B = p.B, G = 4 * H, T = p.max_steps;
  const int HL = kUseLM ? lm.HL : 0;
  const GreedyPlan P = greedy_plan(H, F, M, S, V, HL, R);
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
  float* ctw = smem + P.ctw;      // [H][V] ct_w
  float* ctb = smem + P.ctb;      // [V]
  float* phis = smem + P.phis;    // [H][Mc] phi[:, m0 : m0 + Mc]
  float* bias = smem + P.bias;    // [2][128] b1, b2 at the own columns (q * 32 + j)
  int* rows = reinterpret_cast<int*>(smem + P.rows);  // [R] batch row read (clamped)
  int* lens = reinterpret_cast<int*>(smem + P.lens);  // [R]
  int* ids = reinterpret_cast<int*>(smem + P.ids);    // [R] the step's argmax
  int* done = reinterpret_cast<int*>(smem + P.done);  // [R] EOS emitted
  float* lx = smem + P.lx;          // [R][HL] the LM's input embedding
  float* g1b = smem + P.g1;         // [2][R][HL] the GRU states
  float* g2b = smem + P.g2;         // [2][R][HL]
  float* gg = smem + P.gg;          // [R][128] a GRU's own column sums
  float* llogit = smem + P.llogit;  // [R][V]
  float* low = smem + P.low;        // [HL][V] out_w
  float* lob = smem + P.lob;        // [V]
  float* gbias = smem + P.gbias;    // [2][128] GRU 1, GRU 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * R, u0 = c * kSpUnits;
  const int Fc = F / C, f0 = c * Fc, Mc = M / C, m0 = c * Mc;
  const int col = sp_gate_col(H, u0);
  // The LM's share: Uc = HL / C units of each GRU from ul0, and their 6 Uc own
  // columns: input-side r, z, n, then hidden-side r, z, n, Uc each (own column
  // g * Uc + j, or 3 Uc + g * Uc + j, is column g * HL + ul0 + j of W_ih or
  // W_hh). Lane l reads the float4 of own columns 4l .. 4l + 3; lanes past
  // 6 Uc / 4 read a valid float4 too, whose sums land in ignored columns.
  const int Uc = HL / C, ul0 = c * Uc;
  bool ghid = false;  // the lane's float4 lies in W_hh (else in W_ih)
  int gcol = 0;       // ... at this column
  if (kUseLM) {
    const int n4 = 3 * Uc / 4, item = lane % (2 * n4), i = item % n4;
    ghid = item >= n4;
    gcol = (i / (Uc / 4)) * HL + ul0 + 4 * (i % (Uc / 4));
  }

  if (tid < R) {
    const int b = min(b0 + tid, B - 1);
    rows[tid] = b;
    lens[tid] = max(p.lens[b], 1);
    done[tid] = 0;
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
  if (kUseLM) {
    for (int i = tid; i < R * HL; i += kSpThreads) lx[i] = lm.emb[(size_t)kSOS * HL + i % HL];
    for (int i = tid; i < 4 * R * HL; i += kSpThreads) g1b[i] = 0.f;  // g1b and g2b
    for (int i = tid; i < HL * V; i += kSpThreads) low[i] = lm.out_w[i];
    for (int i = tid; i < V; i += kSpThreads) lob[i] = lm.out_b[i];
    for (int i = tid; i < 2 * kSpCols; i += kSpThreads) {
      const int l = i % kSpCols, g = (l % (3 * Uc)) / Uc, j = l % Uc;
      const bool second = i >= kSpCols, hidden = l >= 3 * Uc;
      const float* b = hidden ? (second ? lm.bhh2 : lm.bhh1) : (second ? lm.bih2 : lm.bih1);
      gbias[i] = l < 6 * Uc ? b[g * HL + ul0 + j] : 0.f;
    }
  }
  cluster.sync();  // every CTA is running and initialised before the first remote write

  // A GRU cell (torch GRUCell) of the own units of every row: x's and h's
  // products over the own columns (W and in are the lane's: W_ih and x, or
  // W_hh and hc), the warps' partials summed with the biases into gg, then
  // the new state of each (row, own unit) to every CTA's hn.
  auto gru_cell = [&](const float* W, const float* in, const float* hc, float* hn,
                      const float* gb) {
    float ga[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) ga[r][0] = ga[r][1] = ga[r][2] = ga[r][3] = 0.f;
    sp_gate_acc<R>(W, 3 * HL, gcol, in, HL, HL, ga);
    sp_gate_store<R>(part, ga);
    __syncthreads();
    sp_gate_reduce<R>(part, gb, gg);
    if (tid < R * Uc) {
      const int r = tid / Uc, j = tid % Uc;
      const float* a = gg + r * kSpCols + j;
      const float rg = ss::sigmoid(a[0] + a[3 * Uc]);
      const float z = ss::sigmoid(a[Uc] + a[4 * Uc]);
      const float n = tanhf(a[2 * Uc] + rg * a[5 * Uc]);
      const float hv = (1.f - z) * n + z * hc[r * HL + ul0 + j];
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(hn, d)[r * HL + ul0 + j] = hv;
    }
  };

  // acc: this CTA's gate partials; at a step's start they hold h1_{t-1} @ W_hh1
  // (zero at t = 0)
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  const int ns = (S - c + C - 1) / C;  // the positions s = c (mod C)
  const bool own = tid < R * kSpUnits;  // a thread a (row, own unit) of the cells
  const int r_own = tid / kSpUnits, j_own = tid % kSpUnits, u_own = u0 + j_own;
  int steps = T;  // the steps the tile ran
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    float* h1n = h1b + nxt * R * H;
    float* h2c = h2b + cur * R * H;
    float* h2n = h2b + nxt * R * H;
    float* g1c = g1b + cur * R * HL;
    float* g1n = g1b + nxt * R * HL;
    float* g2c = g2b + cur * R * HL;
    float* g2n = g2b + nxt * R * HL;

    // (1) the energies of the own positions, to every CTA; masked past the length
    sp_dots(R, ns, c, C, q, M, p.comp, rows, (size_t)S * M, M, 0, M,
            [&](int r, int s, float v) {
              const float ev = s < lens[r] ? v : -INFINITY;
              for (int d = 0; d < C; ++d) cluster.map_shared_rank(e, d)[r * S + s] = ev;
            });
    ss::cluster_arrive();
    // behind the barrier: the embeddings of the last step's ids (cp.async), their
    // rows of W_ih1, and the LM's first GRU cell, to every CTA
    if (t > 0) {
      for (int idx = tid; idx < R * H / 4; idx += kSpThreads) {
        const int r = idx / (H / 4), i = idx % (H / 4);
        ss::cp_async16_zfill(fed + 4 * idx, p.emb + (size_t)ids[r] * H + 4 * i, true);
      }
      if (kUseLM)
        for (int idx = tid; idx < R * HL / 4; idx += kSpThreads) {
          const int r = idx / (HL / 4), i = idx % (HL / 4);
          ss::cp_async16_zfill(lx + 4 * idx, lm.emb + (size_t)ids[r] * HL + 4 * i, true);
        }
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();
    sp_gate_acc<R>(p.wih1, G, col, fed, H, H, acc);  // the fed embedding's rows of W_ih1
    if (kUseLM) gru_cell(ghid ? lm.whh1 : lm.wih1, ghid ? g1c : lx, g1c, g1n, gbias);
    ss::cluster_wait();

    // (2) the softmax of every row (each CTA alike), the context's own columns to
    // every CTA
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
    cluster.sync();

    // (3) the context's rows of W_ih1; cell 1 of the own units; h1_t to every CTA
    sp_gate_acc<R>(p.wih1 + (size_t)H * G, G, col, ctx, F, F, acc);
    sp_gate_store<R>(part, acc);
    __syncthreads();
    sp_gate_reduce<R>(part, bias, gts);
    if (own) {
      const float* a = gts + r_own * kSpCols + j_own;
      const float cn =
          ss::sigmoid(a[kSpUnits]) * c1[tid] + ss::sigmoid(a[0]) * tanhf(a[2 * kSpUnits]);
      const float hn = ss::sigmoid(a[3 * kSpUnits]) * tanhf(cn);
      c1[tid] = cn;
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(h1n, d)[r_own * H + u_own] = hn;
    }
    ss::cluster_arrive();
    // behind the barrier: h2_{t-1}'s rows of cell 2, and the LM's second GRU cell
    // (over g1_t, gathered at (2)), to every CTA
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    sp_gate_acc<R>(p.whh2, G, col, h2c, H, H, acc);
    if (kUseLM) gru_cell(ghid ? lm.whh2 : lm.wih2, ghid ? g2c : g1n, g2c, g2n, gbias + kSpCols);
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
      const float cn =
          ss::sigmoid(a[kSpUnits]) * c2[tid] + ss::sigmoid(a[0]) * tanhf(a[2 * kSpUnits]);
      const float hn = ss::sigmoid(a[3 * kSpUnits]) * tanhf(cn);
      c2[tid] = cn;
      for (int d = 0; d < C; ++d) cluster.map_shared_rank(h2n, d)[r_own * H + u_own] = hn;
    }
    ss::cluster_arrive();
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (t + 1 < T) sp_gate_acc<R>(p.whh1, G, col, h1n, H, H, acc);  // the next step's
    ss::cluster_wait();

    // (5) the logits (and the LM's), the fused score and its argmax in every CTA
    // alike; the tokens; the tile's early exit
    sp_colprod<R>(h2n, H, H, ctw, V, V, ctb, spart,
                  [&](int r, int j, float v) { logit[r * V + j] = v; });
    if (kUseLM)
      sp_colprod<R>(g2n, HL, HL, low, V, V, lob, spart,
                    [&](int r, int j, float v) { llogit[r * V + j] = v; });
    for (int r = warp; r < R; r += kSpWarps) {
      const float* la = logit + r * V;
      const float* ll = llogit + r * V;
      float mxa = 0.f, lsa = 0.f, mxl = 0.f, lsl = 0.f;
      if (kUseLM) {
        warp_log_softmax_terms(la, V, mxa, lsa);
        warp_log_softmax_terms(ll, V, mxl, lsl);
      }
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int v = lane; v < V; v += 32) {
        const float sc =
            kUseLM ? ((la[v] - mxa) - lsa) + lm.weight * ((ll[v] - mxl) - lsl) : la[v];
        if (sc > best) {
          best = sc;
          best_i = v;
        }
      }
      ss::warp_argmax(best, best_i);
      if (lane == 0) {
        ids[r] = best_i;
        if (c == 0 && b0 + r < B) p.out[(size_t)(b0 + r) * T + t] = done[r] ? kSOS : best_i;
        done[r] |= best_i == kEOS;
      }
    }
    __syncthreads();
    bool all_done = true;
    for (int r = 0; r < R; ++r) all_done = all_done && done[r];
    if (all_done) {  // the same in every CTA: the cluster leaves together
      steps = t + 1;
      break;
    }
  }
  // a done row emits SOS for the steps its tile did not run
  if (c == 0 && steps < T)
    for (int idx = tid; idx < R * (T - steps); idx += kSpThreads) {
      const int r = idx / (T - steps), k = steps + idx % (T - steps);
      if (b0 + r < B) p.out[(size_t)(b0 + r) * T + k] = kSOS;
    }
}

template <int R, bool kUseLM>
cudaError_t launch_cluster(const Speller& p, const CharLM& lm, cudaStream_t stream) {
  const auto kernel = greedy_cluster_kernel<R, kUseLM>;
  const size_t smem =
      sizeof(float) * greedy_plan(p.H, p.F, p.M, p.S, p.V, kUseLM ? lm.HL : 0, R).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.H / 32, (p.B + R - 1) / R, 1);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.H / 32;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, lm);
}

// rows = 0 takes the one-row route; rows in {1, 2, 4} the cluster route
// with tiles of that many batch rows. The wrapper's greedy_route decides; a
// shape the cluster route does not serve is refused here, never rerouted.
template <bool kUseLM>
int launch(const Speller& p, const CharLM& lm, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 0) {
    if (!greedy_cluster_serves(p.H, p.F, p.M, p.S, p.V, kUseLM ? lm.HL : 0, rows))
      return static_cast<int>(cudaErrorInvalidValue);
    err = rows == 1   ? launch_cluster<1, kUseLM>(p, lm, st)
          : rows == 2 ? launch_cluster<2, kUseLM>(p, lm, st)
                      : launch_cluster<4, kUseLM>(p, lm, st);
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * smem_floats(p, lm.HL, kUseLM);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(greedy_decode_kernel<kUseLM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_decode_kernel<kUseLM><<<p.B, kThreads, smem, st>>>(p, lm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ss_greedy_decode(const float* enc, const float* comp, const int* lens,
                                const float* phi, const float* wih1, const float* whh1,
                                const float* b1, const float* wih2, const float* whh2,
                                const float* b2, const float* ct_w, const float* ct_b,
                                const float* emb, int* out, int B, int S, int F, int M, int H,
                                int V, int max_steps, int rows, int device, void* stream) {
  const Speller p{enc, comp, lens, phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb, out,
                  B, S, F, M, H, V, max_steps};
  const CharLM lm{};
  return launch<false>(p, lm, rows, device, stream);
}

extern "C" int ss_greedy_decode_lm(
    const float* enc, const float* comp, const int* lens, const float* phi, const float* wih1,
    const float* whh1, const float* b1, const float* wih2, const float* whh2, const float* b2,
    const float* ct_w, const float* ct_b, const float* emb, int* out, int B, int S, int F, int M,
    int H, int V, int max_steps, const float* lm_emb, const float* g1_wih, const float* g1_whh,
    const float* g1_bih, const float* g1_bhh, const float* g2_wih, const float* g2_whh,
    const float* g2_bih, const float* g2_bhh, const float* lm_w, const float* lm_b, int HL,
    float lm_weight, int rows, int device, void* stream) {
  const Speller p{enc, comp, lens, phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb, out,
                  B, S, F, M, H, V, max_steps};
  const CharLM lm{lm_emb, g1_wih, g1_whh, g1_bih, g1_bhh, g2_wih, g2_whh,
                  g2_bih, g2_bhh, lm_w,   lm_b,   HL,     lm_weight};
  return launch<true>(p, lm, rows, device, stream);
}
