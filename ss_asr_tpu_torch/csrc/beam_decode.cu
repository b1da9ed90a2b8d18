// Whole beam-search attend-and-spell decode in one kernel, with and without
// char-LM shallow fusion (one template, kUseLM).
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/beam.py::_make_kernel(K,
// use_lm) (beam_device_pallas), which computes what the XLA scan
// ss_asr_tpu/decode/beam.py::_beam_scan computes: K hypotheses per utterance
// advance together; each step every beam runs attention, the two speller
// LSTM cells, the character projection and (with the LM) two GRU cells, its
// candidates are scores + log_softmax(asr) [+ w * log_softmax(lm)] (a
// finished beam may only extend by SOS at no cost), the K best of the K * V
// candidates survive (ties to the lower flat index, lax.top_k's rule), and
// each survivor takes its parent's states. After the last step the still
// open beams pay the cost of emitting EOS. Outputs: tokens and parents per
// step [T, B, K], final scores, done flags and hypothesis lengths [B, K];
// the backtrack runs on the host.
//
// Two routes; the shape decides (ops/kernels/beam.py::beam_route).
//
// The cluster route (beam_cluster_kernel). A thread-block cluster of C CTAs
// decodes U utterances: rows = U x RB beams, RB = K rounded up to 4, 8 or 16;
// one or two utterances of at most 8 beams share 4 or 8 rows, an utterance
// of 9-16 beams takes 16 rows alone. CTA c owns 128 = 4H / C gate columns
// (so C = H / 32, at most 8): the i, f, g, o columns of H / C units
// of both speller cells and the r, z, n columns of HL / C units of both LM
// GRUs, and streams just those weight panels ([rows][128], packed per CTA by
// the wrapper) from L2 through a cp.async ring of 3 to 8 stages of 32 rows
// that runs on across steps (a step's weights are the same every step); each
// weight is read once a step from shared memory for all rows. Replicated in
// every CTA: the inputs (emb, context, h1, h2 and the LM's states); local:
// the cells of its own units; resident: its columns of phi, its rows of ct_w
// and its columns of the LM's output layer.
// A step, with one cluster barrier after each phase:
//   (a) its queries, all-gathered; the first GRU cell of its LM units.
//   (b) the attention over its range of memory steps (eight lanes per step
//       and utterance): energies, their max and sum of exp, and the
//       unnormalised context, reduce-scattered to the owners of its F / C
//       features; the second GRU cell.
//   (c) the owners merge the partials (the max / sum merge of a split
//       softmax) and all-gather the context; the LM logits of its columns go
//       to CTA 0.
//   (d) the first LSTM cell of its units, h1 all-gathered.
//   (e) the second cell, h2 all-gathered; the logits' partial sums over its
//       units go to CTA 0.
//   (f) CTA 0 adds the partials, runs the fused log-probs (a warp a row), the
//       top K of each utterance, the bookkeeping and the early exit, and
//       broadcasts each row's token and parent; every CTA then regathers its
//       states by parent. The steps of a finished utterance write SOS tokens
//       and identity parents, as the one-block kernel's early exit does.
// The top K keeps lax.top_k's order (the larger score; on equal scores the
// lower flat index r * V + v) without serial rounds: every candidate counts
// the better ones of its own beam, and those with fewer than K survive, K a
// beam, sorted; every survivor then adds, for each other beam, how many of
// its survivors are better (a binary search of a sorted prefix), and the
// survivor whose count is j < K is the j-th pick. A candidate of the top K
// has fewer than K better ones anywhere, so it survives, and so do all the
// candidates better than it: its count is its rank.
// Shared memory: one buffer, by phase, holds the context partials (b)-(c)
// and CTA 0's logit partials (e)-(f); another the queries (a)-(b) and CTA
// 0's candidates (f). At 4 and 8 rows h1, h2 and the GRU states are double-
// buffered by step parity, so a cell writes the next step's copy while the
// cluster still reads this one's. 16 rows' double buffers do not fit a CTA
// (the flagship width with the LM: 68,032 floats of replicated state and
// buffers against 58,112 less 13,824 for three ring stages), so the 16-row
// variant keeps one copy of each and the context in the partials' buffer
// (40,352 floats with the LM, 33,312 without: three and five ring stages at
// S = 64), and a split cluster barrier guards each all-gather into a buffer
// that the cluster may still read: the arrive once this CTA has read it
// (after its product, or the context merge), the wait before the remote
// writes, the new values staged in this CTA's gate sums between the two.
// What bounds it: each SM streams its 0.9 MB (C = 8) of weights a step, and
// the L2 bytes one SM keeps in flight set that pace; then the six barriers
// (eleven with the LM at 16 rows, counting the split ones) and the
// attention's L2 latency. At 16 rows a cluster holds one utterance and the
// card 15 clusters of 8, so a batch of 16 runs in two waves.
//
// The one-block route (beam_decode_kernel), for shapes no cluster serves (an
// H other than 32, 64, 128 or 256, F or HL not in whole ring stages, a wide
// LM, a vocabulary smaller than K, a plan that does not fit shared memory).
// One block of 1024 threads decodes one utterance (grid = B). The K
// beams' states live in shared memory k-major, x[k * RB + r] for beam r
// (RB = K rounded up to 4, 8 or 16; rows past K are padding that stays
// zero), so every product reads each weight ONCE per step for all K beams:
// a thread owns a weight column (and a k-slice of it for narrow products),
// keeps RB accumulators and reads the RB inputs of a k as float4 broadcasts.
// The TPU kernel's K^2 select-accumulate regather and its beam-major (K, B,
// .) scratch were VMEM workarounds; here the regather is an indexed copy by
// parent through a scratch buffer, and the top-K is K rounds of a one-warp
// argmax over the K * V candidates, each round masking its winner. A row
// whose beams are all done stops: it writes SOS tokens and identity parents
// for the steps left, which is what the fixed-trip TPU kernel and the
// early-exit scan both produce, and needs no EOS charge.
//
// What bounds that route on an H100: as the greedy kernel (greedy_decode.cu), each
// step streams every speller weight (about 6.3 MB f32 at the flagship size,
// plus 0.4 MB for the LM) from L2 into one SM, now for K beams at once, and
// does K fused multiply-adds per weight. At K = 3 the L2 stream dominates;
// at K = 16 the 25 M multiply-adds a step (about 110 us on one SM's 128
// FP32 lanes) do. At B = 16 there are 16 blocks on 132 SMs: the card is
// mostly idle, as for the greedy kernel. Shared memory holds the K beams'
// states (h1 c1 h2 c2 [+ two LM states]), the inputs of the first cell, the
// query, the logits and one buffer of max(1024, 4H, 6HL, M, V) * RB floats
// for partial sums, attention weights, candidates and the regather: 219 KB
// at K = 16 with the LM, whatever S is. The attention energies and weights
// of the K beams (S * RB floats) use that buffer when S fits it (S <= 1024
// at the flagship size, 82 s of audio) and otherwise the block's slice of a
// global scratch [B, S, RB] that the caller provides, which L1 and L2 serve;
// both run the same code.

#include <climits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "speller.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // the JAX beam search's candidate mask
constexpr int kMaxBeams = 16;

struct Beam {
  const float* enc;   // [B, S, F] listener output
  const float* comp;  // [B, S, M] tanh(psi(enc))
  const int* lens;    // [B] listener lengths, clamped to >= 1
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
  int* toks;          // [max_steps, B, K]
  int* parents;       // [max_steps, B, K]
  float* scores;      // [B, K]
  int* done;          // [B, K]
  int* hyp_len;       // [B, K]
  float* att;         // [B, S, RB] attention scratch for an S the shared buffer cannot hold
  int B, S, F, M, H, V, K, max_steps;
};

// acc[r] += sum_{k0 <= k < k1} in[k * RB + r] * W[k * ld + col]
template <int RB>
__device__ __forceinline__ void accumulate(const float* in, const float* __restrict__ W, int ld,
                                           int col, int k0, int k1, float (&acc)[RB]) {
  // weight loads in flight per thread, within the 64 registers of a
  // 1024-thread block
  constexpr int kUnroll = RB >= 16 ? 2 : (RB >= 8 ? 4 : 8);
#pragma unroll kUnroll
  for (int k = k0; k < k1; ++k) {
    const float w = W[(size_t)k * ld + col];
    const float4* xv = reinterpret_cast<const float4*>(in + (size_t)k * RB);
#pragma unroll
    for (int j = 0; j < RB / 4; ++j) {
      const float4 v = xv[j];
      acc[4 * j] = fmaf(v.x, w, acc[4 * j]);
      acc[4 * j + 1] = fmaf(v.y, w, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(v.z, w, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(v.w, w, acc[4 * j + 3]);
    }
  }
}

// Partial products of RB rows at once; inputs are k-major (in[k * RB + r]).
//   kSplit = false: column c < ncols sums [x | h] (nx + nh inputs) against
//                   [Wx ; Wh], both ncols wide (an LSTM cell's gates).
//   kSplit = true:  ncols = 2G; column c < G sums x against Wx, column G + c
//                   sums h against Wh, both G wide (a GRU cell's two halves).
// Each column's inputs split into P slices; slice p's partial sum for row r
// lands in part[(p * ncols + c) * RB + r] (with P = 1 that is the product
// itself, [ncols][RB]). Ends with a barrier.
template <int RB, bool kSplit>
__device__ void rows_product(const float* x, int nx, const float* __restrict__ Wx,
                             const float* h, int nh, const float* __restrict__ Wh, int ncols,
                             int P, float* part) {
  const int G = kSplit ? ncols / 2 : ncols;
  for (int idx = threadIdx.x; idx < P * ncols; idx += blockDim.x) {
    const int c = idx % ncols;
    const int p = idx / ncols;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    if (kSplit) {
      const bool hid = c >= G;
      const int n = hid ? nh : nx;
      accumulate<RB>(hid ? h : x, hid ? Wh : Wx, G, hid ? c - G : c, p * n / P,
                     (p + 1) * n / P, acc);
    } else {
      const int n = nx + nh, k0 = p * n / P, k1 = (p + 1) * n / P;
      accumulate<RB>(x, Wx, G, c, k0, min(k1, nx), acc);
      accumulate<RB>(h, Wh, G, c, max(k0, nx) - nx, k1 - nx, acc);
    }
    float4* out = reinterpret_cast<float4*>(part + ((size_t)p * ncols + c) * RB);
#pragma unroll
    for (int j = 0; j < RB / 4; ++j)
      out[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
}

// out[c * RB + r] = act(bias[c] + sum_p part[(p * ncols + c) * RB + r]).
// Ends with a barrier.
template <int RB>
__device__ void rows_reduce(const float* part, int P, int ncols, const float* __restrict__ bias,
                            bool tanh_act, float* out) {
  for (int idx = threadIdx.x; idx < ncols * RB; idx += blockDim.x) {
    float acc = bias ? bias[idx / RB] : 0.f;
    for (int p = 0; p < P; ++p) acc += part[(size_t)p * ncols * RB + idx];
    out[idx] = tanh_act ? tanhf(acc) : acc;
  }
  __syncthreads();
}

// LSTM cells of the first `rows` rows from the gate partials of
// rows_product (4H columns i f g o): c[u * RB + r] in place, h the output
// (may be the cell's own h input: the products are complete). Ends with a
// barrier.
template <int RB>
__device__ void rows_lstm_update(const float* part, int P, const float* __restrict__ bias, int H,
                                 int rows, float* c, float* h) {
  const int G = 4 * H;
  for (int idx = threadIdx.x; idx < H * RB; idx += blockDim.x) {
    const int u = idx / RB, r = idx % RB;
    if (r >= rows) continue;
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = bias[q * H + u];
      for (int p = 0; p < P; ++p) a[q] += part[((size_t)p * G + q * H + u) * RB + r];
    }
    const float c_new = ss::sigmoid(a[1]) * c[idx] + ss::sigmoid(a[0]) * tanhf(a[2]);
    c[idx] = c_new;
    h[idx] = ss::sigmoid(a[3]) * tanhf(c_new);
  }
  __syncthreads();
}

// GRU cells (torch GRUCell) of the first `rows` rows from the split partials
// of rows_product (input r z n, then hidden r z n); h updated in place.
// Ends with a barrier.
template <int RB>
__device__ void rows_gru_update(const float* part, int P, const float* __restrict__ bi,
                                const float* __restrict__ bh, int HL, int rows, float* h) {
  const int G2 = 6 * HL;
  for (int idx = threadIdx.x; idx < HL * RB; idx += blockDim.x) {
    const int u = idx / RB, r = idx % RB;
    if (r >= rows) continue;
    float a[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a[j] = (j < 3 ? bi : bh)[(j % 3) * HL + u];
      for (int p = 0; p < P; ++p) a[j] += part[((size_t)p * G2 + j * HL + u) * RB + r];
    }
    const float rg = ss::sigmoid(a[0] + a[3]);
    const float z = ss::sigmoid(a[1] + a[4]);
    const float nn = tanhf(a[2] + rg * a[5]);
    h[idx] = (1.f - z) * nn + z * h[idx];
  }
  __syncthreads();
}

// max of v[i * stride] for i < n and the sum of exp(v - max), within one warp.
__device__ __forceinline__ void warp_max_sum(const float* v, int n, int stride, float& mx,
                                             float& sum) {
  const int lane = threadIdx.x & 31;
  mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, v[i * stride]);
  mx = ss::warp_max(mx);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += expf(v[i * stride] - mx);
  sum = ss::warp_sum(s);
}

// the shared buffer of partial sums, candidates, the regather and (for an S
// up to its width) the attention weights, in floats
__host__ __device__ inline int part_floats(const Beam& p, int HL, bool use_lm, int RB) {
  int n = kThreads;
  if (4 * p.H > n) n = 4 * p.H;
  if (use_lm && 6 * HL > n) n = 6 * HL;
  if (p.M > n) n = p.M;
  if (p.V > n) n = p.V;
  return n * RB;
}

size_t smem_floats(const Beam& p, int HL, bool use_lm, int RB) {
  size_t n = ((size_t)5 * p.H + p.F + p.M + p.V) * RB + part_floats(p, HL, use_lm, RB);
  if (use_lm) n += ((size_t)3 * HL + p.V) * RB;
  return n;
}

// One block per SM: ptxas may then give a thread all 64 registers (left to
// itself it fits the K <= 4 variant without the LM into 32, for two blocks
// an SM, and spills in the inner loop).
template <int RB, bool kUseLM>
__global__ void __launch_bounds__(kThreads, 1) beam_decode_kernel(Beam p, CharLM lm) {
  extern __shared__ float4 smem4[];
  __shared__ float score[kMaxBeams], top_score[kMaxBeams];
  __shared__ int done[kMaxBeams], hyp[kMaxBeams], parent[kMaxBeams], token[kMaxBeams];
  __shared__ int all_done;
  const int H = p.H, F = p.F, S = p.S, M = p.M, V = p.V, K = p.K, HL = lm.HL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // every buffer is [n][RB], k-major, so float4 reads stay aligned
  float* xin = reinterpret_cast<float*>(smem4);  // [H + F + H]: emb(last) | context | h1
  float* ctx = xin + H * RB;
  float* h1 = ctx + F * RB;
  float* c1 = h1 + H * RB;
  float* h2 = c1 + H * RB;
  float* c2 = h2 + H * RB;
  float* q = c2 + H * RB;       // [M] attention queries
  float* logit = q + M * RB;    // [V]
  float* part = logit + V * RB;
  const int part_n = part_floats(p, HL, kUseLM, RB);
  float* lx = part + part_n;    // [HL] LM input embedding
  float* g1 = lx + HL * RB;     // [HL] GRU states
  float* g2 = g1 + HL * RB;
  float* llogit = g2 + HL * RB;  // [V]

  const int b = blockIdx.x;
  const int len = max(p.lens[b], 1);
  const float* enc = p.enc + (size_t)b * S * F;
  const float* comp = p.comp + (size_t)b * S * M;
  const int B = p.B;
  // [S][RB] attention energies, then weights
  float* att = S * RB <= part_n ? part : p.att + (size_t)b * S * RB;

  // zero states; every beam starts from SOS, only beam 0 is live
  for (int i = tid; i < (5 * H + F) * RB; i += blockDim.x) xin[i] = 0.f;
  for (int i = tid; i < H * RB; i += blockDim.x)
    if (i % RB < K) xin[i] = p.emb[(size_t)kSOS * H + i / RB];
  if (kUseLM) {
    for (int i = tid; i < 3 * HL * RB; i += blockDim.x) lx[i] = 0.f;
    for (int i = tid; i < HL * RB; i += blockDim.x)
      if (i % RB < K) lx[i] = lm.emb[(size_t)kSOS * HL + i / RB];
  }
  if (tid < K) {
    score[tid] = tid == 0 ? 0.f : kNegInf;
    done[tid] = 0;
    hyp[tid] = 0;
  }
  __syncthreads();

  for (int t = 0; t <= p.max_steps; ++t) {
    // attention of every beam: queries, masked energies, softmax, context
    rows_product<RB, false>(h1, H, p.phi, nullptr, 0, nullptr, M, slices(M), part);
    rows_reduce<RB>(part, slices(M), M, nullptr, true, q);
    for (int idx = tid; idx < S * RB; idx += blockDim.x) {
      const int s = idx / RB, r = idx % RB;
      float acc = -INFINITY;
      if (s < len) {
        const float* cr = comp + (size_t)s * M;
        acc = 0.f;
        for (int m = 0; m < M; ++m) acc = fmaf(cr[m], q[m * RB + r], acc);
      }
      att[idx] = acc;
    }
    __syncthreads();
    if (warp < RB) {
      float mx, sum;
      warp_max_sum(att + warp, S, RB, mx, sum);
      for (int s = lane; s < S; s += 32) att[s * RB + warp] = expf(att[s * RB + warp] - mx) / sum;
    }
    __syncthreads();
    rows_product<RB, false>(att, S, enc, nullptr, 0, nullptr, F, 1, ctx);

    // speller: two LSTM cells, then the character logits (+ the LM)
    rows_product<RB, false>(xin, H + F, p.wih1, h1, H, p.whh1, 4 * H, slices(4 * H), part);
    rows_lstm_update<RB>(part, slices(4 * H), p.b1, H, K, c1, h1);
    rows_product<RB, false>(h1, H, p.wih2, h2, H, p.whh2, 4 * H, slices(4 * H), part);
    rows_lstm_update<RB>(part, slices(4 * H), p.b2, H, K, c2, h2);
    rows_product<RB, false>(h2, H, p.ct_w, nullptr, 0, nullptr, V, slices(V), part);
    rows_reduce<RB>(part, slices(V), V, p.ct_b, false, logit);
    if (kUseLM) {
      rows_product<RB, true>(lx, HL, lm.wih1, g1, HL, lm.whh1, 6 * HL, slices(6 * HL), part);
      rows_gru_update<RB>(part, slices(6 * HL), lm.bih1, lm.bhh1, HL, K, g1);
      rows_product<RB, true>(g1, HL, lm.wih2, g2, HL, lm.whh2, 6 * HL, slices(6 * HL), part);
      rows_gru_update<RB>(part, slices(6 * HL), lm.bih2, lm.bhh2, HL, K, g2);
      rows_product<RB, false>(g2, HL, lm.out_w, nullptr, 0, nullptr, V, slices(V), part);
      rows_reduce<RB>(part, slices(V), V, lm.out_b, false, llogit);
    }

    // fused log-probs; the candidates of beam r are part[r * V + v]
    if (warp < K) {
      const int r = warp;
      float mxa, lsa, mxl = 0.f, lsl = 0.f;
      warp_max_sum(logit + r, V, RB, mxa, lsa);
      lsa = logf(lsa);
      if (kUseLM) {
        warp_max_sum(llogit + r, V, RB, mxl, lsl);
        lsl = logf(lsl);
      }
      if (t == p.max_steps) {
        // the still-open beams pay their terminal EOS cost
        float lp = (logit[kEOS * RB + r] - mxa) - lsa;
        if (kUseLM) lp += lm.weight * ((llogit[kEOS * RB + r] - mxl) - lsl);
        if (lane == 0 && !done[r]) score[r] += lp;
      } else {
        for (int v = lane; v < V; v += 32) {
          float lp = (logit[v * RB + r] - mxa) - lsa;
          if (kUseLM) lp += lm.weight * ((llogit[v * RB + r] - mxl) - lsl);
          // a finished beam may only extend by SOS, at no cost
          if (done[r]) lp = v == kSOS ? 0.f : kNegInf;
          part[r * V + v] = score[r] + lp;
        }
      }
    }
    __syncthreads();
    if (t == p.max_steps) break;

    // top K of the K * V candidates: K rounds of a first-occurrence argmax
    if (warp == 0) {
      for (int j = 0; j < K; ++j) {
        float best = -INFINITY;
        int best_i = INT_MAX;
        for (int i = lane; i < K * V; i += 32) {
          const float v = part[i];
          if (v > best) {
            best = v;
            best_i = i;
          }
        }
        ss::warp_argmax(best, best_i);
        if (lane == 0) {
          top_score[j] = best;
          parent[j] = best_i / V;
          token[j] = best_i % V;
          part[best_i] = -INFINITY;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // bookkeeping: a beam is done once it or its parent emitted EOS; its
    // length counts the characters before EOS
    int nd = 0, nh = 0;
    if (tid < K) {
      const int pd = done[parent[tid]];
      nd = pd || token[tid] == kEOS;
      nh = hyp[parent[tid]] + (nd ? 0 : 1);
      const size_t o = ((size_t)t * B + b) * K + tid;
      p.toks[o] = token[tid];
      p.parents[o] = parent[tid];
    }
    // each survivor takes its parent's states (through the scratch buffer)
    float* sc = part;
    for (int idx = tid; idx < H * RB; idx += blockDim.x) {
      const int r = idx % RB;
      if (r >= K) continue;
      const int src = idx - r + parent[r];
      sc[idx] = h1[src];
      sc[H * RB + idx] = c1[src];
      sc[2 * H * RB + idx] = h2[src];
      sc[3 * H * RB + idx] = c2[src];
    }
    __syncthreads();
    if (tid < K) {
      done[tid] = nd;
      hyp[tid] = nh;
      score[tid] = top_score[tid];
    }
    for (int idx = tid; idx < H * RB; idx += blockDim.x) {
      const int r = idx % RB;
      if (r >= K) continue;
      h1[idx] = sc[idx];
      c1[idx] = sc[H * RB + idx];
      h2[idx] = sc[2 * H * RB + idx];
      c2[idx] = sc[3 * H * RB + idx];
      xin[idx] = p.emb[(size_t)token[r] * H + idx / RB];
    }
    if (kUseLM) {
      __syncthreads();
      for (int idx = tid; idx < HL * RB; idx += blockDim.x) {
        const int r = idx % RB;
        if (r >= K) continue;
        const int src = idx - r + parent[r];
        sc[idx] = g1[src];
        sc[HL * RB + idx] = g2[src];
      }
      __syncthreads();
      for (int idx = tid; idx < HL * RB; idx += blockDim.x) {
        const int r = idx % RB;
        if (r >= K) continue;
        g1[idx] = sc[idx];
        g2[idx] = sc[HL * RB + idx];
        lx[idx] = lm.emb[(size_t)token[r] * HL + idx / RB];
      }
    }
    __syncthreads();
    if (tid == 0) {
      int all = 1;
      for (int j = 0; j < K; ++j) all &= done[j];
      all_done = all;
    }
    __syncthreads();
    if (all_done) {
      // nothing can change any more: SOS tokens and identity parents
      for (int i = tid; i < (p.max_steps - t - 1) * K; i += blockDim.x) {
        const size_t o = ((size_t)(t + 1 + i / K) * B + b) * K + i % K;
        p.toks[o] = kSOS;
        p.parents[o] = i % K;
      }
      break;
    }
  }

  if (tid < K) {
    p.scores[(size_t)b * K + tid] = score[tid];
    p.done[(size_t)b * K + tid] = done[tid];
    p.hyp_len[(size_t)b * K + tid] = hyp[tid];
  }
}

template <int RB, bool kUseLM>
int launch_rows(const Beam& p, const CharLM& lm, int device, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(p, lm.HL, kUseLM, RB);
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + 1024 > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(beam_decode_kernel<RB, kUseLM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_decode_kernel<RB, kUseLM>
      <<<p.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, lm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kUseLM>
int launch(const Beam& p, const CharLM& lm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.K < 1 || p.K > kMaxBeams) return static_cast<int>(cudaErrorInvalidValue);
  if (p.K <= 4) return launch_rows<4, kUseLM>(p, lm, device, stream);
  if (p.K <= 8) return launch_rows<8, kUseLM>(p, lm, device, stream);
  return launch_rows<16, kUseLM>(p, lm, device, stream);
}


// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kBT = 256;        // threads of a cluster CTA
constexpr int kBW = kBT / 32;   // its warps
constexpr int kKC = 32;         // stream rows a ring stage
// A CTA owns kSW = 4H / C gate columns: the width of its weight stream, read in
// the ring at a pitch of kSW + 16 floats (a read phase's two rows on other banks).
constexpr int kSW = 128;
constexpr int kStage = kKC * (kSW + 16);  // floats of a ring stage
constexpr int kMaxStages = 8;
// rows (utterances x beams, each K padded to 4, 8 or 16) a cluster decodes:
// up to kMaxRows / 2 for one or two utterances, kMaxRows for one utterance
constexpr int kMaxRows = 16;

// The 16-row variant keeps one copy of h1, h2 and the GRU states, and the
// context in the partials' buffer (see the header).
template <int NR>
constexpr bool kSingleBuffered = NR > kMaxRows / 2;

// A cluster CTA's shared memory (offsets in floats) and the shape it serves.
struct CPlan {
  int H, F, M, V, HL, S, K, C, U, RB, NR, Hc, Fc, Mc, Vc, HLc, Sc, nst, rows;
  int emb, ctx, h1, h2, lx, g1, g2, c1, c2, q, phi, ctw, low, gbuf, slots, stats, logit, llogit,
      small, att, ring, total;
};

inline int up4(int n) { return (n + 3) & ~3; }

// The plan for C CTAs over U utterances of K beams (rows = U x RB, RB = K
// rounded up to 4, 8 or 16), or total = 0 where the route does not serve.
// Mirrored by ops/kernels/beam.py::cluster_plan; ss_beam_cluster_plan below
// reports it.
CPlan cluster_plan(const Beam& p, int HL, int C, int U, int max_floats) {
  CPlan P{};
  P.H = p.H, P.F = p.F, P.M = p.M, P.V = p.V, P.HL = HL, P.S = p.S, P.K = p.K, P.C = C, P.U = U;
  P.RB = p.K <= 4 ? 4 : (p.K <= 8 ? 8 : 16);
  P.NR = U * P.RB;
  const bool single = P.NR > kMaxRows / 2;
  // the 16-row variant stages a CTA's context features (F / C of them) in its gate sums
  const bool ok = (C == 1 || C == 2 || C == 4 || C == 8) && U >= 1 && p.K >= 1 &&
                  p.K <= kMaxRows && P.NR <= (U == 1 ? kMaxRows : kMaxRows / 2) &&
                  p.K <= p.V && 4 * p.H == kSW * C && p.F % kKC == 0 && p.F % (4 * C) == 0 &&
                  (!single || p.F / C <= kSW) && p.M % C == 0 && p.M % 4 == 0 &&
                  (HL == 0 || (HL % kKC == 0 && HL % C == 0 && 6 * (HL / C) <= kSW &&
                               (3 * HL / C) % 4 == 0));
  if (!ok) return P;
  const int NR = P.NR, H = p.H, nb = single ? 1 : 2;  // nb: copies of h1, h2, g1, g2
  P.Hc = H / C, P.Fc = p.F / C, P.Mc = p.M / C, P.Vc = (p.V + C - 1) / C;
  P.HLc = HL / C, P.Sc = (p.S + C - 1) / C;
  P.rows = 2 * HL + 2 * H + p.F + 2 * H;  // GRU1, GRU2, cell 1, cell 2
  int o = 0;
  auto take = [&](int n) {
    const int r = o;
    o += up4(n);
    return r;
  };
  P.emb = take(H * NR), P.ctx = single ? -1 : take(p.F * NR);
  P.h1 = take(nb * H * NR), P.h2 = take(nb * H * NR);
  P.lx = take(HL * NR), P.g1 = take(nb * HL * NR), P.g2 = take(nb * HL * NR);
  P.c1 = take(P.Hc * NR), P.c2 = take(P.Hc * NR);
  P.q = take((p.M > p.V ? p.M : p.V) * NR);  // the queries; CTA 0's candidates in (f)
  P.phi = take(H * P.Mc), P.ctw = take(P.Hc * p.V), P.low = take(HL * P.Vc);
  P.gbuf = take(kSW * NR);
  // the context partials (b)-(c), CTA 0's logit partials (e)-(f); at 16 rows the context (c)-(d)
  P.slots = take((p.F > C * p.V ? p.F : C * p.V) * NR);
  if (single) P.ctx = P.slots;
  P.stats = take(2 * C * NR);
  P.logit = take(p.V * NR), P.llogit = take(p.V * NR), P.small = take(8 * kMaxRows + 32);
  P.att = -1;
  if (o + up4(P.Sc * NR) + 3 * kStage <= max_floats) P.att = take(P.Sc * NR);
  P.ring = o;
  P.nst = (max_floats - o) / kStage;
  if (P.nst > kMaxStages) P.nst = kMaxStages;
  if (P.nst < 3) return P;
  P.total = o + P.nst * kStage;
  return P;
}

// The weight stream of a CTA: its panels [rows][kSW], read in chunks of kKC
// rows through a ring of nst stages by cp.async, nst - 1 chunks ahead; the
// chunks of one step repeat every step, so the ring runs on across steps.
struct Ring {
  float* buf;
  const float* src;
  int nst, per_step;
  int use, load, chunk;  // the stage to consume next, the stage and the chunk to load next
};

__device__ __forceinline__ int wrap_inc(int i, int n) { return i + 1 == n ? 0 : i + 1; }

// the next chunk of the step's stream into its stage
__device__ __forceinline__ void ring_load(Ring& rg) {
  float* dst = rg.buf + rg.load * kStage;
  const float* src = rg.src + (size_t)rg.chunk * kKC * kSW;
#pragma unroll
  for (int i = threadIdx.x; i < kKC * kSW / 4; i += kBT) {
    const int row = i / (kSW / 4), c4 = i - row * (kSW / 4);
    ss::cp_async16_zfill(dst + row * (kSW + 16) + c4 * 4, src + row * kSW + c4 * 4, true);
  }
  asm volatile("cp.async.commit_group;");
  rg.load = wrap_inc(rg.load, rg.nst);
  rg.chunk = wrap_inc(rg.chunk, rg.per_step);
}

// all but the newest `pending` commit groups of this thread have landed
__device__ __forceinline__ void ring_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;"); break;
    case 2: asm volatile("cp.async.wait_group 2;"); break;
    case 3: asm volatile("cp.async.wait_group 3;"); break;
    case 4: asm volatile("cp.async.wait_group 4;"); break;
    case 5: asm volatile("cp.async.wait_group 5;"); break;
    default: asm volatile("cp.async.wait_group 6;"); break;
  }
}

// gbuf[col][r] = sum over the next nrows stream rows k of in(k, col)[r] *
// W[k][col], for this CTA's kSW columns and NR rows. A warp owns 16 columns (a
// float4 a lane); its lanes' eight k-groups split each chunk's rows and meet
// by shuffles. Every weight is read once from shared memory. `in(k0, col4)`
// gives the k-major input ([k][NR]) of the chunk starting at stream row k0 for
// the columns of col4. Ends with a barrier.
template <int NR, typename In>
__device__ void stream_product(Ring& rg, int nrows, In in, float* gbuf) {
  static_assert(kSW == 16 * kBW, "a warp's lanes span 16 columns");
  constexpr int kKG = 8;  // k-groups of a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col4 = warp * 4 + (lane & 3), kg = lane >> 2;
  float acc[4][NR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[i][r] = 0.f;
  for (int k0 = 0; k0 < nrows; k0 += kKC) {
    ring_wait(rg.nst - 2);
    __syncthreads();
    const float* st = rg.buf + rg.use * kStage;
    const float* x = in(k0, col4);
#pragma unroll
    for (int i = 0; i < kKC / kKG; ++i) {
      const int k = kg + kKG * i;
      const float4 w = *reinterpret_cast<const float4*>(st + k * (kSW + 16) + col4 * 4);
#pragma unroll
      for (int j = 0; j < NR / 4; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(x + k * NR + 4 * j);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][4 * j + e] = fmaf(xs[e], w.x, acc[0][4 * j + e]);
          acc[1][4 * j + e] = fmaf(xs[e], w.y, acc[1][4 * j + e]);
          acc[2][4 * j + e] = fmaf(xs[e], w.z, acc[2][4 * j + e]);
          acc[3][4 * j + e] = fmaf(xs[e], w.w, acc[3][4 * j + e]);
        }
      }
    }
    ring_load(rg);  // into the stage consumed one chunk ago, which the barrier above freed
    rg.use = wrap_inc(rg.use, rg.nst);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float v = acc[i][r];
      v += __shfl_xor_sync(ss::kFullMask, v, 4);
      v += __shfl_xor_sync(ss::kFullMask, v, 8);
      v += __shfl_xor_sync(ss::kFullMask, v, 16);
      acc[i][r] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NR / 4; ++j)
        *reinterpret_cast<float4*>(gbuf + (col4 * 4 + i) * NR + 4 * j) = make_float4(
            acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  }
  __syncthreads();
}

template <int NR, bool kUseLM>
__global__ void __launch_bounds__(kBT, 1)
beam_cluster_kernel(Beam p, CharLM lm, CPlan P, const float* __restrict__ wstream,
                    float* __restrict__ att_g) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = P.C, c = blockIdx.x;  // the cluster spans the grid's x; this CTA's rank
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = P.H, F = P.F, M = P.M, V = P.V, HL = P.HL, S = P.S, K = P.K;
  const int U = P.U, RB = P.RB, Hc = P.Hc, Fc = P.Fc, Mc = P.Mc, Vc = P.Vc, HLc = P.HLc;
  const int B = p.B, b0 = blockIdx.y * U;  // the cluster's utterances b0 .. b0 + U - 1
  constexpr bool kSingle = kSingleBuffered<NR>;
  float* emb_x = sm + P.emb;  // [H][NR] the embedding of each row's last token
  float* ctx = sm + P.ctx;    // [F][NR] the context (at 16 rows in the partials' buffer)
  float* h1 = sm + P.h1;      // [2][H][NR] the first cell's h by step parity ([H][NR] at 16 rows)
  float* h2 = sm + P.h2;      // [2][H][NR]
  float* lx = sm + P.lx;      // [HL][NR] the LM's input embedding
  float* g1 = sm + P.g1;      // [2][HL][NR] the GRU states
  float* g2 = sm + P.g2;
  float* c1 = sm + P.c1;      // [Hc][NR] the cells of this CTA's units
  float* c2 = sm + P.c2;
  float* q = sm + P.q;        // [M][NR] attention queries
  float* phi = sm + P.phi;    // [H][Mc] this CTA's columns of phi
  float* ctw = sm + P.ctw;    // [Hc][V] the rows of ct_w of this CTA's units
  float* low = sm + P.low;    // [HL][Vc] this CTA's columns of the LM's output layer
  float* gbuf = sm + P.gbuf;  // [kSW][NR] a product's gate sums
  float* slots = sm + P.slots;  // [C][Fc][NR] the context partials the cluster owes this CTA
  float* stats = sm + P.stats;  // [2][C][NR] their max and sum of exp
  float* lgs = slots;           // [C][V][NR] (CTA 0, e-f) the logit partials of each CTA's units
  float* logit = sm + P.logit;  // [V][NR] (CTA 0)
  float* llogit = sm + P.llogit;  // [V][NR] (CTA 0) the LM's logits
  float* cand = q;                // [U][RB][V] (CTA 0, f) each beam's candidates
  int* tok = reinterpret_cast<int*>(sm + P.small);  // [kMaxRows] the step's token of each row
  int* par = tok + kMaxRows;       // [kMaxRows] its parent beam
  int* done = par + kMaxRows;      // [kMaxRows] (CTA 0)
  int* hyp = done + kMaxRows;      // [kMaxRows] (CTA 0)
  int* lens = hyp + kMaxRows;      // [kMaxRows] listener lengths of the utterances
  int* udone = lens + kMaxRows;    // [kMaxRows] (CTA 0) every beam of the utterance done
  float* score = reinterpret_cast<float*>(udone + kMaxRows);  // [kMaxRows] (CTA 0)
  float* tscore = score + kMaxRows;                             // [kMaxRows] (CTA 0)
  int* flags = reinterpret_cast<int*>(tscore + kMaxRows);       // [0] stop
  const int s0 = c * P.Sc, ns = max(0, min(S, s0 + P.Sc) - s0);  // this CTA's memory steps
  float* att = P.att >= 0 ? sm + P.att : att_g + ((size_t)blockIdx.y * C + c) * P.Sc * NR;

  // a row r is beam r % RB of utterance r / RB; rows past K or past B stay zero
  auto live = [&](int r) { return r % RB < K && b0 + r / RB < B; };

  for (int i = tid; i < P.ring; i += kBT) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < H * Mc; i += kBT) {
    const int k = i / Mc, m = i - k * Mc;
    phi[i] = p.phi[(size_t)k * M + c * Mc + m];
  }
  for (int i = tid; i < Hc * V; i += kBT) ctw[i] = p.ct_w[(size_t)c * Hc * V + i];
  if (kUseLM)
    for (int i = tid; i < HL * Vc; i += kBT) {
      const int k = i / Vc, v = c * Vc + i - k * Vc;
      low[i] = v < V ? lm.out_w[(size_t)k * V + v] : 0.f;
    }
  for (int i = tid; i < H * NR; i += kBT)
    if (live(i % NR)) emb_x[i] = p.emb[(size_t)kSOS * H + i / NR];
  if (kUseLM)
    for (int i = tid; i < HL * NR; i += kBT)
      if (live(i % NR)) lx[i] = lm.emb[(size_t)kSOS * HL + i / NR];
  if (tid < kMaxRows) {
    const int r = tid;
    lens[r] = r < U && b0 + r < B ? max(p.lens[b0 + r], 1) : 1;
    udone[r] = !(r < U && b0 + r < B);
    score[r] = r % RB == 0 ? 0.f : kNegInf;
    done[r] = 0;
    hyp[r] = 0;
  }
  Ring rg{sm + P.ring, wstream + (size_t)c * P.rows * kSW, P.nst, P.rows / kKC, 0, 0, 0};
  for (int g = 0; g < P.nst - 1; ++g) ring_load(rg);
  cluster.sync();  // every CTA's buffers are set before the first remote write

  for (int t = 0; t <= p.max_steps; ++t) {
    // this step's states and the next one's (one copy at 16 rows)
    const int cur = kSingle ? 0 : t & 1, nxt = kSingle ? 0 : cur ^ 1;
    const float* h1c = h1 + cur * H * NR;
    float* h1n = h1 + nxt * H * NR;
    const float* h2c = h2 + cur * H * NR;
    float* h2n = h2 + nxt * H * NR;
    const float* g1c = g1 + cur * HL * NR;
    float* g1n = g1 + nxt * HL * NR;
    const float* g2c = g2 + cur * HL * NR;
    float* g2n = g2 + nxt * HL * NR;

    // (a) this CTA's queries, to every CTA; the first GRU cell of its LM units
    for (int i = tid >> 2; i < Mc * NR; i += kBT / 4) {  // four lanes an item, a quarter of k each
      const int m = i / NR, r = i - m * NR, quarter = tid & 3;
      float acc = 0.f;
#pragma unroll 8
      for (int k = quarter; k < H; k += 4) acc = fmaf(h1c[k * NR + r], phi[k * Mc + m], acc);
      acc += __shfl_xor_sync(0xfu << (lane & ~3), acc, 1);
      acc += __shfl_xor_sync(0xfu << (lane & ~3), acc, 2);
      if (quarter == 0) {
        const float v = tanhf(acc);
        for (int dst = 0; dst < C; ++dst) cluster.map_shared_rank(q, dst)[(c * Mc + m) * NR + r] = v;
      }
    }
    // dst[(u0 + j) * NR + r] = gbuf[j * NR + r] in every CTA, for j < n: the new
    // values a phase staged in gbuf, each over the first of the sums it was
    // computed from (the same thread reads and writes it); single-buffered, after
    // the cluster barrier's wait says that no CTA reads dst any more
    auto all_gather = [&](float* dst, int u0, int n) {
      for (int i = tid; i < n * NR; i += kBT) {
        const float v = gbuf[i];
        for (int d = 0; d < C; ++d) cluster.map_shared_rank(dst, d)[u0 * NR + i] = v;
      }
    };
    // a GRU cell of this CTA's units from gbuf (input r z n, then hidden r z n), to
    // every CTA; single-buffered (hn is hc) it arrives now that its product has read
    // hc and writes after the wait
    auto gru_cell = [&](const float* hc, float* hn, const float* bi, const float* bh) {
      if (kSingle) ss::cluster_arrive();
      for (int i = tid; i < HLc * NR; i += kBT) {
        const int j = i / NR, r = i - j * NR, u = c * HLc + j;
        float hv = 0.f;
        if (live(r)) {
          float a[3], h[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            a[g] = gbuf[(g * HLc + j) * NR + r] + bi[g * HL + u];
            h[g] = gbuf[((3 + g) * HLc + j) * NR + r] + bh[g * HL + u];
          }
          const float rg_ = ss::sigmoid(a[0] + h[0]);
          const float z = ss::sigmoid(a[1] + h[1]);
          const float nn = tanhf(a[2] + rg_ * h[2]);
          hv = (1.f - z) * nn + z * hc[u * NR + r];
        }
        gbuf[i] = hv;
      }
      if (kSingle) ss::cluster_wait();
      all_gather(hn, c * HLc, HLc);
    };
    if (kUseLM) {
      stream_product<NR>(rg, HL, [&](int k0, int col4) {
        return (col4 * 4 < 3 * HLc ? lx : g1c) + k0 * NR;
      }, gbuf);
      gru_cell(g1c, g1n, lm.bih1, lm.bhh1);
    }
    cluster.sync();

    // (b) the attention over this CTA's memory steps: energies, their max and sum of
    // exp, and the unnormalised context, reduce-scattered to the owners of its features
    // eight lanes per (memory step, utterance), its comp row from L2 in float4s
    for (int i = tid >> 3; i < ns * U; i += kBT / 8) {
      const int sl = i / U, u = i - sl * U, s = s0 + sl, b = b0 + u, part = tid & 7;
      float acc[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[j] = 0.f;
      const bool ok = b < B && s < lens[u];
      if (ok) {
        const float4* cr = reinterpret_cast<const float4*>(p.comp + ((size_t)b * S + s) * M);
#pragma unroll 4
        for (int m4 = part; m4 < M / 4; m4 += 8) {
          const float4 cv = cr[m4];
          const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* qm = q + (4 * m4 + e) * NR + u * RB;
#pragma unroll
            for (int j = 0; j < NR; ++j)
              if (j < RB) acc[j] = fmaf(cs[e], qm[j], acc[j]);
          }
        }
      }
      const unsigned group = 0xffu << (lane & ~7);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        acc[j] += __shfl_xor_sync(group, acc[j], 1);
        acc[j] += __shfl_xor_sync(group, acc[j], 2);
        acc[j] += __shfl_xor_sync(group, acc[j], 4);
      }
      // lane `part` of the eight writes the rows j = part (mod 8)
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (j < RB && (j & 7) == part) att[sl * NR + u * RB + j] = ok ? acc[j] : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < NR; r += kBW) {
      float mx = -INFINITY;
      for (int sl = lane; sl < ns; sl += 32) mx = fmaxf(mx, att[sl * NR + r]);
      mx = ss::warp_max(mx);
      float sum = 0.f;
      for (int sl = lane; sl < ns; sl += 32) {
        const float w = mx == -INFINITY ? 0.f : expf(att[sl * NR + r] - mx);
        att[sl * NR + r] = w;
        sum += w;
      }
      sum = ss::warp_sum(sum);
      if (lane < C) {
        float* st = cluster.map_shared_rank(stats, lane);
        st[c * NR + r] = mx;
        st[(C + c) * NR + r] = sum;
      }
    }
    __syncthreads();
    // four lanes per (4 features, utterance), each over a quarter of the steps
    for (int i = tid >> 2; i < F / 4 * U; i += kBT / 4) {
      const int u = i / (F / 4), f = (i - u * (F / 4)) * 4, b = b0 + u, quarter = tid & 3;
      float acc[4][NR];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[e][j] = 0.f;
      if (b < B) {
        const float* eb = p.enc + ((size_t)b * S + s0) * F + f;
#pragma unroll 8
        for (int sl = quarter; sl < ns; sl += 4) {
          const float4 ev = *reinterpret_cast<const float4*>(eb + (size_t)sl * F);
          const float es[4] = {ev.x, ev.y, ev.z, ev.w};
          const float* w = att + sl * NR + u * RB;
#pragma unroll
          for (int j = 0; j < NR; ++j)
            if (j < RB) {
              const float wj = w[j];
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[e][j] = fmaf(wj, es[e], acc[e][j]);
            }
        }
      }
      const unsigned group = 0xfu << (lane & ~3);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          acc[e][j] += __shfl_xor_sync(group, acc[e][j], 1);
          acc[e][j] += __shfl_xor_sync(group, acc[e][j], 2);
        }
      if (quarter == 0) {
        const int own = f / Fc;
        float* dst = cluster.map_shared_rank(slots, own) + (c * Fc + f - own * Fc) * NR + u * RB;
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < NR; ++j)
            if (j < RB) dst[e * NR + j] = acc[e][j];
      }
    }
    if (kUseLM) {
      stream_product<NR>(rg, HL, [&](int k0, int col4) {
        return (col4 * 4 < 3 * HLc ? g1n : g2c) + k0 * NR;
      }, gbuf);
      gru_cell(g2c, g2n, lm.bih2, lm.bhh2);
    }
    cluster.sync();

    // (c) the context of this CTA's features, merged over the cluster's partials, to
    // every CTA; the LM's logits of this CTA's columns, to CTA 0. At 16 rows the
    // context overwrites the partials: staged in gbuf until every CTA has merged.
    for (int i = tid; i < Fc * NR; i += kBT) {
      const int fo = i / NR, r = i - fo * NR;
      float mx = -INFINITY;
      for (int src = 0; src < C; ++src) mx = fmaxf(mx, stats[src * NR + r]);
      float den = 0.f, num = 0.f;
      for (int src = 0; src < C; ++src) {
        const float m = stats[src * NR + r];
        if (m != -INFINITY) {
          const float e = expf(m - mx);
          den = fmaf(stats[(C + src) * NR + r], e, den);
          num = fmaf(slots[(src * Fc + fo) * NR + r], e, num);
        }
      }
      const float v = den > 0.f ? num / den : 0.f;
      if (kSingle) gbuf[i] = v;
      else
        for (int dst = 0; dst < C; ++dst)
          cluster.map_shared_rank(ctx, dst)[(c * Fc + fo) * NR + r] = v;
    }
    if (kSingle) ss::cluster_arrive();
    if (kUseLM) {
      for (int i = tid >> 3; i < Vc * NR; i += kBT / 8) {  // eight lanes an item
        const int vo = i / NR, r = i - vo * NR, v = c * Vc + vo, part = tid & 7;
        float acc = 0.f;
        for (int k = part; k < HL; k += 8) acc = fmaf(g2n[k * NR + r], low[k * Vc + vo], acc);
        const unsigned group = 0xffu << (lane & ~7);
        acc += __shfl_xor_sync(group, acc, 1);
        acc += __shfl_xor_sync(group, acc, 2);
        acc += __shfl_xor_sync(group, acc, 4);
        if (part == 0 && v < V) cluster.map_shared_rank(llogit, 0)[v * NR + r] = acc + lm.out_b[v];
      }
    }
    if (kSingle) {
      ss::cluster_wait();
      all_gather(ctx, c * Fc, Fc);
    }
    cluster.sync();

    // (d) the first cell: [emb | context | h1] against this CTA's gate columns
    stream_product<NR>(rg, 2 * H + F, [&](int k0, int) {
      return k0 < H ? emb_x + k0 * NR : k0 < H + F ? ctx + (k0 - H) * NR : h1c + (k0 - H - F) * NR;
    }, gbuf);
    // an LSTM cell of this CTA's units from gbuf (i f g o blocks of Hc columns), h to
    // every CTA (single-buffered: after the cluster's reads, as gru_cell)
    auto lstm_cell = [&](float* cc, float* hn, const float* bias) {
      if (kSingle) ss::cluster_arrive();
      for (int i = tid; i < Hc * NR; i += kBT) {
        const int j = i / NR, r = i - j * NR, u = c * Hc + j;
        float hv = 0.f, cv = 0.f;
        if (live(r)) {
          float a[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) a[g] = gbuf[(g * Hc + j) * NR + r] + bias[g * H + u];
          cv = ss::sigmoid(a[1]) * cc[j * NR + r] + ss::sigmoid(a[0]) * tanhf(a[2]);
          hv = ss::sigmoid(a[3]) * tanhf(cv);
        }
        cc[j * NR + r] = cv;
        gbuf[i] = hv;
      }
      if (kSingle) ss::cluster_wait();
      all_gather(hn, c * Hc, Hc);
    };
    lstm_cell(c1, h1n, p.b1);
    cluster.sync();

    // (e) the second cell: [h1 | h2]; then the logits' partial sums over this CTA's units, to CTA 0
    stream_product<NR>(rg, 2 * H, [&](int k0, int) {
      return k0 < H ? h1n + k0 * NR : h2c + (k0 - H) * NR;
    }, gbuf);
    lstm_cell(c2, h2n, p.b2);
    __syncthreads();
    for (int i = tid; i < V * NR; i += kBT) {
      const int v = i / NR, r = i - v * NR;
      float acc = 0.f;
      for (int j = 0; j < Hc; ++j) acc = fmaf(h2n[(c * Hc + j) * NR + r], ctw[j * V + v], acc);
      cluster.map_shared_rank(lgs, 0)[(c * V + v) * NR + r] = acc;
    }
    cluster.sync();

    // (f) CTA 0: the fused log-probs, the top K of each utterance, the bookkeeping, and
    // each row's token and parent to every CTA
    if (c == 0) {
      for (int i = tid; i < V * NR; i += kBT) {
        const int v = i / NR;
        float acc = p.ct_b[v];
        for (int src = 0; src < C; ++src) acc += lgs[src * V * NR + i];
        logit[i] = acc;
      }
      __syncthreads();
      for (int r = warp; r < NR; r += kBW) {  // a warp a row
        if (!live(r) || udone[r / RB]) continue;
        float mxa, lsa, mxl = 0.f, lsl = 0.f;
        warp_max_sum(logit + r, V, NR, mxa, lsa);
        lsa = logf(lsa);
        if (kUseLM) {
          warp_max_sum(llogit + r, V, NR, mxl, lsl);
          lsl = logf(lsl);
        }
        if (t == p.max_steps) {
          // the still-open beams pay their terminal EOS cost
          float lp = (logit[kEOS * NR + r] - mxa) - lsa;
          if (kUseLM) lp += lm.weight * ((llogit[kEOS * NR + r] - mxl) - lsl);
          if (lane == 0 && !done[r]) score[r] += lp;
        } else {
          for (int v = lane; v < V; v += 32) {
            float lp = (logit[v * NR + r] - mxa) - lsa;
            if (kUseLM) lp += lm.weight * ((llogit[v * NR + r] - mxl) - lsl);
            // a finished beam may only extend by SOS, at no cost
            if (done[r]) lp = v == kSOS ? 0.f : kNegInf;
            cand[r * V + v] = score[r] + lp;
          }
        }
      }
      __syncthreads();
      if (t < p.max_steps) {
        // top K of each utterance's K * V candidates (see the header): each candidate's
        // rank among its beam's V, the K best of each beam kept in rank order ...
        float* sv = gbuf;                                    // [U][RB][RB] their scores
        int* si = reinterpret_cast<int*>(gbuf + NR * RB);    // [U][RB][RB] their flat indices
        for (int i = tid; i < U * K * V; i += kBT) {
          const int u = i / (K * V), fi = i - u * K * V, r = fi / V, v = fi - r * V;
          if (udone[u]) continue;
          const float* row = cand + (u * RB + r) * V;
          const float x = row[v];
          int rank = 0;
          for (int v2 = 0; v2 < V; ++v2) {
            const float y = row[v2];
            rank += y > x || (y == x && v2 < v);
          }
          if (rank < K) {
            sv[(u * RB + r) * RB + rank] = x;
            si[(u * RB + r) * RB + rank] = fi;
          }
        }
        __syncthreads();
        // ... then each survivor's rank over the utterance's K * K: its own beam's
        // better ones, and each other beam's, a prefix of its sorted survivors (on equal
        // scores a lower beam's candidate is the better one)
        for (int i = tid; i < U * K * K; i += kBT) {
          const int u = i / (K * K), r = (i - u * K * K) / K, j = i - u * K * K - r * K;
          if (udone[u]) continue;
          const float x = sv[(u * RB + r) * RB + j];
          int rank = j;
          for (int r2 = 0; r2 < K && rank < K; ++r2) {
            if (r2 == r) continue;
            const float* o = sv + (u * RB + r2) * RB;
            int lo = 0, hi = K;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              const float y = o[mid];
              if (y > x || (y == x && r2 < r)) lo = mid + 1;
              else hi = mid;
            }
            rank += lo;
          }
          if (rank < K) {
            const int fi = si[(u * RB + r) * RB + j], w = u * RB + rank;
            tscore[w] = x;
            par[w] = fi / V;
            tok[w] = fi % V;
          }
        }
        // a finished utterance keeps SOS tokens and identity parents
        for (int i = tid; i < U * K; i += kBT) {
          const int u = i / K, j = i - u * K, r = u * RB + j;
          if (udone[u]) {
            tscore[r] = score[r];
            par[r] = j;
            tok[r] = kSOS;
          }
        }
        __syncthreads();
        // a beam is done once it or its parent emitted EOS; its length counts the
        // characters before EOS
        int nd = 0, nh = 0;
        const bool row = tid < NR && live(tid);
        if (row) {
          const int r = tid, u = r / RB, src = u * RB + par[r];
          nd = done[src] || tok[r] == kEOS;
          nh = hyp[src] + (nd ? 0 : 1);
          const size_t o = ((size_t)t * B + b0 + u) * K + r % RB;
          p.toks[o] = tok[r];
          p.parents[o] = par[r];
        }
        __syncthreads();
        if (row) {
          done[tid] = nd;
          hyp[tid] = nh;
          score[tid] = tscore[tid];
        }
        __syncthreads();
        if (tid < U && !udone[tid]) {
          int all = 1;
          for (int j = 0; j < K; ++j) all &= done[tid * RB + j];
          udone[tid] = all;
        }
        __syncthreads();
        int all = 1;
        for (int u = 0; u < U; ++u) all &= udone[u];
        if (all) {
          // nothing can change any more: SOS tokens and identity parents
          for (int i = tid; i < (p.max_steps - t - 1) * U * K; i += kBT) {
            const int st = t + 1 + i / (U * K), uk = i % (U * K), u = uk / K, j = uk - u * K;
            if (b0 + u >= B) continue;
            const size_t o = ((size_t)st * B + b0 + u) * K + j;
            p.toks[o] = kSOS;
            p.parents[o] = j;
          }
        }
        if (tid < C) {
          int* fl = cluster.map_shared_rank(flags, tid);
          int* tk = cluster.map_shared_rank(tok, tid);
          int* pa = cluster.map_shared_rank(par, tid);
          for (int r = 0; r < NR; ++r) {
            tk[r] = tok[r];
            pa[r] = par[r];
          }
          fl[0] = all;
        }
      } else if (tid < C) {
        cluster.map_shared_rank(flags, tid)[0] = 1;
      }
    }
    cluster.sync();
    if (flags[0]) break;

    // (g) every survivor takes its parent's states; the next step's inputs
    int src[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) src[r] = r < NR && live(r) ? (r / RB) * RB + par[r] : -1;
    auto regather = [&](float* a, int n) {
      for (int k = tid; k < n; k += kBT) {
        float v[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) v[r] = a[k * NR + r];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float x = 0.f;
#pragma unroll
          for (int r2 = 0; r2 < NR; ++r2) x = src[r] == r2 ? v[r2] : x;
          a[k * NR + r] = x;
        }
      }
    };
    regather(h1n, H);
    regather(h2n, H);
    regather(c1, Hc);
    regather(c2, Hc);
    if (kUseLM) {
      regather(g1n, HL);
      regather(g2n, HL);
    }
#pragma unroll 4
    for (int i = tid; i < (H + HL) * NR; i += kBT) {
      const int r = i % NR, k = i / NR;
      const bool on = src[r] >= 0;
      if (k < H) emb_x[i] = on ? p.emb[(size_t)tok[r] * H + k] : 0.f;
      else lx[i - H * NR] = on ? lm.emb[(size_t)tok[r] * HL + k - H] : 0.f;
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;");

  if (c == 0 && tid < NR && live(tid)) {
    const size_t o = (size_t)(b0 + tid / RB) * K + tid % RB;
    p.scores[o] = score[tid];
    p.done[o] = done[tid];
    p.hyp_len[o] = hyp[tid];
  }
}

template <int NR, bool kUseLM>
int launch_cluster(const Beam& p, const CharLM& lm, const CPlan& P, const float* wstream,
                   float* att_g, cudaStream_t stream) {
  const auto kernel = beam_cluster_kernel<NR, kUseLM>;
  const size_t smem = sizeof(float) * P.total;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.C, (p.B + P.U - 1) / P.U);
  cfg.blockDim = dim3(kBT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p, lm, P, wstream, att_g));
}

// the launch of the plan's variant (rows, LM)
int launch_plan(const Beam& p, const CharLM& lm, const CPlan& P, const float* wstream,
                float* att_g, cudaStream_t st) {
  const bool use_lm = lm.HL > 0;
#define SS_PLAN(ROWS)                                                              \
  if (P.NR == ROWS)                                                                \
    return use_lm ? launch_cluster<ROWS, true>(p, lm, P, wstream, att_g, st)   \
                  : launch_cluster<ROWS, false>(p, lm, P, wstream, att_g, st);
  SS_PLAN(4)
  SS_PLAN(8)
  SS_PLAN(16)
#undef SS_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ss_beam_decode(const float* enc, const float* comp, const int* lens,
                              const float* phi, const float* wih1, const float* whh1,
                              const float* b1, const float* wih2, const float* whh2,
                              const float* b2, const float* ct_w, const float* ct_b,
                              const float* emb, int* toks, int* parents, float* scores, int* done,
                              int* hyp_len, float* att, int B, int S, int F, int M, int H, int V,
                              int K, int max_steps, int device, void* stream) {
  const Beam p{enc,  comp,    lens,   phi,  wih1,    whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb,
               toks, parents, scores, done, hyp_len, att,  B,  S,    F,    M,  H,  V,    K,
               max_steps};
  const CharLM lm{};
  return launch<false>(p, lm, device, stream);
}

extern "C" int ss_beam_decode_lm(
    const float* enc, const float* comp, const int* lens, const float* phi, const float* wih1,
    const float* whh1, const float* b1, const float* wih2, const float* whh2, const float* b2,
    const float* ct_w, const float* ct_b, const float* emb, int* toks, int* parents,
    float* scores, int* done, int* hyp_len, float* att, int B, int S, int F, int M, int H, int V,
    int K, int max_steps, const float* lm_emb, const float* g1_wih, const float* g1_whh,
    const float* g1_bih, const float* g1_bhh, const float* g2_wih, const float* g2_whh,
    const float* g2_bih, const float* g2_bhh, const float* lm_w, const float* lm_b, int HL,
    float lm_weight, int device, void* stream) {
  const Beam p{enc,  comp,    lens,   phi,  wih1,    whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb,
               toks, parents, scores, done, hyp_len, att,  B,  S,    F,    M,  H,  V,    K,
               max_steps};
  const CharLM lm{lm_emb, g1_wih, g1_whh, g1_bih, g1_bhh, g2_wih, g2_whh,
                  g2_bih, g2_bhh, lm_w,   lm_b,   HL,     lm_weight};
  return launch<true>(p, lm, device, stream);
}


// The cluster route: a cluster of C CTAs decodes U utterances; `wstream` holds
// each CTA's weight panels ([C][rows][128]: the LM's two GRU cells, then the
// speller's two cells, its gate columns, as ops/kernels/beam.py packs them) and
// `att_g` a global attention scratch for the S that shared memory cannot hold
// ([ceil(B / U)][C][ceil(S / C)][U * RB] floats). lm_emb null: no LM. A shape
// the route does not serve is refused here, never rerouted.
extern "C" int ss_beam_decode_cluster(
    const float* enc, const float* comp, const int* lens, const float* phi, const float* wih1,
    const float* whh1, const float* b1, const float* wih2, const float* whh2, const float* b2,
    const float* ct_w, const float* ct_b, const float* emb, int* toks, int* parents,
    float* scores, int* done, int* hyp_len, float* att, int B, int S, int F, int M, int H, int V,
    int K, int max_steps, const float* lm_emb, const float* g1_wih, const float* g1_whh,
    const float* g1_bih, const float* g1_bhh, const float* g2_wih, const float* g2_whh,
    const float* g2_bih, const float* g2_bhh, const float* lm_w, const float* lm_b, int HL,
    float lm_weight, const float* wstream, int cluster, int utts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Beam p{enc,  comp,    lens,   phi,  wih1,    whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb,
               toks, parents, scores, done, hyp_len, att,  B,  S,    F,    M,  H,  V,    K,
               max_steps};
  const bool use_lm = lm_emb != nullptr;
  const CharLM lm{lm_emb, g1_wih, g1_whh, g1_bih, g1_bhh, g2_wih, g2_whh,
                  g2_bih, g2_bhh, lm_w,   lm_b,   use_lm ? HL : 0, lm_weight};
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CPlan P = cluster_plan(p, lm.HL, cluster, utts, max_smem / static_cast<int>(sizeof(float)));
  if (P.total == 0 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_plan(p, lm, P, wstream, att, static_cast<cudaStream_t>(stream));
}

// The cluster route's plan for a shape on this device, as cluster_plan gives
// it to ss_beam_decode_cluster: out = {floats of shared memory a CTA (0 where
// the route does not serve), the attention weights in shared memory (1) or in
// the global scratch (0), ring stages}. The tests hold
// ops/kernels/beam.py::cluster_plan, its mirror, to it.
extern "C" int ss_beam_cluster_plan(int H, int F, int M, int V, int HL, int S, int K, int cluster,
                                    int utts, int device, int* out) {
  int max_smem = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Beam p{};
  p.H = H, p.F = F, p.M = M, p.V = V, p.S = S, p.K = K;
  const CPlan P = cluster_plan(p, HL, cluster, utts, max_smem / static_cast<int>(sizeof(float)));
  out[0] = P.total;
  out[1] = P.att >= 0;
  out[2] = P.nst;
  return 0;
}
