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
// Design. One block of 1024 threads decodes one utterance (grid = B). The K
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
// What bounds it on an H100: as the greedy kernel (greedy_decode.cu), each
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

#include "common.cuh"
#include "speller.cuh"

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
