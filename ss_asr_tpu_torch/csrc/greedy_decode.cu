// Whole greedy attend-and-spell decode in one kernel, with and without
// char-LM shallow fusion (one template, kUseLM).
//
// Replaces the TPU kernels ss_asr_tpu/ops/pallas/decode.py::_decode_kernel
// (greedy_decode_pallas) and ::_decode_lm_kernel (greedy_decode_lm_pallas).
//
// One block decodes one batch row for up to max_steps steps. Each step:
//   q = tanh(h1 @ phi); energy[s] = comp[s] . q, -inf past max(len, 1);
//   score = softmax(energy); context = score @ enc;
//   (h1, c1) = LSTM([emb(last) | context], h1, c1); (h2, c2) = LSTM(h1, h2, c2)
//   logits = h2 @ ct_w + ct_b
//   LM: (g1, g2) = 2 x GRU(lm_emb(last)); lm_logits = g2 @ out_w + out_b;
//       score = log_softmax(logits) + lm_weight * log_softmax(lm_logits)
//   id = argmax (lowest index among equal maxima, as jnp.argmax); last = id.
// The TPU kernel steps the whole batch and, once every row is done, pads
// with SOS; here rows are independent, so a row that emits EOS writes SOS
// for its remaining steps and stops. The tokens are the same, because a
// done row emits SOS either way.
//
// What bounds it on an H100: every step reads all speller weights (W_ih1
// [768, 1024], W_hh1 / W_ih2 / W_hh2 [256, 1024], phi, ct_w: about 6.3 MB
// f32 at the flagship size, plus 0.4 MB for the LM) for a single row's
// matrix-vector products, and the steps of a row are sequential. The weights
// stay resident in the 50 MB L2 across steps and blocks, so a step costs the
// time one SM takes to pull 6.3 MB from L2, which depends on how many loads
// it keeps in flight (measured on an H100 SXM at B = 16: about 68 us per
// step without the LM, 90 GB/s into the SM). The block has 1024 threads and
// every product splits its reduction over thread groups: a hidden unit's
// four gates are summed over kThreads / H slices of the inputs (partial sums
// meet in shared memory, where one thread per unit adds them and updates the
// cell), the narrow products (attention query, context, logits) over
// kThreads / columns slices. The row's state (h, c, context, query,
// energies) lives in shared memory. The faster design splits the weights
// over a cluster of CTAs per row tile, each holding its share in shared
// memory.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSOS = 0;
constexpr int kEOS = 1;

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

template <bool kUseLM>
int launch(const Speller& p, const CharLM& lm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * smem_floats(p, lm.HL, kUseLM);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(greedy_decode_kernel<kUseLM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_decode_kernel<kUseLM><<<p.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, lm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ss_greedy_decode(const float* enc, const float* comp, const int* lens,
                                const float* phi, const float* wih1, const float* whh1,
                                const float* b1, const float* wih2, const float* whh2,
                                const float* b2, const float* ct_w, const float* ct_b,
                                const float* emb, int* out, int B, int S, int F, int M, int H,
                                int V, int max_steps, int device, void* stream) {
  const Speller p{enc, comp, lens, phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb, out,
                  B, S, F, M, H, V, max_steps};
  const CharLM lm{};
  return launch<false>(p, lm, device, stream);
}

extern "C" int ss_greedy_decode_lm(
    const float* enc, const float* comp, const int* lens, const float* phi, const float* wih1,
    const float* whh1, const float* b1, const float* wih2, const float* whh2, const float* b2,
    const float* ct_w, const float* ct_b, const float* emb, int* out, int B, int S, int F, int M,
    int H, int V, int max_steps, const float* lm_emb, const float* g1_wih, const float* g1_whh,
    const float* g1_bih, const float* g1_bhh, const float* g2_wih, const float* g2_whh,
    const float* g2_bih, const float* g2_bhh, const float* lm_w, const float* lm_b, int HL,
    float lm_weight, int device, void* stream) {
  const Speller p{enc, comp, lens, phi, wih1, whh1, b1, wih2, whh2, b2, ct_w, ct_b, emb, out,
                  B, S, F, M, H, V, max_steps};
  const CharLM lm{lm_emb, g1_wih, g1_whh, g1_bih, g1_bhh, g2_wih, g2_whh,
                  g2_bih, g2_bhh, lm_w,   lm_b,   HL,     lm_weight};
  return launch<true>(p, lm, device, stream);
}
