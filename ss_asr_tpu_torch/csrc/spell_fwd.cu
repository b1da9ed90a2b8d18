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
// zero noise the feedback is greedy.
//
// Design: as the greedy decode kernel (greedy_decode.cu), whose device
// functions it shares (speller.cuh): one block of 1024 threads per batch
// row with the step loop inside, the row's state in shared memory. The
// TPU kernel's CHUNK-step grid blocks and batch blocks were VMEM plumbing.
//
// What bounds it on an H100: each step streams all speller weights (about
// 6.3 MB f32 at the flagship size) from L2 into one SM for a single row's
// matrix-vector products, and writes the row's streams (~3.4 KB a step) to
// device memory. At the training flagship (B = 32, L = 48) there are 32
// blocks on 132 SMs.

#include <climits>

#include "common.cuh"
#include "speller.cuh"

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

}  // namespace

extern "C" int ss_spell_fwd(const float* enc, const float* comp, const int* lens, const float* tf,
                            const float* gumbel, const float* temb, const float* phi,
                            const float* wih1, const float* whh1, const float* b1,
                            const float* wih2, const float* whh2, const float* b2,
                            const float* ct_w, const float* ct_b, const float* emb, float* logits,
                            float* att, float* h1s, float* c1s, float* h2s, float* c2s,
                            float* fed, int B, int S, int F, int M, int H, int V, int L,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Spell p{enc,  comp, lens, tf,     gumbel, temb, phi, wih1, whh1, b1, wih2, whh2,
                b2,   ct_w, ct_b, emb,    logits, att,  h1s, c1s,  h2s,  c2s, fed,  B,
                S,    F,    M,    H,      V,      L};
  const size_t smem = sizeof(float) * smem_floats(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spell_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spell_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
