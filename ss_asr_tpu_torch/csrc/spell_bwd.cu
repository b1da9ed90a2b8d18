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
// Design: as the forward kernel (spell_fwd.cu) and its device functions
// (speller.cuh): one block of 1024 threads per batch row with the step loop
// inside, the row's state and carries in shared memory. The six products
// with a transposed weight (ct_w, W_hh2, W_ih2, W_hh1, W_ih1, phi) and the
// one with the row's enc use rowdot: a warp per output, reading the weight's
// row contiguously, then a shuffle reduction.
//
// What bounds it on an H100: each step streams every speller weight twice
// from L2 into one SM, once for the gate recompute and once transposed for
// the adjoint: about 12.5 MB f32 per row-step at the flagship size, twice the
// forward kernel's 6.3 MB, for a single row's matrix-vector products. At the
// training flagship (B = 32, L = 48) there are 32 blocks on 132 SMs. The
// forward could write its gate pre-activations to skip the recompute (half
// the bytes), and a cluster of CTAs per row could split the weights.

#include "common.cuh"
#include "speller.cuh"

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

}  // namespace

extern "C" int ss_spell_bwd(const float* enc, const float* comp, const float* dlogits,
                            const float* daext, const float* att, const float* h1s,
                            const float* c1s, const float* h2s, const float* c2s,
                            const float* fed, const float* phi, const float* wih1,
                            const float* whh1, const float* b1, const float* wih2,
                            const float* whh2, const float* b2, const float* ct_w,
                            const float* emb, float* dg1, float* dg2, float* de, float* dqp,
                            float* demb, int B, int S, int F, int M, int H, int V, int L,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SpellBwd p{enc,  comp, dlogits, daext, att,  h1s,  c1s, h2s, c2s,  fed, phi, wih1,
                   whh1, b1,   wih2,    whh2,  b2,   ct_w, emb, dg1, dg2,  de,  dqp, demb,
                   B,    S,    F,       M,     H,    V,    L};
  const size_t smem = sizeof(float) * smem_floats(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spell_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spell_bwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
