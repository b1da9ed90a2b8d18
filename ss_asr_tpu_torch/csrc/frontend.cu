// Fused log-mel frontend: frame + windowed DFT + power + mel + log.
//
// Replaces the TPU kernel ss_asr_tpu/ops/pallas/frontend.py::_fe_kernel
// (reached from fbank_pallas, ops.frontend._log_mel_fbank_batch).
//
// Computes, per signal row b and frame t, from the reflect-padded signal:
//   frame  = yp[b, t*hop : t*hop + n_fft]
//   spec   = frame @ W           W [n_fft, 2*n_bins]: the Hann window folded
//                                into the real-DFT basis (cos | -sin)
//   power  = re^2 + im^2         [n_bins]
//   out[b, t] = log(power @ mel + eps)          mel [n_bins, n_mels]
//
// What bounds it on an H100: operations. At sr 22050 (n_fft 551, 276 bins) a
// frame costs 2*551*552 + 2*276*40 = 630 kFLOP against 880 bytes of signal
// and 160 bytes of output. The DFT product (97 % of the work) runs on the
// tensor cores at float32 accuracy by 3xTF32: each operand is split in
// registers, hi = x rounded to TF32, lo = x - hi rounded to TF32, and
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulate in float32 (the small terms
// first), so the useful operations are issued three times at the TF32 rate
// (495 TFLOP/s dense) instead of once at the float32 FMA rate (67 TFLOP/s).
// The tensor core truncates when it adds into its accumulator, so a chain of
// mma is one ring tile long and the chains meet by rounded float32 adds.
// The instruction is the warp-level mma.sync.m16n8k8 (tf32 x tf32 -> f32):
// its A fragment is four scalar shared-memory loads per thread, which is
// what a Toeplitz A operand needs. Element (f, k) of the frame matrix is
// sig[f*hop + k] of the block's contiguous signal span, so no frame matrix
// exists anywhere, and wgmma's A-from-shared descriptors cannot express it
// (A from registers would need the same loads and a K-major copy of the
// basis besides). What that costs: mma.sync does not reach the dense TF32
// rate that wgmma does, and at three mma per useful product (plus the splits
// and the fragment loads between them) that instruction stream is what a
// block's main loop waits for: PERF.md has the times beside the bound.
//
// Design. A block of 256 threads (8 warps) takes a tile of kTile frames of
// one row (128, or 64 where the span of 128 frames does not fit or the grid
// would leave half of the SMs idle; on a grid smaller still, a thread-block
// cluster shares the tile, each CTA taking every cn-th column chunk, and the
// mel sums meet in CTA 0 through distributed shared memory):
//   * the span of (kTile-1)*hop + K samples is copied to shared memory once.
//     The 8 rows of an A fragment are hop samples apart; where hop is a
//     multiple of the 32 banks (sr 16000: hop 160) they would collide 8
//     ways, so sample s is stored at s + skew*(s / hop) with (hop + skew) mod
//     8 == 4, which puts the rows on distinct banks;
//   * the basis, interleaved (cos in column 2j, -sin in 2j+1) and zero-padded
//     to K = a multiple of 8 rows and a multiple of kNC columns (interleave_basis),
//     streams from L2 through a ring of kStages shared-memory tiles of
//     [kKT, kNC] by cp.async (16 bytes a thread), so the loads of tile i+2
//     fly while tile i is multiplied. The tile's row pitch (kNC + 8) makes
//     the B-fragment loads conflict-free;
//   * the columns are walked in chunks of kNC = 96 (48 bins). A warp owns 32
//     frames (two 16-row slabs) x NT 8-column tiles: each B fragment is
//     split once and used on both slabs, each A fragment on all NT tiles;
//   * an accumulator fragment's two adjacent columns are re and im of one
//     bin: the power is squared in registers, goes to shared memory per
//     chunk, and the mel product (3 % of the work, float32 FMAs, a thread
//     owning kTile/32 frames x up to 5 or 8 mels, the chunk's rows of the
//     filterbank staged in shared memory) accumulates over the chunks in
//     registers. Only [kTile, n_mels] is written, coalesced.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kNC = 96;            // basis columns per chunk (48 bins)
constexpr int kKT = 32;            // basis rows per ring tile
constexpr int kStages = 3;         // ring depth
constexpr int kBPitch = kNC + 8;   // ring row pitch: 8 mod 32, B loads conflict-free
constexpr int kPwPitch = kNC / 2 + 1;  // power tile row pitch (odd)
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int skewed(int s, int hop, int skew) { return s + skew * (s / hop); }

__host__ inline size_t smem_floats(int tile, int hop, int kpad, int skew, int n_mels) {
  const int span = (tile - 1) * hop + kpad;
  const size_t sig = (size_t)((skewed(span, hop, skew) + 4) & ~3);
  const size_t pw = (size_t)tile * (n_mels > kPwPitch ? n_mels : kPwPitch);
  return sig + (size_t)kStages * kKT * kBPitch + pw + (size_t)(kNC / 2) * n_mels;
}

// x = hi + lo with hi the value rounded to TF32 (10 mantissa bits, half up in
// magnitude, as cvt.rna.tf32.f32 rounds) and lo the rest, rounded the same way.
// The rounding is an integer add of half a TF32 ulp and a mask: integer
// instructions issue at 4-8 times the rate of cvt, which at 40 splits a thread
// for each 36 mma set the kernel's pace. (A finite x whose magnitude rounds up
// across 2^128 would become inf: audio samples and a windowed basis are
// nowhere near.)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// kTile frames per block; MW mels per warp in the mel product (8 * MW >= n_mels)
template <int kTile, int MW>
__global__ void __launch_bounds__(kThreads, 1)
fbank_kernel(const float* __restrict__ yp,   // [B, Np]
             const float* __restrict__ wil,  // [kpad, ncols] packed basis
             const float* __restrict__ mel,  // [n_bins, n_mels]
             float* __restrict__ out,        // [B, nf, n_mels]
             int Np, int nf, int hop, int kpad, int n_bins, int ncols, int n_mels, int skew,
             int cn, float log_eps) {
  constexpr int WM = kTile / 32;    // warps along the frames
  constexpr int WN = 8 / WM;        // warps along a chunk's columns
  constexpr int NT = kNC / 8 / WN;  // 8-column tiles per warp
  constexpr int FPT = kTile / 32;   // frames per thread in the mel product

  extern __shared__ __align__(16) float smem[];
  const int span = (kTile - 1) * hop + kpad;
  float* sig = smem;                                         // the skewed signal span
  float* ring = smem + ((skewed(span, hop, skew) + 4) & ~3);  // [kStages][kKT][kBPitch]
  float* pw = ring + kStages * kKT * kBPitch;                // [kTile][kPwPitch] power, then out
  float* mels = pw + kTile * (n_mels > kPwPitch ? n_mels : kPwPitch);  // [kNC / 2][n_mels]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % cn;  // in the cluster of cn CTAs that share this tile of frames
  const int f0 = (blockIdx.x / cn) * kTile;

  const int nkt = (kpad + kKT - 1) / kKT;
  // this CTA's column chunks: rank, rank + cn, ... (cn <= the number of chunks)
  const int nchunks = (ncols / kNC - rank + cn - 1) / cn;
  const int ntiles = nkt * nchunks;

  auto load_tile = [&](int i) {
    const int lc = i / nkt, kt = i - lc * nkt, c = rank + lc * cn;
    float* dst = ring + (i % kStages) * (kKT * kBPitch);
    const float* src = wil + (size_t)kt * kKT * ncols + c * kNC;
#pragma unroll
    for (int j = 0; j < kKT * (kNC / 4) / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / (kNC / 4), q = idx - r * (kNC / 4);
      if (kt * kKT + r < kpad) cp_async16(dst + r * kBPitch + q * 4, src + (size_t)r * ncols + q * 4);
    }
  };

  // the ring's first tiles fly while the signal span is copied
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }
  {
    const float* row = yp + (size_t)b * Np;
    const int s0 = f0 * hop;
    for (int i = tid; i < span; i += kThreads) {
      const int s = s0 + i;
      // frames past nf and the padded K read zeros
      sig[skewed(i, hop, skew)] = s < Np ? row[s] : 0.f;
    }
  }

  // the rows of this thread's A fragments: slab sl, rows g and g + 8
  int rowbase[2][2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int h = 0; h < 2; ++h) rowbase[sl][h] = (wm * 32 + sl * 16 + h * 8 + g) * (hop + skew);

  float acc[2][NT][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[sl][nt][q] = 0.f;
  float macc[FPT][MW];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int q = 0; q < MW; ++q) macc[i][q] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed; every warp is done with tile i-1's slot
    if (i + kStages - 1 < ntiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const int lc = i / nkt, kt = i - lc * nkt, c = rank + lc * cn;
    const float* Bs = ring + (i % kStages) * (kKT * kBPitch) + wn * (NT * 8) + g;
    const int ksteps = min(kKT, kpad - kt * kKT) / 8;
    // The tensor core truncates when it adds into its float32 accumulator, and over
    // the K / 8 chained steps of a whole column that bias grows to 5e-6 of a pure
    // tone's peak. So a chain is one ring tile long (12 mma), on a partial sum
    // that starts at zero, and the partial sums meet in acc by rounded adds.
    float part[2][NT][4];
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[sl][nt][q] = 0.f;
    auto kstep = [&](int ks) {
      const int ka = kt * kKT + ks * 8 + t, kb = ka + 4;
      // offset of column k inside a frame: k, skewed by the hops it crosses (K <= 4 * hop)
      const int oa = ka + skew * ((ka >= hop) + (ka >= 2 * hop) + (ka >= 3 * hop));
      const int ob = kb + skew * ((kb >= hop) + (kb >= 2 * hop) + (kb >= 3 * hop));
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        split(sig[rowbase[sl][0] + oa], ahi[sl][0], alo[sl][0]);
        split(sig[rowbase[sl][1] + oa], ahi[sl][1], alo[sl][1]);
        split(sig[rowbase[sl][0] + ob], ahi[sl][2], alo[sl][2]);
        split(sig[rowbase[sl][1] + ob], ahi[sl][3], alo[sl][3]);
      }
      const float* bk = Bs + (ks * 8 + t) * kBPitch;
      unsigned bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split(bk[nt * 8], bhi[nt][0], blo[nt][0]);
        split(bk[nt * 8 + 4 * kBPitch], bhi[nt][1], blo[nt][1]);
      }
      // term by term over all 2 * NT accumulators, the small terms first: the three mma
      // into one accumulator depend on each other and must not follow back to back
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) mma_tf32(part[sl][nt], alo[sl], bhi[nt][0], bhi[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) mma_tf32(part[sl][nt], ahi[sl], blo[nt][0], blo[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) mma_tf32(part[sl][nt], ahi[sl], bhi[nt][0], bhi[nt][1]);
    };
    if (ksteps == kKT / 8) {
#pragma unroll
      for (int ks = 0; ks < kKT / 8; ++ks) kstep(ks);  // unrolled: loads run ahead of the mma
    } else {
      for (int ks = 0; ks < ksteps; ++ks) kstep(ks);  // the ragged last tile of K
    }
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[sl][nt][q] += part[sl][nt][q];
    if (kt == nkt - 1) {
      // the chunk is complete: power of its 48 bins, then their share of the mel product,
      // whose rows of the filterbank come to shared memory behind the power's arithmetic
      constexpr int kMelRegs = ((kNC / 2) * 8 * MW + kThreads - 1) / kThreads;
      const int jn = min(kNC / 2, n_bins - c * (kNC / 2));
      const float* msrc = mel + (size_t)c * (kNC / 2) * n_mels;
      float mreg[kMelRegs];
#pragma unroll
      for (int q = 0; q < kMelRegs; ++q) {
        const int o = tid + q * kThreads;
        mreg[q] = o < jn * n_mels ? __ldg(msrc + o) : 0.f;
      }
#pragma unroll
      for (int sl = 0; sl < 2; ++sl)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float(&a)[4] = acc[sl][nt];
          float* p = pw + (wm * 32 + sl * 16 + g) * kPwPitch + wn * (NT * 4) + nt * 4 + t;
          p[0] = a[0] * a[0] + a[1] * a[1];
          p[8 * kPwPitch] = a[2] * a[2] + a[3] * a[3];
          a[0] = a[1] = a[2] = a[3] = 0.f;
        }
#pragma unroll
      for (int q = 0; q < kMelRegs; ++q) {
        const int o = tid + q * kThreads;
        if (o < (kNC / 2) * n_mels) mels[o] = mreg[q];
      }
      __syncthreads();
      const float* mrow = mels + warp * MW;
#pragma unroll 4
      for (int jb = 0; jb < jn; ++jb) {
        float mv[MW];
#pragma unroll
        for (int q = 0; q < MW; ++q)
          mv[q] = warp * MW + q < n_mels ? mrow[jb * n_mels + q] : 0.f;
#pragma unroll
        for (int fi = 0; fi < FPT; ++fi) {
          const float p = pw[(lane + 32 * fi) * kPwPitch + jb];
#pragma unroll
          for (int q = 0; q < MW; ++q) macc[fi][q] = fmaf(p, mv[q], macc[fi][q]);
        }
      }
      // the next write of pw is a chunk away, behind the loop's barriers
    }
  }
  const int nvalid = min(kTile, nf - f0) * n_mels;
  float* dst = out + ((size_t)b * nf + f0) * n_mels;
  if (cn > 1) {
    // The cluster's CTAs hold the mel sums of their own chunks: each writes its
    // [kTile, n_mels] into slot [rank] of CTA 0's shared memory (over the signal span
    // and the ring, which are dead once every CTA has left its main loop), and CTA 0
    // adds the slots in rank order, takes the log and writes the tile.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float* slot = cluster.map_shared_rank(smem, 0) + rank * kTile * n_mels;
#pragma unroll
    for (int fi = 0; fi < FPT; ++fi)
#pragma unroll
      for (int q = 0; q < MW; ++q) {
        const int m = warp * MW + q;
        if (m < n_mels) slot[(lane + 32 * fi) * n_mels + m] = macc[fi][q];
      }
    cluster.sync();
    if (rank == 0)
      for (int o = tid; o < nvalid; o += kThreads) {
        float sum = smem[o];
        for (int r = 1; r < cn; ++r) sum += smem[r * kTile * n_mels + o];
        dst[o] = logf(sum + log_eps);
      }
    return;
  }
  // log, staged through shared memory so that the tile's rows leave coalesced
  __syncthreads();
#pragma unroll
  for (int fi = 0; fi < FPT; ++fi)
#pragma unroll
    for (int q = 0; q < MW; ++q) {
      const int m = warp * MW + q;
      if (m < n_mels) pw[(lane + 32 * fi) * n_mels + m] = logf(macc[fi][q] + log_eps);
    }
  __syncthreads();
  for (int o = tid; o < nvalid; o += kThreads) dst[o] = pw[o];
}

template <int kTile, int MW>
cudaError_t launch(const float* yp, const float* wil, const float* mel, float* out, int B, int Np,
                   int nf, int hop, int kpad, int n_bins, int ncols, int n_mels, int skew, int cn,
                   float log_eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fbank_kernel<kTile, MW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((nf + kTile - 1) / kTile) * cn, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fbank_kernel<kTile, MW>, yp, wil, mel, out, Np, nf, hop, kpad,
                            n_bins, ncols, n_mels, skew, cn, log_eps);
}

}  // namespace

// yp [B, Np] must hold (nf-1)*hop + n_fft samples per row; wil [kpad, ncols]
// is the packed basis: (cos, -sin) columns interleaved, zero rows up to kpad
// (a multiple of 8), zero columns up to ncols (a multiple of 96).
extern "C" int ss_fbank(const float* yp, const float* wil, const float* mel, float* out,
                        int B, int Np, int nf, int n_fft, int hop, int n_bins, int kpad,
                        int ncols, int n_mels, float log_eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kpad % 8 != 0 || kpad < n_fft || ncols % kNC != 0 || ncols < 2 * n_bins || hop < 1 ||
      kpad > 4 * hop || n_mels < 1 || n_mels > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int skew = (12 - hop % 8) % 8;  // (hop + skew) mod 8 == 4
  // 128 frames a block, or 64 where 128 do not fit or fill less than half of the SMs
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = sizeof(float) * smem_floats(128, hop, kpad, skew, n_mels);
  const bool big = smem <= kMaxSmem && 2 * B * ((nf + 127) / 128) >= sms;
  if (!big) smem = sizeof(float) * smem_floats(64, hop, kpad, skew, n_mels);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // A small grid leaves SMs idle while each block walks all the column chunks one
  // after the other: then a cluster of cn CTAs shares a tile of frames, each taking
  // every cn-th chunk. As many as the idle SMs allow, the chunks number and CTA 0's
  // shared memory holds slots for.
  const int tile = big ? 128 : 64;
  const int blocks = B * ((nf + tile - 1) / tile);
  const int slots = static_cast<int>((smem / sizeof(float) - (size_t)tile * kPwPitch) /
                                     ((size_t)tile * n_mels));
  int cn = sms / blocks;
  cn = cn > 8 ? 8 : cn;
  cn = cn > ncols / kNC ? ncols / kNC : cn;
  cn = cn > slots ? slots : cn;
  cn = cn < 1 ? 1 : cn;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SS_FBANK(TILE, MW)                                                                      \
  launch<TILE, MW>(yp, wil, mel, out, B, Np, nf, hop, kpad, n_bins, ncols, n_mels, skew, cn, \
                   log_eps, smem, st)
  if (n_mels <= 40)
    err = big ? SS_FBANK(128, 5) : SS_FBANK(64, 5);
  else
    err = big ? SS_FBANK(128, 8) : SS_FBANK(64, 8);
#undef SS_FBANK
  return static_cast<int>(err);
}

