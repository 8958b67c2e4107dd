// Fused Lloyd steps for Hopper (sm_90a): embed + assign + (Z, g, cost) for one
// row block, the embedded Y never in device memory.
//
// Replaces: src/repro/kernels/lloyd_step.py::fused_apnc_step (_apnc_step_kernel)
// and ::fused_rff_step (_rff_step_kernel), with their shared epilogue
// _assign_reduce (here lloyd_epilogue.cuh), the Pallas TPU kernels.
//
// Bound on an H100 SXM: operations. fused_apnc_step does
// 2*n*l*(d + m) + 2*n*k*m f32 operations against (n*d + l*d + m*l + 2*k*m)*4
// bytes; at the stream path's shape (d = 900, l = 500, m = 256, k = 164) a
// pass over n = 1,262,102 rows is 1.57e12 FLOP against 4.5 GB, 23.4 ms on
// 67 TFLOP/s f32 and about 17x more operation- than byte-bound.
// fused_rff_step does 2*n*d*m/2 + 2*n*k*m (5.9 ms a pass at m = 256).
//
// The arithmetic contract (both kernels): every S = X L^T (or X W) output and
// every rbf norm is one fmaf chain from 0.0f over the features in ascending
// order, every Y = K R^T output one chain over the landmarks in ascending
// order, with no split and no tree sum; kappa is tilemath::nonlin. These
// repeat apnc_embed.cu and rff_embed.cu bit for bit, and the epilogue repeats
// apnc_assign.cu, so a fused step gives the labels of the un-fused kernel
// chain bit for bit. Tile shapes, pipelining and CTA counts do not touch the
// chains. Plain f32 FMA, no tensor cores (TF32 would not keep them).
//
// fused_apnc_kernel (redesigned for Hopper; the first port ran 0.79 ms a
// 4,096-row block, 9.6 % of its bound, with 52 % of the SMs idle):
//  * Its embed mainloop is apnc_mainloop.cuh's, at the apncml::Short
//    geometry: apnc_embed.cu runs the same code, so the chains are one.
//  * A CTA owns a 32-row tile, so a 4,096-row block is 128 CTAs on the 132
//    SMs. One CTA of 256 threads a SM (no spills), 155 KB of shared memory
//    at m = 256, 192 KB at m = 512.
//  * Landmarks go in super-tiles of 256: S (32 x 256) is 8 rows x 4
//    landmarks a thread, 2.7 FMAs for every float read from shared memory
//    (the first port's 4 x 4 tile did 2); the X chunk is staged twice a tile
//    at l = 500, not 8 times. A thread's rows are 4 apart and its landmarks
//    64 apart, and a warp spans 4 rows x 8 landmarks, so every float4
//    operand read is 128 distinct bytes in distinct banks at pitch 36
//    (36 / 4 is odd).
//  * Every operand arrives by cp.async into a 2-stage ring, one barrier a
//    step: the X and L chunks (32 and 256 rows x 32 features), then the R
//    sub-chunks (256 Y columns x 32 landmarks) over the same ring. Step
//    s + 1's copies are in flight while step s computes, across the phase
//    boundaries too. The operands are read 4 features (or landmarks) at a
//    time along their rows, so X, L and R all stay in their natural layout
//    and no chunk needs the register-staged transpose. A third stage (it
//    fits at m <= 256) read 2 % slower than two in one card run of
//    tools/kernel_ablation.py and 5 % faster in another: two are kept
//    until that is settled.
//  * rbf norms ride in the d loop: thread t sums landmark t of the
//    super-tile, threads t < 32 row t. Every thread owns a norm, so none
//    waits for the others; a separate launch for the landmark norms would
//    save nothing.
//  * K (32 x 256) goes to shared memory once a super-tile, and Y (32 x m)
//    stays in shared memory, transposed (pitch 36), for the epilogue
//    (lloyd_epilogue.cuh at 32 rows: 4 rows x 4 centroids a thread, 128
//    centroids a chunk, each C sub-chunk loaded into registers while the one
//    before it is in use).
//  * Ragged n, d, l and m are zero-filled by the copies (zero K for padded
//    landmarks). 16-byte copies need d and l multiples of 4 and aligned
//    arrays; other shapes take 4-byte copies, the same arithmetic.
//  * Where the time goes (tools/kernel_ablation.py takes the kernel apart on
//    the card; PERF.md has its readings): the FMA loops run at about two
//    thirds of the SM's f32 rate, the copies cost about 30 % of a launch (all
//    128 CTAs read the same L chunk from L2 at once; a thread-block cluster
//    multicasting it would halve that traffic), the epilogue about 20 %, the
//    (Z, g, cost) reduce 4 %.
//
// fused_rff_kernel (the first port's design): one CTA owns 64 rows and
// streams X and W through shared memory in synchronous chunks of 32
// features; s cos(S), s sin(S) go into the [cos | sin] halves of the
// (64 x m) Y^T tile, which the epilogue reads in place; 86 KB at
// m = 256. A 4,096-row block is 64 CTAs, under half of the SMs.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "apnc_mainloop.cuh"
#include "lloyd_epilogue.cuh"

namespace {

using lloyd::BN;
using lloyd::KC;
using lloyd::PAD;
using lloyd::THREADS;
using tilemath::KParams;

constexpr int BD = 32;  // features per chunk (fused_rff_kernel)
constexpr int MC = 64;  // Y columns per update chunk (fused_rff_kernel)
constexpr int MAX_M = 512;

__device__ __forceinline__ void zero_tile(float* ys, int m_pad) {
  for (int e = threadIdx.x; e < m_pad * PAD; e += THREADS) ys[e] = 0.0f;
}

// fused_apnc_kernel: apnc_mainloop.cuh's embed of a 32-row tile into the
// shared Y^T tile, then the assign epilogue on it.
namespace apnc {
using G = apncml::Short;
using Epi = lloyd::Layout<G::BN>;
static_assert(lloyd::MK * Epi::CPAD <= G::STAGE, "the epilogue's C sub-chunk fits in a ring stage");

template <bool L1, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_apnc_kernel(const float* __restrict__ X, const float* __restrict__ L,
                  const float* __restrict__ R, const float* __restrict__ C,
                  float* __restrict__ Zp, float* __restrict__ gp, float* __restrict__ costp,
                  int* __restrict__ labels, int n, int d, int l, int m, int k, int tiles_per_cta,
                  KParams kp) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, G::MC);
  const apncml::TileSmem sm = apncml::carve<G>(smem, m_pad);  // ring: also the
                                                              // epilogue's C^T sub-chunk
  lloyd::EpilogueSmem es;
  es.cs = sm.ring;
  es.yy_s = sm.ll_s + G::BL;         // [BN]
  es.cc_s = es.yy_s + G::BN;         // [Epi::KC]
  es.mind_s = es.cc_s + Epi::KC;     // [BN]
  es.lab_s = reinterpret_cast<int*>(es.mind_s + G::BN);  // [BN]

  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_partials(zp, gpc, k, m);

  const int n_tiles = (n + G::BN - 1) / G::BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * G::BN;
    const int rows = min(G::BN, n - row0);
    __syncthreads();  // the previous tile's epilogue is done with ys, the ring and the scratch
    apncml::embed_tile<G, VEC, false>(X, L, R, n, d, l, m, m_pad, row0, sm, kp, nullptr, 0);
    lloyd::assign_reduce_tile<L1, G::BN, G::YP, true>(sm.ys, m_pad, C, k, m, row0, rows, es,
                                                      labels, zp, gpc, cost_acc);
  }
  if (threadIdx.x == 0) costp[blockIdx.x] = cost_acc;
}

size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, G::MC);
  return sizeof(float) * (G::smem_floats(m_pad) + G::BN + Epi::KC + G::BN) +
         sizeof(int) * G::BN;
}
}  // namespace apnc

template <bool L1>
__global__ void __launch_bounds__(THREADS)
fused_rff_kernel(const float* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ C, float* __restrict__ Zp, float* __restrict__ gp,
                 float* __restrict__ costp, int* __restrict__ labels, int n, int d, int mh, int k,
                 float scale, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m = 2 * mh;
  const int m_pad = lloyd::round_up(m, MC);
  float* ys = smem;                  // [m_pad][PAD]  Y^T tile, [cos | sin]
  float* xs = ys + m_pad * PAD;      // [BD][PAD]     X^T chunk; epilogue: C^T chunk
  float* ws = xs + BD * PAD;         // [BD][PAD]     W chunk
  lloyd::EpilogueSmem es;
  es.cs = xs;
  es.yy_s = ws + BD * PAD;           // [BN]
  es.cc_s = es.yy_s + BN;            // [KC]
  es.mind_s = es.cc_s + KC;          // [BN]
  es.lab_s = reinterpret_cast<int*>(es.mind_s + BN);  // [BN]

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_partials(zp, gpc, k, m);

  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    const int rows = min(BN, n - row0);
    __syncthreads();  // the previous tile's epilogue is done with ys and the scratch
    zero_tile(ys, m_pad);  // columns >= 2 mh stay 0

    for (int c0 = 0; c0 < mh; c0 += MC) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < d; k0 += BD) {
        __syncthreads();  // earlier readers of xs / ws are done
        for (int e = t; e < BN * BD; e += THREADS) {
          const int r = e / BD, c = e % BD;
          const int gr = row0 + r, gc = k0 + c;
          xs[c * PAD + r] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.0f;
        }
        for (int e = t; e < BD * MC; e += THREADS) {
          const int c = e / MC, j = e % MC;
          const int gc = k0 + c, gj = c0 + j;
          ws[c * PAD + j] = (gc < d && gj < mh) ? W[(size_t)gc * mh + gj] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < BD; ++c) {
          tilemath::fma_4x4(acc, *reinterpret_cast<const float4*>(xs + c * PAD + ty * 4),
                            *reinterpret_cast<const float4*>(ws + c * PAD + tx * 4));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = ty * 4 + i, j = c0 + tx * 4 + jj;
          if (j < mh) {
            float sv, cv;
            sincosf(acc[i][jj], &sv, &cv);
            ys[j * PAD + r] = scale * cv;
            ys[(mh + j) * PAD + r] = scale * sv;
          }
        }
    }
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, rows, es, labels, zp, gpc, cost_acc);
  }
  if (t == 0) costp[blockIdx.x] = cost_acc;
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

size_t rff_smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, MC);
  return sizeof(float) * ((size_t)m_pad * PAD + 2 * (size_t)BD * PAD + BN + KC + BN) +
         sizeof(int) * BN;
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Largest embedding width m (rff: 2 * m_half) one fused launch takes.
int lloyd_step_max_m() { return MAX_M; }

// Rows per tile of fused_apnc_step (member 0) and fused_rff_step (member
// 1); the wrapper sizes the P partials from it.
int lloyd_step_tile_rows(int member) { return member == 0 ? apnc::G::BN : BN; }

// Dynamic shared memory of one CTA, in bytes.
long long fused_apnc_smem_bytes(int m) { return (long long)apnc::smem_bytes(m); }
long long fused_rff_smem_bytes(int m) { return (long long)rff_smem_bytes(m); }

// X (n, d), L (l, d), R (m, l), C (k, m) f32 -> Z (k, m), g (k,), cost (1,) f32,
// labels (n,) int32. Zp (num_ctas, k, m), gp (num_ctas, k) and costp
// (num_ctas,) are scratch; CTA p covers tiles [p * tiles_per_cta, (p + 1) *
// tiles_per_cta). Returns the CUDA error code of the launches.
int fused_apnc_step_f32(const float* X, const float* L, const float* R, const float* C, float* Z,
                        float* g, float* cost, int* labels, float* Zp, float* gp, float* costp,
                        int n, int d, int l, int m, int k, int l1, int num_ctas, int tiles_per_cta,
                        int kind, float gamma, float coef0, float scale, int degree, void* stream) {
  if (m > MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = apnc::smem_bytes(m);
  const KParams kp{kind, gamma, coef0, scale, degree};
  const bool vec = d % 4 == 0 && l % 4 == 0 && aligned16(X) && aligned16(L) && aligned16(R);
  const auto kernel =
      l1 ? (vec ? apnc::fused_apnc_kernel<true, true> : apnc::fused_apnc_kernel<true, false>)
         : (vec ? apnc::fused_apnc_kernel<false, true> : apnc::fused_apnc_kernel<false, false>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_ctas, THREADS, smem, s>>>(X, L, R, C, Zp, gp, costp, labels, n, d, l, m, k,
                                         tiles_per_cta, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)lloyd::launch_reduce(Zp, gp, costp, Z, g, cost, num_ctas, k, m, s);
}

// X (n, d), W (d, mh), C (k, 2 mh) f32 in the [cos | sin] layout -> as
// fused_apnc_step_f32, with Y = scale * [cos(X W), sin(X W)].
int fused_rff_step_f32(const float* X, const float* W, const float* C, float* Z, float* g,
                       float* cost, int* labels, float* Zp, float* gp, float* costp, int n, int d,
                       int mh, int k, int l1, float scale, int num_ctas, int tiles_per_cta,
                       void* stream) {
  const int m = 2 * mh;
  if (m > MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = rff_smem_bytes(m);
  cudaError_t err;
  if (l1) {
    err = set_smem(fused_rff_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_rff_kernel<true><<<num_ctas, THREADS, smem, s>>>(X, W, C, Zp, gp, costp, labels, n, d,
                                                           mh, k, scale, tiles_per_cta);
  } else {
    err = set_smem(fused_rff_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_rff_kernel<false><<<num_ctas, THREADS, smem, s>>>(X, W, C, Zp, gp, costp, labels, n, d,
                                                            mh, k, scale, tiles_per_cta);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)lloyd::launch_reduce(Zp, gp, costp, Z, g, cost, num_ctas, k, m, s);
}

}  // extern "C"
