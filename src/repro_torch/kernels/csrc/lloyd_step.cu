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
//    SMs. One CTA of 256 threads a SM (no spills), 156,420 bytes of shared
//    memory at m = 256, 193,284 at m = 512.
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
//    (lloyd_epilogue.cuh: 8 rows x 4 centroids a thread, 256 centroids a
//    chunk, each C sub-chunk in flight by cp.async, into the ring, while the
//    one before it is in use).
//  * Ragged n, d, l and m are zero-filled by the copies (zero K for padded
//    landmarks). 16-byte copies need d and l multiples of 4 and aligned
//    arrays; other shapes take 4-byte copies, the same arithmetic.
//  * Where the time goes (tools/kernel_ablation.py takes the kernel apart on
//    the card; PERF.md has its readings): the FMA loops run at about two
//    thirds of the SM's f32 rate, the copies cost about 30 % of a launch (all
//    128 CTAs read the same L chunk from L2 at once; a thread-block cluster
//    multicasting it would halve that traffic), the epilogue about 20 %, the
//    (Z, g, cost) reduce 4 %. With the 8 x 4 epilogue (NVIDIA H100 80GB
//    HBM3, 700.00 W; chip_smoke.py timing) a pass reads 69.7-70.3 ms
//    (71.3-71.8 before its k tail was narrowed), 78.6-78.7 with the 4 x 4
//    one.
//
// fused_rff_kernel (redesigned for Hopper; the first port ran 64-row tiles,
// 64 CTAs a 4,096-row block, with synchronous 32-feature chunks, two barriers
// a chunk and every X chunk staged twice at mh = 128: 77.41-78.20 ms a pass,
// 7.6 % of its bound):
//  * Its projection mainloop is rff_mainloop.cuh's, at the rffml::Fused
//    geometry: rff_embed.cu runs the same code, so the chains are one.
//  * A CTA owns a 32-row tile and every frequency of its rows: 32 x 128 S a
//    pass, 4 x 4 a thread, 256 threads, the work of one rff_embed_block CTA;
//    mh = 256 (m = 512) takes two passes. A 4,096-row block is 128 CTAs.
//  * W's 64-feature chunks come by cp.async into a 3-stage ring and X's
//    through registers into a swizzled, double-buffered X^T, one barrier a
//    chunk. A warp spans 8 row groups x 4 frequency groups, so each step
//    reads 8 + 4 distinct float4 from shared memory for 16 FMAs a thread.
//  * s cos(S) and s sin(S) go from registers into the [cos | sin] halves of
//    the 32-row Y^T tile (pitch 36), float4 over a thread's 4 rows: the 8
//    lanes of a quarter warp are 8 row groups, so the stores are
//    conflict-free. The epilogue (lloyd_epilogue.cuh) reads the tile in
//    place; the W ring holds its C buffers. 153,732 bytes of shared memory
//    at m = 256, 190,596 at m = 512: one CTA a SM.
//  * Ragged n, d and mh are zero-filled by the loads; the padded columns
//    [m, m_pad) of Y^T are zeroed once a CTA.
//  * Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py timing, a pass
//    of the rff stream fit, d = 900, mh = 128, k = 164): 21.8 ms of
//    device time, 19.8 the kernel and 2.0 the reduce; 22.8-25.5 ms
//    event-timed.
//    tools/kernel_ablation.py puts 40 of a 73 us launch in the projection
//    (41 % of the f32 rate, as rff_embed_block), 4 in the trig and about 30
//    in the epilogue.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "apnc_mainloop.cuh"
#include "lloyd_epilogue.cuh"
#include "rff_mainloop.cuh"

namespace {

using lloyd::PAD;
using lloyd::THREADS;
using tilemath::KParams;

constexpr int MAX_M = 512;

// fused_apnc_kernel: apnc_mainloop.cuh's embed of a 32-row tile into the
// shared Y^T tile, then the assign epilogue on it.
namespace apnc {
using G = apncml::Short;
static_assert(G::BN == lloyd::BN && G::YP == PAD, "the epilogue's tile");
static_assert(2 * lloyd::CBUF <= G::NS * G::STAGE, "the epilogue's C buffers fit in the ring");

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
                                                              // epilogue's C buffers
  const lloyd::EpilogueSmem es = lloyd::carve(sm.ll_s + G::BL, sm.ring);

  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_counts(gpc, k);

  const int n_tiles = (n + G::BN - 1) / G::BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * G::BN;
    const int rows = min(G::BN, n - row0);
    __syncthreads();  // the previous tile's epilogue is done with ys, the ring and the scratch
    apncml::embed_tile<G, VEC, false>(X, L, R, n, d, l, m, m_pad, row0, sm, kp, nullptr, 0);
    lloyd::assign_reduce_tile<L1>(sm.ys, m_pad, C, k, m, row0, rows, tile == tile_lo, es, labels,
                                  zp, gpc, cost_acc, [] {});
  }
  if (threadIdx.x == 0) costp[blockIdx.x] = cost_acc;
}

size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, G::MC);
  return sizeof(float) * (G::smem_floats(m_pad) + lloyd::SCRATCH);
}
}  // namespace apnc

// fused_rff_kernel: rff_mainloop.cuh's projection of a 32-row tile, s cos
// and s sin into the shared Y^T tile, then the assign epilogue on it.
namespace rff {
using G = rffml::Fused;
static_assert(G::BN == lloyd::BN && rffml::THREADS == THREADS, "the epilogue's tile");
static_assert(2 * lloyd::CBUF <= rffml::WSTAGES * G::WCH,
              "the epilogue's C buffers fit in the W ring");

template <bool L1, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_rff_kernel(const float* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ C, float* __restrict__ Zp, float* __restrict__ gp,
                 float* __restrict__ costp, int* __restrict__ labels, int n, int d, int mh, int k,
                 float scale, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m = 2 * mh;
  const int m_pad = lloyd::round_up(m, lloyd::MK);
  float* xs = smem;                              // 2 x [BD][BN]  X^T chunks, swizzled
  float* ws = xs + 2 * G::XCH;                   // 3 x [BD][BM]  W chunks; the C buffers
  float* ys = ws + rffml::WSTAGES * G::WCH;      // [m_pad][PAD]  Y^T tile, [cos | sin]
  const lloyd::EpilogueSmem es = lloyd::carve(ys + (size_t)m_pad * PAD, ws);
  int ty, tx;
  rffml::coords<G>(ty, tx);

  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_counts(gpc, k);
  for (int e = threadIdx.x; e < (m_pad - m) * PAD; e += THREADS) ys[m * PAD + e] = 0.0f;

  const int n_tiles = (n + G::BN - 1) / G::BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * G::BN;
    const int rows = min(G::BN, n - row0);
    for (int c0 = 0; c0 < mh; c0 += G::BM) {
      __syncthreads();  // the previous pass or tile is done with xs, ws, ys and the scratch
      float acc[4][4];
      rffml::project<G, VEC>(acc, X, W, n, d, mh, row0, c0, xs, ws, ty, tx);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = c0 + tx * 4 + jj;
        if (j >= mh) continue;
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sincosf(acc[i][jj], &sv[i], &cv[i]);
        *reinterpret_cast<float4*>(ys + j * PAD + ty * 4) =
            make_float4(scale * cv[0], scale * cv[1], scale * cv[2], scale * cv[3]);
        *reinterpret_cast<float4*>(ys + (mh + j) * PAD + ty * 4) =
            make_float4(scale * sv[0], scale * sv[1], scale * sv[2], scale * sv[3]);
      }
    }
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, rows, tile == tile_lo, es, labels, zp,
                                  gpc, cost_acc, [] {});
  }
  if (threadIdx.x == 0) costp[blockIdx.x] = cost_acc;
}

size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, lloyd::MK);
  return sizeof(float) * (G::SMEM_FLOATS + (size_t)m_pad * PAD + lloyd::SCRATCH);
}
}  // namespace rff

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

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
int lloyd_step_tile_rows(int member) { return member == 0 ? apnc::G::BN : rff::G::BN; }

// Dynamic shared memory of one CTA, in bytes.
long long fused_apnc_smem_bytes(int m) { return (long long)apnc::smem_bytes(m); }
long long fused_rff_smem_bytes(int m) { return (long long)rff::smem_bytes(m); }

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
  const size_t smem = rff::smem_bytes(m);
  const bool vec = d % 4 == 0 && mh % 4 == 0 && aligned16(X) && aligned16(W);
  const auto kernel =
      l1 ? (vec ? rff::fused_rff_kernel<true, true> : rff::fused_rff_kernel<true, false>)
         : (vec ? rff::fused_rff_kernel<false, true> : rff::fused_rff_kernel<false, false>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_ctas, THREADS, smem, s>>>(X, W, C, Zp, gp, costp, labels, n, d, mh, k, scale,
                                         tiles_per_cta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)lloyd::launch_reduce(Zp, gp, costp, Z, g, cost, num_ctas, k, m, s);
}

}  // extern "C"
