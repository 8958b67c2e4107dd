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

#include "cp_async.cuh"
#include "lloyd_epilogue.cuh"

namespace {

using lloyd::BN;
using lloyd::KC;
using lloyd::PAD;
using lloyd::THREADS;
using tilemath::KParams;
using tilemath::nonlin;
using tilemath::RBF;

constexpr int BD = 32;  // features per chunk (fused_rff_kernel)
constexpr int MC = 64;  // Y columns per update chunk (fused_rff_kernel)
constexpr int MAX_M = 512;

__device__ __forceinline__ void zero_tile(float* ys, int m_pad) {
  for (int e = threadIdx.x; e < m_pad * PAD; e += THREADS) ys[e] = 0.0f;
}

// fused_apnc_kernel's geometry.
namespace apnc {
constexpr int BN = 32;         // rows per tile
constexpr int BL = 256;        // landmarks per super-tile
constexpr int BD = 32;         // features per chunk
constexpr int MC = 256;        // Y columns per update chunk
constexpr int RL = 32;         // landmarks per R sub-chunk
constexpr int SP = 36;         // pitch of the staged chunks (SP / 4 odd: conflict-free float4)
constexpr int KP = BL + 4;     // pitch of the K tile
constexpr int YP = BN + 4;     // pitch of the Y^T tile
constexpr int STAGE = (BN + BL) * SP;  // floats in one ring stage
constexpr int NS = 2;          // ring stages: step s + 1's copies are in flight during step s
constexpr int TX = 64;         // threads along the landmarks / Y columns
constexpr int TY = 4;          // threads along the rows
constexpr int RI = 8;          // rows a thread, TY apart
constexpr int RQ = 4;          // landmarks / Y columns a thread, TX apart
using Epi = lloyd::Layout<BN>;
static_assert(BL == THREADS, "thread t sums landmark t's norm");
static_assert(TX * RQ == BL && TX * RQ == MC && TY * RI == BN && TX * TY == THREADS,
              "thread tiling");
static_assert(MC * SP <= STAGE, "an R sub-chunk fits in a ring stage");
static_assert(lloyd::MK * Epi::CPAD <= STAGE, "the epilogue's C sub-chunk fits in a ring stage");
static_assert(BD == 32 && RL == 32, "stage_block copies 32 columns");

// Copy rows [r0, r0 + nrows) x columns [c0, c0 + 32) of a row-major (rows,
// cols) array A into dst at pitch SP; elements outside A are zero-filled.
template <bool VEC>
__device__ __forceinline__ void stage_block(float* dst, const float* __restrict__ A, int rows,
                                            int cols, int nrows, int r0, int c0) {
  if (VEC) {
    for (int e = threadIdx.x; e < nrows * 8; e += THREADS) {
      const int r = e >> 3, c = (e & 7) * 4;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cpasync::copy16(dst + r * SP + c, ok ? A + (size_t)(r0 + r) * cols + c0 + c : A, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * 32; e += THREADS) {
      const int r = e >> 5, c = e & 31;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cpasync::copy4(dst + r * SP + c, ok ? A + (size_t)(r0 + r) * cols + c0 + c : A, ok);
    }
  }
}

// The steps of one tile, in order: for each landmark super-tile, nd steps
// over the feature chunks (X and L), then nr steps over the (Y column chunk,
// R sub-chunk) pairs. Issues step s's copies into its ring stage as one
// group (an empty group past the last step, so the group count stays fixed).
template <bool VEC>
__device__ __forceinline__ void issue_step(int s, int steps, float* ring, const float* X,
                                           const float* L, const float* R, int n, int d, int l,
                                           int m, int row0, int nd, int nr) {
  const int per = nd + nr;
  const int j0 = (s / per) * BL;
  const int w = s % per;
  float* stage = ring + (s % NS) * STAGE;
  if (s < steps && w < nd) {
    stage_block<VEC>(stage, X, n, d, BN, row0, w * BD);
    stage_block<VEC>(stage + BN * SP, L, l, d, BL, j0, w * BD);
  } else if (s < steps) {
    const int sub = (w - nd) % (BL / RL), cc = (w - nd) / (BL / RL);
    stage_block<VEC>(stage, R, m, l, MC, cc * MC, j0 + sub * RL);
  }
  cpasync::commit();
}

// The top of step s: its copies have landed and every thread is done with
// step s - 1, whose stage then takes step s + NS - 1's copies.
template <bool VEC>
__device__ __forceinline__ const float* begin_step(int s, int steps, float* ring, const float* X,
                                                   const float* L, const float* R, int n, int d,
                                                   int l, int m, int row0, int nd, int nr) {
  cpasync::wait<NS - 2>();
  __syncthreads();
  issue_step<VEC>(s + NS - 1, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
  return ring + (s % NS) * STAGE;
}

__device__ __forceinline__ void norm4(float& acc, const float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  acc = fmaf(v.w, v.w, acc);
}

// acc[i][q] += a[i] . b[q] over four consecutive indices, in ascending order.
__device__ __forceinline__ void fma_8x4x4(float (&acc)[RI][RQ], const float4 (&a)[RI],
                                          const float4 (&b)[RQ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      acc[i][q] = fmaf(a[i].x, b[q].x, acc[i][q]);
      acc[i][q] = fmaf(a[i].y, b[q].y, acc[i][q]);
      acc[i][q] = fmaf(a[i].z, b[q].z, acc[i][q]);
      acc[i][q] = fmaf(a[i].w, b[q].w, acc[i][q]);
    }
}

template <bool L1, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_apnc_kernel(const float* __restrict__ X, const float* __restrict__ L,
                  const float* __restrict__ R, const float* __restrict__ C,
                  float* __restrict__ Zp, float* __restrict__ gp, float* __restrict__ costp,
                  int* __restrict__ labels, int n, int d, int l, int m, int k, int tiles_per_cta,
                  KParams kp) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, MC);
  float* ring = smem;                // NS x [STAGE]  X + L chunks or an R sub-chunk;
                                     //               epilogue: C^T sub-chunk
  float* ks = ring + NS * STAGE;     // [BN][KP]     K tile
  float* ys = ks + BN * KP;          // [m_pad][YP]  Y^T tile
  float* xx_s = ys + m_pad * YP;     // [BN]         row norms
  float* ll_s = xx_s + BN;           // [BL]         landmark norms
  lloyd::EpilogueSmem es;
  es.cs = ring;
  es.yy_s = ll_s + BL;               // [BN]
  es.cc_s = es.yy_s + BN;            // [Epi::KC]
  es.mind_s = es.cc_s + Epi::KC;     // [BN]
  es.lab_s = reinterpret_cast<int*>(es.mind_s + BN);  // [BN]

  // A warp is 4 (ty) x 8 (tx) threads: its operand reads touch 4 rows and
  // 8 landmarks (or Y columns): a float4 read is 128 distinct bytes in distinct banks.
  const int t = threadIdx.x;
  const int tx = (t >> 5) * 8 + (t & 7);
  const int ty = (t & 31) >> 3;
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_partials(zp, gpc, k, m);

  const int nd = (d + BD - 1) / BD;
  const int nr = (m_pad / MC) * (BL / RL);
  const int n_st = (l + BL - 1) / BL;
  const int steps = n_st * (nd + nr);
  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    const int rows = min(BN, n - row0);
    __syncthreads();  // the previous tile's epilogue is done with ys, the ring and the scratch
    for (int p = 0; p < NS - 1; ++p)
      issue_step<VEC>(p, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
    int s = 0;
    for (int st = 0; st < n_st; ++st) {
      const int j0 = st * BL;
      // S = X L^T for the super-tile: rows ty + 4 i, landmarks tx + 64 q.
      float acc[RI][RQ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int q = 0; q < RQ; ++q) acc[i][q] = 0.0f;
      float nl = 0.0f, nx = 0.0f;  // |l_{j0 + t}|^2; t < BN: |x_t|^2
      for (int w = 0; w < nd; ++w, ++s) {
        const float* xs = begin_step<VEC>(s, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
        const float* ls = xs + BN * SP;
        if (kp.kind == RBF) {
#pragma unroll
          for (int c = 0; c < BD; c += 4) {
            norm4(nl, *reinterpret_cast<const float4*>(ls + t * SP + c));
            if (t < BN) norm4(nx, *reinterpret_cast<const float4*>(xs + t * SP + c));
          }
        }
#pragma unroll
        for (int c = 0; c < BD; c += 4) {
          float4 a[RI], b[RQ];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            a[i] = *reinterpret_cast<const float4*>(xs + (ty + i * TY) * SP + c);
#pragma unroll
          for (int q = 0; q < RQ; ++q)
            b[q] = *reinterpret_cast<const float4*>(ls + (tx + q * TX) * SP + c);
          fma_8x4x4(acc, a, b);
        }
      }
      if (t < BN) xx_s[t] = nx;
      ll_s[t] = nl;
      __syncthreads();  // norms visible; every thread is done with the last chunk
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int r = ty + i * TY, j = tx + q * TX;
          ks[r * KP + j] = (j0 + j < l) ? nonlin(acc[i][q], xx_s[r], ll_s[j], kp) : 0.0f;
        }

      // Y += K R^T: rows ty + 4 i, columns c0 + tx + 64 q.
      for (int c0 = 0; c0 < m_pad; c0 += MC) {
        float y[RI][RQ];
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int i = 0; i < RI; ++i)
            y[i][q] = st ? ys[(c0 + tx + q * TX) * YP + ty + i * TY] : 0.0f;
        for (int sub = 0; sub < BL / RL; ++sub, ++s) {
          const float* rs = begin_step<VEC>(s, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
          const float* kt = ks + sub * RL;
#pragma unroll
          for (int j = 0; j < RL; j += 4) {
            float4 a[RI], b[RQ];
#pragma unroll
            for (int i = 0; i < RI; ++i)
              a[i] = *reinterpret_cast<const float4*>(kt + (ty + i * TY) * KP + j);
#pragma unroll
            for (int q = 0; q < RQ; ++q)
              b[q] = *reinterpret_cast<const float4*>(rs + (tx + q * TX) * SP + j);
            fma_8x4x4(y, a, b);
          }
        }
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int i = 0; i < RI; ++i) ys[(c0 + tx + q * TX) * YP + ty + i * TY] = y[i][q];
      }
    }
    lloyd::assign_reduce_tile<L1, BN, YP, true>(ys, m_pad, C, k, m, row0, rows, es, labels, zp,
                                                gpc, cost_acc);
  }
  if (t == 0) costp[blockIdx.x] = cost_acc;
}

size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, MC);
  return sizeof(float) * (NS * (size_t)STAGE + (size_t)BN * KP + (size_t)m_pad * YP + BN + BL +
                          BN + Epi::KC + BN) +
         sizeof(int) * BN;
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
int lloyd_step_tile_rows(int member) { return member == 0 ? apnc::BN : BN; }

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
