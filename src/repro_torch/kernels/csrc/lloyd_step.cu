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
// Design, and what it does about the bound:
//  * The TPU kernel holds L, R and C whole in VMEM; on Hopper L alone is
//    1.8 MB at l = 500, d = 900. So one CTA owns 64 rows and streams the
//    operands through shared memory in tiles, as csrc/apnc_embed.cu does:
//    S = X L^T over feature chunks of 32, K = kappa(S) for a landmark tile of
//    64, Y += K R^T over column chunks of 64. The RFF kernel computes
//    S = X W in column chunks of 64 and writes s cos(S), s sin(S) into the
//    [cos | sin] halves of the tile.
//  * The (64 x m) Y tile stays in shared memory, transposed (ys[c][r]), and
//    feeds the shared epilogue straight away: no Y in device memory, no
//    second launch over Y. The arithmetic of both embeds repeats
//    apnc_embed.cu and rff_embed.cu step for step, and the epilogue repeats
//    apnc_assign.cu, so a fused step gives the labels of the un-fused kernel
//    chain bit for bit.
//  * Shared memory is (m_pad * 68 + 8,704 + ~1,000) floats: about 106 KB at
//    m = 256, 2 CTAs per SM. The tile buffers of the embed are reused by the
//    epilogue. m <= 512 (lloyd_step_max_m); the wrapper's caller routes wider
//    params to the un-fused kernels.
//  * A 4,096-row block is 64 CTAs, under half of the 132 SMs: the launch is
//    latency-bound by construction. Filling the card is for a later PR.
//  * Plain f32 FMA, no tensor cores: the parity checks hold f32 numbers.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "lloyd_epilogue.cuh"

namespace {

using lloyd::BN;
using lloyd::KC;
using lloyd::PAD;
using lloyd::THREADS;
using tilemath::KParams;
using tilemath::nonlin;
using tilemath::RBF;

constexpr int BL = 64;  // landmarks per tile
constexpr int BD = 32;  // features per chunk
constexpr int MC = 64;  // Y columns per update chunk
constexpr int MAX_M = 512;
static_assert(2 * BD == BL, "the R chunk aliases the X and L chunks");
static_assert(lloyd::MK * PAD <= BL * PAD, "the epilogue's C chunk fits over the K tile");

__device__ __forceinline__ void zero_tile(float* ys, int m_pad) {
  for (int e = threadIdx.x; e < m_pad * PAD; e += THREADS) ys[e] = 0.0f;
}

template <bool L1>
__global__ void __launch_bounds__(THREADS)
fused_apnc_kernel(const float* __restrict__ X, const float* __restrict__ L,
                  const float* __restrict__ R, const float* __restrict__ C,
                  float* __restrict__ Zp, float* __restrict__ gp, float* __restrict__ costp,
                  int* __restrict__ labels, int n, int d, int l, int m, int k, int tiles_per_cta,
                  KParams kp) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, MC);
  float* ys = smem;                  // [m_pad][PAD]  Y^T tile
  float* ks = ys + m_pad * PAD;      // [BL][PAD]     K^T tile; epilogue: C^T chunk
  float* xs = ks + BL * PAD;         // [BD][PAD]     X^T chunk
  float* ls = xs + BD * PAD;         // [BD][PAD]     L^T chunk
  float* rs = xs;                    // [BL][PAD]     R^T chunk, over xs and ls
  float* xx_s = xs + BL * PAD;       // [BN]          row norms
  float* ll_s = xx_s + BN;           // [BL]          landmark norms
  lloyd::EpilogueSmem es;
  es.cs = ks;
  es.yy_s = ll_s + BL;               // [BN]
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
    zero_tile(ys, m_pad);

    for (int j0 = 0; j0 < l; j0 += BL) {
      float acc[4][4] = {};
      float nrm = 0.0f;  // t < BN: |x_t|^2; BN <= t < BN + BL: |l_t|^2
      for (int k0 = 0; k0 < d; k0 += BD) {
        __syncthreads();  // earlier readers of xs / ls / rs are done
        for (int e = t; e < BN * BD; e += THREADS) {
          const int r = e / BD, c = e % BD;
          const int gc = k0 + c;
          const int gr = row0 + r, gl = j0 + r;
          xs[c * PAD + r] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.0f;
          ls[c * PAD + r] = (gl < l && gc < d) ? L[(size_t)gl * d + gc] : 0.0f;
        }
        __syncthreads();
        if (kp.kind == RBF) {
          if (t < BN) {
            for (int c = 0; c < BD; ++c) { const float v = xs[c * PAD + t]; nrm = fmaf(v, v, nrm); }
          } else if (t < BN + BL) {
            for (int c = 0; c < BD; ++c) { const float v = ls[c * PAD + t - BN]; nrm = fmaf(v, v, nrm); }
          }
        }
#pragma unroll 8
        for (int c = 0; c < BD; ++c) {
          tilemath::fma_4x4(acc, *reinterpret_cast<const float4*>(xs + c * PAD + ty * 4),
                            *reinterpret_cast<const float4*>(ls + c * PAD + tx * 4));
        }
      }
      if (t < BN) xx_s[t] = nrm;
      else if (t < BN + BL) ll_s[t - BN] = nrm;
      __syncthreads();  // norms visible; xs / ls no longer read

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = ty * 4 + i, j = tx * 4 + jj;
          ks[j * PAD + r] = (j0 + j < l) ? nonlin(acc[i][jj], xx_s[r], ll_s[j], kp) : 0.0f;
        }

      for (int c0 = 0; c0 < m_pad; c0 += MC) {
        __syncthreads();  // ks complete; earlier readers of rs are done
        for (int e = t; e < MC * BL; e += THREADS) {
          const int c = e / BL, j = e % BL;
          const int gc = c0 + c, gj = j0 + j;
          rs[j * PAD + c] = (gc < m && gj < l) ? R[(size_t)gc * l + gj] : 0.0f;
        }
        __syncthreads();
        // y[i][jj]: row ty*4 + i, column c0 + tx*4 + jj of the transposed tile.
        float y[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v = *reinterpret_cast<const float4*>(ys + (c0 + tx * 4 + jj) * PAD + ty * 4);
          y[0][jj] = v.x; y[1][jj] = v.y; y[2][jj] = v.z; y[3][jj] = v.w;
        }
#pragma unroll 8
        for (int j = 0; j < BL; ++j) {
          tilemath::fma_4x4(y, *reinterpret_cast<const float4*>(ks + j * PAD + ty * 4),
                            *reinterpret_cast<const float4*>(rs + j * PAD + tx * 4));
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          *reinterpret_cast<float4*>(ys + (c0 + tx * 4 + jj) * PAD + ty * 4) =
              make_float4(y[0][jj], y[1][jj], y[2][jj], y[3][jj]);
        }
      }
    }
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, rows, es, labels, zp, gpc, cost_acc);
  }
  if (t == 0) costp[blockIdx.x] = cost_acc;
}

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

size_t apnc_smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, MC);
  return sizeof(float) * ((size_t)m_pad * PAD + (size_t)BL * PAD + 2 * (size_t)BD * PAD +
                          BN + BL + BN + KC + BN) +
         sizeof(int) * BN;
}

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

// Rows per tile; the wrapper sizes the P partials from it.
int lloyd_step_tile_rows() { return BN; }

// Dynamic shared memory of one CTA, in bytes.
long long fused_apnc_smem_bytes(int m) { return (long long)apnc_smem_bytes(m); }
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
  const size_t smem = apnc_smem_bytes(m);
  const KParams kp{kind, gamma, coef0, scale, degree};
  cudaError_t err;
  if (l1) {
    err = set_smem(fused_apnc_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_apnc_kernel<true><<<num_ctas, THREADS, smem, s>>>(X, L, R, C, Zp, gp, costp, labels, n,
                                                            d, l, m, k, tiles_per_cta, kp);
  } else {
    err = set_smem(fused_apnc_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_apnc_kernel<false><<<num_ctas, THREADS, smem, s>>>(X, L, R, C, Zp, gp, costp, labels, n,
                                                             d, l, m, k, tiles_per_cta, kp);
  }
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
