// Fused APNC embedding for Hopper (sm_90a): Y = kappa(X, L) @ R^T for one block.
//
// Replaces: src/repro/kernels/apnc_embed.py::apnc_embed_block (_embed_kernel,
// _apply_kernel_nonlin), the Pallas TPU kernel.
//
// Bound on an H100 SXM: compute. One launch does 2*n*l*(d + m) f32 operations
// and moves (n*d + n*m)*4 bytes; at the main path's shape (n = 1,262,102,
// d = 900, l = 500, m = 256) that is 1.46e12 FLOP against 5.84 GB, so against
// the card's 67 TFLOP/s f32 rate and 3.35 TB/s it is about 12x more
// operation-bound than byte-bound.
//
// Design, and what it does about the bound:
//  * One CTA owns BN = 64 rows of Y and walks over every landmark tile and
//    every feature chunk itself. The TPU kernel's sequential grid, which adds
//    each landmark tile's K R^T into a revisited output block, has no GPU
//    counterpart; here the (BN x m) Y accumulator stays in shared memory for
//    the whole CTA, so Y is written to device memory exactly once and the
//    (n, l) gram never reaches it.
//  * Both contractions (S = X L^T over d, then Y += K R^T over the landmark
//    tile) are 64 x 64 register-tiled f32 FMA loops: 256 threads, 4 x 4
//    outputs each, operands staged transposed in shared memory and read as
//    float4. Plain f32 keeps the numbers of the plain PyTorch version; tensor
//    cores (TF32, bf16) are a later step.
//  * rbf row and landmark norms ride along in the d loop, d^2 is clamped at 0
//    before exp, as in the TPU kernel.
//  * Ragged n, d, l and m are masked in the loads and stores: no padded copies.
//  * The R chunk aliases the X/L chunk buffers (they are never live together),
//    so at m = 256 a CTA takes about 101 KB and two CTAs fit on one SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "tile_math.cuh"

namespace {

using tilemath::fma_4x4;
using tilemath::KParams;
using tilemath::nonlin;
using tilemath::RBF;

constexpr int BN = 64;        // rows of Y per CTA
constexpr int BL = 64;        // landmarks per tile
constexpr int BD = 32;        // features per chunk
constexpr int MC = 64;        // Y columns per update chunk
constexpr int PAD = 68;       // pitch of the transposed tiles, in floats (keeps float4 alignment)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
static_assert(2 * BD == BL, "the R chunk aliases the X and L chunks");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX>
__global__ void __launch_bounds__(THREADS)
embed_kernel(const TX* __restrict__ X, const float* __restrict__ L, const float* __restrict__ R,
             float* __restrict__ Y, int n, int d, int l, int m, int ldy, KParams kp) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = (m + MC - 1) / MC * MC;
  float* yacc = smem;               // [BN][m_pad]  Y accumulator
  float* ks = yacc + BN * m_pad;    // [BL][PAD]    K^T tile
  float* xs = ks + BL * PAD;        // [BD][PAD]    X^T chunk
  float* ls = xs + BD * PAD;        // [BD][PAD]    L^T chunk
  float* rs = xs;                   // [BL][PAD]    R^T chunk, over xs and ls
  float* xx_s = xs + BL * PAD;      // [BN]         row norms
  float* ll_s = xx_s + BN;          // [BL]         landmark norms

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int row0 = blockIdx.x * BN;

  for (int e = t; e < BN * m_pad; e += THREADS) yacc[e] = 0.0f;

  for (int j0 = 0; j0 < l; j0 += BL) {
    float acc[4][4] = {};
    float nrm = 0.0f;  // t < BN: |x_t|^2; BN <= t < BN + BL: |l_t|^2
    for (int k0 = 0; k0 < d; k0 += BD) {
      __syncthreads();  // earlier readers of xs / ls / rs are done
      for (int e = t; e < BN * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int gc = k0 + c;
        const int gr = row0 + r, gl = j0 + r;
        xs[c * PAD + r] = (gr < n && gc < d) ? to_f32(X[(size_t)gr * d + gc]) : 0.0f;
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
        fma_4x4(acc, *reinterpret_cast<const float4*>(xs + c * PAD + ty * 4),
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
      float y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(yacc + (ty * 4 + i) * m_pad + c0 + tx * 4);
        y[i][0] = v.x; y[i][1] = v.y; y[i][2] = v.z; y[i][3] = v.w;
      }
#pragma unroll 8
      for (int j = 0; j < BL; ++j) {
        fma_4x4(y, *reinterpret_cast<const float4*>(ks + j * PAD + ty * 4),
                *reinterpret_cast<const float4*>(rs + j * PAD + tx * 4));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(yacc + (ty * 4 + i) * m_pad + c0 + tx * 4) =
            make_float4(y[i][0], y[i][1], y[i][2], y[i][3]);
      }
    }
  }
  __syncthreads();
  for (int e = t; e < BN * m; e += THREADS) {
    const int r = e / m, c = e % m;
    if (row0 + r < n) Y[(size_t)(row0 + r) * ldy + c] = yacc[r * m_pad + c];
  }
}

size_t smem_bytes(int m) {
  const int m_pad = (m + MC - 1) / MC * MC;
  return sizeof(float) * ((size_t)BN * m_pad + (size_t)BL * PAD + 2 * (size_t)BD * PAD + BN + BL);
}

template <typename TX>
int launch(const TX* X, const float* L, const float* R, float* Y, int n, int d, int l, int m,
           int ldy, int kind, float gamma, float coef0, float scale, int degree, void* stream) {
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(embed_kernel<TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const KParams kp{kind, gamma, coef0, scale, degree};
  const dim3 grid((n + BN - 1) / BN);
  embed_kernel<TX><<<grid, THREADS, smem, (cudaStream_t)stream>>>(X, L, R, Y, n, d, l, m, ldy, kp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m one launch takes; the wrapper splits wider blocks into column groups.
int apnc_embed_max_m() { return 512; }

// Dynamic shared memory of one CTA for a launch with m columns, in bytes.
long long apnc_embed_smem_bytes(int m) { return (long long)smem_bytes(m); }

// X (n, d) f32, L (l, d) f32, R (m, l) f32 -> Y (n, m) f32 with row pitch ldy.
// Returns the CUDA error code of the launch (0 on success).
int apnc_embed_f32(const float* X, const float* L, const float* R, float* Y, int n, int d, int l,
                   int m, int ldy, int kind, float gamma, float coef0, float scale, int degree,
                   void* stream) {
  return launch<float>(X, L, R, Y, n, d, l, m, ldy, kind, gamma, coef0, scale, degree, stream);
}

// As apnc_embed_f32 with X in bf16; accumulation stays f32.
int apnc_embed_bf16(const void* X, const float* L, const float* R, float* Y, int n, int d, int l,
                    int m, int ldy, int kind, float gamma, float coef0, float scale, int degree,
                    void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(X), L, R, Y, n, d, l, m, ldy,
                               kind, gamma, coef0, scale, degree, stream);
}

}  // extern "C"
