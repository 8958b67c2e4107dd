// Random Fourier features for Hopper (sm_90a): Y = s [cos(X W), sin(X W)].
//
// Replaces: src/repro/kernels/rff_embed.py::rff_embed_block (_rff_kernel), the
// Pallas TPU kernel.
//
// Bound on an H100 SXM: operations. One launch does 2*n*d*mh f32 operations
// (the trig is ~40 more per output, left out of the bound) and moves
// (n*d + d*mh + 2*n*mh)*4 bytes; at the stream path's shape (n = 1,262,102,
// d = 900, mh = 128) that is 2.9e11 FLOP against 5.85 GB: 4.34 ms on
// 67 TFLOP/s f32 against 1.75 ms on 3.35 TB/s.
//
// Design, and what it does about the bound:
//  * A CTA owns a 64-row x 64-frequency tile of S = X W and walks the feature
//    dimension in chunks of 32 itself (the TPU kernel's sequential d grid
//    axis with its VMEM accumulator becomes a loop in the CTA; the
//    accumulator lives in registers, 4 x 4 a thread, 256 threads).
//  * The trig runs while S is still in registers, and s cos, s sin go
//    straight into the two column halves of Y (row pitch ldy): no (n, mh)
//    projection in device memory, no concatenation afterwards.
//  * sincosf is the accurate version: the projections are not small, and the
//    fast intrinsics lose accuracy as |x| grows. The build uses no
//    --use_fast_math.
//  * Ragged n, d and mh are masked in the loads and stores: no padded
//    copies. The W chunk is read in its natural (d, mh) layout.
//  * The projection repeats the arithmetic of lloyd_step.cu's fused_rff
//    kernel step for step, so the fused Lloyd step sees the same Y.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tile_math.cuh"

namespace {

constexpr int BN = 64;        // rows per tile
constexpr int BM = 64;        // frequencies per tile
constexpr int BD = 32;        // features per chunk
constexpr int PAD = 68;       // pitch of the staged chunks, in floats (keeps float4 alignment)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
rff_kernel(const float* __restrict__ X, const float* __restrict__ W, float* __restrict__ Y,
           int n, int d, int mh, int ldy, float scale) {
  __shared__ __align__(16) float xs[BD * PAD];  // X^T chunk
  __shared__ __align__(16) float ws[BD * PAD];  // W chunk
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int row0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += BD) {
    __syncthreads();  // earlier readers of xs / ws are done
    for (int e = t; e < BN * BD; e += THREADS) {
      const int r = e / BD, c = e % BD;
      const int gr = row0 + r, gc = k0 + c;
      xs[c * PAD + r] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.0f;
    }
    for (int e = t; e < BD * BM; e += THREADS) {
      const int c = e / BM, j = e % BM;
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
      const int r = row0 + ty * 4 + i, j = c0 + tx * 4 + jj;
      if (r < n && j < mh) {
        float sv, cv;
        sincosf(acc[i][jj], &sv, &cv);
        Y[(size_t)r * ldy + j] = scale * cv;
        Y[(size_t)r * ldy + mh + j] = scale * sv;
      }
    }
}

}  // namespace

extern "C" {

// X (n, d) f32, W (d, mh) f32 -> Y (n, 2 mh) f32 with row pitch ldy:
// Y[:, :mh] = scale cos(X W), Y[:, mh:2 mh] = scale sin(X W).
// Returns the CUDA error code of the launch (0 on success).
int rff_embed_f32(const float* X, const float* W, float* Y, int n, int d, int mh, int ldy,
                  float scale, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (mh + BM - 1) / BM);
  rff_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(X, W, Y, n, d, mh, ldy, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
