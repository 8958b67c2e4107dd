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
// The arithmetic contract: every projection S = X W is one fmaf chain from
// 0.0f over the features in ascending order (no split, no tree sum), then
// sincosf (the accurate version: the projections are not small, and the
// fast intrinsics lose accuracy as |x| grows; the build uses no
// --use_fast_math) and one multiply by s. The mainloop is rff_mainloop.cuh's,
// which lloyd_step.cu's fused_rff_kernel runs too, so it sees this kernel's
// Y bit for bit.
//
// Design, and what it does about the bound (the first port read 7.5 TFLOP/s,
// 12 % of an SM's f32 rate: one CTA of 8 warps a SM, every chunk staged
// synchronously with two barriers, 4-way bank conflicts on the transposed
// stores):
//  * A CTA owns a 64-row x 64-frequency tile of S in registers, 4 x 4 a
//    thread, 256 threads, and walks the features in chunks of 64 (half the
//    barriers of chunks of 32). A 4,096-row block is 128 CTAs; up to two
//    CTAs share a SM (80 KB of shared memory each) on the local fit's
//    single launch over all rows.
//  * Loads are in flight while the SM computes (rff_mainloop.cuh, at its
//    rffml::Embed geometry): chunk i + 1 of X comes into registers with
//    16-byte loads during chunk i's FMAs and is then stored, transposed,
//    into the other of two XOR-swizzled X^T buffers; W's chunks come by
//    cp.async into a 3-stage ring. One barrier a chunk.
//  * The trig runs while S is still in registers; s cos and s sin go out as
//    float4 stores into the two column halves of Y (row pitch ldy).
//  * Ragged n, d and mh are zero-filled in the loads and masked in the
//    stores. 16-byte loads and stores need d, mh and ldy multiples of 4 and
//    aligned arrays; other shapes take 4-byte ones, the same arithmetic.
//  * The grid is 1-D with the frequency tile fastest, so the CTAs that read
//    the same rows of X run together and X comes from device memory once.
//  * Measured (H100 80GB HBM3, 700 W; chip_smoke.py): 43 us a 4,096-row
//    block at d = 900, mh = 128 (the first port: 125 us), a third of the
//    f32 rate; 89 registers, two CTAs a SM. The 4 x 4 tile still reads 2
//    float4 from shared memory for 16 FMAs; a taller tile is the next step.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "rff_mainloop.cuh"

namespace {

using G = rffml::Embed;
constexpr int BN = G::BN;  // rows per tile
constexpr int BM = G::BM;  // frequencies per tile
constexpr int THREADS = rffml::THREADS;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
rff_kernel(const float* __restrict__ X, const float* __restrict__ W, float* __restrict__ Y,
           int n, int d, int mh, int ldy, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // 2 x [BD][BN]  X^T chunks, swizzled
  float* ws = xs + 2 * G::XCH;   // 3 x [BD][BM]  W chunks
  int ty, tx;
  rffml::coords<G>(ty, tx);
  const int col_tiles = (mh + BM - 1) / BM;
  const int row0 = (blockIdx.x / col_tiles) * BN;
  const int c0 = (blockIdx.x % col_tiles) * BM;

  float acc[4][4];
  rffml::project<G, VEC>(acc, X, W, n, d, mh, row0, c0, xs, ws, ty, tx);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    const int j = c0 + tx * 4;
    if (r >= n) continue;
    float cv[4], sv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) sincosf(acc[i][jj], &sv[jj], &cv[jj]);
    float* yc = Y + (size_t)r * ldy + j;
    if (VEC) {
      if (j < mh) {
        *reinterpret_cast<float4*>(yc) =
            make_float4(scale * cv[0], scale * cv[1], scale * cv[2], scale * cv[3]);
        *reinterpret_cast<float4*>(yc + mh) =
            make_float4(scale * sv[0], scale * sv[1], scale * sv[2], scale * sv[3]);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j + jj < mh) {
          yc[jj] = scale * cv[jj];
          yc[mh + jj] = scale * sv[jj];
        }
      }
    }
  }
}

constexpr size_t SMEM_BYTES = sizeof(float) * G::SMEM_FLOATS;

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

extern "C" {

// X (n, d) f32, W (d, mh) f32 -> Y (n, 2 mh) f32 with row pitch ldy:
// Y[:, :mh] = scale cos(X W), Y[:, mh:2 mh] = scale sin(X W).
// Returns the CUDA error code of the launch (0 on success).
int rff_embed_f32(const float* X, const float* W, float* Y, int n, int d, int mh, int ldy,
                  float scale, void* stream) {
  const bool vec = d % 4 == 0 && mh % 4 == 0 && ldy % 4 == 0 && aligned16(X) && aligned16(W) &&
                   aligned16(Y);
  const auto kernel = vec ? rff_kernel<true> : rff_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((n + BN - 1) / BN) * ((mh + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(X, W, Y, n, d, mh, ldy,
                                                                        scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
