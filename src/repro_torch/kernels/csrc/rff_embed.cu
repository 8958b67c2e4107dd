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
// --use_fast_math) and one multiply by s. lloyd_step.cu's fused_rff_kernel
// takes the same steps, so it sees this kernel's Y bit for bit.
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
//  * Loads are in flight while the SM computes: chunk i + 1 of X comes into
//    registers with 16-byte loads during chunk i's FMAs and is then stored,
//    transposed, into the other of two X^T buffers; W's chunks, already in
//    the (feature, frequency) layout the reads want, come by cp.async into a
//    3-stage ring. One barrier a chunk.
//  * The X^T buffers are XOR-swizzled by 16-byte row group, so the
//    transposed stores are conflict-free and the float4 reads stay whole.
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

#include "cp_async.cuh"
#include "tile_math.cuh"

namespace {

constexpr int BN = 64;        // rows per tile
constexpr int BM = 64;        // frequencies per tile
constexpr int BD = 64;        // features per chunk
constexpr int WSTAGES = 3;    // W chunks in flight
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int CHUNK = BD * BN;  // floats in one staged chunk (BN == BM)
static_assert(BN == BM && BN == 64, "X^T and W chunks share the 64-float row");

__device__ __forceinline__ int swizzle(int c) { return ((c >> 2) & 3) << 1; }

// Chunk k0 of X as four float4 a thread: rows r = 8 (combo % 8) + lane % 8,
// features 4 c4 .. 4 c4 + 3 with c4 = 4 (combo / 8) + lane / 8, combo =
// 4 warp + p. Zero outside X.
template <bool VEC>
__device__ __forceinline__ void load_x(float4 (&v)[4], const float* __restrict__ X, int n, int d,
                                       int row0, int k0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int combo = warp * 4 + p;
    const int r = (combo & 7) * 8 + (lane & 7);
    const int c = ((combo >> 3) * 4 + (lane >> 3)) * 4;
    const int gr = row0 + r, gc = k0 + c;
    const float* src = X + (size_t)gr * d + gc;
    if (VEC) {
      v[p] = (gr < n && gc < d) ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
    } else {
      const bool ok = gr < n;
      v[p] = make_float4(ok && gc < d ? src[0] : 0.0f, ok && gc + 1 < d ? src[1] : 0.0f,
                         ok && gc + 2 < d ? src[2] : 0.0f, ok && gc + 3 < d ? src[3] : 0.0f);
    }
  }
}

// Store load_x's values transposed: X^T element (c, r) at
// c * BN + ((r / 4) ^ swizzle(c)) * 4 + r % 4. Within a warp the 32 stores
// of one feature hit 32 banks.
__device__ __forceinline__ void store_xt(float* xs, const float4 (&v)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int combo = warp * 4 + p;
    const int r = (combo & 7) * 8 + (lane & 7);
    const int c = ((combo >> 3) * 4 + (lane >> 3)) * 4;
    const float e[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xs[(c + j) * BN + (((r >> 2) ^ swizzle(c + j)) << 2) + (r & 3)] = e[j];
  }
}

// W rows [k0, k0 + BD) x columns [c0, c0 + BM) into ws (pitch BM) by
// cp.async, as one group (empty when k0 >= d); zero outside W.
template <bool VEC>
__device__ __forceinline__ void issue_w(float* ws, const float* __restrict__ W, int d, int mh,
                                        int k0, int c0) {
  if (k0 < d && VEC) {
    for (int e = threadIdx.x; e < BD * BM / 4; e += THREADS) {
      const int c = e >> 4, j = (e & 15) * 4;
      const bool ok = k0 + c < d && c0 + j < mh;
      cpasync::copy16(ws + c * BM + j, ok ? W + (size_t)(k0 + c) * mh + c0 + j : W, ok);
    }
  } else if (k0 < d) {
    for (int e = threadIdx.x; e < BD * BM; e += THREADS) {
      const int c = e >> 6, j = e & 63;
      const bool ok = k0 + c < d && c0 + j < mh;
      cpasync::copy4(ws + c * BM + j, ok ? W + (size_t)(k0 + c) * mh + c0 + j : W, ok);
    }
  }
  cpasync::commit();
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
rff_kernel(const float* __restrict__ X, const float* __restrict__ W, float* __restrict__ Y,
           int n, int d, int mh, int ldy, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // 2 x [BD][BN]  X^T chunks, swizzled
  float* ws = xs + 2 * CHUNK;    // 3 x [BD][BM]  W chunks
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int col_tiles = (mh + BM - 1) / BM;
  const int row0 = (blockIdx.x / col_tiles) * BN;
  const int c0 = (blockIdx.x % col_tiles) * BM;
  const int chunks = (d + BD - 1) / BD;

  issue_w<VEC>(ws, W, d, mh, 0, c0);
  issue_w<VEC>(ws + CHUNK, W, d, mh, BD, c0);  // an empty group when d <= BD
  float4 xr[4];
  load_x<VEC>(xr, X, n, d, row0, 0);
  store_xt(xs, xr);

  float acc[4][4] = {};
  for (int i = 0; i < chunks; ++i) {
    cpasync::wait<1>();  // W chunk i has landed; i + 1 may still be in flight
    __syncthreads();     // X^T chunk i visible; every thread is done with chunk i - 1
    issue_w<VEC>(ws + ((i + 2) % WSTAGES) * CHUNK, W, d, mh, (i + 2) * BD, c0);
    const bool more = i + 1 < chunks;
    if (more) load_x<VEC>(xr, X, n, d, row0, (i + 1) * BD);
    const float* xc = xs + (i & 1) * CHUNK;
    const float* wc = ws + (i % WSTAGES) * CHUNK;
#pragma unroll 16
    for (int c = 0; c < BD; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(xc + c * BN + ((ty ^ swizzle(c)) << 2));
      tilemath::fma_4x4(acc, x, *reinterpret_cast<const float4*>(wc + c * BM + tx * 4));
    }
    if (more) store_xt(xs + ((i + 1) & 1) * CHUNK, xr);
  }

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

constexpr size_t SMEM_BYTES = sizeof(float) * (2 + WSTAGES) * CHUNK;

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
