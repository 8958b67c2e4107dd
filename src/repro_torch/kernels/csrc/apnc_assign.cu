// Fused APNC assignment for Hopper (sm_90a): distances -> argmin -> (Z, g, cost).
//
// Replaces: src/repro/kernels/apnc_assign.py::apnc_assign_padded
// (_assign_kernel, _distances), the Pallas TPU kernel; the block's cost, which
// the TPU path takes in a second pass (core/lloyd.py::block_cost), comes out
// of the same launch.
//
// Bound on an H100 SXM: operations. One launch does 2*n*k*m f32 operations
// and moves (n*m + k*m + n + k*m + k + 1)*4 bytes; at the main path's shape
// (n = 1,262,102, m = 256, k = 164) that is 1.06e11 FLOP against 1.30 GB,
// 1.58 ms on 67 TFLOP/s f32, about 4x more operation-bound than byte-bound
// on 3.35 TB/s.
//
// Design, and what it does about the bound (redesigned for Hopper; the first
// port ran 64-row tiles, 4 rows x 4 centroids a thread, Y loaded by scalar
// loads with a divide a value and stored transposed with bank conflicts, C
// re-read synchronously between two barriers a 32-column sub-chunk, the row
// norms serial on a quarter of the threads, every CTA zeroing its whole
// (k, m) Z partial and updating it one row at a time through L2, and the
// cost in a second GEMM over Y: 7.82-7.87 ms a launch over the resident X
// without the cost, 20 % of its bound):
//  * assign_kernel is the fused steps' epilogue (lloyd_epilogue.cuh) on a Y
//    tile read from device memory: 32-row tiles, the CTAs of
//    lloyd_step.launch_geometry(n, 32) (at most 264, each over an equal run
//    of tiles), per-CTA (Z, g, cost) partials and lloyd_reduce_kernel summing
//    them in the order p = 0..P-1. For the same Y and C its (Z, g, labels,
//    cost) are therefore bitwise those of fused_apnc_step, fused_rff_step and
//    fused_dequant_step, run to run: no float atomics.
//  * A tile's rows come by cp.async (16-byte copies when m is a multiple of 4
//    and Y is aligned, 4-byte copies otherwise; zero past n and m) into a raw
//    row-major tile whose rows are an odd number of 16-byte words apart, in
//    the space of the epilogue's C buffers. Y is read once, so its copies
//    carry an L2 evict-first policy: over the resident X (1.29 GB) the
//    CTAs' Z partials (263 x 164 x 256 floats, 44 MB) and C stay in the
//    50 MB L2 instead of going to device memory between their updates.
//    Where a CTA holds more tiles, the next tile's copies go out as soon as
//    the epilogue has read its last C sub-chunk and are in flight while it
//    combines, groups and updates Z.
//  * The raw tile is transposed into the epilogue's ys[c * 36 + r]: lane r
//    reads row r's 16-byte words (the odd pitch spreads a quarter warp's
//    reads over the banks), and the 32 lanes of a warp store one column's 32
//    rows, 32 banks, no conflict.
//  * Shared memory is the Y^T tile (m_pad * 36 floats), the C buffers or the
//    raw tile, whichever is larger, and the epilogue's scratch: 112,772 bytes
//    at m = 256, so two CTAs share an SM (__launch_bounds__(256, 2): at most
//    128 registers); m <= 832 fits a CTA's 232,448 bytes (MAX_M).
//  * Wider m takes assign_wide_kernel: 64-row tiles, 4 x 4 a thread, Y
//    streamed through shared memory 64 rows x 32 columns at a time beside the
//    matching C sub-chunk, read again for each 64-centroid chunk, (Z, g)
//    through a zeroed per-CTA partial updated row by row, and the cost beside
//    them. Its labels and cost are the tiled kernel's; its Z is a sum in
//    another order.
//  * Labels: every distance is one fmaf chain over the columns in ascending
//    order; l2 compares yy - 2 y.c + cc clamped at 0, with yy and cc
//    ascending chains; l1 sums |y - c|; ties go to the lowest index. The cost
//    is block_cost's: the sum over rows of sqrt(min d^2) for l2, of min d for
//    l1, in row order within a CTA.
//  * Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py timing, m = 256,
//    k = 164): 5.46-5.50 ms a launch over the resident X, the cost and a
//    31 us reduce included (the first port 7.78-7.83 ms without the cost,
//    in the same calls); 36-38 us of device time a 4,096-row launch.
//    tools/kernel_ablation.py puts 0.75 ms of a launch in the Z update,
//    0.6 in the distance loop's reads of Y, about 0.1 in the cost, 0.09 in
//    the copies, transposes and reduce, and the rest in the distance FMAs at
//    about 42 % of the f32 rate; one CTA an SM instead of two reads 7.0-7.1
//    ms, the k tail padded to 256 centroids 6.1.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "cp_async.cuh"
#include "lloyd_epilogue.cuh"
#include "tile_math.cuh"

namespace {

using lloyd::BN;
using lloyd::MK;
using lloyd::PAD;
using lloyd::THREADS;

constexpr int MAX_M = 832;          // widest m of the tiled kernel
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a CTA may have

// The raw tile: BN rows of m_pad floats, each row `pitch` 16-byte words
// apart, pitch odd.
__host__ __device__ constexpr int raw_pitch(int m_pad) { return (m_pad / 4) | 1; }

// Floats of the space the raw tile shares with the epilogue's C buffers.
__host__ __device__ constexpr int shared_floats(int m_pad) {
  return 4 * BN * raw_pitch(m_pad) > 2 * lloyd::CBUF ? 4 * BN * raw_pitch(m_pad)
                                                     : 2 * lloyd::CBUF;
}

constexpr size_t tiled_smem_bytes(int m) {
  return sizeof(float) * ((size_t)lloyd::round_up(m, MK) * PAD +
                          shared_floats(lloyd::round_up(m, MK)) + lloyd::SCRATCH);
}
static_assert(tiled_smem_bytes(MAX_M) <= SMEM_MAX && tiled_smem_bytes(MAX_M + MK) > SMEM_MAX,
              "MAX_M is the widest m whose tile fits");

// Rows [row0, row0 + BN) of Y into the raw tile by cp.async, one group; zero
// outside Y. VEC: 16-byte copies (m a multiple of 4, Y aligned). Y is read
// once: its lines go first from L2 (policy), before the Z partials and C.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float4* raw, const float* __restrict__ Y, int n, int m,
                                           int m_pad, int row0, unsigned long long policy) {
  const int words = m_pad / 4, pitch = raw_pitch(m_pad);
  if (VEC) {
    for (int e = threadIdx.x; e < BN * words; e += THREADS) {
      const int r = e / words, w = e % words;
      const bool ok = row0 + r < n && w * 4 < m;
      cpasync::copy16_hint(reinterpret_cast<float*>(raw + r * pitch + w),
                           ok ? Y + (size_t)(row0 + r) * m + w * 4 : Y, ok, policy);
    }
  } else {
    float* rt = reinterpret_cast<float*>(raw);
    for (int e = threadIdx.x; e < BN * m_pad; e += THREADS) {
      const int r = e / m_pad, c = e % m_pad;
      const bool ok = row0 + r < n && c < m;
      cpasync::copy4_hint(rt + r * pitch * 4 + c, ok ? Y + (size_t)(row0 + r) * m + c : Y, ok,
                          policy);
    }
  }
  cpasync::commit();
}

// The raw tile into Y^T: lane r takes row r, warp w the words w, w + 8, ...
__device__ __forceinline__ void transpose_tile(float* ys, const float4* raw, int m_pad) {
  const int r = threadIdx.x & 31;
  const int words = m_pad / 4, pitch = raw_pitch(m_pad);
  for (int w = threadIdx.x >> 5; w < words; w += THREADS / 32) {
    const float4 v = raw[r * pitch + w];
    ys[(4 * w) * PAD + r] = v.x;
    ys[(4 * w + 1) * PAD + r] = v.y;
    ys[(4 * w + 2) * PAD + r] = v.z;
    ys[(4 * w + 3) * PAD + r] = v.w;
  }
}

template <bool L1, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
assign_kernel(const float* __restrict__ Y, const float* __restrict__ C, float* __restrict__ Zp,
              float* __restrict__ gp, float* __restrict__ costp, int* __restrict__ labels, int n,
              int m, int k, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, MK);
  float* ys = smem;                          // [m_pad][PAD]  Y^T tile
  float* cs = ys + (size_t)m_pad * PAD;      // the epilogue's C buffers, or the raw tile
  float4* raw = reinterpret_cast<float4*>(cs);  // [BN][pitch]  rows of Y
  const lloyd::EpilogueSmem es = lloyd::carve(cs + shared_floats(m_pad), cs);

  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  const unsigned long long policy = cpasync::evict_first_policy();
  if (tile_lo < tile_hi) stage_tile<VEC>(raw, Y, n, m, m_pad, tile_lo * BN, policy);
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_counts(gpc, k);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    cpasync::wait<0>();
    __syncthreads();  // the tile's rows landed; the previous epilogue is done with ys
    transpose_tile(ys, raw, m_pad);
    // The epilogue's first barrier ends the reads of the raw tile; the next
    // tile's copies go into the same space once its C reads are done.
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, min(BN, n - row0),
                                  tile == tile_lo, es, labels, zp,
                                  gpc, cost_acc, [&] {
      if (tile + 1 < tile_hi) stage_tile<VEC>(raw, Y, n, m, m_pad, row0 + BN, policy);
    });
  }
  if (threadIdx.x == 0) costp[blockIdx.x] = cost_acc;
}

// assign_wide_kernel for any m: the first port's 64-row kernel, Y streamed
// through shared memory in 64 x 32 sub-tiles, once per centroid chunk, so
// only the sub-tiles, the C sub-chunk and the counts are resident. |y|^2 and
// y.c accumulate over the columns in ascending order.
namespace wide {
constexpr int BN = 64;   // rows per tile
constexpr int KC = 64;   // centroids per chunk
constexpr int PAD = 68;  // pitch of the transposed tiles, in floats

size_t smem_bytes(int k) {
  return sizeof(float) * (2 * (size_t)MK * PAD + 2 * BN + KC) + sizeof(int) * ((size_t)BN + k);
}

template <bool L1>
__global__ void __launch_bounds__(THREADS)
assign_wide_kernel(const float* __restrict__ Y, const float* __restrict__ C,
                   float* __restrict__ Zp, float* __restrict__ gp, float* __restrict__ costp,
                   int* __restrict__ labels, int n, int m, int k, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = (m + MK - 1) / MK * MK;
  float* ys = smem;                       // [MK][PAD]  Y^T sub-tile
  float* cs = ys + MK * PAD;              // [MK][PAD]  C^T sub-chunk
  float* yy_s = cs + MK * PAD;            // [BN]
  float* cc_s = yy_s + BN;                // [KC]
  float* mind_s = cc_s + KC;              // [BN]  per-row min distance, block_cost's units
  int* lab_s = reinterpret_cast<int*>(mind_s + BN);  // [BN]
  int* cnt_s = lab_s + BN;                // [k]

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float cost_acc = 0.0f;

  for (int c = t; c < m; c += THREADS)
    for (int j = 0; j < k; ++j) zp[(size_t)j * m + c] = 0.0f;
  for (int j = t; j < k; j += THREADS) cnt_s[j] = 0;

  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    const int rows = min(BN, n - row0);
    float best_d[4];
    int best_j[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { best_d[i] = INFINITY; best_j[i] = 0; }
    float yn = 0.0f;  // t < BN: |y_t|^2, built during the first centroid chunk

    for (int j0 = 0; j0 < k; j0 += KC) {
      float acc[4][4] = {};
      float cn = 0.0f;  // t < KC: |c_{j0 + t}|^2
      for (int c0 = 0; c0 < m_pad; c0 += MK) {
        __syncthreads();  // earlier readers of ys, cs, cc_s and lab_s are done
        for (int e = t; e < BN * MK; e += THREADS) {
          const int r = e / MK, c = e % MK;
          const int gc = c0 + c;
          ys[c * PAD + r] = (r < rows && gc < m) ? Y[(size_t)(row0 + r) * m + gc] : 0.0f;
        }
        for (int e = t; e < KC * MK; e += THREADS) {
          const int j = e / MK, c = e % MK;
          const int gj = j0 + j, gc = c0 + c;
          cs[c * PAD + j] = (gj < k && gc < m) ? C[(size_t)gj * m + gc] : 0.0f;
        }
        __syncthreads();
        if (!L1 && j0 == 0 && t < BN) {
          for (int c = 0; c < MK; ++c) { const float v = ys[c * PAD + t]; yn = fmaf(v, v, yn); }
        }
        if (!L1 && t < KC) {
          for (int c = 0; c < MK; ++c) { const float v = cs[c * PAD + t]; cn = fmaf(v, v, cn); }
        }
#pragma unroll 8
        for (int c = 0; c < MK; ++c) {
          tilemath::dist_4x4<L1>(acc, *reinterpret_cast<const float4*>(ys + c * PAD + ty * 4),
                                 *reinterpret_cast<const float4*>(cs + c * PAD + tx * 4));
        }
      }
      if (!L1 && j0 == 0 && t < BN) yy_s[t] = yn;
      if (!L1 && t < KC) cc_s[t] = cn;
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx * 4 + jj;
        if (j >= k) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dist = L1 ? acc[i][jj]
                                : fmaxf(yy_s[ty * 4 + i] - 2.0f * acc[i][jj] + cc_s[tx * 4 + jj], 0.0f);
          if (dist < best_d[i]) { best_d[i] = dist; best_j[i] = j; }
        }
      }
    }

    // The 16 threads of one row sit in one half-warp: combine lexicographically.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dv = best_d[i];
      int jv = best_j[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, dv, off);
        const int oj = __shfl_xor_sync(0xffffffffu, jv, off);
        if (od < dv || (od == dv && oj < jv)) { dv = od; jv = oj; }
      }
      if (tx == 0) {
        lab_s[ty * 4 + i] = jv;
        mind_s[ty * 4 + i] = L1 ? dv : sqrtf(dv);
      }
    }
    __syncthreads();

    if (t < rows) {
      labels[row0 + t] = lab_s[t];
      atomicAdd(&cnt_s[lab_s[t]], 1);  // integer counts: exact in any order
    }
    if (t == 0)
      for (int r = 0; r < rows; ++r) cost_acc += mind_s[r];
    for (int c = t; c < m; c += THREADS) {
      float* zc = zp + c;
      for (int r = 0; r < rows; ++r) zc[(size_t)lab_s[r] * m] += Y[(size_t)(row0 + r) * m + c];
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += THREADS) gp[(size_t)blockIdx.x * k + j] = (float)cnt_s[j];
  if (t == 0) costp[blockIdx.x] = cost_acc;
}
}  // namespace wide

// The kernel a launch at width m takes, its dynamic shared memory, and its
// attributes set: the shared memory and, for the tiled kernel, the largest
// carveout, so two CTAs share an SM where their shared memory fits.
template <bool L1>
cudaError_t prepare(int m, int k, bool vec, void (**kernel)(const float*, const float*, float*,
                                                            float*, float*, int*, int, int, int,
                                                            int),
                    size_t* smem) {
  cudaError_t err;
  if (m > MAX_M) {
    *kernel = wide::assign_wide_kernel<L1>;
    *smem = wide::smem_bytes(k);
  } else {
    *kernel = vec ? assign_kernel<L1, true> : assign_kernel<L1, false>;
    *smem = tiled_smem_bytes(m);
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool L1>
cudaError_t launch_assign(const float* Y, const float* C, float* Zp, float* gp, float* costp,
                          int* labels, int n, int m, int k, int num_ctas, int tiles_per_cta,
                          cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, float*, float*, int*, int, int, int, int);
  size_t smem;
  const bool vec = m % 4 == 0 && ((size_t)Y & 15) == 0;
  cudaError_t err = prepare<L1>(m, k, vec, &kernel, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_ctas, THREADS, smem, stream>>>(Y, C, Zp, gp, costp, labels, n, m, k,
                                              tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m the tiled kernel takes; wider m goes to assign_wide_kernel.
int apnc_assign_max_m() { return MAX_M; }

// Rows per tile of the tiled (streamed = 0) and wide (streamed = 1)
// kernels; the wrapper sizes the P partials from it.
int apnc_assign_tile_rows(int streamed) { return streamed ? wide::BN : BN; }

// Dynamic shared memory of one CTA of the launch at width m, in bytes.
long long apnc_assign_smem_bytes(int m, int k) {
  return (long long)(m > MAX_M ? wide::smem_bytes(k) : tiled_smem_bytes(m));
}

// CTAs of the l2 launch at width m that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error code.
int apnc_assign_ctas_per_sm(int m, int k) {
  void (*kernel)(const float*, const float*, float*, float*, float*, int*, int, int, int, int);
  size_t smem;
  cudaError_t err = prepare<false>(m, k, true, &kernel, &smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Y (n, m) f32, C (k, m) f32 -> Z (k, m), g (k,), cost (1,) f32, labels (n,)
// int32. Zp (num_ctas, k, m), gp (num_ctas, k) and costp (num_ctas,) are
// scratch; CTA p covers tiles [p * tiles_per_cta, (p + 1) * tiles_per_cta)
// of apnc_assign_tile_rows(m > apnc_assign_max_m()) rows. Returns the CUDA
// error code of the launches.
int apnc_assign_f32(const float* Y, const float* C, float* Z, float* g, float* cost, int* labels,
                    float* Zp, float* gp, float* costp, int n, int m, int k, int l1, int num_ctas,
                    int tiles_per_cta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      l1 ? launch_assign<true>(Y, C, Zp, gp, costp, labels, n, m, k, num_ctas, tiles_per_cta, s)
         : launch_assign<false>(Y, C, Zp, gp, costp, labels, n, m, k, num_ctas, tiles_per_cta, s);
  if (err != cudaSuccess) return (int)err;
  return (int)lloyd::launch_reduce(Zp, gp, costp, Z, g, cost, num_ctas, k, m, s);
}

}  // extern "C"
