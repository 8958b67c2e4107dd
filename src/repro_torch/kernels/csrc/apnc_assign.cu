// Fused APNC assignment for Hopper (sm_90a): distances -> argmin -> (Z, g).
//
// Replaces: src/repro/kernels/apnc_assign.py::apnc_assign_padded
// (_assign_kernel, _distances), the Pallas TPU kernel.
//
// Bound on an H100 SXM: compute. One launch does 2*n*k*m f32 operations and
// moves (n*m + k*m + n + k*m + k)*4 bytes; at the main path's shape
// (n = 1,262,102, m = 256, k = 164) that is 1.06e11 FLOP against 1.30 GB,
// about 4x more operation-bound than byte-bound on 67 TFLOP/s f32 and
// 3.35 TB/s.
//
// Design, and what it does about the bound:
//  * A fixed number P of CTAs each own a contiguous range of 64-row tiles.
//    A tile of Y is read from device memory once, into shared memory, and
//    serves the distances, the argmin and the (Z, g) update.
//  * Distances are a 64 x 64 register-tiled f32 loop over centroid chunks of
//    64 (k need not fit in shared memory; padded centroids are masked, there
//    are no sentinel rows). l2 compares squared distances
//    yy - 2 y.c + cc clamped at 0, in the TPU kernel's order; l1 sums |y - c|.
//  * Above m = 768 the Y tile no longer fits in shared memory, and
//    assign_wide_kernel streams it instead: 64 rows x 32 columns of Y at a
//    time beside the matching C sub-chunk, read again for each centroid
//    chunk, and the (Z, g) update reads the tile's rows from device memory.
//    Its sums run in the same order, so it gives the labels the tiled kernel
//    would.
//  * Ties go to the lowest centroid index, as with argmin: a thread updates
//    only on strict <, visiting centroids in increasing order, and the
//    16 threads of a row combine (distance, index) lexicographically.
//  * The TPU kernel accumulates (Z, g) over a sequential grid. Here every CTA
//    keeps its own (k, m) partial of Z in device memory, each column owned by
//    one thread that adds the tile's rows in row order, and a second launch
//    sums the P partials in a fixed order. No float atomics, so Z and g are
//    bitwise identical from run to run. Counts are exact integers.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tile_math.cuh"

namespace {

constexpr int BN = 64;        // rows per tile
constexpr int KC = 64;        // centroids per chunk
constexpr int MK = 32;        // embedding columns per centroid sub-chunk
constexpr int PAD = 68;       // pitch of the transposed tiles, in floats
constexpr int THREADS = 256;  // 16 x 16 threads, 4 rows x 4 centroids each
constexpr int REDUCE_THREADS = 256;

template <bool L1>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ Y, const float* __restrict__ C, float* __restrict__ Zp,
              float* __restrict__ gp, int* __restrict__ labels, int n, int m, int k,
              int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = (m + MK - 1) / MK * MK;
  float* ys = smem;                       // [m_pad][PAD]  Y^T tile
  float* cs = ys + m_pad * PAD;           // [MK][PAD]     C^T sub-chunk
  float* yy_s = cs + MK * PAD;            // [BN]
  float* cc_s = yy_s + BN;                // [KC]
  int* lab_s = reinterpret_cast<int*>(cc_s + KC);  // [BN]
  int* cnt_s = lab_s + BN;                // [k]

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  float* zp = Zp + (size_t)blockIdx.x * k * m;

  // Each thread zeroes, and later alone updates, the columns it owns.
  for (int c = t; c < m; c += THREADS)
    for (int j = 0; j < k; ++j) zp[(size_t)j * m + c] = 0.0f;
  for (int j = t; j < k; j += THREADS) cnt_s[j] = 0;

  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    const int rows = min(BN, n - row0);
    __syncthreads();  // the previous tile's readers of ys and lab_s are done
    for (int e = t; e < BN * m_pad; e += THREADS) {
      const int r = e / m_pad, c = e % m_pad;
      ys[c * PAD + r] = (r < rows && c < m) ? Y[(size_t)(row0 + r) * m + c] : 0.0f;
    }
    __syncthreads();
    if (!L1 && t < BN) {
      float s = 0.0f;
      for (int c = 0; c < m_pad; ++c) { const float v = ys[c * PAD + t]; s = fmaf(v, v, s); }
      yy_s[t] = s;
    }

    float best_d[4];
    int best_j[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { best_d[i] = INFINITY; best_j[i] = 0; }

    for (int j0 = 0; j0 < k; j0 += KC) {
      float acc[4][4] = {};
      float cn = 0.0f;  // t < KC: |c_{j0 + t}|^2
      for (int c0 = 0; c0 < m_pad; c0 += MK) {
        __syncthreads();  // earlier readers of cs and cc_s are done; yy_s visible
        for (int e = t; e < KC * MK; e += THREADS) {
          const int j = e / MK, c = e % MK;
          const int gj = j0 + j, gc = c0 + c;
          cs[c * PAD + j] = (gj < k && gc < m) ? C[(size_t)gj * m + gc] : 0.0f;
        }
        __syncthreads();
        if (!L1 && t < KC) {
          for (int c = 0; c < MK; ++c) { const float v = cs[c * PAD + t]; cn = fmaf(v, v, cn); }
        }
#pragma unroll 8
        for (int c = 0; c < MK; ++c) {
          tilemath::dist_4x4<L1>(acc, *reinterpret_cast<const float4*>(ys + (c0 + c) * PAD + ty * 4),
                                 *reinterpret_cast<const float4*>(cs + c * PAD + tx * 4));
        }
      }
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
      if (tx == 0) lab_s[ty * 4 + i] = jv;
    }
    __syncthreads();

    if (t < rows) {
      labels[row0 + t] = lab_s[t];
      atomicAdd(&cnt_s[lab_s[t]], 1);  // integer counts: exact in any order
    }
    for (int c = t; c < m; c += THREADS) {
      float* zc = zp + c;
      for (int r = 0; r < rows; ++r) zc[(size_t)lab_s[r] * m] += ys[c * PAD + r];
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += THREADS) gp[(size_t)blockIdx.x * k + j] = (float)cnt_s[j];
}

// assign_kernel for any m: Y streams through shared memory in 64 x 32
// sub-tiles, once per centroid chunk, so only the sub-tiles, the C
// sub-chunk and the counts are resident. |y|^2 and y.c accumulate over the
// columns in the order assign_kernel takes them.
template <bool L1>
__global__ void __launch_bounds__(THREADS)
assign_wide_kernel(const float* __restrict__ Y, const float* __restrict__ C,
                   float* __restrict__ Zp, float* __restrict__ gp, int* __restrict__ labels, int n,
                   int m, int k, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = (m + MK - 1) / MK * MK;
  float* ys = smem;                       // [MK][PAD]  Y^T sub-tile
  float* cs = ys + MK * PAD;              // [MK][PAD]  C^T sub-chunk
  float* yy_s = cs + MK * PAD;            // [BN]
  float* cc_s = yy_s + BN;                // [KC]
  int* lab_s = reinterpret_cast<int*>(cc_s + KC);  // [BN]
  int* cnt_s = lab_s + BN;                // [k]

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  float* zp = Zp + (size_t)blockIdx.x * k * m;

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
      if (tx == 0) lab_s[ty * 4 + i] = jv;
    }
    __syncthreads();

    if (t < rows) {
      labels[row0 + t] = lab_s[t];
      atomicAdd(&cnt_s[lab_s[t]], 1);  // integer counts: exact in any order
    }
    for (int c = t; c < m; c += THREADS) {
      float* zc = zp + c;
      for (int r = 0; r < rows; ++r) zc[(size_t)lab_s[r] * m] += Y[(size_t)(row0 + r) * m + c];
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += THREADS) gp[(size_t)blockIdx.x * k + j] = (float)cnt_s[j];
}

// Z = sum_p Zp[p], g = sum_p gp[p], each element summed in the order p = 0..P-1.
__global__ void reduce_kernel(const float* __restrict__ Zp, const float* __restrict__ gp,
                              float* __restrict__ Z, float* __restrict__ g, int P, int k, int m) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t km = (size_t)k * m;
  if (e < km) {
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += Zp[(size_t)p * km + e];
    Z[e] = s;
  } else if (e < km + k) {
    const size_t j = e - km;
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += gp[(size_t)p * k + j];
    g[j] = s;
  }
}

constexpr int MAX_TILE_M = 768;  // widest m whose whole Y tile assign_kernel holds

size_t smem_bytes(int m, int k) {
  const int m_pad = (m > MAX_TILE_M) ? MK : (m + MK - 1) / MK * MK;  // wide: one sub-tile
  return sizeof(float) * ((size_t)m_pad * PAD + (size_t)MK * PAD + BN + KC) +
         sizeof(int) * ((size_t)BN + k);
}

template <bool L1>
cudaError_t launch_assign(const float* Y, const float* C, float* Zp, float* gp, int* labels, int n,
                          int m, int k, int num_ctas, int tiles_per_cta, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, k);
  auto kernel = (m > MAX_TILE_M) ? assign_wide_kernel<L1> : assign_kernel<L1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_ctas, THREADS, smem, stream>>>(Y, C, Zp, gp, labels, n, m, k, tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m whose Y tile assign_kernel holds whole in shared memory; wider m
// goes to assign_wide_kernel.
int apnc_assign_max_m() { return MAX_TILE_M; }

// Rows per tile; the wrapper sizes the P partials from it.
int apnc_assign_tile_rows() { return BN; }

// Dynamic shared memory of one CTA of the assign launch, in bytes.
long long apnc_assign_smem_bytes(int m, int k) { return (long long)smem_bytes(m, k); }

// Y (n, m) f32, C (k, m) f32 -> Z (k, m) f32, g (k,) f32, labels (n,) int32.
// Zp (num_ctas, k, m) and gp (num_ctas, k) are scratch. CTA p covers tiles
// [p * tiles_per_cta, (p + 1) * tiles_per_cta). Returns the CUDA error code.
int apnc_assign_f32(const float* Y, const float* C, float* Z, float* g, int* labels, float* Zp,
                    float* gp, int n, int m, int k, int l1, int num_ctas, int tiles_per_cta,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = l1 ? launch_assign<true>(Y, C, Zp, gp, labels, n, m, k, num_ctas, tiles_per_cta, s)
                       : launch_assign<false>(Y, C, Zp, gp, labels, n, m, k, num_ctas, tiles_per_cta, s);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)k * m + k;
  const unsigned blocks = (unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  reduce_kernel<<<blocks, REDUCE_THREADS, 0, s>>>(Zp, gp, Z, g, num_ctas, k, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
