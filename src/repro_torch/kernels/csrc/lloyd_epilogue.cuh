// The epilogue shared by the fused Lloyd-step kernels (lloyd_step.cu):
// distances -> argmin -> per-CTA (Z, g, cost) partials, then a fixed-order
// reduction of the partials.
//
// Replaces the shared epilogue of the Pallas TPU kernels,
// src/repro/kernels/lloyd_step.py::_assign_reduce.
//
// A CTA holds one 64-row tile of Y in shared memory, transposed, as
// ys[c * PAD + r] for column c < m_pad and row r < BN. The epilogue follows
// csrc/apnc_assign.cu step for step, so for the same Y tile it gives the same
// labels bit for bit:
//  * centroids stream through shared memory in chunks of KC = 64 and
//    sub-chunks of MK = 32 columns; l2 compares yy - 2 y.c + cc clamped at 0,
//    l1 sums |y - c|; ties go to the lowest index (strict < in increasing
//    order, then a lexicographic (distance, index) shuffle);
//  * each column of the CTA's (k, m) Z partial, each centroid's count and the
//    CTA's cost are owned by one thread, which adds the tile's rows in row
//    order; lloyd_reduce_kernel sums the P partials in the order p = 0..P-1.
//    No float atomics: Z, g and cost are bitwise identical run to run;
//  * rows >= n (the ragged last tile) are computed on zeros and masked out
//    of labels, (Z, g) and cost;
//  * the cost is block_cost's: the sum over rows of sqrt(min d^2) for l2,
//    of min d for l1.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tile_math.cuh"

namespace lloyd {

constexpr int BN = 64;        // rows per tile
constexpr int KC = 64;        // centroids per chunk
constexpr int MK = 32;        // embedding columns per centroid sub-chunk
constexpr int PAD = 68;       // pitch of the transposed tiles, in floats (keeps float4 alignment)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 rows x 4 outputs each
constexpr int REDUCE_THREADS = 256;

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// Shared-memory scratch of the epilogue, apart from the Y tile.
struct EpilogueSmem {
  float* cs;      // [MK][PAD]  C^T sub-chunk
  float* yy_s;    // [BN]       row norms
  float* cc_s;    // [KC]       centroid norms
  float* mind_s;  // [BN]       per-row min distance, in block_cost's units
  int* lab_s;     // [BN]       per-row label
};

// Zero the CTA's partials: thread t owns Z columns c = t (mod THREADS) and
// centroid counts j = t (mod THREADS), here and in every later update.
__device__ __forceinline__ void zero_partials(float* zp, float* gp, int k, int m) {
  const int t = threadIdx.x;
  for (int c = t; c < m; c += THREADS)
    for (int j = 0; j < k; ++j) zp[(size_t)j * m + c] = 0.0f;
  for (int j = t; j < k; j += THREADS) gp[j] = 0.0f;
}

// One tile: labels of rows [row0, row0 + rows), their (Z, g) added to the
// CTA's partials zp (k, m) and gp (k,), and (thread 0) their cost added to
// cost_acc. ys must be complete; the caller syncs before overwriting it.
template <bool L1>
__device__ void assign_reduce_tile(const float* ys, int m_pad, const float* __restrict__ C,
                                   int k, int m, int row0, int rows, const EpilogueSmem& s,
                                   int* __restrict__ labels, float* __restrict__ zp,
                                   float* __restrict__ gp, float& cost_acc) {
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  __syncthreads();  // ys complete
  if (!L1 && t < BN) {
    float v2 = 0.0f;
    for (int c = 0; c < m_pad; ++c) { const float v = ys[c * PAD + t]; v2 = fmaf(v, v, v2); }
    s.yy_s[t] = v2;
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
        s.cs[c * PAD + j] = (gj < k && gc < m) ? C[(size_t)gj * m + gc] : 0.0f;
      }
      __syncthreads();
      if (!L1 && t < KC) {
        for (int c = 0; c < MK; ++c) { const float v = s.cs[c * PAD + t]; cn = fmaf(v, v, cn); }
      }
#pragma unroll 8
      for (int c = 0; c < MK; ++c) {
        tilemath::dist_4x4<L1>(acc, *reinterpret_cast<const float4*>(ys + (c0 + c) * PAD + ty * 4),
                               *reinterpret_cast<const float4*>(s.cs + c * PAD + tx * 4));
      }
    }
    if (!L1 && t < KC) s.cc_s[t] = cn;
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx * 4 + jj;
      if (j >= k) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dist = L1 ? acc[i][jj]
                              : fmaxf(s.yy_s[ty * 4 + i] - 2.0f * acc[i][jj] + s.cc_s[tx * 4 + jj], 0.0f);
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
      s.lab_s[ty * 4 + i] = jv;
      s.mind_s[ty * 4 + i] = L1 ? dv : sqrtf(dv);
    }
  }
  __syncthreads();

  if (t < rows) labels[row0 + t] = s.lab_s[t];
  for (int c = t; c < m; c += THREADS) {
    float* zc = zp + c;
    for (int r = 0; r < rows; ++r) zc[(size_t)s.lab_s[r] * m] += ys[c * PAD + r];
  }
  for (int j = t; j < k; j += THREADS) {
    int cnt = 0;
    for (int r = 0; r < rows; ++r) cnt += (s.lab_s[r] == j);
    gp[j] += (float)cnt;
  }
  if (t == 0)
    for (int r = 0; r < rows; ++r) cost_acc += s.mind_s[r];
}

// Z = sum_p Zp[p], g = sum_p gp[p], cost = sum_p costp[p], each element
// summed in the order p = 0..P-1.
__global__ void lloyd_reduce_kernel(const float* __restrict__ Zp, const float* __restrict__ gp,
                                    const float* __restrict__ costp, float* __restrict__ Z,
                                    float* __restrict__ g, float* __restrict__ cost, int P, int k,
                                    int m) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t km = (size_t)k * m;
  float acc = 0.0f;
  if (e < km) {
    for (int p = 0; p < P; ++p) acc += Zp[(size_t)p * km + e];
    Z[e] = acc;
  } else if (e < km + k) {
    const size_t j = e - km;
    for (int p = 0; p < P; ++p) acc += gp[(size_t)p * k + j];
    g[j] = acc;
  } else if (e == km + k) {
    for (int p = 0; p < P; ++p) acc += costp[p];
    *cost = acc;
  }
}

inline cudaError_t launch_reduce(const float* Zp, const float* gp, const float* costp, float* Z,
                                 float* g, float* cost, int P, int k, int m, cudaStream_t stream) {
  const size_t total = (size_t)k * m + k + 1;
  const unsigned blocks = (unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  lloyd_reduce_kernel<<<blocks, REDUCE_THREADS, 0, stream>>>(Zp, gp, costp, Z, g, cost, P, k, m);
  return cudaGetLastError();
}

}  // namespace lloyd
