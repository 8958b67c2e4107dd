// The epilogue shared by the fused Lloyd-step kernels (lloyd_step.cu,
// dequant_step.cu) and the assign kernel (apnc_assign.cu): distances ->
// argmin -> per-CTA (Z, g, cost) partials, then a fixed-order reduction of
// the partials. Four kernels that hand it the same Y tiles under the same
// launch geometry give the same (Z, g, labels, cost) bit for bit.
//
// Replaces the shared epilogue of the Pallas TPU kernels,
// src/repro/kernels/lloyd_step.py::_assign_reduce, and the body of
// src/repro/kernels/apnc_assign.py::_assign_kernel.
//
// A CTA holds one tile of BN = 32 rows of Y in shared memory, transposed, as
// ys[c * PAD + r] for column c < m_pad (zero for c >= m) and row r < 32, at
// pitch PAD = 36. Its labels are bit for bit those of the first port's assign
// kernel, which apnc_assign.cu's assign_wide_kernel still runs for m > 832:
//  * centroids go in chunks of KC = 256 and sub-chunks of MK = 32 columns,
//    each distance one chain over the columns in ascending order; l2
//    compares yy - 2 y.c + cc clamped at 0, l1 sums |y - c|; ties go to the
//    lowest index (strict < in increasing order, then a lexicographic
//    (distance, index) combine), whatever the split of the centroids over
//    the threads.
//  * a thread owns 8 rows x 4 centroids (32 FMAs for 3 float4 reads from
//    shared memory): warp w takes rows 8 (w / 2) .. + 7 and centroids
//    lane + 32 (w % 2 + 2 q), q < 4, so its Y reads are broadcasts and its C
//    reads 32 rows in distinct banks (pitch CP = 36: 9 16-byte words, odd).
//  * a chunk's groups of 32 centroids at or past k are skipped, warp by
//    warp: the two halves of the row groups take alternate groups, so at
//    k = 164 every warp runs 3 of its 4 (192 of 256 centroids' FMAs) and the
//    last chunk of any k pads to a multiple of 64, not of 256.
//  * C sub-chunks come in their natural (centroid, column) layout by cp.async
//    into two buffers: sub-chunk s + 1 is in flight while s is in use, one
//    barrier a sub-chunk. Once the last is read, the caller's after_c() runs
//    on every thread, so a kernel may refill the buffers' space while the
//    rest of the epilogue runs.
//  * every norm is one chain in ascending order, and none holds the CTA up:
//    thread t sums centroid t of the chunk, threads t < 32 also row t of the
//    tile in the first chunk, one sub-chunk at a time beside the FMAs. Where
//    k fits one chunk, the centroid norms of a CTA's first tile stay in
//    shared memory for its later tiles (C does not change within a launch).
//  * (Z, g): one lane a row groups the tile's rows by label (match.any), so
//    each distinct label of the tile is one group of rows in row order. Each
//    (label, column) element of the CTA's (k, m) Z partial is owned by one
//    thread, which loads it once (or starts from 0.0f if the CTA has not met
//    the label yet), adds the group's rows in row order and stores it once:
//    the bits of a read-modify-write per row, one store per group, the loads
//    of ZB = 8 groups in flight together. The group's leader adds its size
//    to the label's count. Rows of labels the CTA never met are never
//    written; lloyd_reduce_kernel skips them (their
//    count partial is 0, and adding +0.0 to a sum that starts at +0.0 never
//    changes it), so no CTA zeroes its Z partial;
//  * lloyd_reduce_kernel sums the P partials in the order p = 0..P-1. No
//    float atomics: Z, g and cost are bitwise identical run to run;
//  * rows >= n (the ragged last tile) are computed on zeros and masked out
//    of labels, (Z, g) and cost;
//  * the cost is block_cost's: the sum over rows, in row order, of
//    sqrt(min d^2) for l2, of min d for l1.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "cp_async.cuh"

namespace lloyd {

constexpr int BN = 32;        // rows per tile: one lane a row in the grouping
constexpr int PAD = BN + 4;   // pitch of the Y^T tile (float4 reads stay aligned)
constexpr int THREADS = 256;  // 4 row groups x 2 centroid halves, a warp each
constexpr int RI = 8;         // rows a thread
constexpr int KC = 256;       // centroids per chunk: thread t sums centroid t's norm
constexpr int MK = 32;        // embedding columns per C sub-chunk
constexpr int CP = MK + 4;    // pitch of a C sub-chunk (9 16-byte words: odd)
constexpr int CBUF = KC * CP;  // floats in one C sub-chunk buffer
constexpr int ZB = 8;         // Z partial loads in flight a thread
constexpr int REDUCE_THREADS = 256;
static_assert(BN == 32 && KC == THREADS && (THREADS / 32) * RI == 2 * BN, "the thread tiling");

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// Shared memory of the epilogue, apart from the Y tile: the two C buffers
// (2 CBUF floats, 16-byte aligned) and SCRATCH 4-byte words.
struct EpilogueSmem {
  float* cs;           // 2 x [KC][CP] C sub-chunks
  float* yy_s;         // [BN]         row norms
  float* cc_s;         // [KC]         centroid norms
  float* cand_d;       // [2][BN]      each half's best distance a row
  int* cand_j;         // [2][BN]      and its centroid
  float* mind_s;       // [BN]         per-row min distance, in block_cost's units
  int* grp_lab;        // [BN]         label of each group of the tile
  unsigned* grp_rows;  // [BN]         its rows, a bit mask
  int* grp_fresh;      // [BN]         1 if the CTA meets its label for the first time
  int* n_grp;          // [1]          number of groups
};
constexpr int SCRATCH = 9 * BN + KC + 1;

__device__ __forceinline__ EpilogueSmem carve(float* scratch, float* cs) {
  EpilogueSmem s;
  s.cs = cs;
  s.yy_s = scratch;
  s.cc_s = s.yy_s + BN;
  s.cand_d = s.cc_s + KC;
  s.cand_j = reinterpret_cast<int*>(s.cand_d + 2 * BN);
  s.mind_s = reinterpret_cast<float*>(s.cand_j + 2 * BN);
  s.grp_lab = reinterpret_cast<int*>(s.mind_s + BN);
  s.grp_rows = reinterpret_cast<unsigned*>(s.grp_lab + BN);
  s.grp_fresh = reinterpret_cast<int*>(s.grp_rows + BN);
  s.n_grp = s.grp_fresh + BN;
  return s;
}

// Zero the CTA's count partial (its Z partial needs no zeroing).
__device__ __forceinline__ void zero_counts(float* gp, int k) {
  for (int j = threadIdx.x; j < k; j += THREADS) gp[j] = 0.0f;
}

// C rows [j0, j0 + KC) x columns [c0, c0 + MK) into buf (pitch CP) by
// cp.async, one group; zero outside C. 16-byte copies when the rows are whole
// aligned words (vec), else 4-byte ones.
__device__ __forceinline__ void issue_c(float* buf, const float* __restrict__ C, int k, int m,
                                        int j0, int c0, bool vec) {
  if (vec) {
    for (unsigned e = threadIdx.x; e < KC * MK / 4; e += THREADS) {
      const int j = (int)(e / (MK / 4)), c = (int)(e % (MK / 4)) * 4;
      const bool ok = j0 + j < k && c0 + c < m;
      cpasync::copy16(buf + j * CP + c, ok ? C + (size_t)(j0 + j) * m + c0 + c : C, ok);
    }
  } else {
    for (unsigned e = threadIdx.x; e < KC * MK; e += THREADS) {
      const int j = (int)(e / MK), c = (int)(e % MK);
      const bool ok = j0 + j < k && c0 + c < m;
      cpasync::copy4(buf + j * CP + c, ok ? C + (size_t)(j0 + j) * m + c0 + c : C, ok);
    }
  }
  cpasync::commit();
}

// acc[i][q] over four columns, for the centroids q < NQ: a[cc] holds rows i
// of column cc (two float4), b[q] centroid q's four columns.
template <bool L1, int NQ>
__device__ __forceinline__ void dist_8x4(float (&acc)[RI][4], const float4 (&a)[8],
                                         const float4 (&b)[NQ]) {
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float av[RI] = {a[2 * cc].x, a[2 * cc].y, a[2 * cc].z, a[2 * cc].w,
                          a[2 * cc + 1].x, a[2 * cc + 1].y, a[2 * cc + 1].z, a[2 * cc + 1].w};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float bv = cc == 0 ? b[q].x : cc == 1 ? b[q].y : cc == 2 ? b[q].z : b[q].w;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        if (L1) acc[i][q] += fabsf(av[i] - bv);
        else acc[i][q] = fmaf(av[i], bv, acc[i][q]);
      }
    }
  }
}

// The distance FMAs of one C sub-chunk cb (columns c0 .. c0 + MK of the
// tile) for the thread's RI rows and its first NQ centroids: NQ is a
// template argument, so every loop is unrolled and every index static.
template <bool L1, int NQ>
__device__ __forceinline__ void sub_chunk(float (&acc)[RI][4], const float* ys, const float* cb,
                                          int c0, int lane, int half, int ty) {
#pragma unroll 2
  for (int c = 0; c < MK; c += 4) {
    float4 b[NQ], a[8];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      b[q] = *reinterpret_cast<const float4*>(cb + (lane + 32 * (half + 2 * q)) * CP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      a[2 * cc] = *reinterpret_cast<const float4*>(ys + (c0 + c + cc) * PAD + RI * ty);
      a[2 * cc + 1] = *reinterpret_cast<const float4*>(ys + (c0 + c + cc) * PAD + RI * ty + 4);
    }
    dist_8x4<L1, NQ>(acc, a, b);
  }
}

// One tile: labels of rows [row0, row0 + rows), their (Z, g) added to the
// CTA's partials zp (k, m) and gp (k,), and (thread 0) their cost added to
// cost_acc; `first`: the CTA's first tile. The caller has written ys and
// has no cp.async copy in flight (its waits here would wait for it too); the
// first barrier here makes ys complete and frees the C buffers. after_c()
// runs on every thread once no thread reads the C buffers any more. The
// caller syncs before overwriting ys or the scratch (cc_s outlives a tile).
template <bool L1, class AfterC>
__device__ void assign_reduce_tile(const float* ys, int m_pad, const float* __restrict__ C,
                                   int k, int m, int row0, int rows, bool first,
                                   const EpilogueSmem& s,
                                   int* __restrict__ labels, float* __restrict__ zp,
                                   float* __restrict__ gp, float& cost_acc, AfterC after_c) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ty = warp >> 1, half = warp & 1;  // rows RI ty + i; centroids lane + 32 (half + 2 q)
  const bool vec = (m & 3) == 0 && ((size_t)C & 15) == 0;
  const bool cc_kept = !first && k <= KC;  // cc_s holds the first tile's centroid norms
  __syncthreads();  // ys complete; every thread is done with the C buffers' earlier use
  issue_c(s.cs, C, k, m, 0, 0, vec);

  float best_d[RI];
  int best_j[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) { best_d[i] = INFINITY; best_j[i] = 0; }

  float yn = 0.0f;  // t < BN: |y_t|^2, over the first chunk
  int step = 0;
  for (int j0 = 0; j0 < k; j0 += KC) {
    float acc[RI][4] = {};
    float cn = 0.0f;  // |c_{j0 + t}|^2
    const int groups = (min(k - j0, KC) + 31) / 32;  // groups of 32 centroids in the chunk
    const int nq = (groups - half + 1) / 2;          // this warp's: half, half + 2, ...
    for (int c0 = 0; c0 < m_pad; c0 += MK, ++step) {
      cpasync::wait<0>();
      __syncthreads();  // sub-chunk `step` landed; every thread is done with the other buffer
      if (c0 + MK < m_pad) issue_c(s.cs + ((step + 1) & 1) * CBUF, C, k, m, j0, c0 + MK, vec);
      else if (j0 + KC < k) issue_c(s.cs + ((step + 1) & 1) * CBUF, C, k, m, j0 + KC, 0, vec);
      const float* cb = s.cs + (step & 1) * CBUF;
      if (!L1) {
        if (!cc_kept) {
#pragma unroll
          for (int c = 0; c < MK; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(cb + t * CP + c);
            cn = fmaf(v.x, v.x, cn);
            cn = fmaf(v.y, v.y, cn);
            cn = fmaf(v.z, v.z, cn);
            cn = fmaf(v.w, v.w, cn);
          }
        }
        if (j0 == 0 && t < BN) {
#pragma unroll
          for (int c = 0; c < MK; ++c) {
            const float v = ys[(c0 + c) * PAD + t];
            yn = fmaf(v, v, yn);
          }
        }
      }
      switch (nq) {  // warp-uniform
        case 4: sub_chunk<L1, 4>(acc, ys, cb, c0, lane, half, ty); break;
        case 3: sub_chunk<L1, 3>(acc, ys, cb, c0, lane, half, ty); break;
        case 2: sub_chunk<L1, 2>(acc, ys, cb, c0, lane, half, ty); break;
        case 1: sub_chunk<L1, 1>(acc, ys, cb, c0, lane, half, ty); break;
        default: break;  // none of this warp's groups is below k
      }
    }
    if (!L1 && !cc_kept) s.cc_s[t] = cn;
    if (!L1 && j0 == 0 && t < BN) s.yy_s[t] = yn;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jl = lane + 32 * (half + 2 * q);
      if (j0 + jl >= k) continue;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float dist = L1 ? acc[i][q]
                              : fmaxf(s.yy_s[RI * ty + i] - 2.0f * acc[i][q] + s.cc_s[jl], 0.0f);
        if (dist < best_d[i]) { best_d[i] = dist; best_j[i] = j0 + jl; }
      }
    }
  }
  after_c();  // every thread is past the barrier after the last C read

  // Combine lexicographically: the 32 lanes of a warp, then the two halves.
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float dv = best_d[i];
    int jv = best_j[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, dv, off);
      const int oj = __shfl_xor_sync(0xffffffffu, jv, off);
      if (od < dv || (od == dv && oj < jv)) { dv = od; jv = oj; }
    }
    if (lane == 0) {
      s.cand_d[half * BN + RI * ty + i] = dv;
      s.cand_j[half * BN + RI * ty + i] = jv;
    }
  }
  __syncthreads();

  // Lane r takes row r: its label, then the groups of rows by label, the
  // lowest lane of each label leading its group.
  if (t < BN) {
    float dv = s.cand_d[t];
    int lab = s.cand_j[t];
    const float od = s.cand_d[BN + t];
    const int oj = s.cand_j[BN + t];
    if (od < dv || (od == dv && oj < lab)) { dv = od; lab = oj; }
    s.mind_s[t] = L1 ? dv : sqrtf(dv);
    if (t < rows) labels[row0 + t] = lab;
    else lab = -1;
    const unsigned same = __match_any_sync(0xffffffffu, lab);
    const unsigned below = (1u << t) - 1u;
    const bool lead = lab >= 0 && (same & below) == 0u;
    const unsigned leads = __ballot_sync(0xffffffffu, lead);
    if (lead) {
      const int gi = __popc(leads & below);
      const float seen = gp[lab];
      s.grp_lab[gi] = lab;
      s.grp_rows[gi] = same;
      s.grp_fresh[gi] = seen == 0.0f;
      gp[lab] = seen + (float)__popc(same);
    }
    if (t == 0) *s.n_grp = __popc(leads);
  }
  __syncthreads();

  // Z: thread t owns columns c = t (mod THREADS); one load and one store a
  // group. The loads of ZB groups go out together (their labels differ, so
  // their elements do), then each group adds its rows in row order.
  const int ng = *s.n_grp;
  for (int c = t; c < m; c += THREADS) {
    const float* yc = ys + c * PAD;
    for (int g0 = 0; g0 < ng; g0 += ZB) {
      float v[ZB];
#pragma unroll
      for (int u = 0; u < ZB; ++u)
        if (g0 + u < ng) v[u] = s.grp_fresh[g0 + u] ? 0.0f : zp[(size_t)s.grp_lab[g0 + u] * m + c];
#pragma unroll
      for (int u = 0; u < ZB; ++u) {
        if (g0 + u >= ng) break;
        for (unsigned rs = s.grp_rows[g0 + u]; rs; rs &= rs - 1u) v[u] += yc[__ffs(rs) - 1];
        zp[(size_t)s.grp_lab[g0 + u] * m + c] = v[u];
      }
    }
  }
  if (t == 0)
    for (int r = 0; r < rows; ++r) cost_acc += s.mind_s[r];
}

// Z = sum_p Zp[p], g = sum_p gp[p], cost = sum_p costp[p], each element
// summed in the order p = 0..P-1: block j < k sums row j of Z and g[j],
// block k the cost. Row j of Zp[p] holds data only where gp[p][j] > 0 and
// is skipped elsewhere: the block lists those p in ascending order first, so
// every thread's loads of its column are independent of each other.
constexpr int MAX_P = 264;  // partials one reduce takes (the wrapper's MAX_CTAS)

__global__ void __launch_bounds__(REDUCE_THREADS)
lloyd_reduce_kernel(const float* __restrict__ Zp, const float* __restrict__ gp,
                    const float* __restrict__ costp, float* __restrict__ Z,
                    float* __restrict__ g, float* __restrict__ cost, int P, int k, int m) {
  __shared__ float part[MAX_P];  // gp[p][j], or costp[p]
  __shared__ int met[MAX_P];     // the p with gp[p][j] > 0, ascending
  __shared__ unsigned masks[(MAX_P + 31) / 32];
  const int t = threadIdx.x, j = blockIdx.x;
  if (j == k) {
    for (int p = t; p < P; p += REDUCE_THREADS) part[p] = costp[p];
    __syncthreads();
    if (t == 0) {
      float acc = 0.0f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) acc += part[p];
      *cost = acc;
    }
    return;
  }
  for (int base = (t >> 5) * 32; base < P; base += REDUCE_THREADS) {  // a warp a 32-p group
    const int p = base + (t & 31);
    const float v = p < P ? gp[(size_t)p * k + j] : 0.0f;
    if (p < P) part[p] = v;
    const unsigned mask = __ballot_sync(0xffffffffu, v != 0.0f);
    if ((t & 31) == 0) masks[base >> 5] = mask;
  }
  __syncthreads();
  int n_met = 0;
  for (int q = 0; q < (P + 31) / 32; ++q) n_met += __popc(masks[q]);
  for (int p = t; p < P; p += REDUCE_THREADS) {
    const unsigned mask = masks[p >> 5], below = (1u << (p & 31)) - 1u;
    if (mask >> (p & 31) & 1u) {
      int at = __popc(mask & below);
      for (int q = 0; q < (p >> 5); ++q) at += __popc(masks[q]);
      met[at] = p;
    }
  }
  __syncthreads();
  if (t == 32) {  // beside warp 0's columns
    float acc = 0.0f;
#pragma unroll 16
    for (int p = 0; p < P; ++p) acc += part[p];
    g[j] = acc;
  }
  const size_t km = (size_t)k * m;
  for (int c = t; c < m; c += REDUCE_THREADS) {
    const float* src = Zp + (size_t)j * m + c;
    float acc = 0.0f;
    for (int i0 = 0; i0 < n_met; i0 += 8) {  // 8 loads in flight, then their sums in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = i0 + u < n_met ? src[(size_t)met[i0 + u] * km] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < n_met) acc += v[u];
    }
    Z[(size_t)j * m + c] = acc;
  }
}

inline cudaError_t launch_reduce(const float* Zp, const float* gp, const float* costp, float* Z,
                                 float* g, float* cost, int P, int k, int m, cudaStream_t stream) {
  if (P > MAX_P) return cudaErrorInvalidValue;
  lloyd_reduce_kernel<<<k + 1, REDUCE_THREADS, 0, stream>>>(Zp, gp, costp, Z, g, cost, P, k, m);
  return cudaGetLastError();
}

}  // namespace lloyd
