// The APNC embed mainloop shared by apnc_embed.cu (apnc_embed_block) and
// lloyd_step.cu (fused_apnc_step): Y = kappa(X, L) R^T for one tile of rows.
//
// The arithmetic contract, whatever the geometry: every S = X L^T entry and
// every rbf row and landmark norm is one fmaf chain from 0.0f over the
// features in ascending order; kappa is tilemath::nonlin (d^2 clamped at 0);
// every Y entry is one fmaf chain from 0.0f over the landmarks in ascending
// order; padded landmarks, features and columns are exact zeros. So every
// geometry gives every row the same bits, and fused_apnc_step's labels are
// those of apnc_embed_block -> apnc_assign bit for bit.
//
// The pipeline (fused_apnc_step's design):
//  * landmarks go in super-tiles of BL = 256; a thread owns RI rows (TY
//    apart) x RQ landmarks (TX apart) of S and the same rows x RQ Y columns
//    of a 256-column chunk. A warp spans 4 rows x 8 landmarks (or columns),
//    so each float4 operand read is 4 or 8 distinct 16-byte words in
//    distinct banks at pitch SP = 36 (SP / 4 odd).
//  * every operand arrives by cp.async into an NS = 2 stage ring, one
//    barrier a step: the X and L chunks (BN and 256 rows x 32 features),
//    then the R sub-chunks (256 Y columns x 32 landmarks) over the same
//    ring. Step s + 1's copies are in flight while step s computes, across
//    the phase boundaries too. X, L and R are read 4 features (landmarks) at
//    a time along their rows, in their natural layout.
//  * rbf norms ride in the d loop: thread t sums landmark t of the
//    super-tile, threads t < BN row t.
//  * K (BN x 256) goes to shared memory once a super-tile; Y (BN x m) stays
//    in shared memory, transposed (pitch YP = BN + 4), between super-tiles.
//    With TO_GLOBAL the last super-tile stages each Y chunk row-major over
//    its own columns of that tile (pitch MC + 8, conflict-free) and writes
//    it to device memory in coalesced float4 rows.
//  * ragged n, d, l and m are zero-filled by the copies. 16-byte copies need
//    d and l multiples of 4 and aligned arrays (VEC); otherwise 4-byte
//    copies, the same arithmetic. A bf16 X is widened to f32 as it is staged
//    (plain loads, no cp.async).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "cp_async.cuh"
#include "tile_math.cuh"

namespace apncml {

using tilemath::KParams;
using tilemath::nonlin;
using tilemath::RBF;

constexpr int THREADS = 256;

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// A tile geometry: BN rows, TY x TX threads, RI x RQ outputs a thread.
template <int BN_, int TY_, int RI_, int TX_, int RQ_>
struct Geometry {
  static constexpr int BN = BN_;          // rows per tile
  static constexpr int TY = TY_;          // threads along the rows
  static constexpr int RI = RI_;          // rows a thread, TY apart
  static constexpr int TX = TX_;          // threads along the landmarks / Y columns
  static constexpr int RQ = RQ_;          // landmarks / Y columns a thread, TX apart
  static constexpr int BL = 256;          // landmarks per super-tile
  static constexpr int BD = 32;           // features per chunk
  static constexpr int MC = 256;          // Y columns per update chunk
  static constexpr int RL = 32;           // landmarks per R sub-chunk
  static constexpr int SP = 36;           // pitch of the staged chunks
  static constexpr int KP = BL + 4;       // pitch of the K tile
  static constexpr int YP = BN + 4;       // pitch of the Y^T tile
  static constexpr int OP = MC + 8;       // pitch of a Y chunk staged row-major for the store
  static constexpr int STAGE = (BN + BL) * SP;  // floats in one ring stage
  static constexpr int NS = 2;            // ring stages
  static_assert(BL == THREADS, "thread t sums landmark t's norm");
  static_assert(TX * RQ == BL && TX * RQ == MC && TY * RI == BN && TX * TY == THREADS,
                "thread tiling");
  static_assert(TX % 8 == 0 && TY % 4 == 0, "a warp is 4 rows x 8 landmarks");
  static_assert(MC * SP <= STAGE, "an R sub-chunk fits in a ring stage");
  static_assert(BN * OP <= MC * YP, "a staged Y chunk fits over its columns of Y^T");

  // Floats of shared memory: the ring, K, Y^T at m_pad columns, the norms.
  static constexpr size_t smem_floats(int m_pad) {
    return NS * (size_t)STAGE + (size_t)BN * KP + (size_t)m_pad * YP + BN + BL;
  }
};

// fused_apnc_step's geometry (32-row tiles: 128 CTAs a 4,096-row block),
// and apnc_embed_block's for launches of a few waves.
using Short = Geometry<32, 4, 8, 64, 4>;
// apnc_embed_block's geometry for launches of many waves: 64-row tiles,
// 8 x 8 outputs a thread (16 FMAs for every float4 read from shared memory).
using Tall = Geometry<64, 8, 8, 32, 8>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Copy rows [r0, r0 + nrows) x columns [c0, c0 + 32) of a row-major (rows,
// cols) array A into dst at pitch SP; elements outside A are zero-filled.
template <class G, bool VEC>
__device__ __forceinline__ void stage_block(float* dst, const float* __restrict__ A, int rows,
                                            int cols, int nrows, int r0, int c0) {
  if (VEC) {
    for (int e = threadIdx.x; e < nrows * 8; e += THREADS) {
      const int r = e >> 3, c = (e & 7) * 4;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cpasync::copy16(dst + r * G::SP + c, ok ? A + (size_t)(r0 + r) * cols + c0 + c : A, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * 32; e += THREADS) {
      const int r = e >> 5, c = e & 31;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cpasync::copy4(dst + r * G::SP + c, ok ? A + (size_t)(r0 + r) * cols + c0 + c : A, ok);
    }
  }
}

// A bf16 block, widened to f32 by plain loads and stores.
template <class G, bool VEC>
__device__ __forceinline__ void stage_block(float* dst, const __nv_bfloat16* __restrict__ A,
                                            int rows, int cols, int nrows, int r0, int c0) {
  for (int e = threadIdx.x; e < nrows * 32; e += THREADS) {
    const int r = e >> 5, c = e & 31;
    const bool ok = r0 + r < rows && c0 + c < cols;
    dst[r * G::SP + c] = ok ? to_f32(A[(size_t)(r0 + r) * cols + c0 + c]) : 0.0f;
  }
}

// The steps of one tile, in order: for each landmark super-tile, nd steps
// over the feature chunks (X and L), then nr steps over the (Y column chunk,
// R sub-chunk) pairs. Issues step s's copies into its ring stage as one
// group (an empty group past the last step, so the group count stays fixed).
template <class G, bool VEC, typename TX>
__device__ __forceinline__ void issue_step(int s, int steps, float* ring, const TX* X,
                                           const float* L, const float* R, int n, int d, int l,
                                           int m, int row0, int nd, int nr) {
  const int per = nd + nr;
  const int j0 = (s / per) * G::BL;
  const int w = s % per;
  float* stage = ring + (s % G::NS) * G::STAGE;
  if (s < steps && w < nd) {
    stage_block<G, VEC>(stage, X, n, d, G::BN, row0, w * G::BD);
    stage_block<G, VEC>(stage + G::BN * G::SP, L, l, d, G::BL, j0, w * G::BD);
  } else if (s < steps) {
    const int sub = (w - nd) % (G::BL / G::RL), cc = (w - nd) / (G::BL / G::RL);
    stage_block<G, VEC>(stage, R, m, l, G::MC, cc * G::MC, j0 + sub * G::RL);
  }
  cpasync::commit();
}

// The top of step s: its copies have landed and every thread is done with
// step s - 1, whose stage then takes step s + NS - 1's copies.
template <class G, bool VEC, typename TX>
__device__ __forceinline__ const float* begin_step(int s, int steps, float* ring, const TX* X,
                                                   const float* L, const float* R, int n, int d,
                                                   int l, int m, int row0, int nd, int nr) {
  cpasync::wait<G::NS - 2>();
  __syncthreads();
  issue_step<G, VEC>(s + G::NS - 1, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
  return ring + (s % G::NS) * G::STAGE;
}

__device__ __forceinline__ void norm4(float& acc, const float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  acc = fmaf(v.w, v.w, acc);
}

// acc[i][q] += a[i] . b[q] over four consecutive indices, in ascending order.
template <int RI, int RQ>
__device__ __forceinline__ void fma_tile(float (&acc)[RI][RQ], const float4 (&a)[RI],
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

// Shared memory of one tile's mainloop.
struct TileSmem {
  float* ring;  // NS x [STAGE]  X + L chunks or an R sub-chunk
  float* ks;    // [BN][KP]      K tile
  float* ys;    // [m_pad][YP]   Y^T tile
  float* xx_s;  // [BN]          row norms
  float* ll_s;  // [BL]          landmark norms
};

template <class G>
__device__ __forceinline__ TileSmem carve(float* smem, int m_pad) {
  TileSmem t;
  t.ring = smem;
  t.ks = t.ring + G::NS * G::STAGE;
  t.ys = t.ks + G::BN * G::KP;
  t.xx_s = t.ys + (size_t)m_pad * G::YP;
  t.ll_s = t.xx_s + G::BN;
  return t;
}

// Y for rows [row0, row0 + BN): into sm.ys (transposed), or with TO_GLOBAL
// into Y (row pitch ldy) for rows < n and columns < m. The caller's barrier
// must separate this from earlier readers of the ring, ys and the norms.
template <class G, bool VEC, bool TO_GLOBAL, typename TX>
__device__ __forceinline__ void embed_tile(const TX* __restrict__ X, const float* __restrict__ L,
                                           const float* __restrict__ R, int n, int d, int l,
                                           int m, int m_pad, int row0, const TileSmem& sm,
                                           const KParams& kp, float* __restrict__ Y, int ldy) {
  constexpr int RI = G::RI, RQ = G::RQ, TY = G::TY, TXT = G::TX, BN = G::BN, SP = G::SP;
  // A warp is 4 (ty) x 8 (tx) threads.
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int tx = (w % (TXT / 8)) * 8 + (t & 7);
  const int ty = (w / (TXT / 8)) * 4 + ((t & 31) >> 3);
  const int nd = (d + G::BD - 1) / G::BD;
  const int nr = (m_pad / G::MC) * (G::BL / G::RL);
  const int n_st = (l + G::BL - 1) / G::BL;
  const int steps = n_st * (nd + nr);
  float* ring = sm.ring;

  for (int p = 0; p < G::NS - 1; ++p)
    issue_step<G, VEC>(p, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
  int s = 0;
  for (int st = 0; st < n_st; ++st) {
    const int j0 = st * G::BL;
    // S = X L^T for the super-tile: rows ty + TY i, landmarks tx + TX q.
    float acc[RI][RQ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int q = 0; q < RQ; ++q) acc[i][q] = 0.0f;
    float nl = 0.0f, nx = 0.0f;  // |l_{j0 + t}|^2; t < BN: |x_t|^2
    for (int wd = 0; wd < nd; ++wd, ++s) {
      const float* xs = begin_step<G, VEC>(s, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
      const float* ls = xs + BN * SP;
      if (kp.kind == RBF) {
#pragma unroll
        for (int c = 0; c < G::BD; c += 4) {
          norm4(nl, *reinterpret_cast<const float4*>(ls + t * SP + c));
          if (t < BN) norm4(nx, *reinterpret_cast<const float4*>(xs + t * SP + c));
        }
      }
#pragma unroll
      for (int c = 0; c < G::BD; c += 4) {
        float4 a[RI], b[RQ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + (ty + i * TY) * SP + c);
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          b[q] = *reinterpret_cast<const float4*>(ls + (tx + q * TXT) * SP + c);
        fma_tile(acc, a, b);
      }
    }
    if (t < BN) sm.xx_s[t] = nx;
    sm.ll_s[t] = nl;
    __syncthreads();  // norms visible; every thread is done with the last chunk
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int r = ty + i * TY, j = tx + q * TXT;
        sm.ks[r * G::KP + j] =
            (j0 + j < l) ? nonlin(acc[i][q], sm.xx_s[r], sm.ll_s[j], kp) : 0.0f;
      }

    // Y += K R^T: rows ty + TY i, columns c0 + tx + TX q.
    for (int c0 = 0; c0 < m_pad; c0 += G::MC) {
      float y[RI][RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q)
#pragma unroll
        for (int i = 0; i < RI; ++i)
          y[i][q] = st ? sm.ys[(c0 + tx + q * TXT) * G::YP + ty + i * TY] : 0.0f;
      for (int sub = 0; sub < G::BL / G::RL; ++sub, ++s) {
        const float* rs = begin_step<G, VEC>(s, steps, ring, X, L, R, n, d, l, m, row0, nd, nr);
        const float* kt = sm.ks + sub * G::RL;
#pragma unroll
        for (int j = 0; j < G::RL; j += 4) {
          float4 a[RI], b[RQ];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            a[i] = *reinterpret_cast<const float4*>(kt + (ty + i * TY) * G::KP + j);
#pragma unroll
          for (int q = 0; q < RQ; ++q)
            b[q] = *reinterpret_cast<const float4*>(rs + (tx + q * TXT) * SP + j);
          fma_tile(y, a, b);
        }
      }
      if (TO_GLOBAL && st == n_st - 1) {
        // Stage the chunk row-major over its own (already read) columns of
        // the Y^T tile, then write it out in float4 rows, coalesced.
        float* yst = sm.ys + (size_t)c0 * G::YP;
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int q = 0; q < RQ; ++q) yst[(ty + i * TY) * G::OP + tx + q * TXT] = y[i][q];
        __syncthreads();
        const bool vy = (ldy & 3) == 0 && (reinterpret_cast<size_t>(Y) & 15) == 0;
        for (int e = t; e < BN * (G::MC / 4); e += THREADS) {
          const int r = e / (G::MC / 4), c = (e % (G::MC / 4)) * 4;
          const int gr = row0 + r, gc = c0 + c;
          if (gr >= n || gc >= m) continue;
          const float4 v = *reinterpret_cast<const float4*>(yst + r * G::OP + c);
          float* dst = Y + (size_t)gr * ldy + gc;
          if (vy && gc + 3 < m) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
            for (int j = 0; j < 4 && gc + j < m; ++j) dst[j] = vv[j];
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int i = 0; i < RI; ++i) sm.ys[(c0 + tx + q * TXT) * G::YP + ty + i * TY] = y[i][q];
      }
    }
  }
}

}  // namespace apncml
