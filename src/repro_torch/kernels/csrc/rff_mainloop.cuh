// The RFF projection mainloop shared by rff_embed.cu (rff_embed_block) and
// lloyd_step.cu (fused_rff_step): S = X W for one tile of rows x
// frequencies, 4 x 4 outputs a thread, in registers.
//
// The arithmetic contract, whatever the geometry: every S entry is one fmaf
// chain from 0.0f over the features in ascending order (no split, no tree
// sum); padded rows, features and frequencies are exact zeros. Both callers
// then take sincosf (the accurate version) and one multiply by s, so
// fused_rff_step's Y is rff_embed_block's bit for bit.
//
// The pipeline (rff_embed_block's design):
//  * features go in chunks of BD = 64. Chunk i + 1 of X comes into registers
//    with 16-byte loads during chunk i's FMAs and is then stored, transposed,
//    into the other of two X^T buffers; W's chunks, already in the (feature,
//    frequency) layout the reads want, come by cp.async into a 3-stage ring.
//    One barrier a chunk.
//  * the X^T buffers are XOR-swizzled by 16-byte row group, so the transposed
//    stores are conflict-free and the float4 reads stay whole.
//  * a thread owns rows 4 ty .. 4 ty + 3 and frequencies 4 tx .. 4 tx + 3; a
//    warp spans WY row groups x 32 / WY frequency groups.
//  * ragged n, d and mh are zero-filled in the loads. 16-byte loads need d
//    and mh multiples of 4 and aligned arrays (VEC); otherwise 4-byte ones,
//    the same arithmetic.
#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#include "cp_async.cuh"
#include "tile_math.cuh"

namespace rffml {

constexpr int THREADS = 256;
constexpr int BD = 64;      // features per chunk
constexpr int WSTAGES = 3;  // W chunks in flight

// A tile geometry: BN rows x BM frequencies, WY row groups a warp.
template <int BN_, int BM_, int WY_>
struct Geometry {
  static constexpr int BN = BN_;
  static constexpr int BM = BM_;
  static constexpr int TY = BN / 4;        // threads along the rows
  static constexpr int TX = BM / 4;        // threads along the frequencies
  static constexpr int WY = WY_;           // row groups a warp
  static constexpr int WX = 32 / WY;       // frequency groups a warp
  static constexpr int RG = BN / 8;        // 8-row groups of an X chunk
  static constexpr int XCH = BD * BN;      // floats in one X^T chunk
  static constexpr int WCH = BD * BM;      // floats in one W chunk
  static constexpr int XV = XCH / 4 / THREADS;  // float4 of an X chunk a thread loads
  static constexpr size_t SMEM_FLOATS = 2 * (size_t)XCH + WSTAGES * (size_t)WCH;
  static_assert(TY * TX == THREADS && TX % WX == 0 && TY % WY == 0, "thread tiling");
  static_assert(BN == 32 || BN == 64, "the swizzle keeps a row group inside the tile");
  static_assert(8 * XV == RG * (BD / 16), "a warp loads 8 rows x 16 features");
};

// rff_embed_block: 64 x 64, 16 x 16 threads, a warp 2 row groups x 16
// frequency groups (two CTAs a SM).
using Embed = Geometry<64, 64, 2>;
// fused_rff_step: 32 rows x 128 frequencies, 8 x 32 threads, a warp 8 row
// groups x 4 frequency groups, so an X read is 8 distinct float4 and a W
// read 4 (two wavefronts for 16 FMAs), and the transposed Y stores of
// lloyd_step.cu are conflict-free.
using Fused = Geometry<32, 128, 8>;

// Index arithmetic below is unsigned: the geometry's sizes are powers of
// two, so every divide and modulo is a shift or a mask.
template <class G>
__device__ __forceinline__ void coords(int& ty, int& tx) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr unsigned WPR = G::TX / G::WX;  // warps along the frequencies
  tx = (int)((warp % WPR) * G::WX + lane % G::WX);
  ty = (int)((warp / WPR) * G::WY + lane / G::WX);
}

__device__ __forceinline__ int swizzle(int c) { return ((c >> 2) & 3) << 1; }

// Chunk k0 of X as XV float4 a thread: rows r = 8 (combo % RG) + lane % 8,
// features 4 c4 .. 4 c4 + 3 with c4 = 4 (combo / RG) + lane / 8, combo =
// XV warp + p. Zero outside X.
template <class G, bool VEC>
__device__ __forceinline__ void load_x(float4 (&v)[G::XV], const float* __restrict__ X, int n,
                                       int d, int row0, int k0) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < G::XV; ++p) {
    const unsigned combo = warp * G::XV + p;
    const int r = (int)((combo % G::RG) * 8 + (lane & 7));
    const int c = (int)(((combo / G::RG) * 4 + (lane >> 3)) * 4);
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
template <class G>
__device__ __forceinline__ void store_xt(float* xs, const float4 (&v)[G::XV]) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < G::XV; ++p) {
    const unsigned combo = warp * G::XV + p;
    const int r = (int)((combo % G::RG) * 8 + (lane & 7));
    const int c = (int)(((combo / G::RG) * 4 + (lane >> 3)) * 4);
    const float e[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xs[(c + j) * G::BN + (((r >> 2) ^ swizzle(c + j)) << 2) + (r & 3)] = e[j];
  }
}

// W rows [k0, k0 + BD) x columns [c0, c0 + BM) into ws (pitch BM) by
// cp.async, as one group (empty when k0 >= d); zero outside W.
template <class G, bool VEC>
__device__ __forceinline__ void issue_w(float* ws, const float* __restrict__ W, int d, int mh,
                                        int k0, int c0) {
  if (k0 < d && VEC) {
    for (unsigned e = threadIdx.x; e < BD * G::BM / 4; e += THREADS) {
      const int c = (int)(e / (G::BM / 4)), j = (int)(e % (G::BM / 4)) * 4;
      const bool ok = k0 + c < d && c0 + j < mh;
      cpasync::copy16(ws + c * G::BM + j, ok ? W + (size_t)(k0 + c) * mh + c0 + j : W, ok);
    }
  } else if (k0 < d) {
    for (unsigned e = threadIdx.x; e < BD * G::BM; e += THREADS) {
      const int c = (int)(e / G::BM), j = (int)(e % G::BM);
      const bool ok = k0 + c < d && c0 + j < mh;
      cpasync::copy4(ws + c * G::BM + j, ok ? W + (size_t)(k0 + c) * mh + c0 + j : W, ok);
    }
  }
  cpasync::commit();
}

// acc = S for rows [row0, row0 + BN) x frequencies [c0, c0 + BM), thread
// (ty, tx) holding rows 4 ty + i x frequencies 4 tx + j. xs: 2 x XCH floats,
// ws: WSTAGES x WCH. The caller's barrier must separate this from earlier
// readers of xs and ws; every copy it issues has landed when it returns.
template <class G, bool VEC>
__device__ __forceinline__ void project(float (&acc)[4][4], const float* __restrict__ X,
                                        const float* __restrict__ W, int n, int d, int mh,
                                        int row0, int c0, float* xs, float* ws, int ty, int tx) {
  const int chunks = (d + BD - 1) / BD;
  issue_w<G, VEC>(ws, W, d, mh, 0, c0);
  issue_w<G, VEC>(ws + G::WCH, W, d, mh, BD, c0);  // an empty group when d <= BD
  float4 xr[G::XV];
  load_x<G, VEC>(xr, X, n, d, row0, 0);
  store_xt<G>(xs, xr);

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int i = 0; i < chunks; ++i) {
    cpasync::wait<1>();  // W chunk i has landed; i + 1 may still be in flight
    __syncthreads();     // X^T chunk i visible; every thread is done with chunk i - 1
    issue_w<G, VEC>(ws + ((i + 2) % WSTAGES) * G::WCH, W, d, mh, (i + 2) * BD, c0);
    const bool more = i + 1 < chunks;
    if (more) load_x<G, VEC>(xr, X, n, d, row0, (i + 1) * BD);
    const float* xc = xs + (i & 1) * G::XCH;
    const float* wc = ws + (i % WSTAGES) * G::WCH;
#pragma unroll 16
    for (int c = 0; c < BD; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(xc + c * G::BN + ((ty ^ swizzle(c)) << 2));
      tilemath::fma_4x4(acc, x, *reinterpret_cast<const float4*>(wc + c * G::BM + tx * 4));
    }
    if (more) store_xt<G>(xs + ((i + 1) & 1) * G::XCH, xr);
  }
}

}  // namespace rffml
