// Causal flash attention for Hopper (sm_90a): softmax(q k^T * scale) v with an
// optional sliding window, online max and sum, the (S, S) scores never in
// device memory.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_bhsd
// (_flash_kernel), the Pallas TPU kernel.
//
// Bound on an H100 SXM: operations. Per (b, h) a causal pass takes
// 4 * Dh * S(S+1)/2 f32 operations (q k^T and p v, the exp left out) and
// moves 4 * S * Dh elements (q, k, v read once, o written once); at the
// serving path's shape (B*H = 64, S = 4,096, Dh = 64, f32) that is
// 1.37e11 FLOP, 2.05 ms at 67 TFLOP/s f32, against 268 MB, 0.08 ms at
// 3.35 TB/s.
//
// Design, and what it does about the bound:
//  * One CTA owns one (b*h, 64-row query tile) and loops over the key/value
//    tiles in order, only over the live ones: a 64-key tile is live when
//    kv_start <= q_end and, with a window, kv_end > q_start - window (the
//    TPU kernel's @pl.when skip, as a loop bound). The TPU kernel's
//    sequential kv grid axis with its VMEM scratch becomes this loop; the
//    running max m, sum l and the accumulator stay in registers across it.
//  * Q (transposed), K (transposed), V and the probabilities P live in
//    shared memory, all f32: (2 * DP * 68 + 64 * (DP + 4) + 64 * 68) * 4
//    bytes for the head dim padded to DP = 64, 128 or 256 (69,632 bytes at
//    DP = 64, three CTAs an SM; 223,232 at DP = 256). Ragged S and a head dim
//    below DP are masked in the loads (zeros) and the stores: no padded
//    copies.
//  * 256 threads, 16 x 16: a thread owns 4 query rows x 4 keys of the score
//    tile (tile_math's fma_4x4 over the head dim) and the same 4 rows x
//    DP / 16 columns of the output. A row's 64 scores sit in 16 lanes of one
//    warp, so its max and sum are shuffle reductions and m, l, alpha never
//    leave registers.
//  * The arithmetic is the reference's, in its order: masked scores -inf,
//    m starts at -1e30, m_new = max(m, rowmax) (monotone, so a fully masked
//    row of a live tile cannot blow alpha up), p = exp(s - m_new),
//    alpha = exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha + p v,
//    out = acc / max(l, 1e-30). expf, not __expf, and no --use_fast_math.
//  * Query tiles are issued longest first (the last rows see the most keys).
//    No atomics: every bit is the same run to run.
//  * q, k, v and o are read and written in the model's (B, S, H, Dh) layout
//    through their strides (the last dim contiguous): no transposed copies.
//    f32 or bf16 in, f32 arithmetic, output in the input's type (bf16
//    rounded to nearest even, as torch rounds).
//  * Tensor cores (wgmma), TMA and a K/V ring are later work: this is the
//    plain FMA kernel.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "tile_math.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int PAD = 68;       // pitch of the transposed Q / K tiles and of P (float4 aligned)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint16_t* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {  // round to nearest even
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    *p = 0x7fc0;  // NaN
    return;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  *p = (uint16_t)(u >> 16);
}

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)2 * DP * PAD + (size_t)BK * (DP + 4) + (size_t)BK * PAD;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H, int S,
             int Dh, int window, float scale) {
  constexpr int VP = DP + 4;   // pitch of the V tile
  constexpr int G = DP / 64;   // 64-column groups of the output a thread touches
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // Q^T: qt[d * PAD + r]
  float* kt = qt + DP * PAD;   // K^T: kt[d * PAD + c]
  float* vs = kt + DP * PAD;   // V:   vs[c * VP + d]
  float* pt = vs + BK * VP;    // P^T: pt[c * PAD + r]

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest rows first
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int e = t; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const int row = q0 + r;
    qt[d * PAD + r] = (row < S && d < Dh) ? load(qb + row * sq.s + d) : 0.0f;
  }

  float acc[4][4 * G];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.0f;
  }

  // The live key tiles: kv_start <= q_end, and with a window
  // kv_start + BK - 1 > q0 - window.
  const int j_hi = min(q0 + BQ - 1, S - 1) / BK;
  int j_lo = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 2;  // least live kv_start
    j_lo = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's readers of kt, vs and pt are done
    for (int e = t; e < BK * DP; e += THREADS) {
      const int c = e / DP, d = e % DP;
      const int col = k0 + c;
      const bool in = col < S && d < Dh;
      kt[d * PAD + c] = in ? load(kb + col * sk.s + d) : 0.0f;
      vs[c * VP + d] = in ? load(vb + col * sv.s + d) : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DP; ++d)
      tilemath::fma_4x4(s, *reinterpret_cast<const float4*>(qt + d * PAD + ty * 4),
                        *reinterpret_cast<const float4*>(kt + d * PAD + tx * 4));

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx * 4 + jj;
        const bool ok = col < S && col <= row && (window <= 0 || row - col < window);
        s[i][jj] = ok ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        sum += s[i][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 4 * G; ++jj) acc[i][jj] *= alpha[i];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(pt + (tx * 4 + jj) * PAD + ty * 4) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(pt + c * PAD + ty * 4);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + c * VP + g * 64 + tx * 4);
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][g * 4 + jj] = fmaf(pv[i], vw[jj], acc[i][g * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < Dh) store(ob + row * so.s + d, acc[i][g * 4 + jj] / den);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const long long* st,
                   int B, int S, int H, int Dh, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  flash_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, H, S, Dh, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const long long* st,
                     int B, int S, int H, int Dh, int window, float scale, cudaStream_t s) {
  if (Dh <= 64) return launch<T, 64>(q, k, v, o, st, B, S, H, Dh, window, scale, s);
  if (Dh <= 128) return launch<T, 128>(q, k, v, o, st, B, S, H, Dh, window, scale, s);
  return launch<T, 256>(q, k, v, o, st, B, S, H, Dh, window, scale, s);
}

}  // namespace

extern "C" {

// Largest head dim one launch takes.
int flash_attention_max_head_dim() { return 256; }

// Dynamic shared memory of one CTA for head dim Dh, in bytes.
long long flash_attention_smem_bytes(int Dh) {
  if (Dh <= 64) return (long long)(smem_floats<64>() * sizeof(float));
  if (Dh <= 128) return (long long)(smem_floats<128>() * sizeof(float));
  return (long long)(smem_floats<256>() * sizeof(float));
}

// q, k, v, o (B, S, H, Dh), f32 (bf16 = 0) or bf16 bits (bf16 = 1), the head
// dim contiguous; strides[12] = (batch, seq, head) strides in elements of q,
// k, v and o, in that order. Causal, positions = row indices, and with
// window > 0 only keys with row - col < window. scale multiplies q k^T.
// Returns the CUDA error code of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o, int bf16, int B, int S,
                    int H, int Dh, const long long* strides, int window, float scale,
                    void* stream) {
  if (Dh < 1 || Dh > 256 || S < 1 || B * H < 1 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      bf16 ? dispatch<uint16_t>(q, k, v, o, strides, B, S, H, Dh, window, scale, s)
           : dispatch<float>(q, k, v, o, strides, B, S, H, Dh, window, scale, s);
  return (int)err;
}

}  // extern "C"
