// The Lloyd step over a quantized cache block for Hopper (sm_90a): decode
// the int8 or bf16 Y tile into shared memory, then assign + (Z, g, cost),
// the decoded f32 Y never in device memory.
//
// Replaces: src/repro/kernels/lloyd_step.py::fused_dequant_step
// (_dequant_step_kernel), the Pallas TPU kernel.
//
// Bound on an H100 SXM: operations. One launch does 2*n*k*m f32 operations
// (the distances; the decode is n*m multiplies) against n*m bytes of int8
// payload (2*n*m for bf16) plus (m + 2*k*m + k + n + 1)*4 bytes; at the
// sweep's shape (m = 256, k = 164) a pass over n = 1,262,102 rows is
// 1.06e11 FLOP, 1.58 ms at 67 TFLOP/s f32, against 0.32 GB of int8 Y,
// 0.1 ms at 3.35 TB/s.
//
// Design, and what it does about the bound (redesigned for Hopper; the first
// port ran 64-row tiles, 64 CTAs a 4,096-row block, a byte-wide decode with
// 4-way bank conflicts, the C^T sub-chunks loaded between two barriers with
// nothing in flight and every CTA zeroing a (k, m) Z partial: 27.14-45.16 ms
// a pass, 3.5-5.8 % of its bound):
//  * One CTA owns a range of 32-row tiles, so a 4,096-row block is 128 CTAs
//    on the 132 SMs.
//  * A tile's payload comes by 16-byte cp.async copies (coalesced, 16 int8 or
//    8 bf16 values each) into a raw tile in shared memory, rows at an odd
//    number of 16-byte words apart, in the space of the epilogue's C
//    buffers. Where a CTA holds more tiles, the next tile's copies go out as
//    soon as the epilogue has read its last C sub-chunk, and are in flight
//    while it combines, groups and updates Z. Payloads whose rows are not
//    whole 16-byte words, or unaligned, are staged by plain loads.
//  * The decode reads the raw tile 16 bytes a thread, lane r on row r (the
//    odd pitch spreads a quarter warp's reads over the banks), and writes
//    the transposed f32 tile ys[c * 36 + r] that lloyd_epilogue.cuh reads:
//    the 32 lanes of a warp store one column's 32 rows, 32 banks, no
//    conflict. int8 decodes as __fmul_rn(float(q), scale[c]), one rounded
//    multiply, as the TPU kernel's y = yq.astype(f32) * s (the scales staged
//    once a CTA, zero past m); bf16 exactly, as the top half of an f32. The
//    decode is stored before any distance is taken, so nvcc cannot contract
//    it into the distance arithmetic. The codec's bf16 scale is identically
//    1.0, so the bf16 instance reads no scale.
//  * The epilogue (assign_reduce_tile, lloyd_reduce_kernel) is the fused
//    steps' own: the same labels as apnc_assign.cu for the same Y, 8 rows x
//    4 centroids a thread, each C sub-chunk in flight while the one before
//    it is in use, the norms beside the distance FMAs, one Z store per
//    distinct label of a tile, per-CTA (Z, g, cost) partials summed in a
//    fixed order, no float atomics, so every bit is the same run to run.
//    Ragged rows are masked, not padded.
//  * Shared memory is the Y tile (m_pad = m rounded up to 32, times 36
//    floats), the epilogue's two C buffers (the raw tile in their space),
//    the scales and scratch: 113,796 bytes at m = 256, 194,308 at m = 800.
//    A CTA may have 232,448 bytes, so m <= 800 (dequant_step_max_m). Wider
//    blocks take decode_kernel below, then apnc_assign.cu.
//  * Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py timing, a pass
//    over the sweep's int8 cache at k = 164, 309 launches): 10.9 ms of
//    device time, 8.4 the kernel and 2.5 the reduce (with the epilogue's
//    narrowed k tail and batched Z loads; 11.2-11.3 before); 15.4-22.3 ms
//    event-timed, the rest the host's launches. tools/kernel_ablation.py
//    puts a 35 us launch at 5 us for staging, decode and an empty reduce,
//    4.6 us for the Z update, the rest in the distances (about half the f32
//    rate) and the reduce.
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "lloyd_epilogue.cuh"

namespace {

using lloyd::BN;
using lloyd::MK;
using lloyd::PAD;
using lloyd::THREADS;

constexpr int MAX_M = 800;
constexpr int DECODE_THREADS = 256;

__device__ __forceinline__ float decode(int8_t q, const float* __restrict__ scale, int c) {
  return __fmul_rn((float)q, __ldg(scale + c));
}

__device__ __forceinline__ float decode(uint16_t bits, const float* __restrict__, int) {
  return __uint_as_float((unsigned)bits << 16);
}

// Values a 16-byte word holds.
template <typename T>
__host__ __device__ constexpr int per_word() { return 16 / (int)sizeof(T); }

// The raw tile: BN rows of m_pad values, each row `pitch` 16-byte words
// apart, pitch odd.
template <typename T>
__host__ __device__ inline int raw_pitch(int m_pad) { return (m_pad / per_word<T>()) | 1; }

// Floats of the space the raw tile shares with the epilogue's C buffers.
template <typename T>
__host__ __device__ inline int shared_floats(int m_pad) {
  const int raw = 4 * BN * raw_pitch<T>(m_pad);
  return raw > 2 * lloyd::CBUF ? raw : 2 * lloyd::CBUF;
}

// Rows [row0, row0 + BN) of Yq into the raw tile, zero outside Yq: by
// 16-byte cp.async copies as one group (VEC: rows of whole aligned words),
// or by plain loads.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(uint4* raw, const T* __restrict__ Yq, int n, int m,
                                           int m_pad, int row0) {
  constexpr int V = per_word<T>();
  const int words = m_pad / V, pitch = raw_pitch<T>(m_pad);
  if (VEC) {
    for (int e = threadIdx.x; e < BN * words; e += THREADS) {
      const int r = e / words, w = e % words;
      const bool ok = row0 + r < n && w * V < m;
      cpasync::copy16(reinterpret_cast<float*>(raw + r * pitch + w),
                      reinterpret_cast<const float*>(ok ? Yq + (size_t)(row0 + r) * m + w * V : Yq),
                      ok);
    }
    cpasync::commit();
  } else {
    T* rt = reinterpret_cast<T*>(raw);
    for (int e = threadIdx.x; e < BN * m_pad; e += THREADS) {
      const int r = e / m_pad, c = e % m_pad;
      rt[r * pitch * V + c] = (row0 + r < n && c < m) ? Yq[(size_t)(row0 + r) * m + c] : T(0);
    }
  }
}

// The 16 int8 or 8 bf16 values of one raw word, decoded into Y^T column
// c0 + e, row r.
__device__ __forceinline__ void decode_word(float* ys, uint4 q, const float* scale_s, int c0,
                                            int r, int8_t) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int8_t v = (int8_t)(w[e >> 2] >> (8 * (e & 3)));
    ys[(c0 + e) * PAD + r] = __fmul_rn((float)v, scale_s[c0 + e]);
  }
}

__device__ __forceinline__ void decode_word(float* ys, uint4 q, const float*, int c0, int r,
                                            uint16_t) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned bits = (e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16);
    ys[(c0 + e) * PAD + r] = __uint_as_float(bits);
  }
}

// The raw tile decoded into Y^T: lane r takes row r, warp w the words w,
// w + 8, ...
template <typename T>
__device__ __forceinline__ void decode_tile(float* ys, const uint4* raw, const float* scale_s,
                                            int m_pad) {
  constexpr int V = per_word<T>();
  const int r = threadIdx.x & 31;
  const int words = m_pad / V, pitch = raw_pitch<T>(m_pad);
  for (int w = threadIdx.x >> 5; w < words; w += THREADS / 32)
    decode_word(ys, raw[r * pitch + w], scale_s, w * V, r, T(0));
}

template <typename T, bool L1, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_dequant_kernel(const T* __restrict__ Yq, const float* __restrict__ scale,
                     const float* __restrict__ C, float* __restrict__ Zp,
                     float* __restrict__ gp, float* __restrict__ costp, int* __restrict__ labels,
                     int n, int m, int k, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, MK);
  float* ys = smem;                             // [m_pad][PAD]  Y^T tile
  float* cs = ys + (size_t)m_pad * PAD;         // the epilogue's C buffers, or the raw tile
  uint4* raw = reinterpret_cast<uint4*>(cs);    // [BN][pitch]   raw payload
  float* scale_s = cs + shared_floats<T>(m_pad);  // [m_pad]     int8 scales, zero past m
  const lloyd::EpilogueSmem es = lloyd::carve(scale_s + m_pad, cs);

  const int t = threadIdx.x;
  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  if (tile_lo < tile_hi) stage_tile<T, VEC>(raw, Yq, n, m, m_pad, tile_lo * BN);
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_counts(gpc, k);
  if (sizeof(T) == 1)
    for (int c = t; c < m_pad; c += THREADS) scale_s[c] = c < m ? scale[c] : 0.0f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    cpasync::wait<0>();
    __syncthreads();  // the tile's payload and the scales visible; the previous epilogue is done
    decode_tile<T>(ys, raw, scale_s, m_pad);
    // The epilogue's first barrier ends the decode's reads of the raw tile;
    // the next tile's copies go into the same space once its C reads are done.
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, min(BN, n - row0),
                                  tile == tile_lo, es, labels, zp,
                                  gpc, cost_acc, [&] {
                                    if (tile + 1 < tile_hi)
                                      stage_tile<T, VEC>(raw, Yq, n, m, m_pad, row0 + BN);
                                  });
  }
  if (t == 0) costp[blockIdx.x] = cost_acc;
}

// Y = decode(Yq) elementwise into device memory: the route for m > MAX_M.
template <typename T>
__global__ void __launch_bounds__(DECODE_THREADS)
decode_kernel(const T* __restrict__ Yq, const float* __restrict__ scale, float* __restrict__ Y,
              size_t total, int m) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride)
    Y[e] = decode(Yq[e], scale, (int)(e % (size_t)m));
}

template <typename T>
size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, MK);
  return sizeof(float) *
         ((size_t)m_pad * PAD + shared_floats<T>(m_pad) + m_pad + lloyd::SCRATCH);
}

template <typename T, bool L1>
cudaError_t launch_step(const void* Yq, const float* scale, const float* C, float* Zp, float* gp,
                        float* costp, int* labels, int n, int m, int k, int num_ctas,
                        int tiles_per_cta, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(m);
  const bool vec = (m * sizeof(T)) % 16 == 0 && ((size_t)Yq & 15) == 0;
  const auto kernel =
      vec ? fused_dequant_kernel<T, L1, true> : fused_dequant_kernel<T, L1, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_ctas, THREADS, smem, s>>>(static_cast<const T*>(Yq), scale, C, Zp, gp, costp,
                                         labels, n, m, k, tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m one fused launch takes (the decoded Y tile lives in shared memory).
int dequant_step_max_m() { return MAX_M; }

// Rows per tile; the wrapper sizes the P partials from it.
int dequant_step_tile_rows() { return BN; }

// Dynamic shared memory of one CTA, in bytes, for an int8 (bf16 = 0) or
// bf16 (bf16 = 1) payload.
long long fused_dequant_smem_bytes(int m, int bf16) {
  return (long long)(bf16 ? smem_bytes<uint16_t>(m) : smem_bytes<int8_t>(m));
}

// Yq (n, m) int8 (bf16 = 0) or bf16 bits (bf16 = 1), scale (m,) f32 (int8
// only; unread for bf16), C (k, m) f32 -> Z (k, m), g (k,), cost (1,) f32,
// labels (n,) int32. Zp (num_ctas, k, m), gp (num_ctas, k) and costp
// (num_ctas,) are scratch; CTA p covers tiles [p * tiles_per_cta, (p + 1) *
// tiles_per_cta). Returns the CUDA error code of the launches.
int fused_dequant_step(const void* Yq, int bf16, const float* scale, const float* C, float* Z,
                       float* g, float* cost, int* labels, float* Zp, float* gp, float* costp,
                       int n, int m, int k, int l1, int num_ctas, int tiles_per_cta,
                       void* stream) {
  if (m > MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    err = l1 ? launch_step<uint16_t, true>(Yq, scale, C, Zp, gp, costp, labels, n, m, k,
                                           num_ctas, tiles_per_cta, s)
             : launch_step<uint16_t, false>(Yq, scale, C, Zp, gp, costp, labels, n, m, k,
                                            num_ctas, tiles_per_cta, s);
  } else {
    err = l1 ? launch_step<int8_t, true>(Yq, scale, C, Zp, gp, costp, labels, n, m, k, num_ctas,
                                         tiles_per_cta, s)
             : launch_step<int8_t, false>(Yq, scale, C, Zp, gp, costp, labels, n, m, k,
                                          num_ctas, tiles_per_cta, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)lloyd::launch_reduce(Zp, gp, costp, Z, g, cost, num_ctas, k, m, s);
}

// Y (n, m) f32 = decode(Yq), total = n * m elements. Returns the CUDA error code.
int dequant_decode(const void* Yq, int bf16, const float* scale, float* Y, long long total, int m,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long want = (total + DECODE_THREADS - 1) / DECODE_THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  if (bf16)
    decode_kernel<uint16_t><<<blocks, DECODE_THREADS, 0, s>>>(
        static_cast<const uint16_t*>(Yq), scale, Y, (size_t)total, m);
  else
    decode_kernel<int8_t><<<blocks, DECODE_THREADS, 0, s>>>(
        static_cast<const int8_t*>(Yq), scale, Y, (size_t)total, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
