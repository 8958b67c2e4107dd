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
// Design, and what it does about the bound:
//  * One CTA owns a range of 64-row tiles. Its threads read a tile of the
//    payload row by row (neighbouring threads on neighbouring elements, so
//    the loads coalesce) and decode each element straight into the
//    transposed f32 tile ys[c * PAD + r] that lloyd_epilogue.cuh reads:
//    int8 as __fmul_rn(float(q), scale[c]), one rounded multiply, as the TPU
//    kernel's y = yq.astype(f32) * s; bf16 exactly, as the top half of an
//    f32. The decode is stored before any distance is taken, so nvcc cannot
//    contract it into the distance arithmetic. The codec's bf16 scale is
//    identically 1.0, so the bf16 instance reads no scale.
//  * The epilogue (assign_reduce_tile, lloyd_reduce_kernel) is the fused
//    steps' own: the same labels as apnc_assign.cu for the same Y, per-CTA
//    (Z, g, cost) partials summed in a fixed order, no float atomics, so
//    every bit is the same run to run. Ragged rows are masked, not padded.
//  * Shared memory is the Y tile (m_pad = m rounded up to 32, times PAD
//    floats) plus the epilogue's C sub-chunk and row scratch:
//    272 * m_pad + 9,728 bytes, 79,360 at m = 256 (two CTAs an SM). A CTA
//    may have 232,448 bytes, so m <= 800 (dequant_step_max_m). Wider blocks
//    take decode_kernel below, then apnc_assign.cu.
//  * A 4,096-row block is 64 CTAs on 132 SMs: latency-bound by
//    construction, like the other fused steps. Filling the card is later work.
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "lloyd_epilogue.cuh"

namespace {

using lloyd::BN;
using lloyd::KC;
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

template <typename T, bool L1>
__global__ void __launch_bounds__(THREADS)
fused_dequant_kernel(const T* __restrict__ Yq, const float* __restrict__ scale,
                     const float* __restrict__ C, float* __restrict__ Zp,
                     float* __restrict__ gp, float* __restrict__ costp, int* __restrict__ labels,
                     int n, int m, int k, int tiles_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = lloyd::round_up(m, MK);
  float* ys = smem;                  // [m_pad][PAD]  Y^T tile
  lloyd::EpilogueSmem es;
  es.cs = ys + m_pad * PAD;          // [MK][PAD]
  es.yy_s = es.cs + MK * PAD;        // [BN]
  es.cc_s = es.yy_s + BN;            // [KC]
  es.mind_s = es.cc_s + KC;          // [BN]
  es.lab_s = reinterpret_cast<int*>(es.mind_s + BN);  // [BN]

  const int t = threadIdx.x;
  float* zp = Zp + (size_t)blockIdx.x * k * m;
  float* gpc = gp + (size_t)blockIdx.x * k;
  float cost_acc = 0.0f;
  lloyd::zero_partials(zp, gpc, k, m);

  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row0 = tile * BN;
    const int rows = min(BN, n - row0);
    __syncthreads();  // the previous tile's epilogue is done with ys and the scratch
    for (int e = t; e < BN * m_pad; e += THREADS) {
      const int r = e / m_pad, c = e % m_pad;
      ys[c * PAD + r] = (r < rows && c < m) ? decode(Yq[(size_t)(row0 + r) * m + c], scale, c)
                                            : 0.0f;
    }
    lloyd::assign_reduce_tile<L1>(ys, m_pad, C, k, m, row0, rows, es, labels, zp, gpc, cost_acc);
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

size_t smem_bytes(int m) {
  const int m_pad = lloyd::round_up(m, MK);
  return sizeof(float) * ((size_t)m_pad * PAD + (size_t)MK * PAD + BN + KC + BN) +
         sizeof(int) * BN;
}

template <typename T, bool L1>
cudaError_t launch_step(const void* Yq, const float* scale, const float* C, float* Zp, float* gp,
                        float* costp, int* labels, int n, int m, int k, int num_ctas,
                        int tiles_per_cta, cudaStream_t s) {
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(fused_dequant_kernel<T, L1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_dequant_kernel<T, L1><<<num_ctas, THREADS, smem, s>>>(
      static_cast<const T*>(Yq), scale, C, Zp, gp, costp, labels, n, m, k, tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m one fused launch takes (the decoded Y tile lives in shared memory).
int dequant_step_max_m() { return MAX_M; }

// Rows per tile; the wrapper sizes the P partials from it.
int dequant_step_tile_rows() { return BN; }

// Dynamic shared memory of one CTA, in bytes.
long long fused_dequant_smem_bytes(int m) { return (long long)smem_bytes(m); }

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
