// Fused APNC embedding for Hopper (sm_90a): Y = kappa(X, L) @ R^T for one block.
//
// Replaces: src/repro/kernels/apnc_embed.py::apnc_embed_block (_embed_kernel,
// _apply_kernel_nonlin), the Pallas TPU kernel.
//
// Bound on an H100 SXM: compute. One launch does 2*n*l*(d + m) f32 operations
// and moves (n*d + n*m)*4 bytes; at the main path's shape (n = 1,262,102,
// d = 900, l = 500, m = 256) that is 1.46e12 FLOP against 5.84 GB, so against
// the card's 67 TFLOP/s f32 rate and 3.35 TB/s it is about 12x more
// operation-bound than byte-bound.
//
// Design (redesigned for Hopper; the first port, 64-row tiles with a 4 x 4
// register tile and synchronous staging, read X once per 64-landmark tile,
// 8 times at l = 500, and ran 1.43x slower than cdist -> exp -> matmul):
//  * The mainloop is apnc_mainloop.cuh's, the one fused_apnc_step runs, so
//    the fmaf chains are one: each S entry and norm a chain over the
//    features in ascending order, each Y entry a chain over the landmarks in
//    ascending order, from 0.0f, padded with exact zeros. Every row's bits are
//    the same whatever the geometry or the launch it falls in.
//  * Landmark super-tiles of 256 stage each X chunk twice at l = 500 (l <=
//    512 in two passes), every operand by cp.async into a 2-stage ring, X, L
//    and R read in their natural layout, conflict-free float4 reads.
//  * Two geometries, chosen per launch. A launch of many waves (the local
//    fit's one launch over all of X) takes apncml::Tall: 64-row tiles, 8 x 8
//    outputs a thread, 16 FMAs for every float4 read from shared memory, and
//    half the L and R traffic from L2 per row of the 32-row tile; 224 KB of
//    shared memory at m <= 256, one CTA a SM. A launch of a few waves (the
//    sweep's 4,096-row blocks: 64 CTAs of 64 rows would leave half the SMs
//    idle) and m up to 512 take apncml::Short, fused_apnc_step's 32-row
//    tiles.
//  * One tile a CTA; the last landmark super-tile writes Y from registers
//    to device memory (row pitch ldy, so Y may be a column slice), masked to
//    n and m.
//  * X in bf16 is widened to f32 as it is staged; L and R are f32.
//  * Ragged n, d, l and m are masked in the copies and the stores: no padded
//    copies. 16-byte copies need d and l multiples of 4 and aligned L and R
//    (and X in f32); other shapes take 4-byte copies, the same arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "apnc_mainloop.cuh"

namespace {

using apncml::KParams;
using apncml::THREADS;

constexpr int MAX_M = 512;       // columns one launch takes
constexpr int TALL_MAX_M = 256;  // the Tall geometry's shared memory holds Y^T up to this
constexpr int TALL_WAVES = 4;    // launches of at least this many waves of Tall tiles take it

template <class G, typename TX, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
embed_kernel(const TX* __restrict__ X, const float* __restrict__ L, const float* __restrict__ R,
             float* __restrict__ Y, int n, int d, int l, int m, int ldy, KParams kp) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = apncml::round_up(m, G::MC);
  const apncml::TileSmem sm = apncml::carve<G>(smem, m_pad);
  apncml::embed_tile<G, VEC, true>(X, L, R, n, d, l, m, m_pad, (int)blockIdx.x * G::BN, sm, kp,
                                   Y, ldy);
}

template <class G>
size_t smem_bytes(int m) {
  return sizeof(float) * G::smem_floats(apncml::round_up(m, G::MC));
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// Whether a launch of n rows and m columns takes the Tall geometry.
bool tall(int n, int m) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;  // an H100 SXM's SMs
  const int tiles = (n + apncml::Tall::BN - 1) / apncml::Tall::BN;
  return m <= TALL_MAX_M && tiles >= TALL_WAVES * sms;
}

template <class G, typename TX, bool VEC>
cudaError_t run(const TX* X, const float* L, const float* R, float* Y, int n, int d, int l, int m,
                int ldy, const KParams& kp, cudaStream_t stream) {
  const size_t smem = smem_bytes<G>(m);
  cudaError_t err = cudaFuncSetAttribute(embed_kernel<G, TX, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + G::BN - 1) / G::BN);
  embed_kernel<G, TX, VEC><<<grid, THREADS, smem, stream>>>(X, L, R, Y, n, d, l, m, ldy, kp);
  return cudaGetLastError();
}

template <typename TX>
int launch(const TX* X, const float* L, const float* R, float* Y, int n, int d, int l, int m,
           int ldy, int kind, float gamma, float coef0, float scale, int degree, void* stream) {
  if (m > MAX_M) return (int)cudaErrorInvalidValue;
  const KParams kp{kind, gamma, coef0, scale, degree};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && l % 4 == 0 && aligned16(L) && aligned16(R) &&
                   (sizeof(TX) != 4 || aligned16(X));
  cudaError_t err;
  if (tall(n, m))
    err = vec ? run<apncml::Tall, TX, true>(X, L, R, Y, n, d, l, m, ldy, kp, s)
              : run<apncml::Tall, TX, false>(X, L, R, Y, n, d, l, m, ldy, kp, s);
  else
    err = vec ? run<apncml::Short, TX, true>(X, L, R, Y, n, d, l, m, ldy, kp, s)
              : run<apncml::Short, TX, false>(X, L, R, Y, n, d, l, m, ldy, kp, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Largest m one launch takes; the wrapper splits wider blocks into column groups.
int apnc_embed_max_m() { return MAX_M; }

// Rows per CTA tile of a launch of n rows and m columns (64: Tall, 32: Short).
int apnc_embed_tile_rows(int n, int m) {
  return tall(n, m) ? apncml::Tall::BN : apncml::Short::BN;
}

// Dynamic shared memory of one CTA for a launch of n rows and m columns, in bytes.
long long apnc_embed_smem_bytes(int n, int m) {
  return (long long)(tall(n, m) ? smem_bytes<apncml::Tall>(m) : smem_bytes<apncml::Short>(m));
}

// X (n, d) f32, L (l, d) f32, R (m, l) f32 -> Y (n, m) f32 with row pitch ldy.
// Returns the CUDA error code of the launch (0 on success).
int apnc_embed_f32(const float* X, const float* L, const float* R, float* Y, int n, int d, int l,
                   int m, int ldy, int kind, float gamma, float coef0, float scale, int degree,
                   void* stream) {
  return launch<float>(X, L, R, Y, n, d, l, m, ldy, kind, gamma, coef0, scale, degree, stream);
}

// As apnc_embed_f32 with X in bf16; accumulation stays f32.
int apnc_embed_bf16(const void* X, const float* L, const float* R, float* Y, int n, int d, int l,
                    int m, int ldy, int kind, float gamma, float coef0, float scale, int degree,
                    void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(X), L, R, Y, n, d, l, m, ldy,
                               kind, gamma, coef0, scale, degree, stream);
}

}  // extern "C"
