// Causal flash attention for Hopper (sm_90a): softmax(q k^T * scale) v with an
// optional sliding window and grouped KV heads, online max and sum, the
// (S, S) scores never in device memory.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_bhsd
// (_flash_kernel), the Pallas TPU kernel.
//
// Bound on an H100 SXM: operations. Per query head a causal pass takes
// 4 * Dh * S(S+1)/2 operations (q k^T and p v, the exp left out) and moves
// q, k, v and o once; at the serving path's shape (B*H = 64, S = 4,096,
// Dh = 64, f32) that is 1.37e11 FLOP, 2.05 ms at the 67 TFLOP/s f32 FMA rate,
// against 268 MB, 0.08 ms at 3.35 TB/s. This kernel runs the products on the
// tensor cores as 3xTF32 (three TF32 products per f32 product): 4.1e11 TF32
// operations, 0.83 ms at 495 TFLOP/s.
//
// Design (redesigned for Hopper; the first port ran every product as a SIMT
// f32 FMA with a 4 x 4 register tile, K and V staged synchronously with
// bank-conflicted transposed stores, and P through shared memory: 1.17x
// slower than scaled_dot_product_attention at Dh = 64, 1.95x at Dh = 128):
//  * Both products on the tensor cores, mma.sync.m16n8k8 TF32 with f32
//    accumulators. Each f32 operand x is split into hi = tf32(x) and
//    lo = tf32(x - hi) with integer masks (see split), and a.b is summed as
//    a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps the products near f32
//    accuracy (one TF32 pass would not hold the f32 tolerances). A bf16
//    value is exact in TF32, so with bf16 inputs q k^T takes one pass and
//    p v two (P is split, V is not). wgmma's TF32 form wants a K-major B, which V (head dim
//    contiguous) is not; mma.sync takes it as it lies.
//  * One CTA owns one (batch, head, 64-row query tile): 4 warps, each 16
//    query rows. Q is staged once, in f32. K and V come by cp.async
//    (16-byte copies, zero-filled past S and Dh) into a 2-stage ring of
//    BK-key tiles, the next tile in flight while this one computes, one
//    barrier a tile. BK = 32 (64 for bf16 at Dh <= 64), so a CTA takes
//    53 KB at Dh <= 64 (four CTAs a SM, at most 128 registers a thread),
//    101 KB at Dh <= 128 (two) and 197 KB at 256, in f32; bf16 K and V take
//    half. Unaligned strides or a head dim that is not a multiple of 16
//    bytes take plain loads into the same ring.
//  * The fragment layouts. Within each 8-wide k-step of both products the
//    order of the summed index is free, so position t of the m16n8k8
//    A and B fragments stands for index 2t and position t + 4 for 2t + 1.
//    Then a thread's A fragment of P is exactly the four scores of its
//    m16n8 accumulator tile, in registers (no shuffles and no round trip
//    through shared memory), and its q and k fragments are float2 reads.
//    Pitches of Dh + 8 (Q, K) and Dh + 4 (f32 V) make every fragment read
//    conflict-free.
//  * Live key tiles only: a tile is live when kv_start <= q_end and, with a
//    window, kv_end > q_start - window (the TPU kernel's @pl.when skip, as a
//    loop bound); the masks are applied only on tiles that need them.
//  * The arithmetic of the reference, in its order: masked scores -inf,
//    m from -1e30, m_new = max(m, rowmax), p = exp(s - m_new),
//    alpha = exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha + p v,
//    out = acc / max(l, 1e-30); the scores and m are kept in base 2 (log2 e
//    folded into the scale) so each exp is one exp2f, no --use_fast_math.
//    A row's max and sum are quad shuffles; m, l and the accumulator stay
//    in registers.
//  * Grouped KV heads: query head h reads KV head h / (H / Hkv) in place,
//    with no repeated copy of k and v.
//  * Query tiles are issued longest first. No atomics: every bit is the
//    same run to run. q, k, v and o are read and written in the model's
//    (B, S, H, Dh) layout through their strides (the head dim contiguous).
//    f32 or bf16 in, f32 arithmetic, output in the input's type (bf16
//    rounded to nearest even, as torch rounds).
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int WARPS = 4;      // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int NS = 2;         // ring stages of K / V tiles
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((unsigned)x << 16); }
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

// Tile shapes for element type T at the padded head dim DP.
template <typename T, int DP>
struct Tiles {
  static constexpr int BK = DP <= 64 && sizeof(T) == 2 ? 64 : 32;  // keys per tile
  static constexpr int NT = BK / 8;                               // 8-key blocks of a tile
  static constexpr int QP = DP + 8;                               // Q pitch, floats
  static constexpr int KP = DP + 8;                               // K pitch, elements
  static constexpr int VP = sizeof(T) == 4 ? DP + 4 : DP + 8;     // V pitch, elements
  static constexpr size_t Q_BYTES = sizeof(float) * BQ * QP;
  static constexpr size_t K_BYTES = sizeof(T) * BK * KP;
  static constexpr size_t STAGE_BYTES = K_BYTES + sizeof(T) * BK * VP;
  static constexpr size_t SMEM = Q_BYTES + NS * STAGE_BYTES;
  static constexpr bool EXACT = sizeof(T) == 2;                   // bf16: exact in TF32
  static_assert(Q_BYTES % 16 == 0 && K_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte aligned tiles");
};

// x = hi + lo + O(2^-21 |x|) with hi, lo TF32: hi is x rounded to TF32 (to
// nearest, ties away), lo the exact residual x - hi truncated to TF32. Integer
// and f32 ops only: cvt.rna.tf32.f32 issues at a fraction of their rate, on
// the pipe the exp also needs (tools/kernel_ablation.py's cvt_split prices it).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b for one m16n8k8 TF32 tile, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over f32 operands as 3xTF32, or as the passes an exact b (and,
// with EXACT_A, an exact a) needs: the small terms first.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
  if (EXACT_B) {
    if (!EXACT_A) mma(c, alo, __float_as_uint(b0), __float_as_uint(b1));
    mma(c, ahi, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma(c, alo, h0, h1);
    mma(c, ahi, l0, l1);
    mma(c, ahi, h0, h1);
  }
}

// Two consecutive elements of a K row.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const uint16_t* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Issue the copies of key tile [k0, k0 + BK) of k and v into a ring stage
// (one cp.async group), zero past S and Dh.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void load_kv(unsigned char* stage, const T* __restrict__ kb,
                                        const T* __restrict__ vb, long long kss, long long vss,
                                        int k0, int S, int Dh) {
  using TL = Tiles<T, DP>;
  T* ks = reinterpret_cast<T*>(stage);
  T* vs = reinterpret_cast<T*>(stage + TL::K_BYTES);
  if (VEC) {
    // A thread copies the same 16 bytes of every RS-th row: its pointers
    // advance by RS rows a copy, with no index arithmetic in the loop.
    constexpr int CH = 16 / sizeof(T);  // elements a copy
    constexpr int PER_ROW = DP / CH;
    constexpr int RS = THREADS / PER_ROW;
    static_assert(THREADS % PER_ROW == 0 && TL::BK % RS == 0, "whole rows a pass");
    const int r0 = threadIdx.x / PER_ROW, c = (threadIdx.x % PER_ROW) * CH;
    const T* kp = kb + (k0 + r0) * kss + c;
    const T* vp = vb + (k0 + r0) * vss + c;
    const bool in_head = c < Dh;
#pragma unroll
    for (int i = 0; i < TL::BK / RS; ++i, kp += RS * kss, vp += RS * vss) {
      const int r = r0 + i * RS;
      const bool ok = in_head && k0 + r < S;
      cpasync::copy16(reinterpret_cast<float*>(ks + r * TL::KP + c),
                      reinterpret_cast<const float*>(ok ? kp : kb), ok);
      cpasync::copy16(reinterpret_cast<float*>(vs + r * TL::VP + c),
                      reinterpret_cast<const float*>(ok ? vp : vb), ok);
    }
  } else {
    for (int e = threadIdx.x; e < TL::BK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const bool ok = k0 + r < S && c < Dh;
      ks[r * TL::KP + c] = ok ? kb[(k0 + r) * kss + c] : T(0);
      vs[r * TL::VP + c] = ok ? vb[(k0 + r) * vss + c] : T(0);
    }
  }
  cpasync::commit();
}

template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 4 : 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H, int group,
             int S, int Dh, int window, float scale) {
  using TL = Tiles<T, DP>;
  constexpr int BK = TL::BK, NT = TL::NT, ND = DP / 8;
  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // Q: qs[r * QP + d], f32
  unsigned char* ring = smem + TL::Q_BYTES;     // NS x (K tile, V tile)

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;  // the mma fragments' group and thread in group
  const int m0 = (t >> 5) * 16;            // the warp's first query row in the tile
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest rows first
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / group) * sk.h;
  const T* vb = v + b * sv.b + (h / group) * sv.h;
  T* ob = o + b * so.b + h * so.h;

  // The live key tiles: kv_start <= q_end, and with a window
  // kv_start + BK - 1 > q0 - window.
  const int j_hi = min(q0 + BQ - 1, S - 1) / BK;
  int j_lo = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 2;  // least live kv_start
    j_lo = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }
  load_kv<T, DP, VEC>(ring, kb, vb, sk.s, sv.s, j_lo * BK, S, Dh);

  for (int e = t; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const int row = q0 + r;
    qs[r * TL::QP + d] = (row < S && d < Dh) ? widen(qb[row * sq.s + d]) : 0.0f;
  }

  float acc[ND][4];
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    cpasync::wait<0>();
    __syncthreads();  // tile j (and Q) visible; every thread is done with tile j - 1
    if (j < j_hi)
      load_kv<T, DP, VEC>(ring + ((j + 1 - j_lo) % NS) * TL::STAGE_BYTES, kb, vb, sk.s, sv.s,
                          k0 + BK, S, Dh);
    const unsigned char* stage = ring + ((j - j_lo) % NS) * TL::STAGE_BYTES;
    const T* kt = reinterpret_cast<const T*>(stage);
    const T* vt = reinterpret_cast<const T*>(stage + TL::K_BYTES);

    // S = Q K^T: 16 rows x BK keys a warp, NT accumulator tiles.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < ND; ++kk) {
      const float2 qa = *reinterpret_cast<const float2*>(qs + (m0 + g) * TL::QP + kk * 8 + 2 * tq);
      const float2 qc =
          *reinterpret_cast<const float2*>(qs + (m0 + g + 8) * TL::QP + kk * 8 + 2 * tq);
      const float a[4] = {qa.x, qc.x, qa.y, qc.y};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (TL::EXACT) {
          ahi[e] = __float_as_uint(a[e]);
          alo[e] = 0u;
        } else {
          split(a[e], ahi[e], alo[e]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv = load2(kt + (nt * 8 + g) * TL::KP + kk * 8 + 2 * tq);
        mma3<TL::EXACT, TL::EXACT>(s[nt], ahi, alo, kv.x, kv.y);
      }
    }

    // Online softmax over the tile: a thread holds rows g and g + 8, keys
    // nt * 8 + 2 tq + {0, 1}; a row's 8 key blocks span the 4 threads of a quad.
    const bool full = k0 + BK - 1 <= q0 && k0 + BK <= S &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + m0 + g + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + nt * 8 + 2 * tq + e;
          const bool ok = full || (col < S && col <= row && (window <= 0 || row - col < window));
          const float x = ok ? s[nt][2 * hh + e] * scale2 : -INFINITY;
          s[nt][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nt][2 * hh + e] - m_new);
          s[nt][2 * hh + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = exp2f(m_run[hh] - m_new);
      l_run[hh] = l_run[hh] * alpha + sum;
      m_run[hh] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * hh] *= alpha;
        acc[nd][2 * hh + 1] *= alpha;
      }
    }

    // acc += P V: P's A fragment is the thread's own accumulator tile.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t phi[4], plo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], phi[e], plo[e]);
      const T* vr = vt + (kk * 8 + 2 * tq) * TL::VP + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        mma3<false, TL::EXACT>(acc[nd], phi, plo, widen(vr[nd * 8]), widen(vr[TL::VP + nd * 8]));
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + m0 + g + 8 * hh;
    if (row >= S) continue;
    const float den = fmaxf(l_run[hh], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * tq + e;
        if (d < Dh) store(ob + row * so.s + d, acc[nd][2 * hh + e] / den);
      }
  }
}

template <typename T, int DP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const long long* st,
                   int B, int S, int H, int Hkv, int Dh, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = Tiles<T, DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  flash_kernel<T, DP, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, H, H / Hkv, S, Dh, window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t by_copies(bool vec, const void* q, const void* k, const void* v, void* o,
                      const long long* st, int B, int S, int H, int Hkv, int Dh, int window,
                      float scale, cudaStream_t s) {
  return vec ? launch<T, DP, true>(q, k, v, o, st, B, S, H, Hkv, Dh, window, scale, s)
             : launch<T, DP, false>(q, k, v, o, st, B, S, H, Hkv, Dh, window, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const long long* st,
                     int B, int S, int H, int Hkv, int Dh, int window, float scale,
                     cudaStream_t s) {
  // 16-byte copies of K and V: whole copies inside the head dim, aligned rows.
  const long long ch = 16 / sizeof(T);
  bool vec = Dh % ch == 0 && ((size_t)k & 15) == 0 && ((size_t)v & 15) == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % ch == 0;
  if (Dh <= 64) return by_copies<T, 64>(vec, q, k, v, o, st, B, S, H, Hkv, Dh, window, scale, s);
  if (Dh <= 128)
    return by_copies<T, 128>(vec, q, k, v, o, st, B, S, H, Hkv, Dh, window, scale, s);
  return by_copies<T, 256>(vec, q, k, v, o, st, B, S, H, Hkv, Dh, window, scale, s);
}

template <typename T>
long long smem_of(int Dh) {
  if (Dh <= 64) return (long long)Tiles<T, 64>::SMEM;
  if (Dh <= 128) return (long long)Tiles<T, 128>::SMEM;
  return (long long)Tiles<T, 256>::SMEM;
}

}  // namespace

extern "C" {

// Largest head dim one launch takes.
int flash_attention_max_head_dim() { return 256; }

// Dynamic shared memory of one CTA for head dim Dh, f32 (bf16 = 0) or bf16
// inputs, in bytes.
long long flash_attention_smem_bytes(int Dh, int bf16) {
  return bf16 ? smem_of<uint16_t>(Dh) : smem_of<float>(Dh);
}

// q, o (B, S, H, Dh) and k, v (B, S, Hkv, Dh), f32 (bf16 = 0) or bf16 bits
// (bf16 = 1), the head dim contiguous, H a multiple of Hkv; strides[12] =
// (batch, seq, head) strides in elements of q, k, v and o, in that order.
// Query head h reads KV head h / (H / Hkv). Causal, positions = row
// indices, and with window > 0 only keys with row - col < window. scale
// multiplies q k^T. Returns the CUDA error code of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o, int bf16, int B, int S,
                    int H, int Hkv, int Dh, const long long* strides, int window, float scale,
                    void* stream) {
  if (Dh < 1 || Dh > 256 || S < 1 || B * H < 1 || Hkv < 1 || H % Hkv != 0 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      bf16 ? dispatch<uint16_t>(q, k, v, o, strides, B, S, H, Hkv, Dh, window, scale, s)
           : dispatch<float>(q, k, v, o, strides, B, S, H, Hkv, Dh, window, scale, s);
  return (int)err;
}

}  // extern "C"
