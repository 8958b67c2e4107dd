// Register-tile arithmetic and kernel functions shared by the port's CUDA
// kernels (apnc_embed.cu, apnc_assign.cu, lloyd_step.cu, rff_embed.cu).
//
// Every kernel computes 4 x 4 outputs a thread from two float4 operands
// staged in shared memory, in a fixed order of explicit fmaf, so two kernels
// that walk the same tiles in the same order give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace tilemath {

__device__ __forceinline__ void fma_4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Distance accumulation: sum |a_i - b_j| for l1, the dot product for l2
// (whose yy - 2 y.c + cc the caller completes).
template <bool L1>
__device__ __forceinline__ void dist_4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  if (L1) {
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(av[i] - bv[j]);
  } else {
    fma_4x4(acc, a, b);
  }
}

enum Kind { RBF = 0, POLY = 1, TANH = 2, LINEAR = 3 };

struct KParams {
  int kind;
  float gamma;
  float coef0;
  float scale;
  int degree;
};

// kappa(x, l) from s = x.l and, for rbf, the norms |x|^2 and |l|^2
// (d^2 clamped at 0 before exp, as in the TPU kernel).
__device__ __forceinline__ float nonlin(float s, float xx, float ll, const KParams& kp) {
  switch (kp.kind) {
    case RBF: {
      const float d2 = fmaxf(xx - 2.0f * s + ll, 0.0f);
      return expf(-kp.gamma * d2);
    }
    case POLY: {
      const float b = s + kp.coef0;
      if (kp.degree < 0) return powf(b, (float)kp.degree);
      float r = 1.0f;
      for (int i = 0; i < kp.degree; ++i) r *= b;
      return r;
    }
    case TANH:
      return tanhf(kp.scale * s + kp.coef0);
    default:
      return s;
  }
}

}  // namespace tilemath
