// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// port's pipelined kernels (lloyd_step.cu's fused_apnc_kernel, rff_embed.cu,
// apnc_assign.cu).
//
// A copy of `bytes` (4 or 16) reads `src_bytes` of them and fills the rest
// with zeros, so a ragged edge is masked by passing 0 (src must still be a
// valid address; callers pass the array's base). Copies are grouped with
// commit(), and wait<N>() blocks until at most N groups are still in flight;
// a __syncthreads() after it makes the data visible to the whole CTA.
#pragma once

#include <cuda_runtime.h>

namespace cpasync {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, through L2 only (.cg): dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes (.ca: the only cache mode for sizes under 16).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// An L2 policy for data read once: its lines are the first to be evicted,
// so a stream of them does not push out what is read again (per-CTA
// partials, centroids). For the *_hint copies.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// copy16 and copy4 under an L2 cache policy.
__device__ __forceinline__ void copy16_hint(float* dst, const float* src, bool valid,
                                            unsigned long long policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0), "l"(policy));
}

__device__ __forceinline__ void copy4_hint(float* dst, const float* src, bool valid,
                                           unsigned long long policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0), "l"(policy));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cpasync
