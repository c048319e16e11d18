// Device-side helpers shared by the kernel sources (not by the host-C++
// build of `stage_kernels.cuh`, which holds the blocks' shapes).
#pragma once

#include <cuda_runtime.h>

#if !defined(AG_NJ)
#error "build each source with -DAG_NJ=<joint count> (ops/_build.py)"
#endif

namespace ag {

// dst[i] = src[i], i < n, by threads tid of nt: each thread issues G loads
// before their stores, so a few threads do not wait on memory once per value.
template <int G>
__device__ __forceinline__ void copy_in(float* dst, const float* __restrict__ src,
                                        int n, int tid, int nt) {
  for (int base = 0; base < n; base += G * nt) {
    float buf[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int i = base + c * nt + tid;
      buf[c] = i < n ? src[i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int i = base + c * nt + tid;
      if (i < n) dst[i] = buf[c];
    }
  }
}

// dst[i] = src[i], i < n, by threads tid of nt at consecutive addresses:
// 16 bytes a thread where both ends are 16-byte aligned.
__device__ __forceinline__ void copy_out(float* __restrict__ dst,
                                         const float* src, int n, int tid,
                                         int nt) {
  int done = 0;
  if ((((size_t)dst | (size_t)src) & 15) == 0) {
    const int n4 = n / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < n4; i += nt) d4[i] = s4[i];
    done = 4 * n4;
  }
  for (int i = done + tid; i < n; i += nt) dst[i] = src[i];
}

// Sets the kernel's dynamic shared memory where its block needs more than
// the 48 KB a launch gets without asking (with `static_bytes` of static
// shared memory beside it); past the card's opt-in (227 KB a block on
// Hopper) the call fails and its error is returned.
inline cudaError_t allow_smem(const void* fn, size_t smem,
                              size_t static_bytes) {
  if (smem + static_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace ag
