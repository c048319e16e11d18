// Device-side helpers shared by the kernel sources (not by the host-C++
// build of `stage_kernels.cuh`).
#pragma once

#include <cuda_runtime.h>

namespace ag {

constexpr int kBlock = 128;  // threads per block

// n floats rounded up to 16 bytes, so the shared-memory region after them
// starts aligned.
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

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

}  // namespace ag
