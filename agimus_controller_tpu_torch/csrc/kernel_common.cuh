// Device-side helpers shared by the kernel sources (not by the host-C++
// build of `stage_kernels.cuh`).
#pragma once

#include <cuda_runtime.h>

namespace ag {

constexpr int kBlock = 128;  // threads per block, one node each

// Copies the packed constants into the block's shared memory.
__device__ inline void load_constants(float* C, const float* consts,
                                      int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) C[i] = consts[i];
  __syncthreads();
}

}  // namespace ag
