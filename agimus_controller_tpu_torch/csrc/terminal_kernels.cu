// Terminal-cost kernels K3/K4 for Hopper (sm_90a), with a plain C interface:
// the terminal half of the fused stage kernels, in a source of its own so
// that it compiles in parallel with K1/K2. One thread per node over a 1-D
// grid, the ragged edge masked, the packed constants in shared memory and
// the ref rows gathered by the wrapper on the torch side (K1/K2 gather
// them in the kernel); latency-bound, at one node per call in the tick.
// Launch discipline as stage_kernels.cu: the caller's stream, no
// synchronisation, no allocation, cudaGetLastError() returned.
//   ag_terminal(derivs=1) K3  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=True)
//   ag_terminal(derivs=0) K4  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=False)

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::kBlock;

template <int NJ, bool DERIVS>
__global__ void terminal_kernel(int N, const float* x, const float* rows,
                                int W, const float* consts, int consts_len,
                                int n_items, float* l, float* lx, float* lxx) {
  extern __shared__ float C[];
  ag::load_constants(C, consts, consts_len);
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ag::terminal_node<NJ, DERIVS>(n, x, rows, W, C, n_items, l, lx, lxx);
}

}  // namespace

extern "C" {

int ag_terminal(int nj, int derivs, int N, const float* x, const float* rows,
                int W, const float* consts, int consts_len, int n_items,
                float* l, float* lx, float* lxx, void* stream) {
  if (N <= 0) return 0;
  dim3 grid((N + kBlock - 1) / kBlock), block(kBlock);
  size_t smem = (size_t)consts_len * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define AG_TERM(NJ, D)                                                   \
  terminal_kernel<NJ, D><<<grid, block, smem, s>>>(                      \
      N, x, rows, W, consts, consts_len, n_items, l, lx, lxx)
  if (nj == 7 && derivs) AG_TERM(7, true);
  else if (nj == 7) AG_TERM(7, false);
  else if (nj == 2 && derivs) AG_TERM(2, true);
  else if (nj == 2) AG_TERM(2, false);
  else return (int)cudaErrorInvalidValue;
#undef AG_TERM
  return (int)cudaGetLastError();
}

}  // extern "C"
