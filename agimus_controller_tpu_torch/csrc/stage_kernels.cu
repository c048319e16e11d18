// Fused stage kernels K1-K4 for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ag_stage(derivs=1)    K1  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_stage(derivs=True)
//   ag_stage(derivs=0)    K2  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_stage(derivs=False)
//   ag_terminal(derivs=1) K3  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=True)
//   ag_terminal(derivs=0) K4  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=False)
// (the Pallas stage body inlines pallas_dynamics.py::dynamics_terms, as
// stage_node does here).
//
// Design: one thread per node over a 1-D grid, the ragged edge masked. Each
// thread runs a long, branchy scalar program (tree recursions, a Cholesky,
// log maps; templated on the joint count NJ, instantiated for 2 and 7).
// The block first copies the packed model constants and cost descriptors
// (a few KB) into shared memory.
//
// What bounds it on this card: latency and registers, not bandwidth. K1
// does tens of thousands of flops per node (dual-number passes: 2NJ RNEA
// tangents plus NJ tangents per control_grav/frame item) against ~2 KB of
// outputs; the MPC tick has N = 100 nodes, one block, which fills under
// one SM of 132, and the per-thread locals spill to local memory. This
// simple design does nothing about that yet. The fast design will split a
// node's tangent passes across the threads of a warp (one tangent per
// lane), keep the Jacobian columns in shared memory, coalesce the
// node-major stores through shared memory, and fuse K1 with K3.
//
// Launch discipline: on the caller's stream, no synchronisation, no
// allocation; each entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "stage_kernels.cuh"

namespace {

constexpr int kBlock = 128;

__device__ void load_constants(float* C, const float* consts, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) C[i] = consts[i];
  __syncthreads();
}

template <int NJ, bool DERIVS>
__global__ void stage_kernel(int N, const float* x, const float* u,
                             const float* dt, const float* rows, int W,
                             const float* consts, int consts_len, int n_items,
                             float* xnext, float* Fx, float* Fu, float* l,
                             float* lx, float* lu, float* lxx, float* lxu,
                             float* luu) {
  extern __shared__ float C[];
  load_constants(C, consts, consts_len);
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ag::stage_node<NJ, DERIVS>(n, x, u, dt, rows, W, C, n_items, xnext, Fx, Fu,
                             l, lx, lu, lxx, lxu, luu);
}

template <int NJ, bool DERIVS>
__global__ void terminal_kernel(int N, const float* x, const float* rows,
                                int W, const float* consts, int consts_len,
                                int n_items, float* l, float* lx, float* lxx) {
  extern __shared__ float C[];
  load_constants(C, consts, consts_len);
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ag::terminal_node<NJ, DERIVS>(n, x, rows, W, C, n_items, l, lx, lxx);
}

}  // namespace

extern "C" {

int ag_stage(int nj, int derivs, int N, const float* x, const float* u,
             const float* dt, const float* rows, int W, const float* consts,
             int consts_len, int n_items, float* xnext, float* Fx, float* Fu,
             float* l, float* lx, float* lu, float* lxx, float* lxu,
             float* luu, void* stream) {
  if (N <= 0) return 0;
  dim3 grid((N + kBlock - 1) / kBlock), block(kBlock);
  size_t smem = (size_t)consts_len * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define AG_STAGE(NJ, D)                                                     \
  stage_kernel<NJ, D><<<grid, block, smem, s>>>(                            \
      N, x, u, dt, rows, W, consts, consts_len, n_items, xnext, Fx, Fu, l, \
      lx, lu, lxx, lxu, luu)
  if (nj == 7 && derivs) AG_STAGE(7, true);
  else if (nj == 7) AG_STAGE(7, false);
  else if (nj == 2 && derivs) AG_STAGE(2, true);
  else if (nj == 2) AG_STAGE(2, false);
  else return (int)cudaErrorInvalidValue;
#undef AG_STAGE
  return (int)cudaGetLastError();
}

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

const char* ag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
