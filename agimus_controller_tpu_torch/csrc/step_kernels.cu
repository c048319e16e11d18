// Dynamics-step kernels K5a/K5b for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ag_step(derivs=0)  K5a  agimus_controller_tpu/ops/pallas_dynamics.py::make_pallas_step
//   ag_step(derivs=1)  K5b  agimus_controller_tpu/ops/pallas_dynamics.py::make_pallas_step_derivs
// Semi-implicit Euler step x+ = (q + dt v+, v+), v+ = v + dt M(q)^-1 (u - b(q, v)),
// and with derivs its Jacobians Fx [N, 2NJ, 2NJ], Fu [N, 2NJ, NJ]: the
// device function `ag::dynamics_node` that the stage kernels K1/K2 also run.
//
// Design: one thread per node over a 1-D grid, the ragged edge masked, no
// padding (the Pallas kernel pads to 1024-node blocks in a component-major
// [c, R, 128] layout; here the inputs and outputs stay node-major, as the
// callers hold them). Only the packed model constants (joints and gravity,
// `ops/cuda_dynamics.py::_pack_model`, ~230 floats) go to shared memory.
//
// What bounds it on this card: K5a is latency-bound at the batch FDDP's
// rollout shape (N = B = 4096 nodes, 32 blocks on 132 SMs, one launch per
// time step). K5b writes 308 floats per node against 22 read, so its byte
// bound is small next to its arithmetic: 2 NJ dual-number RNEA passes per
// node, a long scalar program in registers and local memory. This simple
// design does nothing about that yet; the fast design splits a node's
// tangent passes across the lanes of a warp and coalesces the node-major
// Jacobian stores through shared memory.
//
// Launch discipline: on the caller's stream, no synchronisation, no
// allocation; `ag_step` returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::kBlock;

template <int NJ, bool DERIVS>
__global__ void step_kernel(int N, const float* x, const float* u,
                            const float* dt, const float* consts,
                            int consts_len, float* xnext, float* Fx,
                            float* Fu) {
  extern __shared__ float C[];
  ag::load_constants(C, consts, consts_len);
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  constexpr int NX = 2 * NJ;
  float q[NJ], v[NJ], un[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = x[(long)n * NX + i];
    v[i] = x[(long)n * NX + NJ + i];
    un[i] = u[(long)n * NJ + i];
  }
  ag::M3<float> R[NJ];
  ag::V3<float> P[NJ];
  ag::dynamics_node<NJ, DERIVS>(C, q, v, un, dt[n], R, P,
                                xnext + (long)n * NX,
                                DERIVS ? Fx + (long)n * NX * NX : nullptr,
                                DERIVS ? Fu + (long)n * NX * NJ : nullptr);
}

}  // namespace

extern "C" {

int ag_step(int nj, int derivs, int N, const float* x, const float* u,
            const float* dt, const float* consts, int consts_len,
            float* xnext, float* Fx, float* Fu, void* stream) {
  if (N <= 0) return 0;
  dim3 grid((N + kBlock - 1) / kBlock), block(kBlock);
  size_t smem = (size_t)consts_len * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define AG_STEP(NJ, D)                                                    \
  step_kernel<NJ, D><<<grid, block, smem, s>>>(N, x, u, dt, consts,       \
                                                consts_len, xnext, Fx, Fu)
  if (nj == 7 && derivs) AG_STEP(7, true);
  else if (nj == 7) AG_STEP(7, false);
  else if (nj == 2 && derivs) AG_STEP(2, true);
  else if (nj == 2) AG_STEP(2, false);
  else return (int)cudaErrorInvalidValue;
#undef AG_STEP
  return (int)cudaGetLastError();
}

}  // extern "C"
