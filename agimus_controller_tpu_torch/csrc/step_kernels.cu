// Dynamics-step kernels K5a/K5b for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ag_step(derivs=0)  K5a  agimus_controller_tpu/ops/pallas_dynamics.py::make_pallas_step
//   ag_step(derivs=1)  K5b  agimus_controller_tpu/ops/pallas_dynamics.py::make_pallas_step_derivs
// Semi-implicit Euler step x+ = (q + dt v+, v+), v+ = v + dt M(q)^-1 (u - b(q, v)),
// and with derivs its Jacobians Fx [N, 2NJ, 2NJ], Fu [N, 2NJ, NJ]. Inputs
// and outputs stay node-major, as the callers hold them (the Pallas kernel
// pads to 1024-node blocks in a component-major [c, R, 128] layout).
//
// K5a: one node on LANES = 8 lanes (the power of two >= NJ + 1, at most 32;
// 16 Panda nodes per 128-thread block, 4 lanes and 32 nodes for the 2-DoF
// arm, 16 lanes and 8 nodes for the 8-joint Tiago-Pro arm, 32 lanes and 4
// nodes for the 17-joint Tiago-Pro), in
// K5b's first two phases and a finish of its own (`ag::k5_place`,
// `k5_mass_bias`, `k5a_finish` of stage_kernels.cuh), with a warp barrier
// between them: the joint placements one per lane; the mass-matrix columns
// one per lane beside the bias rnea(q, v, 0) on lane NJ; on lane 0 the
// Cholesky factor, a = M^-1 (u - b) and x+, into shared memory, which the
// block stores at consecutive addresses. A node's chain is one placement,
// the bias RNEA and the factor and solve, where the one-thread design
// (`ag::dynamics_node`, which K2 still runs) also ran the NJ column passes
// in sequence. What bounds it: latency. The batch FDDP's rollout launches
// it once per time step at N = B = 4096 nodes: 256 blocks, a few
// microseconds of arithmetic (PERF.md has the numbers).
//
// K5b: one node on LANES = 16 lanes (the power of two >= 2 NJ, at most 32;
// 8 Panda nodes per 128-thread block; past 16 joints lane k takes tangents
// k, k + 32, ...), in the phases `ag::k5_*` of
// stage_kernels.cuh with a warp barrier between them: the joint
// placements one per lane; the mass-matrix columns one per lane beside
// the bias rnea(q, v, 0); on lane 0 the Cholesky factor, the joint
// accelerations and the per-joint values of rnea(q, v, a); then lane k
// the forward-mode derivative of rnea along tangent k of (q, v) around
// those shared values (only joint k's placement carries a q-derivative)
// and the M^-1 column k. The primal step is computed once per node, in
// shared memory; over a serial chain the joint loops unroll, and each
// thread's per-joint forces wait in a shared-memory slot
// (`ag::ForceSlots`), so a thread needs 128 registers and four blocks
// stay resident per SM. x+, Fx and Fu go to shared memory, and the
// block's 128 threads store them at consecutive addresses, 16 bytes a
// thread. What bounds it: latency; the arithmetic (2 NJ tangent passes
// per node) and the bytes (308 floats written per node) would allow
// several times less (PERF.md has the numbers and the variants measured).
//
// One library per joint count: the source is compiled with -DAG_NJ=<nj>
// (ops/_build.py) and holds that one instance of each kernel.
//
// Launch discipline: on the caller's stream, no synchronisation, no
// allocation; `ag_step` returns cudaGetLastError() of its launch, or the
// error of a block that needs more shared memory than the card gives one.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::copy_in;
using ag::copy_out;
using ag::K5aBlock;
using ag::K5Block;
using ag::kBlock;
using ag::round4;

// K5a's shared memory: the constants, then `ag::K5aBlock`.

template <int NJ>
__global__ void __launch_bounds__(kBlock)
step_kernel(int N, const float* __restrict__ x, const float* __restrict__ u,
            const float* __restrict__ dt, const float* consts, int consts_len,
            float* xnext) {
  typedef ag::K5aShape<NJ> K;
  typedef K5aBlock<NJ> B;
  constexpr int NX = B::NX, LANES = K::LANES, NPB = B::NPB;
  extern __shared__ float4 sm4[];
  float* C = reinterpret_cast<float*>(sm4);
  float* sb = C + round4(consts_len);
  const long long n0 = (long long)blockIdx.x * NPB;
  const int nb = N - n0 < NPB ? (int)(N - n0) : NPB;
  const int tid = threadIdx.x;
  copy_in<8>(C, consts, consts_len, tid, kBlock);
  copy_in<1>(sb + B::X, x + n0 * NX, nb * NX, tid, kBlock);
  copy_in<1>(sb + B::U, u + n0 * NJ, nb * NJ, tid, kBlock);
  copy_in<1>(sb + B::H, dt + n0, nb, tid, kBlock);
  __syncthreads();
  const int node = tid / LANES, lane = tid % LANES;
  if (node < nb) {  // whole nodes only: a node's lanes run together
    const unsigned mask =
        (LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u))
        << ((tid % 32) / LANES * LANES);
    const float* xn = sb + B::X + node * NX;
    float* S = sb + B::W + node * K::SIZE;
    const ag::ForceSlots fs{sb + B::DF + tid, kBlock};
    ag::k5_place<NJ, LANES>(lane, C, xn, S);
    __syncwarp(mask);
    ag::k5_mass_bias<NJ, LANES, false>(lane, C, xn, fs, S);
    __syncwarp(mask);
    ag::k5a_finish<NJ>(lane, xn, sb + B::U + node * NJ, sb[B::H + node], S,
                       sb + B::XO + node * NX);
  }
  __syncthreads();
  copy_out(xnext + n0 * NX, sb + B::XO, nb * NX, tid, kBlock);
}

// K5b's blocks per SM: the register cap (128) that lets four stay resident
// measured faster than the compiler's own choice (96 registers, 12 bytes
// spilled) and than 2-3 blocks with more registers (PERF.md).
constexpr int kStepDerivsBlocksPerSM = 4;

// K5b's shared memory: the constants, then `ag::K5Block`.

template <int NJ>
__global__ void __launch_bounds__(kBlock, kStepDerivsBlocksPerSM)
step_derivs_kernel(int N, const float* __restrict__ x,
                   const float* __restrict__ u, const float* __restrict__ dt,
                   const float* consts, int consts_len, float* xnext,
                   float* Fx, float* Fu) {
  typedef ag::K5Shape<NJ> K;
  typedef K5Block<NJ> B;
  constexpr int NX = K::NX, LANES = K::LANES, NPB = B::NPB;
  extern __shared__ float4 sm4[];
  float* C = reinterpret_cast<float*>(sm4);
  float* sb = C + round4(consts_len);
  const long long n0 = (long long)blockIdx.x * NPB;
  const int nb = N - n0 < NPB ? (int)(N - n0) : NPB;
  const int tid = threadIdx.x;
  copy_in<8>(C, consts, consts_len, tid, kBlock);
  copy_in<1>(sb + B::X, x + n0 * NX, nb * NX, tid, kBlock);
  copy_in<1>(sb + B::U, u + n0 * NJ, nb * NJ, tid, kBlock);
  copy_in<1>(sb + B::H, dt + n0, nb, tid, kBlock);
  __syncthreads();
  const int node = tid / LANES, lane = tid % LANES;
  if (node < nb) {  // whole nodes only: a node's lanes run together
    const unsigned mask =
        (LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u))
        << ((tid % 32) / LANES * LANES);
    const float* xn = sb + B::X + node * NX;
    const float h = sb[B::H + node];
    float* S = sb + B::W + node * K::SIZE;
    const ag::ForceSlots fs{sb + B::DF + tid, kBlock};
    ag::k5_place<NJ, LANES>(lane, C, xn, S);
    __syncwarp(mask);
    ag::k5_mass_bias<NJ, LANES>(lane, C, xn, fs, S);
    __syncwarp(mask);
    ag::k5_solve<NJ>(lane, C, xn, sb + B::U + node * NJ, fs, S);
    __syncwarp(mask);
    ag::k5_tangent<NJ>(lane, C, xn, h, S, fs, sb + B::XO + node * NX,
                       sb + B::FX + node * NX * NX,
                       sb + B::FU + node * NX * NJ);
  }
  __syncthreads();
  copy_out(Fx + n0 * NX * NX, sb + B::FX, nb * NX * NX, tid, kBlock);
  copy_out(Fu + n0 * NX * NJ, sb + B::FU, nb * NX * NJ, tid, kBlock);
  copy_out(xnext + n0 * NX, sb + B::XO, nb * NX, tid, kBlock);
}

// The kernel of `derivs` and its block's shared memory in bytes.
template <int NJ>
void kernel_of(bool derivs, int consts_len, const void** fn, size_t* smem) {
  *fn = derivs ? (const void*)step_derivs_kernel<NJ>
               : (const void*)step_kernel<NJ>;
  *smem = sizeof(float) * ag::smem_floats<NJ>(
                              derivs ? ag::KID_K5B : ag::KID_K5A, consts_len,
                              0, 0);
}

template <int NJ>
cudaError_t launch(bool derivs, int N, const float* x, const float* u,
                   const float* dt, const float* consts, int consts_len,
                   float* xnext, float* Fx, float* Fu, cudaStream_t s) {
  const void* fn;
  size_t smem;
  kernel_of<NJ>(derivs, consts_len, &fn, &smem);
  cudaError_t e = ag::allow_smem(fn, smem, 0);
  if (e != cudaSuccess) return e;
  if (!derivs) {
    step_kernel<NJ><<<(N + K5aBlock<NJ>::NPB - 1) / K5aBlock<NJ>::NPB,
                      kBlock, smem, s>>>(N, x, u, dt, consts, consts_len,
                                         xnext);
  } else {
    step_derivs_kernel<NJ><<<(N + K5Block<NJ>::NPB - 1) / K5Block<NJ>::NPB,
                             kBlock, smem, s>>>(N, x, u, dt, consts,
                                                consts_len, xnext, Fx, Fu);
  }
  return cudaGetLastError();
}

// Blocks of the kernel of `derivs` resident per SM (the occupancy calculator).
template <int NJ>
int blocks_per_sm(bool derivs, int consts_len) {
  const void* fn;
  size_t smem;
  kernel_of<NJ>(derivs, consts_len, &fn, &smem);
  if (ag::allow_smem(fn, smem, 0) != cudaSuccess) return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// nj must be the library's AG_NJ.
int ag_step(int nj, int derivs, int N, const float* x, const float* u,
            const float* dt, const float* consts, int consts_len,
            float* xnext, float* Fx, float* Fu, void* stream) {
  if (N <= 0) return 0;
  if (nj != AG_NJ) return (int)cudaErrorInvalidValue;
  return (int)launch<AG_NJ>(derivs != 0, N, x, u, dt, consts, consts_len,
                            xnext, Fx, Fu, (cudaStream_t)stream);
}

// Blocks of ag_step's kernel resident per SM on the current device, or -1.
int ag_step_blocks_per_sm(int nj, int derivs, int consts_len) {
  if (nj != AG_NJ) return -1;
  return blocks_per_sm<AG_NJ>(derivs != 0, consts_len);
}

}  // extern "C"
