// Terminal-cost kernels K3/K4 for Hopper (sm_90a), with a plain C interface:
// the terminal half of the fused stage kernels, in a source of its own so
// that it compiles in parallel with K1/K2.
//   ag_terminal(derivs=1) K3  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=True)
//   ag_terminal(derivs=0) K4  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=False)
//
// Design. One node per warp, four per 128-thread block. As K1/K2, the
// kernel gathers the node's references itself from the wrapper's source
// table (`ag::RefTable`, by value) at the node time t (the horizon, the
// same for every terminal node): the warp copies the ref row into shared
// memory (`ag::gather_row`), so a call runs no torch op on the refs. K4
// splits the cost items over the lanes, one item a lane
// (`ag::terminal_item_values`), and lane 0 sums their values in the
// table's order; K3 runs the one-thread body `ag::terminal_node` on lane 0
// over the shared row.
//
// What bounds it on this card: latency. The tick calls it at one node, a
// few microseconds of work; before this design the wrapper's torch-side
// gather of the ref row set its time (PERF.md has both).
//
// Launch discipline as stage_kernels.cu: the caller's stream, no
// synchronisation, no allocation, cudaGetLastError() returned.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::copy_in;
using ag::round4;

constexpr int kTermNodes = 4;  // nodes (warps) per block

// Shared memory (floats): the constants, then X [kTermNodes, NX], the ref
// rows [kTermNodes, W] and K4's item values [kTermNodes, n_items].
template <int NJ>
__host__ __device__ int term_smem(int consts_len, int W, int n_items) {
  return round4(consts_len) + round4(kTermNodes * 2 * NJ) +
         kTermNodes * (W + n_items);
}

template <int NJ, bool DERIVS>
__global__ void __launch_bounds__(32 * kTermNodes)
terminal_kernel(int N, const float* __restrict__ x, const ag::RefTable tab,
                int t, int W, const float* consts, int consts_len,
                int n_items, float* l, float* lx, float* lxx) {
  constexpr int NX = 2 * NJ;
  extern __shared__ float sm[];
  __shared__ ag::RefTable stab;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) stab = tab;
  const long long n0 = (long long)blockIdx.x * kTermNodes;
  const int nb = N - n0 < kTermNodes ? (int)(N - n0) : kTermNodes;
  float* X = sm + round4(consts_len);
  float* ROWS = X + round4(kTermNodes * NX);
  float* VALS = ROWS + kTermNodes * W;
  copy_in<8>(sm, consts, consts_len, tid, 32 * kTermNodes);
  copy_in<1>(X, x + n0 * NX, nb * NX, tid, 32 * kTermNodes);
  __syncthreads();  // the constants, the states and stab
  if (warp >= nb) return;  // whole warps only
  const long long n = n0 + warp;
  const float* xn = X + warp * NX;
  float* row = ROWS + warp * W;
  ag::gather_row<1>(stab, t, lane, 32, row);
  __syncwarp();
  if (DERIVS) {
    if (lane == 0)
      ag::terminal_node<NJ>(xn, row, sm, n_items, l + n, lx + n * NX,
                            lxx + n * NX * NX);
    return;
  }
  float* vals = VALS + warp * n_items;
  ag::terminal_item_values<NJ>(lane, xn, row, sm, n_items, vals);
  __syncwarp();
  if (lane == 0) {
    float lv = 0.f;
    for (int it = 0; it < n_items; ++it) lv += vals[it];
    l[n] = lv;
  }
}

template <int NJ, bool DERIVS>
cudaError_t launch(int N, const float* x, const ag::RefTable& tab, int t,
                   int W, const float* consts, int consts_len, int n_items,
                   float* l, float* lx, float* lxx, cudaStream_t s) {
  const size_t smem = sizeof(float) * term_smem<NJ>(consts_len, W, n_items);
  if (smem + sizeof(ag::RefTable) > 48 * 1024) {  // with the static table
    cudaError_t e = cudaFuncSetAttribute(
        terminal_kernel<NJ, DERIVS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  terminal_kernel<NJ, DERIVS>
      <<<(N + kTermNodes - 1) / kTermNodes, 32 * kTermNodes, smem, s>>>(
          N, x, tab, t, W, consts, consts_len, n_items, l, lx, lxx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, 2nj]; refs the source table of the W-float ref row, read at node
// time t; outputs l [N] and, when derivs, lx [N, 2nj], lxx [N, 2nj, 2nj]
// (unused and may be null when derivs is 0).
int ag_terminal(int nj, int derivs, int N, const float* x,
                const ag::RefTable* refs, int t, int W, const float* consts,
                int consts_len, int n_items, float* l, float* lx, float* lxx,
                void* stream) {
  if (N <= 0) return 0;
  if (refs->n < 0 || refs->n > ag::kMaxRefs) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AG_TERM(NJ, D) \
  return (int)launch<NJ, D>(N, x, *refs, t, W, consts, consts_len, n_items, \
                            l, lx, lxx, s)
  if (nj == 7 && derivs) AG_TERM(7, true);
  if (nj == 7) AG_TERM(7, false);
  if (nj == 2 && derivs) AG_TERM(2, true);
  if (nj == 2) AG_TERM(2, false);
#undef AG_TERM
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
