// Terminal-cost kernels K3/K4 for Hopper (sm_90a), with a plain C interface:
// the terminal half of the fused stage kernels, in a source of its own so
// that it compiles in parallel with K1/K2.
//   ag_terminal(derivs=1) K3  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=True)
//   ag_terminal(derivs=0) K4  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_terminal(derivs=False)
//
// Design. As K1/K2, the kernels gather the node's references themselves
// from the wrapper's source table (`ag::RefTable`, by value) at the node
// time t (the horizon, the same for every terminal node): the node's lanes
// copy the ref row into shared memory (`ag::gather_row`), so a call runs
// no torch op on the refs.
//   K3: one node on LANES = 16 lanes (the power of two >= 2 NJ, at most 32;
//   8 Panda nodes per 128-thread block), K1's cost-item phases at u = 0 and no dt
//   scale: per item, lane k its tangent k of the item's residual into the
//   node's scratch (`ag::k1_item_tangent`), then each lane sums the
//   Gauss-Newton terms of the output entries it owns
//   (`ag::k1_item_accumulate`); `ag::k3_store` writes l, lx and lxx once,
//   at consecutive addresses. A node's chain is one dual pass per item,
//   where the one-thread body (`ag::terminal_node`) ran one per tangent
//   (7 for a frame item, 14 for a frame-velocity item).
//   K4: one node per warp, four per 128-thread block; the cost items one
//   a lane (`ag::terminal_item_values`), lane 0 sums their values in the
//   table's order.
//
// What bounds them on this card: latency. The tick calls them at one node,
// a few microseconds of work (PERF.md has the numbers).
//
// Built, as stage_kernels.cu, once per joint count (-DAG_NJ=<nj>). Launch
// discipline as stage_kernels.cu: the caller's stream, no synchronisation,
// no allocation, cudaGetLastError() returned.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::copy_in;
using ag::round4;

using ag::kBlock;
using ag::kTermNodes;

template <int NJ>
__global__ void __launch_bounds__(kBlock)
terminal_k3_kernel(int N, const float* __restrict__ x, const ag::RefTable tab,
                   int t, int W, const float* consts, int consts_len,
                   int n_items, float* l, float* lx, float* lxx) {
  typedef ag::K1Shape<NJ> K;
  constexpr int LANES = K::LANES, NPB = kBlock / LANES;
  extern __shared__ float sm[];
  __shared__ ag::RefTable stab;
  if (threadIdx.x == 0) stab = tab;
  copy_in<8>(sm, consts, consts_len, threadIdx.x, kBlock);
  __syncthreads();  // the constants and stab
  const int node = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const long long n = (long long)blockIdx.x * NPB + node;
  if (n >= N) return;  // whole nodes only: a node's lanes leave together
  const unsigned mask =
      (LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u))
      << ((threadIdx.x % 32) / LANES * LANES);
  float* S = sm + round4(consts_len) + node * K::scratch(W);
  ag::K1Lane<NJ> st;
  ag::k3_load<NJ, LANES>(lane, stab, t, x + n * K::NX, S, st);
  __syncwarp(mask);
  for (int it = 0; it < n_items; ++it) {
    ag::K1Item o = ag::k1_item_tangent<NJ, LANES>(lane, sm, it, S, st);
    __syncwarp(mask);
    ag::k1_item_accumulate<NJ, LANES>(lane, o, S, st);
    __syncwarp(mask);
  }
  ag::k3_store<NJ, LANES>(lane, st, n, l, lx, lxx);
}

// K4's shared memory (`ag::smem_floats`): the constants, then
// X [kTermNodes, NX], the ref rows [kTermNodes, W] and the item values
// [kTermNodes, n_items].
template <int NJ>
__global__ void __launch_bounds__(32 * kTermNodes)
terminal_k4_kernel(int N, const float* __restrict__ x, const ag::RefTable tab,
                   int t, int W, const float* consts, int consts_len,
                   int n_items, float* l) {
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
  float* vals = VALS + warp * n_items;
  ag::terminal_item_values<NJ>(lane, xn, row, sm, n_items, vals);
  __syncwarp();
  if (lane == 0) {
    float lv = 0.f;
    for (int it = 0; it < n_items; ++it) lv += vals[it];
    l[n] = lv;
  }
}

template <int NJ>
cudaError_t launch(bool derivs, int N, const float* x,
                   const ag::RefTable& tab, int t, int W, const float* consts,
                   int consts_len, int n_items, float* l, float* lx,
                   float* lxx, cudaStream_t s) {
  const void* fn = derivs ? (const void*)terminal_k3_kernel<NJ>
                          : (const void*)terminal_k4_kernel<NJ>;
  const size_t smem =
      sizeof(float) * ag::smem_floats<NJ>(derivs ? ag::KID_K3 : ag::KID_K4,
                                          consts_len, W, n_items);
  // with the static table
  cudaError_t e = ag::allow_smem(fn, smem, sizeof(ag::RefTable));
  if (e != cudaSuccess) return e;
  if (derivs) {
    constexpr int NPB = kBlock / ag::K1Shape<NJ>::LANES;
    terminal_k3_kernel<NJ><<<(N + NPB - 1) / NPB, kBlock, smem, s>>>(
        N, x, tab, t, W, consts, consts_len, n_items, l, lx, lxx);
  } else {
    terminal_k4_kernel<NJ>
        <<<(N + kTermNodes - 1) / kTermNodes, 32 * kTermNodes, smem, s>>>(
            N, x, tab, t, W, consts, consts_len, n_items, l);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, 2nj]; refs the source table of the W-float ref row, read at node
// time t; outputs l [N] and, when derivs, lx [N, 2nj], lxx [N, 2nj, 2nj]
// (unused and may be null when derivs is 0). nj must be the library's
// AG_NJ.
int ag_terminal(int nj, int derivs, int N, const float* x,
                const ag::RefTable* refs, int t, int W, const float* consts,
                int consts_len, int n_items, float* l, float* lx, float* lxx,
                void* stream) {
  if (N <= 0) return 0;
  if (refs->n < 0 || refs->n > ag::kMaxRefs) return (int)cudaErrorInvalidValue;
  if (nj != AG_NJ) return (int)cudaErrorInvalidValue;
  return (int)launch<AG_NJ>(derivs != 0, N, x, *refs, t, W, consts,
                            consts_len, n_items, l, lx, lxx,
                            (cudaStream_t)stream);
}

}  // extern "C"
