// Fused stage kernels K1/K2 for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ag_stage(derivs=1)    K1  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_stage(derivs=True)
//   ag_stage(derivs=0)    K2  agimus_controller_tpu/ops/pallas_costs.py::make_pallas_stage(derivs=False)
// (K3/K4, the terminal kernels, live in terminal_kernels.cu, so the two
// build in parallel; the Pallas stage body inlines
// pallas_dynamics.py::dynamics_terms, as K1/K2 run `dynamics_node`'s math.)
//
// Design. Both kernels gather each node's references themselves: the
// wrapper passes a table by value (`ag::RefTable`, one source pointer,
// row stride and component count per layout key) and the node times, and
// the lanes of a node copy its ref row into shared memory
// (`ag::gather_row`), so the call runs no torch op on the refs and the
// tick's ring-row views are read in place. The constants and inputs come
// in through `copy_in`, every thread's loads issued before its stores.
//   K1: one node per LANES = 16 lanes (the power of two >= 2 NJ, at most
//   32; 8 Panda nodes per 128-thread block, 4 at 16 joints or more). Every
//   lane runs the primal step; lane k the RNEA tangent k of (q, v) and the
//   M^-1 column k, and per cost item the residual's tangent k, writing
//   Jacobian columns into the node's shared scratch (past 16 joints lane k
//   also takes tangents k + 32, ...); after a warp barrier each lane sums
//   the Gauss-Newton terms of the output entries it owns (e = lane mod
//   LANES) in registers and stores each once, so a node's stores are
//   consecutive across its lanes and no output is read back. The per-lane phases are the host/device
//   functions `ag::k1_*` of stage_kernels.cuh, which a host harness runs
//   lane by lane (tests/test_torch_stage_lanes.py).
//   K2: 32 nodes per 64-thread block; warp 0 runs the step of the 32
//   nodes, warp 1 their cost items, so a node's latency is the longer of
//   the two chains and not their sum (measured against the one-warp form
//   with the same gather: about half the time at the tick shape); x+
//   leaves through shared memory, coalesced.
//
// What bounds it on this card: latency, not bandwidth (PERF.md has the
// numbers). At the tick shape (N = 19-100, a few blocks) a K1 call lasts
// one lane's chain: the primal step, one dual RNEA pass and one dual pass
// per cost item, where the one-thread design ran ~30 dual passes in
// sequence; a K2 call the longer of the step and the cost items. At
// N = 102 400 K1 is slower than the one-thread design: every lane repeats
// the primal step, so a node issues 16 primal steps where it issued one,
// and each thread works through a 3 KB local frame (the per-joint arrays
// of the tree recursions are indexed by runtime parent indices and stay in
// local memory; no spills). More warps do not help: capped at 168
// registers (three blocks per SM instead of two) K1 measured slower. The
// main paths call K1/K2 only at the tick shape.
//
// One library per joint count: the source is compiled with -DAG_NJ=<nj>
// (ops/_build.py) and holds that one instance of each kernel.
//
// Launch discipline: on the caller's stream, no synchronisation, no
// allocation; `ag_stage` returns cudaGetLastError() of its launch, or the
// error of a block that needs more shared memory than the card gives one.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "stage_kernels.cuh"

namespace {

using ag::copy_in;
using ag::kBlock;
using ag::kK2Nodes;

template <int NJ>
__global__ void __launch_bounds__(kBlock)
stage_k1_kernel(int N, const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ dt, const long long* __restrict__ t_idx,
                const ag::RefTable tab, int W, const float* consts,
                int consts_len, int n_items, float* xnext, float* Fx,
                float* Fu, float* l, float* lx, float* lu, float* lxx,
                float* lxu, float* luu) {
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
  float* S = sm + ag::round4(consts_len) + node * K::scratch(W);
  const float* C = sm;
  ag::k1_load<NJ>(lane, LANES, stab, t_idx[n], x + n * K::NX, u + n * NJ,
                  dt[n], S);
  __syncwarp(mask);
  ag::K1Lane<NJ> st;
  ag::k1_dynamics<NJ, LANES>(lane, C, S, st, xnext + n * K::NX);
  for (int it = 0; it < n_items; ++it) {
    ag::K1Item o = ag::k1_item_tangent<NJ, LANES>(lane, C, it, S, st);
    __syncwarp(mask);
    ag::k1_item_accumulate<NJ, LANES>(lane, o, S, st);
    __syncwarp(mask);
  }
  ag::k1_store<NJ, LANES>(lane, S, st, n, Fx, Fu, l, lx, lu, lxx, lxu, luu);
}

template <int NJ>
__global__ void __launch_bounds__(2 * kK2Nodes)
stage_k2_kernel(int N, const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ dt, const long long* __restrict__ t_idx,
                const ag::RefTable tab, int W, const float* consts,
                int consts_len, int n_items, float* xnext, float* l) {
  constexpr int NX = 2 * NJ, B = kK2Nodes;
  extern __shared__ float sm[];
  __shared__ ag::RefTable stab;
  if (threadIdx.x == 0) stab = tab;
  float* X = sm + ag::round4(consts_len);  // [B, NX]
  float* U = X + B * NX;                     // [B, NJ]
  float* H = U + B * NJ;                     // [B]
  float* XO = H + B;                         // [B, NX] x+
  float* ROWS = XO + B * NX;                 // [B, W]
  const long long n0 = (long long)blockIdx.x * B;
  const int nb = N - n0 < B ? (int)(N - n0) : B;
  const int tid = threadIdx.x, j = tid % B, warp = tid / B;
  copy_in<8>(sm, consts, consts_len, tid, 2 * B);
  copy_in<4>(X, x + n0 * NX, nb * NX, tid, 2 * B);
  copy_in<2>(U, u + n0 * NJ, nb * NJ, tid, 2 * B);
  copy_in<1>(H, dt + n0, nb, tid, 2 * B);
  __syncthreads();  // stab
  if (j < nb) ag::gather_row<8>(stab, t_idx[n0 + j], warp, 2, ROWS + j * W);
  __syncthreads();
  if (j < nb) {
    if (warp == 0)
      ag::k2_step<NJ>(sm, X + j * NX, U + j * NJ, H[j], XO + j * NX);
    else
      l[n0 + j] = ag::k2_costs<NJ>(sm, n_items, ROWS + j * W, X + j * NX,
                                   U + j * NJ, H[j]);
  }
  __syncthreads();
  for (int i = tid; i < nb * NX; i += 2 * B) xnext[n0 * NX + i] = XO[i];
}

template <int NJ>
cudaError_t launch(bool derivs, int N, const float* x, const float* u,
                   const float* dt, const long long* t_idx,
                   const ag::RefTable& tab, int W, const float* consts,
                   int consts_len, int n_items, float* xnext, float* Fx,
                   float* Fu, float* l, float* lx, float* lu, float* lxx,
                   float* lxu, float* luu, cudaStream_t s) {
  const void* fn = derivs ? (const void*)stage_k1_kernel<NJ>
                          : (const void*)stage_k2_kernel<NJ>;
  const size_t smem =
      sizeof(float) * ag::smem_floats<NJ>(derivs ? ag::KID_K1 : ag::KID_K2,
                                          consts_len, W, n_items);
  // with the static table
  cudaError_t e = ag::allow_smem(fn, smem, sizeof(ag::RefTable));
  if (e != cudaSuccess) return e;
  if (derivs) {
    constexpr int NPB = kBlock / ag::K1Shape<NJ>::LANES;
    stage_k1_kernel<NJ><<<(N + NPB - 1) / NPB, kBlock, smem, s>>>(
        N, x, u, dt, t_idx, tab, W, consts, consts_len, n_items, xnext, Fx,
        Fu, l, lx, lu, lxx, lxu, luu);
  } else {
    constexpr int B = kK2Nodes;
    stage_k2_kernel<NJ><<<(N + B - 1) / B, 2 * B, smem, s>>>(
        N, x, u, dt, t_idx, tab, W, consts, consts_len, n_items, xnext, l);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, 2nj], u [N, nj], dt [N], t_idx [N] (int64 node times), refs the
// source table of the W-float ref row; outputs node-major in the shapes of
// the JAX `make_pallas_stage` run (Fx, Fu, lx ... luu unused and may be
// null when derivs is 0). nj must be the library's AG_NJ.
int ag_stage(int nj, int derivs, int N, const float* x, const float* u,
             const float* dt, const long long* t_idx,
             const ag::RefTable* refs, int W, const float* consts,
             int consts_len, int n_items, float* xnext, float* Fx, float* Fu,
             float* l, float* lx, float* lu, float* lxx, float* lxu,
             float* luu, void* stream) {
  if (N <= 0) return 0;
  if (refs->n < 0 || refs->n > ag::kMaxRefs) return (int)cudaErrorInvalidValue;
  if (nj != AG_NJ) return (int)cudaErrorInvalidValue;
  return (int)launch<AG_NJ>(derivs != 0, N, x, u, dt, t_idx, *refs, W, consts,
                            consts_len, n_items, xnext, Fx, Fu, l, lx, lu,
                            lxx, lxu, luu, (cudaStream_t)stream);
}

const char* ag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The joint count of this library's kernels.
int ag_nj() { return AG_NJ; }

}  // extern "C"
