// The batch FDDP's Riccati backward pass for Hopper (sm_90a), with a plain C
// interface: `ag_riccati`, one launch a sweep.
//
// Replaces no TPU kernel: the JAX package's sweep
// (agimus_controller_tpu/solver/riccati_components.py::backward_components)
// is XLA, and the port's plain version of it
// (solver/riccati_components.py::backward_components, whose arithmetic the
// phases of riccati_kernels.cuh keep) dispatches some 3 000 PyTorch ops a
// step at 17 joints: its Cholesky and triangular solves are unrolled into
// one op a scalar over the batch, and every small product broadcasts a
// [n, m, p, B] tensor in device memory before it reduces it. This kernel
// takes the batch FDDP's time-major inputs as they are (Fx [T, B, NX, NX],
// Fu [T, B, NX, NU], lx, lu, lxx, lxu, luu, fs [T+1, B, NX], the terminal
// lx, lxx and reg [B]) and writes ks [T, B, NU], Ks [T, B, NU, NX],
// Qus [T, B, NU], d1, d2 and bad [B], as `backward_components` returns them.
//
// What bounds it: the bytes are each step's inputs read once and its gains
// written once (4 454 floats a node at 17 joints: 0.44 ms for the 81 920
// nodes of B = 4 096, T = 20 at 3.35 TB/s); the operations are ~163 k FMA a
// node (0.40 ms at 67 TFLOP/s fp32). The work of a scenario is a chain of
// T small dense steps, so the design keeps a scenario on one block of 128
// threads for the whole sweep: Vx and Vxx stay in shared memory from step to
// step and never reach device memory; step t-1's inputs arrive by cp.async
// into the second stage buffer while step t computes; the products are
// register tiles of 4 x 4 outputs a thread over shared memory (two 16-float
// loads feed 16 FMA), fp32 FMA on the CUDA cores (the configuration is
// float32 with TF32 off); warp 0 forms Quu and its 17 x 17 Cholesky factor
// while the other warps form Qux, Qu, Qx and Qxx, and the factor's 35
// right-hand sides (Qu and the columns of Qux)
// are solved one a thread. A block takes ~48 KB of shared memory at 17
// joints, so four blocks are resident per SM; the launch has one block a
// scenario.
//
// One library per joint count: the source is compiled with -DAG_NJ=<nj>
// (ops/_build.py), NX = 2 NJ, NU = NJ.
//
// Launch discipline: on the caller's stream, no synchronisation, no
// allocation; `ag_riccati` returns cudaGetLastError() of its launch, or the
// error of a block that needs more shared memory than the card gives one.

#include <cuda_runtime.h>

#include "kernel_common.cuh"
#include "riccati_kernels.cuh"

namespace {

using ag::kRiccatiBlock;
using ag::RicShape;

struct RicArgs {
  int T, B;
  const float *Fx, *Fu, *lx, *lu, *lxx, *lxu, *luu, *fs, *term_lx, *term_lxx,
      *reg;
  float *ks, *Ks, *Qus, *d1, *d2;
  unsigned char* bad;
};

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for every group of this thread but the newest `N`.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of n floats, src to shared dst (16-byte aligned), by
// threads tid of nt: 16 bytes a copy where src is 16-byte aligned, else 8
// or 4 (an input's rows of an odd scenario or step need not be).
__device__ __forceinline__ void async_in(float* dst, const float* src, int n,
                                         int tid, int nt) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t a = (size_t)src;
  int done = 0;
  if ((a & 15) == 0) {
    for (int i = tid; i < n / 4; i += nt) cp_async16(d + 16 * i, src + 4 * i);
    done = n / 4 * 4;
  } else if ((a & 7) == 0) {
    for (int i = tid; i < n / 2; i += nt) cp_async8(d + 8 * i, src + 2 * i);
    done = n / 2 * 2;
  }
  for (int i = done + tid; i < n; i += nt) cp_async4(d + 4 * i, src + i);
}

// Starts the copies of step t's inputs of scenario b into stage buffer I.
template <int NJ>
__device__ __forceinline__ void stage_in(float* I, const RicArgs& a, int t,
                                         int b, int tid) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU, nt = kRiccatiBlock;
  const size_t n = (size_t)t * a.B + b, f = n + a.B;  // fs[t + 1]
  async_in(I + R::FX, a.Fx + n * NX * NX, NX * NX, tid, nt);
  async_in(I + R::FU, a.Fu + n * NX * NU, NX * NU, tid, nt);
  async_in(I + R::LXX, a.lxx + n * NX * NX, NX * NX, tid, nt);
  async_in(I + R::LXU, a.lxu + n * NX * NU, NX * NU, tid, nt);
  async_in(I + R::LUU, a.luu + n * NU * NU, NU * NU, tid, nt);
  async_in(I + R::LX, a.lx + n * NX, NX, tid, nt);
  async_in(I + R::LU, a.lu + n * NU, NU, tid, nt);
  async_in(I + R::F, a.fs + f * NX, NX, tid, nt);
}

// dst[i] = src[i], i < n, by threads tid of nt; true where a value is not
// finite.
__device__ __forceinline__ bool store_out(float* __restrict__ dst,
                                          const float* src, int n, int tid,
                                          int nt) {
  bool bad = false;
  for (int i = tid; i < n; i += nt) {
    const float v = src[i];
    bad |= !isfinite(v);
    dst[i] = v;
  }
  return bad;
}

// Four blocks resident per SM at 17 joints (~48 KB of shared memory each):
// at most 128 registers a thread.
template <int NJ>
__global__ void __launch_bounds__(kRiccatiBlock, 4)
riccati_kernel(const RicArgs a) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU, nt = kRiccatiBlock;
  extern __shared__ float4 sm4[];
  float* S = reinterpret_cast<float*>(sm4);
  const int b = blockIdx.x, tid = threadIdx.x;
  const float reg = a.reg[b];
  async_in(S + R::VX, a.term_lx + (size_t)b * NX, NX, tid, nt);
  async_in(S + R::VXX, a.term_lxx + (size_t)b * NX * NX, NX * NX, tid, nt);
  if (a.T > 0) stage_in<NJ>(S, a, a.T - 1, b, tid);
  cp_async_commit();
  float d1 = 0.f, d2 = 0.f;
  bool bad = false;
  for (int t = a.T - 1, s = 0; t >= 0; --t, s ^= 1) {
    float* I = S + s * R::STAGE;
    // the other buffer was step t+1's; every thread left it at the last
    // barrier of that step
    if (t > 0) stage_in<NJ>(S + (s ^ 1) * R::STAGE, a, t - 1, b, tid);
    cp_async_commit();
    cp_async_wait<1>();  // step t's group (and the prologue's) has landed
    __syncthreads();
    ag::ric_p1<NJ>(tid, nt, S, I);
    __syncthreads();
    if (tid < 32) {
      ag::ric_quu<NJ>(tid, S, I, reg);
      __syncwarp();
      // unrolled: each column's dot product has a fixed length, so its
      // shared-memory reads are scheduled ahead of the sums
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        ag::ric_chol_dot<NJ>(tid, j, S);
        __syncwarp();
        ag::ric_chol_scale<NJ>(tid, j, S);
        __syncwarp();
      }
    } else {
      ag::ric_q<NJ>(tid - 32, nt - 32, S, I);
    }
    __syncthreads();
    ag::ric_solve<NJ>(tid, nt, S);
    __syncthreads();
    ag::ric_p4<NJ>(tid, nt, S, I);
    const size_t n = (size_t)t * a.B + b;
    bad |= store_out(a.Ks + n * NU * NX, S + R::KK, NU * NX, tid, nt);
    bad |= store_out(a.ks + n * NU, S + R::KV, NU, tid, nt);
    store_out(a.Qus + n * NU, S + R::QU, NU, tid, nt);
    __syncthreads();
    ag::ric_p5<NJ>(tid, nt, S, I, &d1, &d2);
    __syncthreads();
  }
  cp_async_wait<0>();  // T = 0: the prologue's copies
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    a.d1[b] = d1;
    a.d2[b] = d2;
    a.bad[b] = bad ? 1 : 0;
  }
}

template <int NJ>
cudaError_t launch(const RicArgs& a, cudaStream_t s) {
  const void* fn = (const void*)riccati_kernel<NJ>;
  constexpr size_t smem = sizeof(float) * (size_t)RicShape<NJ>::SIZE;
  cudaError_t e = ag::allow_smem(fn, smem, 0);
  if (e != cudaSuccess) return e;
  riccati_kernel<NJ><<<a.B, kRiccatiBlock, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nj must be the library's AG_NJ; every array is contiguous, time-major.
int ag_riccati(int nj, int T, int B, const float* Fx, const float* Fu,
               const float* lx, const float* lu, const float* lxx,
               const float* lxu, const float* luu, const float* fs,
               const float* term_lx, const float* term_lxx, const float* reg,
               float* ks, float* Ks, float* Qus, float* d1, float* d2,
               unsigned char* bad, void* stream) {
  if (B <= 0) return 0;
  if (nj != AG_NJ || T < 0) return (int)cudaErrorInvalidValue;
  const RicArgs a{T,   B,  Fx,      Fu,       lx,  lu, lxx,
                  lxu, luu, fs,     term_lx,  term_lxx, reg,
                  ks,  Ks,  Qus,    d1,       d2,  bad};
  return (int)launch<AG_NJ>(a, (cudaStream_t)stream);
}

}  // extern "C"
