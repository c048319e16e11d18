// Host harness of the stage kernels K1/K2 (csrc/stage_kernels.cu), the
// terminal kernels K3/K4 (csrc/terminal_kernels.cu) and the dynamics-step
// kernels K5a/K5b (csrc/step_kernels.cu): runs the per-lane functions of
// csrc/stage_kernels.cuh as the kernels place them, one node after
// another. K1, K3, K5a and K5b: each phase lane by lane, which is what the
// warp barriers between the phases guarantee on the card; the node scratch
// (and K5a's and K5b's output scratch) starts as NaN, so a read of an
// entry no lane wrote shows in the outputs. K2: warp 0's step, then warp
// 1's cost items. K4: the warp's gather of the ref row, then the item
// values lane by lane and their sum. The one-thread bodies the lane
// programs replaced (`ag::dynamics_node`, `ag::terminal_node`) run as
// references. Built once per joint count, as the kernels are, with
//   g++ -std=c++17 -O2 -shared -fPIC -DAG_NJ=<nj>
//       -I agimus_controller_tpu_torch/csrc
// by tests/_torch_lanes_lib.py (for test_torch_stage_lanes.py,
// test_torch_step_lanes.py and test_torch_joint_counts.py) and called
// through ctypes with the arguments of `ag_stage`, `ag_terminal` and
// `ag_step` (no stream; the step and the terminal one-thread body take a
// lane-program switch); a call for another joint count returns 1.

#include <algorithm>
#include <cmath>
#include <vector>

#include "stage_kernels.cuh"

#if !defined(AG_NJ)
#error "build with -DAG_NJ=<joint count>"
#endif

namespace {

template <int NJ>
void k1(int N, const float* x, const float* u, const float* dt,
        const long long* t_idx, const ag::RefTable& tab, int W,
        const float* C, int n_items, float* xnext, float* Fx, float* Fu,
        float* l, float* lx, float* lu, float* lxx, float* lxu, float* luu) {
  typedef ag::K1Shape<NJ> K;
  constexpr int LANES = K::LANES;
  for (long long n = 0; n < N; ++n) {
    std::vector<float> S(K::scratch(W), NAN);
    for (int lane = 0; lane < LANES; ++lane)
      ag::k1_load<NJ>(lane, LANES, tab, t_idx[n], x + n * K::NX, u + n * NJ,
                      dt[n], S.data());
    ag::K1Lane<NJ> st[LANES];
    for (int lane = 0; lane < LANES; ++lane)
      ag::k1_dynamics<NJ, LANES>(lane, C, S.data(), st[lane],
                                 xnext + n * K::NX);
    for (int it = 0; it < n_items; ++it) {
      ag::K1Item o[LANES];
      for (int lane = 0; lane < LANES; ++lane)
        o[lane] = ag::k1_item_tangent<NJ, LANES>(lane, C, it, S.data(),
                                                 st[lane]);
      for (int lane = 0; lane < LANES; ++lane)
        ag::k1_item_accumulate<NJ, LANES>(lane, o[lane], S.data(), st[lane]);
    }
    for (int lane = 0; lane < LANES; ++lane)
      ag::k1_store<NJ, LANES>(lane, S.data(), st[lane], n, Fx, Fu, l, lx, lu,
                              lxx, lxu, luu);
  }
}

template <int NJ>
void k2(int N, const float* x, const float* u, const float* dt,
        const long long* t_idx, const ag::RefTable& tab, int W,
        const float* C, int n_items, float* xnext, float* l) {
  constexpr int NX = 2 * NJ;
  std::vector<float> row(W > 0 ? W : 1, NAN);
  for (long long n = 0; n < N; ++n) {
    for (int lane = 0; lane < 2; ++lane)
      ag::gather_row<8>(tab, t_idx[n], lane, 2, row.data());
    ag::k2_step<NJ>(C, x + n * NX, u + n * NJ, dt[n], xnext + n * NX);
    l[n] = ag::k2_costs<NJ>(C, n_items, row.data(), x + n * NX, u + n * NJ,
                            dt[n]);
  }
}

// K3's phases lane by lane.
template <int NJ>
void k3(int N, const float* x, const ag::RefTable& tab, int t, int W,
        const float* C, int n_items, float* l, float* lx, float* lxx) {
  typedef ag::K1Shape<NJ> K;
  constexpr int LANES = K::LANES;
  for (long long n = 0; n < N; ++n) {
    std::vector<float> S(K::scratch(W), NAN);
    ag::K1Lane<NJ> st[LANES];
    for (int lane = 0; lane < LANES; ++lane)
      ag::k3_load<NJ, LANES>(lane, tab, t, x + n * K::NX, S.data(),
                             st[lane]);
    for (int it = 0; it < n_items; ++it) {
      ag::K1Item o[LANES];
      for (int lane = 0; lane < LANES; ++lane)
        o[lane] = ag::k1_item_tangent<NJ, LANES>(lane, C, it, S.data(),
                                                 st[lane]);
      for (int lane = 0; lane < LANES; ++lane)
        ag::k1_item_accumulate<NJ, LANES>(lane, o[lane], S.data(), st[lane]);
    }
    for (int lane = 0; lane < LANES; ++lane)
      ag::k3_store<NJ, LANES>(lane, st[lane], n, l, lx, lxx);
  }
}

// K3's one-thread body over the gathered row.
template <int NJ>
void terminal_one_thread(int N, const float* x, const ag::RefTable& tab,
                         int t, int W, const float* C, int n_items, float* l,
                         float* lx, float* lxx) {
  constexpr int NX = 2 * NJ;
  std::vector<float> row(W > 0 ? W : 1, NAN);
  for (long long n = 0; n < N; ++n) {
    for (int lane = 0; lane < 32; ++lane)
      ag::gather_row<1>(tab, t, lane, 32, row.data());
    ag::terminal_node<NJ>(x + n * NX, row.data(), C, n_items, l + n,
                          lx + n * NX, lxx + n * NX * NX);
  }
}

template <int NJ>
void k4(int N, const float* x, const ag::RefTable& tab, int t, int W,
        const float* C, int n_items, float* l) {
  constexpr int NX = 2 * NJ;
  std::vector<float> row(W > 0 ? W : 1, NAN);
  std::vector<float> vals(n_items > 0 ? n_items : 1, NAN);
  for (long long n = 0; n < N; ++n) {
    for (int lane = 0; lane < 32; ++lane)
      ag::gather_row<1>(tab, t, lane, 32, row.data());
    for (int lane = 0; lane < 32; ++lane)
      ag::terminal_item_values<NJ>(lane, x + n * NX, row.data(), C, n_items,
                                   vals.data());
    float lv = 0.f;
    for (int it = 0; it < n_items; ++it) lv += vals[it];
    l[n] = lv;
  }
}

// K5a's phases lane by lane (lanes = 1: the one-thread body
// `ag::dynamics_node` that K5a ran before them).
template <int NJ>
void step(int lanes, int N, const float* x, const float* u, const float* dt,
          const float* C, float* xnext) {
  typedef ag::K5aShape<NJ> K;
  constexpr int NX = 2 * NJ;
  for (long long n = 0; n < N; ++n) {
    const float* xn = x + n * NX;
    const float* un = u + n * NJ;
    std::vector<float> S(K::SIZE, NAN), xo(NX, NAN);
    if (lanes == 1) {
      ag::M3<float> R[NJ];
      ag::V3<float> P[NJ];
      ag::dynamics_node<NJ, false>(C, xn, xn + NJ, un, dt[n], R, P,
                                   xo.data(), nullptr, nullptr);
    } else {
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_place<NJ, K::LANES>(lane, C, xn, S.data());
      std::vector<float> df(6 * NJ * K::LANES, NAN);
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_mass_bias<NJ, K::LANES, false>(
            lane, C, xn, ag::ForceSlots{&df[lane], K::LANES}, S.data());
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5a_finish<NJ>(lane, xn, un, dt[n], S.data(), xo.data());
    }
    std::copy(xo.begin(), xo.end(), xnext + n * NX);
  }
}

// K5b's phases lane by lane (lanes = 1: the one-thread body
// `ag::dynamics_node` that K5b ran before them).
template <int NJ>
void step_derivs(int lanes, int N, const float* x, const float* u,
                 const float* dt, const float* C, float* xnext, float* Fx,
                 float* Fu) {
  typedef ag::K5Shape<NJ> K;
  constexpr int NX = K::NX;
  for (long long n = 0; n < N; ++n) {
    const float* xn = x + n * NX;
    const float* un = u + n * NJ;
    std::vector<float> S(K::SIZE, NAN), xo(NX, NAN), fx(NX * NX, NAN),
        fu(NX * NJ, NAN);
    if (lanes == 1) {
      ag::M3<float> R[NJ];
      ag::V3<float> P[NJ];
      ag::dynamics_node<NJ, true>(C, xn, xn + NJ, un, dt[n], R, P, xo.data(),
                                  fx.data(), fu.data());
    } else {
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_place<NJ, K::LANES>(lane, C, xn, S.data());
      // each lane's force slots, thread-minor as in the kernel
      std::vector<float> df(6 * NJ * K::LANES, NAN);
      auto fs = [&](int lane) { return ag::ForceSlots{&df[lane], K::LANES}; };
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_mass_bias<NJ, K::LANES>(lane, C, xn, fs(lane), S.data());
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_solve<NJ>(lane, C, xn, un, fs(lane), S.data());
      for (int lane = 0; lane < K::LANES; ++lane)
        ag::k5_tangent<NJ>(lane, C, xn, dt[n], S.data(), fs(lane), xo.data(),
                           fx.data(), fu.data());
    }
    std::copy(xo.begin(), xo.end(), xnext + n * NX);
    std::copy(fx.begin(), fx.end(), Fx + n * NX * NX);
    std::copy(fu.begin(), fu.end(), Fu + n * NX * NJ);
  }
}

}  // namespace

extern "C" int ag_terminal_host(int nj, int derivs, int N, const float* x,
                                const ag::RefTable* tab, int t, int W,
                                const float* C, int consts_len, int n_items,
                                float* l, float* lx, float* lxx) {
  (void)consts_len;
  if (tab->n < 0 || tab->n > ag::kMaxRefs) return 1;
#define AG_HOST(NJ)                                                        \
  if (derivs)                                                              \
    k3<NJ>(N, x, *tab, t, W, C, n_items, l, lx, lxx);                      \
  else                                                                     \
    k4<NJ>(N, x, *tab, t, W, C, n_items, l);                               \
  return 0
  if (nj == AG_NJ) { AG_HOST(AG_NJ); }
#undef AG_HOST
  return 1;
}

// K3's one-thread body `ag::terminal_node`, with the arguments of
// `ag_terminal` at derivs = 1.
extern "C" int ag_terminal_node_host(int nj, int N, const float* x,
                                     const ag::RefTable* tab, int t, int W,
                                     const float* C, int n_items, float* l,
                                     float* lx, float* lxx) {
  if (tab->n < 0 || tab->n > ag::kMaxRefs) return 1;
  if (nj != AG_NJ) return 1;
  terminal_one_thread<AG_NJ>(N, x, *tab, t, W, C, n_items, l, lx, lxx);
  return 0;
}

// K5a (derivs = 0) or K5b's phases, or with lanes = 1 their one-thread
// body; Fx and Fu unused at derivs = 0.
extern "C" int ag_step_host(int nj, int derivs, int lanes, int N,
                            const float* x, const float* u, const float* dt,
                            const float* C, float* xnext, float* Fx,
                            float* Fu) {
#define AG_HOST(NJ)                                                 \
  if (derivs)                                                       \
    step_derivs<NJ>(lanes, N, x, u, dt, C, xnext, Fx, Fu);          \
  else                                                              \
    step<NJ>(lanes, N, x, u, dt, C, xnext);                         \
  return 0
  if (nj == AG_NJ) { AG_HOST(AG_NJ); }
#undef AG_HOST
  return 1;
}

extern "C" int ag_stage_host(int nj, int derivs, int N, const float* x,
                             const float* u, const float* dt,
                             const long long* t_idx, const ag::RefTable* tab,
                             int W, const float* C, int consts_len,
                             int n_items, float* xnext, float* Fx, float* Fu,
                             float* l, float* lx, float* lu, float* lxx,
                             float* lxu, float* luu) {
  (void)consts_len;
  if (tab->n < 0 || tab->n > ag::kMaxRefs) return 1;
#define AG_HOST(NJ)                                                         \
  if (derivs)                                                               \
    k1<NJ>(N, x, u, dt, t_idx, *tab, W, C, n_items, xnext, Fx, Fu, l, lx,   \
           lu, lxx, lxu, luu);                                              \
  else                                                                      \
    k2<NJ>(N, x, u, dt, t_idx, *tab, W, C, n_items, xnext, l);              \
  return 0
  if (nj == AG_NJ) { AG_HOST(AG_NJ); }
#undef AG_HOST
  return 1;
}

// The dynamic shared memory of one block of kernel `kernel` (`ag::KernelId`,
// K1 = 1 ... K5b = 6) in floats at this joint count (`ag::smem_floats`).
extern "C" int ag_smem_floats_host(int kernel, int consts_len, int W,
                                   int n_items) {
  return ag::smem_floats<AG_NJ>(kernel, consts_len, W, n_items);
}
