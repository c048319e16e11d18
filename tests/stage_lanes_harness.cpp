// Host harness of the stage kernels K1/K2 (csrc/stage_kernels.cu): runs the
// per-lane functions of csrc/stage_kernels.cuh as the kernels place them,
// one node after another. K1: each phase lane by lane, which is what the
// warp barriers between the phases guarantee on the card; the node scratch
// starts as NaN, so a read of an entry no lane wrote shows in the outputs.
// K2: warp 0's step, then warp 1's cost items. Built with
//   g++ -std=c++17 -O2 -shared -fPIC -I agimus_controller_tpu_torch/csrc
// by tests/test_torch_stage_lanes.py and called through ctypes with the
// arguments of `ag_stage` (no stream).

#include <cmath>
#include <vector>

#include "stage_kernels.cuh"

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

}  // namespace

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
  if (nj == 7) { AG_HOST(7); }
  if (nj == 2) { AG_HOST(2); }
#undef AG_HOST
  return 1;
}
