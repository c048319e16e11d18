// Host harness of the Riccati sweep kernel (csrc/riccati_kernels.cu): runs
// the per-thread phases of csrc/riccati_kernels.cuh as the kernel places
// them, one scenario after another and, in each phase, thread by thread,
// which is what the kernel's barriers guarantee on the card. The block's
// shared memory starts as NaN, so a read of an entry no phase wrote shows in
// the outputs; step t's inputs are copied into its stage buffer where the
// kernel's cp.async lands them. Built once per joint count with
//   g++ -std=c++17 -O2 -shared -fPIC -DAG_NJ=<nj>
//       -I agimus_controller_tpu_torch/csrc
// by tests/test_torch_riccati_kernel.py and called through ctypes with the
// arguments of `ag_riccati` (no stream); a call for another joint count
// returns 1.

#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

#include "riccati_kernels.cuh"

#if !defined(AG_NJ)
#error "build with -DAG_NJ=<joint count>"
#endif

namespace {

template <int NJ>
void sweep(int T, int B, const float* Fx, const float* Fu, const float* lx,
           const float* lu, const float* lxx, const float* lxu,
           const float* luu, const float* fs, const float* term_lx,
           const float* term_lxx, const float* reg, float* ks, float* Ks,
           float* Qus, float* d1, float* d2, unsigned char* bad) {
  typedef ag::RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU, nt = ag::kRiccatiBlock;
  std::vector<float> smem(R::SIZE);
  float* S = smem.data();
  auto in = [](float* dst, const float* src, int n) {
    std::memcpy(dst, src, sizeof(float) * n);
  };
  for (int b = 0; b < B; ++b) {
    std::fill(smem.begin(), smem.end(),
              std::numeric_limits<float>::quiet_NaN());
    in(S + R::VX, term_lx + (size_t)b * NX, NX);
    in(S + R::VXX, term_lxx + (size_t)b * NX * NX, NX * NX);
    float dd1 = 0.f, dd2 = 0.f;
    bool bd = false;
    for (int t = T - 1, s = 0; t >= 0; --t, s ^= 1) {
      float* I = S + s * R::STAGE;
      const size_t n = (size_t)t * B + b, f = n + B;
      in(I + R::FX, Fx + n * NX * NX, NX * NX);
      in(I + R::FU, Fu + n * NX * NU, NX * NU);
      in(I + R::LXX, lxx + n * NX * NX, NX * NX);
      in(I + R::LXU, lxu + n * NX * NU, NX * NU);
      in(I + R::LUU, luu + n * NU * NU, NU * NU);
      in(I + R::LX, lx + n * NX, NX);
      in(I + R::LU, lu + n * NU, NU);
      in(I + R::F, fs + f * NX, NX);
      for (int tid = 0; tid < nt; ++tid) ag::ric_p1<NJ>(tid, nt, S, I);
      for (int lane = 0; lane < 32; ++lane) ag::ric_quu<NJ>(lane, S, I, reg[b]);
      for (int j = 0; j < NU; ++j) {
        for (int lane = 0; lane < 32; ++lane) ag::ric_chol_dot<NJ>(lane, j, S);
        for (int lane = 0; lane < 32; ++lane)
          ag::ric_chol_scale<NJ>(lane, j, S);
      }
      for (int tid = 32; tid < nt; ++tid) ag::ric_q<NJ>(tid - 32, nt - 32, S, I);
      for (int tid = 0; tid < nt; ++tid) ag::ric_solve<NJ>(tid, nt, S);
      for (int tid = 0; tid < nt; ++tid) ag::ric_p4<NJ>(tid, nt, S, I);
      for (int i = 0; i < NU * NX; ++i) {
        Ks[n * NU * NX + i] = S[R::KK + i];
        bd |= !std::isfinite(S[R::KK + i]);
      }
      for (int u = 0; u < NU; ++u) {
        ks[n * NU + u] = S[R::KV + u];
        bd |= !std::isfinite(S[R::KV + u]);
        Qus[n * NU + u] = S[R::QU + u];
      }
      for (int tid = 0; tid < nt; ++tid)
        ag::ric_p5<NJ>(tid, nt, S, I, &dd1, &dd2);
    }
    d1[b] = dd1;
    d2[b] = dd2;
    bad[b] = bd ? 1 : 0;
  }
}

}  // namespace

extern "C" int ag_riccati_host(int nj, int T, int B, const float* Fx,
                               const float* Fu, const float* lx,
                               const float* lu, const float* lxx,
                               const float* lxu, const float* luu,
                               const float* fs, const float* term_lx,
                               const float* term_lxx, const float* reg,
                               float* ks, float* Ks, float* Qus, float* d1,
                               float* d2, unsigned char* bad) {
  if (nj != AG_NJ) return 1;
  sweep<AG_NJ>(T, B, Fx, Fu, lx, lu, lxx, lxu, luu, fs, term_lx, term_lxx,
               reg, ks, Ks, Qus, d1, d2, bad);
  return 0;
}
