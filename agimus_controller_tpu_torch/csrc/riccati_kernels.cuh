// Per-thread programs of the batch FDDP's Riccati sweep kernel
// (riccati_kernels.cu, `ag_riccati`): one scenario's backward pass on one
// block, step t = T-1 ... 0, in the phases below with a block barrier
// between each two. The same math, batch-minor in plain PyTorch, is
// `solver/riccati_components.py::backward_components`, whose arithmetic the
// phases keep: the same products, the Cholesky factor of Quu column by
// column, the same order of the substitutions' sums, and
// Vxx = Qxx - 0.5 (QK + QK^T).
//
// Like stage_kernels.cuh, every function here is `__host__ __device__` and
// free of CUDA built-ins (a thread index is an argument, the kernel places
// the barriers and the copies), so the header also compiles as host C++ and
// tests/riccati_lanes_harness.cpp runs a sweep thread by thread.
//
// A block's shared memory (`RicShape`, floats): two stage buffers of one
// step's inputs (the kernel fills the one of step t-1 while step t
// computes), the value function Vx, Vxx of step t+1, and the step's
// products. Per step t, with F = Fx, G = Fu, f = fs[t+1]:
//   p1        M = Vxx F, N = Vxx G, Vxp = Vx + Vxx f
//   p2        warp 0: Quu = luu + G^T N + reg I (also the factor's start),
//             then its Cholesky factor column by column (`chol_dot`,
//             `chol_scale`, a warp barrier after each); the other warps:
//             Qux = lxu^T + G^T M, Qu = lu + G^T Vxp, Qx = lx + F^T Vxp and
//             Qxx = lxx + F^T M (in place of lxx)
//   p3        threads 0 ... NX: KK = Quu^-1 Qux (a column a thread) and
//             kk = Quu^-1 Qu (thread NX)
//   p4        QK = Qux^T KK (in place of M), Vx = Qx - Qux^T kk, the
//             per-u parts of Qu . kk and kk^T Quu kk
//   p5        Vxx = Qxx - 0.5 (QK + QK^T); thread 0 adds the parts to d1, d2
#pragma once

#include "stage_kernels.cuh"

namespace ag {

constexpr int kRiccatiBlock = 128;  // threads of one scenario's block

// The block's shared memory in floats; each region starts 16-byte aligned.
// A stage buffer holds step t's Fx [NX, NX], Fu [NX, NU], lxx [NX, NX],
// lxu [NX, NU], luu [NU, NU], lx [NX], lu [NU] and fs[t+1] [NX], row-major
// as the inputs; p2 turns luu into Quu and lxx into Qxx.
template <int NJ> struct RicShape {
  static constexpr int NX = 2 * NJ, NU = NJ;
  static constexpr int FX = 0, FU = FX + round4(NX * NX),
                       LXX = FU + round4(NX * NU),
                       LXU = LXX + round4(NX * NX),
                       LUU = LXU + round4(NX * NU),
                       LX = LUU + round4(NU * NU), LU = LX + round4(NX),
                       F = LU + round4(NU), STAGE = F + round4(NX);
  // after the two stage buffers: Vxx, Vx; M = Vxx Fx (then QK), N = Vxx Fu,
  // Vxp, Qx, Qu, Qux [NU, NX], the factor L [NU, NU] (lower triangle),
  // KK [NU, NX], kk, and the per-u parts of d1 and d2
  static constexpr int VXX = 2 * STAGE, VX = VXX + round4(NX * NX),
                       M = VX + round4(NX), N = M + round4(NX * NX),
                       VXP = N + round4(NX * NU), QX = VXP + round4(NX),
                       QU = QX + round4(NX), QUX = QU + round4(NU),
                       L = QUX + round4(NU * NX), KK = L + round4(NU * NU),
                       KV = KK + round4(NU * NX), D1 = KV + round4(NU),
                       D2 = D1 + round4(NU), SIZE = D2 + round4(NU);
};

// ---- small products ---------------------------------------------------------
// C = A B, C [M, N], over a thread's RM x RN tile of C; A(m, k) =
// a[m * AM + k * AK], B(k, n) = b[k * BK + n * BN]; the sum runs over k in
// order from 0, then `out(m, n, sum)`. A tile holds rows tm, tm + TM, ...
// and columns tn, tn + TN, ..., so a warp's threads (neighbouring tn) read
// neighbouring columns of B. Tile g of the call is thread (g + off) % nt's:
// calls of one phase chain `off` (each returns off + its tiles), so their
// tiles spread over the block's threads in turn.
template <int M, int N, int K, int RM, int RN, int AM, int AK, int BK, int BN,
          class Out>
AG_FN int gemm(int tid, int nt, int off, const float* a, const float* b,
               const Out& out) {
  constexpr int TM = (M + RM - 1) / RM, TN = (N + RN - 1) / RN;
  for (int g = ((tid - off) % nt + nt) % nt; g < TM * TN; g += nt) {
    const int tm = g / TN, tn = g % TN;
    int mi[RM], ni[RN];
    float acc[RM][RN];
    AG_UNROLL
    for (int r = 0; r < RM; ++r) {
      const int m = tm + r * TM;
      mi[r] = (m < M ? m : M - 1) * AM;  // the ragged edge reads a valid row
    }
    AG_UNROLL
    for (int c = 0; c < RN; ++c) {
      const int n = tn + c * TN;
      ni[c] = (n < N ? n : N - 1) * BN;
    }
    AG_UNROLL
    for (int r = 0; r < RM; ++r) {
      AG_UNROLL
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      float av[RM], bv[RN];
      AG_UNROLL
      for (int r = 0; r < RM; ++r) av[r] = a[mi[r] + k * AK];
      AG_UNROLL
      for (int c = 0; c < RN; ++c) bv[c] = b[k * BK + ni[c]];
      AG_UNROLL
      for (int r = 0; r < RM; ++r) {
        AG_UNROLL
        for (int c = 0; c < RN; ++c) acc[r][c] += av[r] * bv[c];
      }
    }
    AG_UNROLL
    for (int r = 0; r < RM; ++r) {
      AG_UNROLL
      for (int c = 0; c < RN; ++c) {
        const int m = tm + r * TM, n = tn + c * TN;
        if (m < M && n < N) out(m, n, acc[r][c]);
      }
    }
  }
  return off + TM * TN;
}

// The products' epilogues: o[m * OM + n] = s (Put), = p[m * PM + n * PN] + s
// (Add), = p[m] - s (SubV); Quu's adds reg on the diagonal and also starts
// the factor; Parts writes kk_m Qu_m and kk_m (Quu kk)_m.
template <int OM> struct Put {
  float* o;
  AG_HD void operator()(int m, int n, float s) const { o[m * OM + n] = s; }
};
template <int OM, int PM, int PN> struct Add {
  float* o;
  const float* p;
  AG_HD void operator()(int m, int n, float s) const {
    o[m * OM + n] = p[m * PM + n * PN] + s;
  }
};
struct SubV {
  float* o;
  const float* p;
  AG_HD void operator()(int m, int, float s) const { o[m] = p[m] - s; }
};
template <int NU> struct QuuOut {
  float* quu;  // luu in, Quu out
  float* L;
  float reg;
  AG_HD void operator()(int m, int n, float s) const {
    float v = quu[m * NU + n] + s;
    if (m == n) v = v + reg;
    quu[m * NU + n] = v;
    L[m * NU + n] = v;
  }
};
struct Parts {
  float* d1;
  float* d2;
  const float* kk;
  const float* qu;
  AG_HD void operator()(int m, int, float s) const {
    d1[m] = qu[m] * kk[m];
    d2[m] = kk[m] * s;
  }
};

// ---- the phases -------------------------------------------------------------
// S: the block's shared memory; I: step t's stage buffer (`RicShape`).

template <int NJ>
AG_FN void ric_p1(int tid, int nt, float* S, const float* I) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  const float* V = S + R::VXX;
  int off = gemm<NX, NX, NX, 4, 4, NX, 1, NX, 1>(tid, nt, 0, V, I + R::FX,
                                                 Put<NX>{S + R::M});
  off = gemm<NX, NU, NX, 4, 4, NX, 1, NU, 1>(tid, nt, off, V, I + R::FU,
                                             Put<NU>{S + R::N});
  gemm<NX, 1, NX, 4, 1, NX, 1, 1, 1>(tid, nt, off, V, I + R::F,
                                     Add<1, 1, 0>{S + R::VXP, S + R::VX});
}

// p2 on warp 0: Quu = luu + G^T N + reg I, into luu and the factor's
// start; then the factor (`ric_chol_dot`, `ric_chol_scale`).
template <int NJ>
AG_FN void ric_quu(int lane, float* S, float* I, float reg) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  gemm<NU, NU, NX, 4, 4, 1, NU, NU, 1>(lane, 32, 0, I + R::FU, S + R::N,
                                       QuuOut<NU>{I + R::LUU, S + R::L, reg});
}

// p2 on the threads past warp 0 (tid and nt counted from thread 32): Qux,
// Qu, Qx, then Qxx in place of lxx.
template <int NJ>
AG_FN void ric_q(int tid, int nt, float* S, float* I) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  const float* G = I + R::FU;  // G^T(m, k) = G[k * NU + m]
  const float* F = I + R::FX;  // F^T(m, k) = F[k * NX + m]
  int off = gemm<NU, NX, NX, 4, 4, 1, NU, NX, 1>(
      tid, nt, 0, G, S + R::M, Add<NX, 1, NU>{S + R::QUX, I + R::LXU});
  off = gemm<NU, 1, NX, 4, 1, 1, NU, 1, 1>(tid, nt, off, G, S + R::VXP,
                                           Add<1, 1, 0>{S + R::QU, I + R::LU});
  off = gemm<NX, 1, NX, 4, 1, 1, NX, 1, 1>(tid, nt, off, F, S + R::VXP,
                                           Add<1, 1, 0>{S + R::QX, I + R::LX});
  gemm<NX, NX, NX, 4, 4, 1, NX, NX, 1>(tid, nt, off, F, S + R::M,
                                       Add<NX, NX, 1>{I + R::LXX, I + R::LXX});
}

// p2 on warp 0, column j of the factor (left-looking, as
// `riccati_components._chol_lanes`): lane `lane` takes rows j + lane,
// j + 32 + lane, ... and forms s = Quu[i][j] - sum_k<j L[i][k] L[j][k], the
// terms in the order of k; L[j][j] = sqrt(s), the other rows keep s ...
template <int NJ>
AG_FN void ric_chol_dot(int lane, int j, float* S) {
  constexpr int NU = RicShape<NJ>::NU;
  float* L = S + RicShape<NJ>::L;
  for (int i = j + lane; i < NU; i += 32) {
    float s = L[i * NU + j];
    for (int k = 0; k < j; ++k) s = s - L[i * NU + k] * L[j * NU + k];
    L[i * NU + j] = i == j ? sqrtf(s) : s;
  }
}

// ... then, after a warp barrier, L[i][j] = s * (1 / L[j][j]) below the
// diagonal.
template <int NJ>
AG_FN void ric_chol_scale(int lane, int j, float* S) {
  constexpr int NU = RicShape<NJ>::NU;
  float* L = S + RicShape<NJ>::L;
  const float inv = 1.f / L[j * NU + j];
  for (int i = j + 1 + lane; i < NU; i += 32) L[i * NU + j] = L[i * NU + j] * inv;
}

// p3: thread r < NX solves (L L^T) x = column r of Qux into column r of KK,
// thread NX solves for Qu into kk; the substitutions' sums in the order of
// `riccati_components._chol_solve_lanes`.
template <int NJ>
AG_FN void ric_solve(int tid, int nt, float* S) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  const float* L = S + R::L;
  for (int r = tid; r <= NX; r += nt) {
    float x[NU];
    AG_UNROLL
    for (int u = 0; u < NU; ++u)
      x[u] = r < NX ? S[R::QUX + u * NX + r] : S[R::QU + u];
    AG_UNROLL
    for (int k = 0; k < NU; ++k) {
      x[k] = x[k] / L[k * NU + k];
      AG_UNROLL
      for (int i = k + 1; i < NU; ++i) x[i] = x[i] - L[i * NU + k] * x[k];
    }
    AG_UNROLL
    for (int i = NU - 1; i >= 0; --i) {
      float s = x[i];
      AG_UNROLL
      for (int k = i + 1; k < NU; ++k) s = s - L[k * NU + i] * x[k];
      x[i] = s / L[i * NU + i];
    }
    AG_UNROLL
    for (int u = 0; u < NU; ++u) {
      if (r < NX)
        S[R::KK + u * NX + r] = x[u];
      else
        S[R::KV + u] = x[u];
    }
  }
}

template <int NJ>
AG_FN void ric_p4(int tid, int nt, float* S, const float* I) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  const float* Q = S + R::QUX;  // Qux^T(m, k) = Qux[k * NX + m]
  int off = gemm<NX, NX, NU, 4, 4, 1, NX, NX, 1>(tid, nt, 0, Q, S + R::KK,
                                                 Put<NX>{S + R::M});
  off = gemm<NX, 1, NU, 4, 1, 1, NX, 1, 1>(tid, nt, off, Q, S + R::KV,
                                           SubV{S + R::VX, S + R::QX});
  gemm<NU, 1, NU, 4, 1, NU, 1, 1, 1>(
      tid, nt, off, I + R::LUU, S + R::KV,
      Parts{S + R::D1, S + R::D2, S + R::KV, S + R::QU});
}

// p5; thread 0 carries d1 and d2 across the steps.
template <int NJ>
AG_FN void ric_p5(int tid, int nt, float* S, const float* I, float* d1,
                  float* d2) {
  typedef RicShape<NJ> R;
  constexpr int NX = R::NX, NU = R::NU;
  const float* qxx = I + R::LXX;
  const float* QK = S + R::M;
  for (int e = tid; e < NX * NX; e += nt) {
    const int i = e / NX, k = e % NX;
    S[R::VXX + e] = qxx[e] - 0.5f * (QK[e] + QK[k * NX + i]);
  }
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int u = 0; u < NU; ++u) {
      s1 += S[R::D1 + u];
      s2 += S[R::D2 + u];
    }
    *d1 = *d1 + s1;
    *d2 = *d2 + s2;
  }
}

}  // namespace ag
