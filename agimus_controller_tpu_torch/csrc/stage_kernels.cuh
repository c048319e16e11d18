// Per-node programs of the fused stage kernels K1-K4 (see stage_kernels.cu).
//
// One call computes one node: the semi-implicit Euler step with Fx/Fu, and
// the Gauss-Newton pack of every cost item of the descriptor table. The
// same math, in plain PyTorch component form, is
// `ops/cuda_dynamics.py::dynamics_terms` and `ops/cuda_costs.py::_item_terms_c`.
//
// Every function here is `__host__ __device__` and free of CUDA built-ins,
// so the header also compiles as host C++.
//
// Derivative routes (CUDA has no autodiff; the Pallas bodies use JAX's):
//   - d rnea(q, v, a) / d(q, v) for Fx (Pallas: `jax.vjp`,
//     pallas_dynamics.py:107-121): forward dual numbers, one pass per
//     tangent of (q, v), through the templated `rnea`.
//   - gravity-torque Jacobian of control_grav (Pallas: `jax.linearize`,
//     pallas_costs.py:333): forward dual numbers, one pass per joint.
//   - frame residual Jacobians, log6/log3 of FK (Pallas: `jax.linearize`,
//     pallas_costs.py:381): forward dual numbers, one pass per joint.
// A dual pass computes exactly what one `jax.linearize` tangent computes.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define AG_HD __host__ __device__ __forceinline__
#define AG_FN __host__ __device__ inline
#else
#define AG_HD inline
#define AG_FN inline
#endif

namespace ag {

// ---- packed-constants layout; must match ops/cuda_costs.py --------------
// per joint (stride 31): rot 9, trans 3, axis 3, type (0 revolute,
// 1 prismatic), parent, mass, com 3, inertia 9, armature; then gravity 3;
// then one 48-float descriptor per cost item.
constexpr int JSTRIDE = 31;
constexpr int J_ROT = 0, J_TRANS = 9, J_AXIS = 12, J_TYPE = 15, J_PARENT = 16,
              J_MASS = 17, J_COM = 18, J_INER = 21, J_ARM = 30;
constexpr int ISTRIDE = 48;
constexpr int I_KIND = 0, I_WEIGHT = 1, I_PJOINT = 2, I_FROT = 3,
              I_FTRANS = 12, I_REF = 15, I_W = 16, I_TRANS = 17, I_SREF = 18,
              I_SW = 32;
constexpr int K_STATE = 0, K_CONTROL = 1, K_CONTROL_GRAV = 2,
              K_FRAME_PLACEMENT = 3, K_FRAME_TRANSLATION = 4,
              K_FRAME_ROTATION = 5;

// ---- forward-mode dual number ---------------------------------------------
struct Dual {
  float v, d;
  AG_HD Dual() : v(0.f), d(0.f) {}
  AG_HD Dual(float a) : v(a), d(0.f) {}
  AG_HD Dual(float a, float b) : v(a), d(b) {}
};
AG_HD Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
AG_HD Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
AG_HD Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
AG_HD Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
AG_HD Dual operator/(Dual a, Dual b) {
  float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}

AG_HD float val(float a) { return a; }
AG_HD float val(Dual a) { return a.v; }
AG_HD float s_sqrt(float a) { return sqrtf(a); }
AG_HD Dual s_sqrt(Dual a) {
  float s = sqrtf(a.v);
  return Dual(s, a.d * 0.5f / s);
}
AG_HD float s_sin(float a) { return sinf(a); }
AG_HD Dual s_sin(Dual a) { return Dual(sinf(a.v), a.d * cosf(a.v)); }
AG_HD float s_cos(float a) { return cosf(a); }
AG_HD Dual s_cos(Dual a) { return Dual(cosf(a.v), -a.d * sinf(a.v)); }
AG_HD float s_abs(float a) { return fabsf(a); }
AG_HD Dual s_abs(Dual a) { return a.v < 0.f ? -a : a; }
AG_HD float s_atan2(float y, float x) { return atan2f(y, x); }
AG_HD Dual s_atan2(Dual y, Dual x) {
  float r2 = x.v * x.v + y.v * y.v;
  return Dual(atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / r2);
}

// ---- 3-vectors and 3x3 matrices (row-major) --------------------------------
template <class T> struct Id { typedef T type; };

template <class S> struct V3 {
  S a[3];
  AG_HD S& operator[](int i) { return a[i]; }
  AG_HD const S& operator[](int i) const { return a[i]; }
};
template <class S> struct M3 {
  S a[9];
  AG_HD S& operator[](int i) { return a[i]; }
  AG_HD const S& operator[](int i) const { return a[i]; }
};

template <class S> AG_HD V3<S> load3(const float* p) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = S(p[i]);
  return r;
}
template <class S> AG_HD M3<S> load9(const float* p) {
  M3<S> r;
  for (int i = 0; i < 9; ++i) r[i] = S(p[i]);
  return r;
}
template <class S> AG_HD V3<S> zero3() {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = S(0.f);
  return r;
}
template <class S> AG_HD V3<S> operator+(const V3<S>& a, const V3<S>& b) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = a[i] + b[i];
  return r;
}
template <class S> AG_HD V3<S> operator-(const V3<S>& a, const V3<S>& b) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = a[i] - b[i];
  return r;
}
template <class S> AG_HD V3<S> scale(typename Id<S>::type s, const V3<S>& a) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r[i] = s * a[i];
  return r;
}
template <class S> AG_HD S dot(const V3<S>& a, const V3<S>& b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
template <class S> AG_HD V3<S> cross(const V3<S>& a, const V3<S>& b) {
  V3<S> r;
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
  return r;
}
template <class S> AG_HD V3<S> matvec(const M3<S>& R, const V3<S>& v) {
  V3<S> r;
  for (int i = 0; i < 3; ++i)
    r[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
  return r;
}
template <class S> AG_HD V3<S> mattvec(const M3<S>& R, const V3<S>& v) {
  V3<S> r;
  for (int i = 0; i < 3; ++i)
    r[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
  return r;
}
template <class S> AG_HD M3<S> matmul(const M3<S>& A, const M3<S>& B) {
  M3<S> r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
  return r;
}
template <class S> AG_HD M3<S> transpose(const M3<S>& A) {
  M3<S> r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r[3 * i + j] = A[3 * j + i];
  return r;
}
template <class S> AG_HD M3<S> axis_rotation(const V3<S>& ax, S q) {
  S x = ax[0], y = ax[1], z = ax[2];
  S c = s_cos(q), s = s_sin(q);
  S t = S(1.f) - c;
  M3<S> r;
  r[0] = t * x * x + c; r[1] = t * x * y - s * z; r[2] = t * x * z + s * y;
  r[3] = t * x * y + s * z; r[4] = t * y * y + c; r[5] = t * y * z - s * x;
  r[6] = t * x * z - s * y; r[7] = t * y * z + s * x; r[8] = t * z * z + c;
  return r;
}

// ---- rigid-body dynamics ---------------------------------------------------
AG_HD int parent_of(const float* C, int i) { return (int)C[i * JSTRIDE + J_PARENT]; }
AG_HD bool revolute(const float* C, int i) { return C[i * JSTRIDE + J_TYPE] == 0.f; }

// Joint placements in the parent joint frame at q.
template <int NJ, class S>
AG_FN void joint_transforms(const float* C, const S* q, M3<S>* R, V3<S>* P) {
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    M3<S> Rj = load9<S>(J + J_ROT);
    V3<S> pj = load3<S>(J + J_TRANS);
    V3<S> ax = load3<S>(J + J_AXIS);
    if (revolute(C, i)) {
      R[i] = matmul(Rj, axis_rotation(ax, q[i]));
      P[i] = pj;
    } else {
      R[i] = Rj;
      P[i] = pj + matvec(Rj, scale<S>(q[i], ax));
    }
  }
}

// Recursive Newton-Euler: tau = rnea(q, v, a), with the placements of q.
template <int NJ, class S>
AG_FN void rnea(const float* C, const M3<S>* R, const V3<S>* P, const S* v,
                const S* a, S* tau) {
  V3<S> w[NJ], lv[NJ], aw[NJ], al[NJ], fn[NJ], ff[NJ];
  const float* g = C + NJ * JSTRIDE;
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    int par = parent_of(C, i);
    V3<S> vpw = zero3<S>(), vpl = zero3<S>(), apw = zero3<S>(), apl;
    if (par >= 0) {
      vpw = w[par]; vpl = lv[par]; apw = aw[par]; apl = al[par];
    } else {
      apl[0] = S(-g[0]); apl[1] = S(-g[1]); apl[2] = S(-g[2]);
    }
    // motion_act_inv: w = R^T w_p ; v = R^T (v_p - p x w_p)
    V3<S> wi = mattvec(R[i], vpw);
    V3<S> vi = mattvec(R[i], vpl - cross(P[i], vpw));
    V3<S> wai = mattvec(R[i], apw);
    V3<S> vai = mattvec(R[i], apl - cross(P[i], apw));
    V3<S> ax = load3<S>(J + J_AXIS);
    V3<S> sdot = scale<S>(v[i], ax);
    if (revolute(C, i)) {
      wi = wi + sdot;
      wai = wai + scale<S>(a[i], ax);
      wai = wai + cross(wi, sdot);
      vai = vai + cross(vi, sdot);
    } else {
      vi = vi + sdot;
      vai = vai + scale<S>(a[i], ax);
      vai = vai + cross(wi, sdot);
    }
    w[i] = wi; lv[i] = vi; aw[i] = wai; al[i] = vai;
    // inertia apply + bias: f = I a + v x* (I v)
    S m = S(J[J_MASS]);
    V3<S> c = load3<S>(J + J_COM);
    M3<S> I = load9<S>(J + J_INER);
    V3<S> hf = scale<S>(m, vi + cross(wi, c));
    V3<S> hn = matvec(I, wi) + cross(c, hf);
    V3<S> f_l = scale<S>(m, vai + cross(wai, c));
    V3<S> f_n = matvec(I, wai) + cross(c, f_l);
    fn[i] = f_n + (cross(wi, hn) + cross(vi, hf));
    ff[i] = f_l + cross(wi, hf);
  }
  for (int i = NJ - 1; i >= 0; --i) {
    V3<S> ax = load3<S>(C + i * JSTRIDE + J_AXIS);
    tau[i] = revolute(C, i) ? dot(ax, fn[i]) : dot(ax, ff[i]);
    int par = parent_of(C, i);
    if (par >= 0) {
      V3<S> flp = matvec(R[i], ff[i]);
      V3<S> fnp = matvec(R[i], fn[i]) + cross(P[i], flp);
      fn[par] = fn[par] + fnp;
      ff[par] = ff[par] + flp;
    }
  }
}

// M + diag(armature) by zero-velocity unit-acceleration columns: only the
// subtree of j carries accelerations, only ancestors of j receive forces.
template <int NJ>
AG_FN void mass_matrix(const float* C, const M3<float>* R, const V3<float>* P,
                       float* M) {
  for (int k = 0; k < NJ * NJ; ++k) M[k] = 0.f;  // non-interacting pairs
  for (int j = 0; j < NJ; ++j) {
    V3<float> aw[NJ], al[NJ], fn[NJ], ff[NJ];
    bool has_a[NJ], has_f[NJ];
    for (int i = 0; i < NJ; ++i) has_a[i] = has_f[i] = false;
    V3<float> axj = load3<float>(C + j * JSTRIDE + J_AXIS);
    aw[j] = revolute(C, j) ? axj : zero3<float>();
    al[j] = revolute(C, j) ? zero3<float>() : axj;
    has_a[j] = true;
    for (int i = j; i < NJ; ++i) {
      const float* J = C + i * JSTRIDE;
      if (i > j) {
        int par = parent_of(C, i);
        if (par < 0 || !has_a[par]) continue;
        aw[i] = mattvec(R[i], aw[par]);
        al[i] = mattvec(R[i], al[par] - cross(P[i], aw[par]));
        has_a[i] = true;
      }
      V3<float> c = load3<float>(J + J_COM);
      M3<float> I = load9<float>(J + J_INER);
      V3<float> plin = scale<float>(J[J_MASS], al[i] + cross(aw[i], c));
      fn[i] = matvec(I, aw[i]) + cross(c, plin);
      ff[i] = plin;
      has_f[i] = true;
    }
    for (int i = NJ - 1; i >= 0; --i) {
      if (!has_f[i]) continue;
      V3<float> ax = load3<float>(C + i * JSTRIDE + J_AXIS);
      float tau = revolute(C, i) ? dot(ax, fn[i]) : dot(ax, ff[i]);
      M[i * NJ + j] = tau;
      if (i < j) M[j * NJ + i] = tau;  // symmetry
      int par = parent_of(C, i);
      if (par >= 0) {
        V3<float> flp = matvec(R[i], ff[i]);
        V3<float> fnp = matvec(R[i], fn[i]) + cross(P[i], flp);
        if (has_f[par]) {
          fn[par] = fn[par] + fnp;
          ff[par] = ff[par] + flp;
        } else {
          fn[par] = fnp;
          ff[par] = flp;
          has_f[par] = true;
        }
      }
    }
  }
  for (int i = 0; i < NJ; ++i) M[i * NJ + i] += C[i * JSTRIDE + J_ARM];
}

template <int N>
AG_FN void chol_factor(const float* M, float* L) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = M[i * N + j];
      for (int k = 0; k < j; ++k) s -= L[i * N + k] * L[j * N + k];
      L[i * N + j] = (i == j) ? sqrtf(s) : s / L[j * N + j];
    }
}

// Solve (L L^T) x = b.
template <int N>
AG_FN void chol_solve(const float* L, const float* b, float* x) {
  float y[N];
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * N + k] * y[k];
    y[i] = s / L[i * N + i];
  }
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < N; ++k) s -= L[k * N + i] * x[k];
    x[i] = s / L[i * N + i];
  }
}

// ---- SE(3) logs ------------------------------------------------------------
// Rotation -> quaternion [x, y, z, w]: the candidate of the largest of
// m00, m11, m22 and the trace (strict >, first wins on ties).
template <class S>
AG_HD void quat(const M3<S>& R, S* out) {
  S m00 = R[0], m01 = R[1], m02 = R[2], m10 = R[3], m11 = R[4], m12 = R[5],
    m20 = R[6], m21 = R[7], m22 = R[8];
  S tr = m00 + m11 + m22;
  S best = m00;
  out[0] = S(1.f) + m00 - m11 - m22; out[1] = m01 + m10;
  out[2] = m02 + m20; out[3] = m21 - m12;
  if (val(m11) > val(best)) {
    best = m11;
    out[0] = m01 + m10; out[1] = S(1.f) - m00 + m11 - m22;
    out[2] = m12 + m21; out[3] = m02 - m20;
  }
  if (val(m22) > val(best)) {
    best = m22;
    out[0] = m02 + m20; out[1] = m12 + m21;
    out[2] = S(1.f) - m00 - m11 + m22; out[3] = m10 - m01;
  }
  if (val(tr) > val(best)) {
    out[0] = m21 - m12; out[1] = m02 - m20;
    out[2] = m10 - m01; out[3] = S(1.f) + tr;
  }
  S n = s_sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2] +
               out[3] * out[3]);
  for (int i = 0; i < 4; ++i) out[i] = out[i] / n;
}

template <class S>
AG_FN V3<S> log3(const M3<S>& R) {
  S qv[4];
  quat(R, qv);
  S sign = S(val(qv[3]) < 0.f ? -1.f : 1.f);
  S qx = qv[0] * sign, qy = qv[1] * sign, qz = qv[2] * sign;
  S c = s_abs(qv[3]);
  S s2 = qx * qx + qy * qy + qz * qz;
  // s2 carries ~1e-12 of f32 rounding noise near the identity; the 1e-8
  // threshold fixes which Jacobian branch is taken (same as the JAX body)
  bool small = val(s2) < 1e-8f;
  S s = s_sqrt(small ? S(1.f) : s2);
  S theta = S(2.f) * s_atan2(s, c);
  S sc = small ? S(2.f) / c : theta / s;
  V3<S> r;
  r[0] = sc * qx; r[1] = sc * qy; r[2] = sc * qz;
  return r;
}

template <class S>
AG_FN void log6(const M3<S>& R, const V3<S>& p, S* out) {
  V3<S> w = log3(R);
  S t2 = dot(w, w);
  bool small = val(t2) < 1e-8f;
  S t2s = small ? S(1.f) : t2;
  S th = s_sqrt(t2s);
  S half = th * S(0.5f);
  S sin_half = small ? S(1.f) : s_sin(half);
  S coef = small ? S(1.f / 12.f) + t2 / S(720.f)
                 : (S(1.f) - half * s_cos(half) / sin_half) / t2s;
  // V^-1 p = p - 0.5 w x p + coef * w x (w x p)
  V3<S> wxp = cross(w, p);
  V3<S> wwxp = cross(w, wxp);
  for (int i = 0; i < 3; ++i) {
    out[i] = w[i];
    out[3 + i] = p[i] - S(0.5f) * wxp[i] + coef * wwxp[i];
  }
}

// Residual of a frame cost item at q; returns its dimension (6 or 3).
template <int NJ, class S>
AG_FN int frame_residual(const float* C, const float* D, const float* row,
                         int kind, const S* q, S* r) {
  M3<S> R[NJ], oR[NJ];
  V3<S> P[NJ], op[NJ];
  joint_transforms<NJ, S>(C, q, R, P);
  for (int i = 0; i < NJ; ++i) {
    int par = parent_of(C, i);
    if (par < 0) {
      oR[i] = R[i];
      op[i] = P[i];
    } else {
      oR[i] = matmul(oR[par], R[i]);
      op[i] = matvec(oR[par], P[i]) + op[par];
    }
  }
  int j = (int)D[I_PJOINT];
  M3<S> Rf = matmul(oR[j], load9<S>(D + I_FROT));
  V3<S> pf = matvec(oR[j], load3<S>(D + I_FTRANS)) + op[j];
  M3<S> refR = load9<S>(row + (int)D[I_REF]);
  V3<S> refp = load3<S>(row + (int)D[I_TRANS]);
  if (kind == K_FRAME_TRANSLATION) {
    V3<S> d = pf - refp;
    for (int i = 0; i < 3; ++i) r[i] = d[i];
    return 3;
  }
  M3<S> rRT = transpose(refR);
  M3<S> dR = matmul(rRT, Rf);
  if (kind == K_FRAME_ROTATION) {
    V3<S> w = log3(dR);
    for (int i = 0; i < 3; ++i) r[i] = w[i];
    return 3;
  }
  log6(dR, matvec(rRT, pf - refp), r);
  return 6;
}

// ---- cost items ------------------------------------------------------------
AG_HD float item_weight(const float* D, const float* row, int i) {
  int off = (int)D[I_W];
  return off >= 0 ? row[off + i] : D[I_SW + i];
}
AG_HD float item_ref(const float* D, const float* row, int i) {
  int off = (int)D[I_REF];
  return off >= 0 ? row[off + i] : D[I_SREF + i];
}

// Adds every cost item of the table (Gauss-Newton when DERIVS) into
// l, lx [NX], lu [NJ], lxx [NX*NX], lxu [NX*NJ], luu [NJ*NJ] (row-major).
template <int NJ, bool DERIVS>
AG_FN void node_costs(const float* C, int n_items, const float* row,
                      const float* q, const float* v, const float* u,
                      const M3<float>* R, const V3<float>* P, float* l,
                      float* lx, float* lu, float* lxx, float* lxu,
                      float* luu) {
  constexpr int NX = 2 * NJ;
  for (int it = 0; it < n_items; ++it) {
    const float* D = C + NJ * JSTRIDE + 3 + it * ISTRIDE;
    int kind = (int)D[I_KIND];
    float wgt = D[I_WEIGHT];
    float li = 0.f;
    if (kind == K_STATE || kind == K_CONTROL) {
      int n = kind == K_STATE ? NX : NJ;
      for (int i = 0; i < n; ++i) {
        float xi = kind == K_CONTROL ? u[i] : (i < NJ ? q[i] : v[i - NJ]);
        float r = xi - item_ref(D, row, i);
        float w = item_weight(D, row, i);
        li += 0.5f * w * r * r;
        if (DERIVS) {
          if (kind == K_STATE) {
            lx[i] += wgt * w * r;
            lxx[i * NX + i] += wgt * w;
          } else {
            lu[i] += wgt * w * r;
            luu[i * NJ + i] += wgt * w;
          }
        }
      }
    } else if (kind == K_CONTROL_GRAV) {
      float g[NJ], Jg[NJ][NJ];  // Jg[k][i] = d g_i / d q_k
      if (DERIVS) {
        for (int k = 0; k < NJ; ++k) {
          Dual qd[NJ], zd[NJ], td[NJ];
          for (int i = 0; i < NJ; ++i) qd[i] = Dual(q[i], i == k ? 1.f : 0.f);
          M3<Dual> Rd[NJ];
          V3<Dual> Pd[NJ];
          joint_transforms<NJ, Dual>(C, qd, Rd, Pd);
          rnea<NJ, Dual>(C, Rd, Pd, zd, zd, td);
          for (int i = 0; i < NJ; ++i) {
            g[i] = td[i].v;
            Jg[k][i] = td[i].d;
          }
        }
      } else {
        float z[NJ];
        for (int i = 0; i < NJ; ++i) z[i] = 0.f;
        rnea<NJ, float>(C, R, P, z, z, g);
      }
      float wr[NJ];
      for (int i = 0; i < NJ; ++i) {
        float w = item_weight(D, row, i);
        float r = u[i] - g[i];
        wr[i] = w * r;
        li += 0.5f * w * r * r;
      }
      if (DERIVS) {
        // J_u = I, J_x = [-Jg, 0]
        for (int i = 0; i < NJ; ++i) {
          lu[i] += wgt * wr[i];
          luu[i * NJ + i] += wgt * item_weight(D, row, i);
        }
        for (int k = 0; k < NJ; ++k) {
          float s = 0.f;
          for (int i = 0; i < NJ; ++i) s += Jg[k][i] * wr[i];
          lx[k] += -wgt * s;
          for (int i = 0; i < NJ; ++i)
            lxu[k * NJ + i] += -wgt * Jg[k][i] * item_weight(D, row, i);
          for (int k2 = 0; k2 <= k; ++k2) {
            float h = 0.f;
            for (int i = 0; i < NJ; ++i)
              h += Jg[k][i] * item_weight(D, row, i) * Jg[k2][i];
            lxx[k * NX + k2] += wgt * h;
            if (k2 != k) lxx[k2 * NX + k] += wgt * h;
          }
        }
      }
    } else {  // frame kinds: residual of q only
      float r[6], Jc[NJ][6];  // Jc[k][i] = d r_i / d q_k
      int nr = 0;
      if (DERIVS) {
        for (int k = 0; k < NJ; ++k) {
          Dual qd[NJ], rd[6];
          for (int i = 0; i < NJ; ++i) qd[i] = Dual(q[i], i == k ? 1.f : 0.f);
          nr = frame_residual<NJ, Dual>(C, D, row, kind, qd, rd);
          for (int i = 0; i < nr; ++i) {
            r[i] = rd[i].v;
            Jc[k][i] = rd[i].d;
          }
        }
      } else {
        nr = frame_residual<NJ, float>(C, D, row, kind, q, r);
      }
      for (int i = 0; i < nr; ++i)
        li += 0.5f * item_weight(D, row, i) * r[i] * r[i];
      if (DERIVS) {
        for (int k = 0; k < NJ; ++k) {
          float s = 0.f;
          for (int i = 0; i < nr; ++i)
            s += Jc[k][i] * (item_weight(D, row, i) * r[i]);
          lx[k] += wgt * s;
          for (int k2 = 0; k2 <= k; ++k2) {
            float h = 0.f;
            for (int i = 0; i < nr; ++i)
              h += Jc[k][i] * item_weight(D, row, i) * Jc[k2][i];
            lxx[k * NX + k2] += wgt * h;
            if (k2 != k) lxx[k2 * NX + k] += wgt * h;
          }
        }
      }
    }
    *l += wgt * li;
  }
}

// ---- one node of K1 (DERIVS) / K2 ------------------------------------------
// Inputs node-major: x [N, 2NJ], u [N, NJ], dt [N], rows [N, W]. Outputs
// node-major in the shapes of the JAX `make_pallas_stage` run; unused
// outputs may be null when DERIVS is false.
template <int NJ, bool DERIVS>
AG_FN void stage_node(int n, const float* x, const float* u, const float* dt,
                      const float* rows, int W, const float* C, int n_items,
                      float* xnext, float* Fx, float* Fu, float* l, float* lx,
                      float* lu, float* lxx, float* lxu, float* luu) {
  constexpr int NX = 2 * NJ;
  const float* row = rows + (long)n * W;
  float q[NJ], v[NJ], un[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = x[(long)n * NX + i];
    v[i] = x[(long)n * NX + NJ + i];
    un[i] = u[(long)n * NJ + i];
  }
  float h = dt[n];

  M3<float> R[NJ];
  V3<float> P[NJ];
  joint_transforms<NJ, float>(C, q, R, P);
  float z[NJ], b[NJ], M[NJ * NJ], L[NJ * NJ], rhs[NJ], a[NJ];
  for (int i = 0; i < NJ; ++i) z[i] = 0.f;
  rnea<NJ, float>(C, R, P, v, z, b);
  mass_matrix<NJ>(C, R, P, M);
  chol_factor<NJ>(M, L);
  for (int i = 0; i < NJ; ++i) rhs[i] = un[i] - b[i];
  chol_solve<NJ>(L, rhs, a);
  float* xo = xnext + (long)n * NX;
  for (int i = 0; i < NJ; ++i) {
    float vn = v[i] + h * a[i];
    xo[NJ + i] = vn;
    xo[i] = q[i] + h * vn;
  }

  float* lxn = nullptr; float* lun = nullptr; float* lxxn = nullptr;
  float* lxun = nullptr; float* luun = nullptr;
  if (DERIVS) {
    float* fx = Fx + (long)n * NX * NX;
    float* fu = Fu + (long)n * NX * NJ;
    float h2 = h * h;
    // Fx: da/d(q,v) = -M^-1 d rnea(q, v, a)/d(q, v), a held fixed
    for (int k = 0; k < NX; ++k) {
      Dual qd[NJ], vd[NJ], ad[NJ], td[NJ];
      for (int i = 0; i < NJ; ++i) {
        qd[i] = Dual(q[i], k == i ? 1.f : 0.f);
        vd[i] = Dual(v[i], k == NJ + i ? 1.f : 0.f);
        ad[i] = Dual(a[i]);
      }
      M3<Dual> Rd[NJ];
      V3<Dual> Pd[NJ];
      joint_transforms<NJ, Dual>(C, qd, Rd, Pd);
      rnea<NJ, Dual>(C, Rd, Pd, vd, ad, td);
      float col[NJ], da[NJ];
      for (int i = 0; i < NJ; ++i) col[i] = -td[i].d;
      chol_solve<NJ>(L, col, da);
      // semi-implicit Euler chain rule: v+ = v + dt a ; q+ = q + dt v+
      for (int i = 0; i < NJ; ++i) {
        if (k < NJ) {
          fx[i * NX + k] = (k == i ? 1.f : 0.f) + h2 * da[i];
          fx[(NJ + i) * NX + k] = h * da[i];
        } else {
          fx[i * NX + k] = (k - NJ == i ? h : 0.f) + h2 * da[i];
          fx[(NJ + i) * NX + k] = (k - NJ == i ? 1.f : 0.f) + h * da[i];
        }
      }
    }
    // Fu: M^-1 columns
    for (int j = 0; j < NJ; ++j) {
      float e[NJ], col[NJ];
      for (int i = 0; i < NJ; ++i) e[i] = i == j ? 1.f : 0.f;
      chol_solve<NJ>(L, e, col);
      for (int i = 0; i < NJ; ++i) {
        fu[i * NJ + j] = h2 * col[i];
        fu[(NJ + i) * NJ + j] = h * col[i];
      }
    }
    lxn = lx + (long)n * NX;
    lun = lu + (long)n * NJ;
    lxxn = lxx + (long)n * NX * NX;
    lxun = lxu + (long)n * NX * NJ;
    luun = luu + (long)n * NJ * NJ;
    for (int i = 0; i < NX; ++i) lxn[i] = 0.f;
    for (int i = 0; i < NJ; ++i) lun[i] = 0.f;
    for (int i = 0; i < NX * NX; ++i) lxxn[i] = 0.f;
    for (int i = 0; i < NX * NJ; ++i) lxun[i] = 0.f;
    for (int i = 0; i < NJ * NJ; ++i) luun[i] = 0.f;
  }
  float lv = 0.f;
  node_costs<NJ, DERIVS>(C, n_items, row, q, v, un, R, P, &lv, lxn, lun, lxxn,
                         lxun, luun);
  // running cost is dt-scaled (terminal has dt = 0 semantics,
  // `ocp_croco_generic.py:808-812`)
  l[n] = lv * h;
  if (DERIVS) {
    for (int i = 0; i < NX; ++i) lxn[i] *= h;
    for (int i = 0; i < NJ; ++i) lun[i] *= h;
    for (int i = 0; i < NX * NX; ++i) lxxn[i] *= h;
    for (int i = 0; i < NX * NJ; ++i) lxun[i] *= h;
    for (int i = 0; i < NJ * NJ; ++i) luun[i] *= h;
  }
}

// ---- one node of K3 (DERIVS) / K4 ------------------------------------------
// Terminal cost items at u = 0, no dt scale. Outputs l [N], lx [N, NX],
// lxx [N, NX, NX] (the last two only when DERIVS).
template <int NJ, bool DERIVS>
AG_FN void terminal_node(int n, const float* x, const float* rows, int W,
                         const float* C, int n_items, float* l, float* lx,
                         float* lxx) {
  constexpr int NX = 2 * NJ;
  const float* row = rows + (long)n * W;
  float q[NJ], v[NJ], un[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = x[(long)n * NX + i];
    v[i] = x[(long)n * NX + NJ + i];
    un[i] = 0.f;
  }
  M3<float> R[NJ];
  V3<float> P[NJ];
  joint_transforms<NJ, float>(C, q, R, P);
  // the terminal model has no control: its lu/lxu/luu are dropped
  float lu[NJ], lxu[NX * NJ], luu[NJ * NJ];
  float* lxn = nullptr;
  float* lxxn = nullptr;
  if (DERIVS) {
    lxn = lx + (long)n * NX;
    lxxn = lxx + (long)n * NX * NX;
    for (int i = 0; i < NX; ++i) lxn[i] = 0.f;
    for (int i = 0; i < NX * NX; ++i) lxxn[i] = 0.f;
    for (int i = 0; i < NJ; ++i) lu[i] = 0.f;
    for (int i = 0; i < NX * NJ; ++i) lxu[i] = 0.f;
    for (int i = 0; i < NJ * NJ; ++i) luu[i] = 0.f;
  }
  float lv = 0.f;
  node_costs<NJ, DERIVS>(C, n_items, row, q, v, un, R, P, &lv, lxn, lu, lxxn,
                         lxu, luu);
  l[n] = lv;
}

}  // namespace ag
