// Per-node programs of the fused stage kernels K1-K4 (see stage_kernels.cu)
// and of the dynamics-step kernels K5a/K5b (step_kernels.cu).
//
// The semi-implicit Euler step with Fx/Fu of one node (`dynamics_node`,
// K2's step and the one-thread reference of K5a/K5b), the Gauss-Newton pack
// of every cost item of the descriptor table (`node_costs`, K2 and K4; with
// derivatives `terminal_node`, K3's one-thread reference), K1's per-lane
// phases of the same (`k1_*`: a node's tangent passes split over the lanes
// of a warp slice; K3 runs them at u = 0 through `k3_load` / `k3_store`),
// K5a's and K5b's (`k5_*`: the step's primal shared by the lanes, the
// mass-matrix columns and K5b's tangents one a lane) and K4's (one cost
// item a lane). The same math, in plain PyTorch component form, is
// `ops/cuda_dynamics.py::dynamics_terms` and
// `ops/cuda_costs.py::_item_terms_c`.
//
// Every function here is `__host__ __device__` and free of CUDA built-ins
// (a lane is an argument, the kernels place the barriers), so the header
// also compiles as host C++ and a host harness can run a node lane by lane
// (tests/stage_lanes_harness.cpp).
//
// Derivative routes (CUDA has no autodiff; the Pallas bodies use JAX's):
//   - d rnea(q, v, a) / d(q, v) for Fx (Pallas: `jax.vjp`,
//     pallas_dynamics.py:107-121): forward mode, one pass per tangent of
//     (q, v): dual numbers through the templated `rnea` (K1), or the
//     derivative parts alone around shared primal values
//     (`k5_tangent_rnea`, K5b).
//   - gravity-torque Jacobian of control_grav (Pallas: `jax.linearize`,
//     pallas_costs.py:333): forward dual numbers, one pass per joint.
//   - frame, visual-servoing and collision residual Jacobians, log6/log3
//     of FK and the capsule distance (Pallas: `jax.linearize`,
//     pallas_costs.py:381): forward dual numbers, one pass per joint.
//   - frame-velocity residual Jacobians, a function of q and v (Pallas:
//     `jax.linearize` over q and v, pallas_costs.py:384-390): one pass per
//     entry of (q, v), 2 NJ passes.
// A forward pass computes exactly what one `jax.linearize` tangent computes.
//
// Activations (pallas_costs.py:188-208): weighted_quad on every kind; exp
// and quad_exp with the Pallas formulas, `sqrt(rr + 1e-12)` for exp and the
// PSD Gauss-Newton diagonal `4 a r^2 / alpha^2` for quad_exp. Build without
// fast math: with alpha = 1e-4 quad_exp values reach f32 denormals, which
// must not be flushed to zero.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define AG_HD __host__ __device__ __forceinline__
#define AG_FN __host__ __device__ inline
#define AG_UNROLL _Pragma("unroll")
#else
#define AG_HD inline
#define AG_FN inline
#define AG_UNROLL
#endif

namespace ag {

// ---- packed-constants layout; must match ops/cuda_costs.py --------------
// per joint (stride 31): rot 9, trans 3, axis 3, type (0 revolute,
// 1 prismatic), parent, mass, com 3, inertia 9, armature; then gravity 3;
// then one descriptor per cost item (`Desc<NJ>::STRIDE` floats, 84 up to
// 7 joints): kind, weight, frame joint, frame rot 9 and trans 3, the
// ref-row offsets of its reference, weights and translation reference
// (-1: static), its static reference and weights (`Desc<NJ>::NS` each: the
// widest static item, a state item's 2 NJ, at least 14). A collision item
// carries its activation code and alpha, the ref-row offset of its
// `w_coll` scale (-1: unscaled) and one 17-float block per geometry of its
// pair: parent joint (-1: world-fixed), rot 9, trans 3, radius, half
// length, and the ref-row offsets of the streamed rot/trans of a
// world-fixed geometry (else -1). Items without geometry reuse its first
// slots: a visual-servoing item holds the ref-row offsets of its object
// transform `wMo` (rot 9, trans 3), a frame-velocity item its convention
// code (V_*); the frame-velocity reference `ee_vel` sits at I_REF.
constexpr int JSTRIDE = 31;
constexpr int J_ROT = 0, J_TRANS = 9, J_AXIS = 12, J_TYPE = 15, J_PARENT = 16,
              J_MASS = 17, J_COM = 18, J_INER = 21, J_ARM = 30;
constexpr int I_KIND = 0, I_WEIGHT = 1, I_PJOINT = 2, I_FROT = 3,
              I_FTRANS = 12, I_REF = 15, I_W = 16, I_TRANS = 17, I_SREF = 18;
constexpr int GSTRIDE = 17;
constexpr int G_PJOINT = 0, G_ROT = 1, G_TRANS = 10, G_RADIUS = 13,
              G_HALFLEN = 14, G_REF_ROT = 15, G_REF_TRANS = 16;
// The descriptor's slots after its static reference and weights, at NJ
// joints.
template <int NJ> struct Desc {
  static constexpr int NS = 2 * NJ > 14 ? 2 * NJ : 14;
  static constexpr int SW = I_SREF + NS, ACT = SW + NS, ALPHA = ACT + 1,
                       WCOLL = ACT + 2, GEOM = ACT + 3, WMO_ROT = GEOM,
                       WMO_TRANS = GEOM + 1, VEL_FRAME = GEOM + 2,
                       STRIDE = GEOM + 2 * GSTRIDE + 1;
};
constexpr int K_STATE = 0, K_CONTROL = 1, K_CONTROL_GRAV = 2,
              K_FRAME_PLACEMENT = 3, K_FRAME_TRANSLATION = 4,
              K_FRAME_ROTATION = 5, K_COLLISION = 6, K_VISUAL_SERVOING = 7,
              K_FRAME_VELOCITY = 8;
constexpr int V_WORLD = 0, V_LOCAL = 1, V_LOCAL_WORLD_ALIGNED = 2;
constexpr int A_WEIGHTED_QUAD = 0, A_EXP = 1, A_QUAD_EXP = 2;

// Lanes that run one node: the power of two >= n (K1, K3 and K5b: n = 2 NJ
// = nx; K5a: n = NJ + 1), at most one warp. Where n passes 32, lane k takes
// the node's items k, k + 32, ... (a tangent, a mass-matrix column, an
// output component).
constexpr int node_lanes(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// Whether lane `lane` of LANES owns item e of a node's N strided items
// (e mod LANES); where the node has a lane per item, whether it is item e.
template <int LANES, int N>
AG_HD bool owns_item(int lane, int e) {
  return (N <= LANES ? e : e % LANES) == lane;
}

// Rounds of a node's N strided items on LANES lanes: lane k takes item
// r LANES + k in round r (one round, the item of the lane, where N <= LANES).
AG_HD constexpr int rounds(int n, int lanes) { return (n + lanes - 1) / lanes; }

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
AG_HD float s_clamp(float a, float lo, float hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
AG_HD Dual s_clamp(Dual a, float lo, float hi) {
  return a.v < lo ? Dual(lo) : (a.v > hi ? Dual(hi) : a);
}
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

// Placement of joint i in its parent joint frame at q_i.
template <class S>
AG_FN void joint_transform(const float* C, int i, S qi, M3<S>& R, V3<S>& P) {
  const float* J = C + i * JSTRIDE;
  M3<S> Rj = load9<S>(J + J_ROT);
  V3<S> pj = load3<S>(J + J_TRANS);
  V3<S> ax = load3<S>(J + J_AXIS);
  if (revolute(C, i)) {
    R = matmul(Rj, axis_rotation(ax, qi));
    P = pj;
  } else {
    R = Rj;
    P = pj + matvec(Rj, scale<S>(qi, ax));
  }
}

// Joint placements in the parent joint frame at q.
template <int NJ, class S>
AG_FN void joint_transforms(const float* C, const S* q, M3<S>* R, V3<S>* P) {
  for (int i = 0; i < NJ; ++i) joint_transform<S>(C, i, q[i], R[i], P[i]);
}

// Whether the joints form one serial chain (the parent of joint i is
// i - 1), as the Panda and the 2-DoF arm do.
template <int NJ>
AG_FN bool is_chain(const float* C) {
  bool chain = true;
  for (int i = 0; i < NJ; ++i) chain = chain && parent_of(C, i) == i - 1;
  return chain;
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

// Column j of M + diag(armature) by the zero-velocity unit-acceleration
// pass of joint j: only the subtree of j carries accelerations, only
// ancestors of j receive forces. Writes the entries (i, j) and (j, i) for
// i <= j, each the value of the pass of the larger index (0 for a pair
// that does not interact), which is the pass whose write the one-pass-
// after-another order keeps: pass j's entries (i, j) for i > j are
// overwritten by pass i. So columns computed on different lanes give the
// same matrix as `mass_matrix`.
template <int NJ>
AG_FN void mass_matrix_column(const float* C, const M3<float>* R,
                              const V3<float>* P, int j, float* M) {
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
  for (int i = 0; i <= j; ++i) M[i * NJ + j] = M[j * NJ + i] = 0.f;
  for (int i = NJ - 1; i >= 0; --i) {
    if (!has_f[i]) continue;
    V3<float> ax = load3<float>(C + i * JSTRIDE + J_AXIS);
    float tau = revolute(C, i) ? dot(ax, fn[i]) : dot(ax, ff[i]);
    if (i <= j) M[i * NJ + j] = M[j * NJ + i] = tau;
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
  M[j * NJ + j] += C[j * JSTRIDE + J_ARM];
}

// M + diag(armature), column after column.
template <int NJ>
AG_FN void mass_matrix(const float* C, const M3<float>* R, const V3<float>* P,
                       float* M) {
  for (int j = 0; j < NJ; ++j) mass_matrix_column<NJ>(C, R, P, j, M);
}

// One thread's per-joint forces, kept out of its registers while a tree
// recursion runs (K5b's phases): joint i's torque part (f = 0) and linear
// part (f = 1) at df[((2 i + f) 3 + c) ds], c < 3 (the kernel interleaves
// the threads' slots, ds = threads per block).
struct ForceSlots {
  float* df;
  int ds;
  AG_HD V3<float> get(int i, int f) const {
    V3<float> r;
    for (int c = 0; c < 3; ++c) r[c] = df[((2 * i + f) * 3 + c) * ds];
    return r;
  }
  AG_HD void set(int i, int f, const V3<float>& r) const {
    for (int c = 0; c < 3; ++c) df[((2 * i + f) * 3 + c) * ds] = r[c];
  }
};

// `mass_matrix_column` over a serial chain (`is_chain`): the joint loops
// unroll, the per-joint accelerations in registers, the forces in fs.
// Every joint up to j is an ancestor of j and receives forces (its first
// from its child).
template <int NJ>
AG_FN void mass_matrix_column_chain(const float* C, const M3<float>* R,
                                    const V3<float>* P, int j,
                                    const ForceSlots& fs, float* M) {
  V3<float> aw = zero3<float>(), al = zero3<float>();
  AG_UNROLL
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    if (i < j) continue;
    if (i == j) {
      V3<float> axj = load3<float>(J + J_AXIS);
      aw = revolute(C, j) ? axj : zero3<float>();
      al = revolute(C, j) ? zero3<float>() : axj;
    } else {
      V3<float> awi = mattvec(R[i], aw);
      al = mattvec(R[i], al - cross(P[i], aw));
      aw = awi;
    }
    V3<float> c = load3<float>(J + J_COM);
    M3<float> I = load9<float>(J + J_INER);
    V3<float> plin = scale<float>(J[J_MASS], al + cross(aw, c));
    fs.set(i, 0, matvec(I, aw) + cross(c, plin));
    fs.set(i, 1, plin);
  }
  AG_UNROLL
  for (int i = NJ - 1; i >= 0; --i) {
    V3<float> ax = load3<float>(C + i * JSTRIDE + J_AXIS);
    const V3<float> fn = fs.get(i, 0), ff = fs.get(i, 1);
    float tau = revolute(C, i) ? dot(ax, fn) : dot(ax, ff);
    if (i <= j) M[i * NJ + j] = M[j * NJ + i] = tau;
    if (i > 0) {
      V3<float> flp = matvec(R[i], ff);
      V3<float> fnp = matvec(R[i], fn) + cross(P[i], flp);
      const bool first = i - 1 < j;  // the parent's first force
      fs.set(i - 1, 0, first ? fnp : fs.get(i - 1, 0) + fnp);
      fs.set(i - 1, 1, first ? flp : fs.get(i - 1, 1) + flp);
    }
  }
  M[j * NJ + j] += C[j * JSTRIDE + J_ARM];
}

template <int N>
AG_FN void chol_factor(const float* M, float* L) {
  AG_UNROLL
  for (int i = 0; i < N; ++i)
    AG_UNROLL
    for (int j = 0; j <= i; ++j) {
      float s = M[i * N + j];
      AG_UNROLL
      for (int k = 0; k < j; ++k) s -= L[i * N + k] * L[j * N + k];
      L[i * N + j] = (i == j) ? sqrtf(s) : s / L[j * N + j];
    }
}

// Solve (L L^T) x = b.
template <int N>
AG_FN void chol_solve(const float* L, const float* b, float* x) {
  float y[N];
  AG_UNROLL
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    AG_UNROLL
    for (int k = 0; k < i; ++k) s -= L[i * N + k] * y[k];
    y[i] = s / L[i * N + i];
  }
  AG_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    AG_UNROLL
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

// World placements of the joint frames at q.
template <int NJ, class S>
AG_FN void world_placements(const float* C, const S* q, M3<S>* oR,
                            V3<S>* op) {
  M3<S> R[NJ];
  V3<S> P[NJ];
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
}

// World placement of one geometry of a collision item (block G): a
// world-fixed geometry from its streamed ref columns, the others through
// the kinematics of their parent joint (Pallas `_geom_pose_c`, :225-241).
template <class S>
AG_FN void geometry_pose(const float* G, const float* row, const M3<S>* oR,
                         const V3<S>* op, M3<S>* Rg, V3<S>* pg) {
  int j = (int)G[G_PJOINT];
  if (j < 0) {
    *Rg = load9<S>(row + (int)G[G_REF_ROT]);
    *pg = load3<S>(row + (int)G[G_REF_TRANS]);
    return;
  }
  *Rg = matmul(oR[j], load9<S>(G + G_ROT));
  *pg = matvec(oR[j], load3<S>(G + G_TRANS)) + op[j];
}

// Signed capsule-capsule distance with the branch-free Ericson clamps of
// `batched_costs._capsule_distance_c` (Pallas :272-280); each capsule's axis
// is its local z column, half length 0 is a sphere.
template <class S>
AG_FN S capsule_distance(const M3<S>& R1, const V3<S>& p1, float r1,
                         float l1, const M3<S>& R2, const V3<S>& p2, float r2,
                         float l2) {
  V3<S> d1, d2;
  d1[0] = R1[2]; d1[1] = R1[5]; d1[2] = R1[8];
  d2[0] = R2[2]; d2[1] = R2[5]; d2[2] = R2[8];
  V3<S> r = p1 - p2;
  S a = dot(d1, d1), e = dot(d2, d2), b = dot(d1, d2);
  S c = dot(d1, r), f = dot(d2, r);
  S denom = a * e - b * b;
  bool degenerate = val(denom) < 1e-9f;
  S s = degenerate ? S(0.f) : (b * f - c * e) / denom;
  s = s_clamp(s, -l1, l1);
  S e_safe = val(e) < 1e-12f ? S(1.f) : e;
  S t = s_clamp((b * s + f) / e_safe, -l2, l2);
  S a_safe = val(a) < 1e-12f ? S(1.f) : a;
  s = s_clamp((b * t - c) / a_safe, -l1, l1);
  V3<S> diff = (p1 + scale<S>(s, d1)) - (p2 + scale<S>(t, d2));
  return s_sqrt(dot(diff, diff) + S(1e-12f)) - S(r1) - S(r2);
}

// Residual of a collision item at q: the signed distance of its pair.
template <int NJ, class S>
AG_FN S collision_residual(const float* C, const float* D, const float* row,
                           const S* q) {
  M3<S> oR[NJ];
  V3<S> op[NJ];
  world_placements<NJ, S>(C, q, oR, op);
  const float* G1 = D + Desc<NJ>::GEOM;
  const float* G2 = D + Desc<NJ>::GEOM + GSTRIDE;
  M3<S> R1, R2;
  V3<S> p1, p2;
  geometry_pose<S>(G1, row, oR, op, &R1, &p1);
  geometry_pose<S>(G2, row, oR, op, &R2, &p2);
  return capsule_distance<S>(R1, p1, G1[G_RADIUS], G1[G_HALFLEN], R2, p2,
                             G2[G_RADIUS], G2[G_HALFLEN]);
}

// Spatial velocity [w; v] of the item's frame (placement Rf, pf) at the
// world placements oR, op and joint velocities v, in the item's convention
// (`batched_costs._frame_velocity_c`, Pallas :266-271): the twist of the
// root-to-frame joint chain at the world origin, moved to the frame origin
// (v - pf x w) and, for V_LOCAL, rotated into the frame.
template <int NJ, class S>
AG_FN void frame_velocity(const float* C, const float* D, const M3<S>* oR,
                          const V3<S>* op, const S* v, const M3<S>& Rf,
                          const V3<S>& pf, S* out) {
  int chain[NJ], n = 0;
  for (int j = (int)D[I_PJOINT]; j >= 0; j = parent_of(C, j)) chain[n++] = j;
  V3<S> w = zero3<S>(), v0 = zero3<S>();
  for (int c = n - 1; c >= 0; --c) {  // root first, as the plain version
    int i = chain[c];
    V3<S> ax = load3<S>(C + i * JSTRIDE + J_AXIS);
    if (revolute(C, i)) {
      V3<S> Sw = matvec(oR[i], ax);
      w = w + scale<S>(v[i], Sw);
      v0 = v0 + scale<S>(v[i], cross(op[i], Sw));
    } else {
      v0 = v0 + scale<S>(v[i], matvec(oR[i], ax));
    }
  }
  int conv = (int)D[Desc<NJ>::VEL_FRAME];
  if (conv != V_WORLD) v0 = v0 - cross(pf, w);
  if (conv == V_LOCAL) {
    w = mattvec(Rf, w);
    v0 = mattvec(Rf, v0);
  }
  for (int i = 0; i < 3; ++i) {
    out[i] = w[i];
    out[3 + i] = v0[i];
  }
}

// Residual of a frame, visual-servoing, frame-velocity or collision cost
// item at (q, v); returns its dimension (6, 3 or 1). Only frame_velocity
// reads v.
template <int NJ, class S>
AG_FN int frame_residual(const float* C, const float* D, const float* row,
                         int kind, const S* q, const S* v, S* r) {
  if (kind == K_COLLISION) {
    r[0] = collision_residual<NJ, S>(C, D, row, q);
    return 1;
  }
  M3<S> oR[NJ];
  V3<S> op[NJ];
  world_placements<NJ, S>(C, q, oR, op);
  int j = (int)D[I_PJOINT];
  M3<S> Rf = matmul(oR[j], load9<S>(D + I_FROT));
  V3<S> pf = matvec(oR[j], load3<S>(D + I_FTRANS)) + op[j];
  if (kind == K_FRAME_VELOCITY) {
    frame_velocity<NJ, S>(C, D, oR, op, v, Rf, pf, r);
    const float* ref = row + (int)D[I_REF];
    for (int i = 0; i < 6; ++i) r[i] = r[i] - S(ref[i]);
    return 6;
  }
  M3<S> refR = load9<S>(row + (int)D[I_REF]);
  V3<S> refp = load3<S>(row + (int)D[I_TRANS]);
  if (kind == K_VISUAL_SERVOING) {
    // target wMo * oMf_ref (Pallas `_pose_target_c`, :215-221)
    M3<S> wR = load9<S>(row + (int)D[Desc<NJ>::WMO_ROT]);
    V3<S> wp = load3<S>(row + (int)D[Desc<NJ>::WMO_TRANS]);
    refp = matvec(wR, refp) + wp;
    refR = matmul(wR, refR);
  }
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
template <int NJ>
AG_HD float item_weight(const float* D, const float* row, int i) {
  int off = (int)D[I_W];
  return off >= 0 ? row[off + i] : D[Desc<NJ>::SW + i];
}
AG_HD float item_ref(const float* D, const float* row, int i) {
  int off = (int)D[I_REF];
  return off >= 0 ? row[off + i] : D[I_SREF + i];
}

// Activation of a residual r [nr]: returns a(r), fills da/dr and the
// Gauss-Newton diagonal of d2a/dr2 (Pallas `_activation_c`, :188-208).
template <int NJ>
AG_FN float activation(const float* D, const float* row, int nr,
                       const float* r, float* a_dr, float* a_drr) {
  int act = (int)D[Desc<NJ>::ACT];
  if (act == A_WEIGHTED_QUAD) {
    float a = 0.f;
    for (int i = 0; i < nr; ++i) {
      float w = item_weight<NJ>(D, row, i);
      a += 0.5f * w * r[i] * r[i];
      a_dr[i] = w * r[i];
      a_drr[i] = w;
    }
    return a;
  }
  float alpha = D[Desc<NJ>::ALPHA];
  float rr = 0.f;
  for (int i = 0; i < nr; ++i) rr += r[i] * r[i];
  if (act == A_EXP) {
    float d = sqrtf(rr + 1e-12f);
    float a = expf(-d / alpha);
    float sc = -a / (alpha * d);
    for (int i = 0; i < nr; ++i) {
      a_dr[i] = sc * r[i];
      a_drr[i] = a / (alpha * alpha);
    }
    return a;
  }
  float a = expf(-rr / alpha);  // quad_exp
  for (int i = 0; i < nr; ++i) {
    a_dr[i] = (-2.f / alpha) * a * r[i];
    a_drr[i] = (4.f / (alpha * alpha)) * a * r[i] * r[i];
  }
  return a;
}

// Cost item `it` of the table: returns its weighted value and, when
// DERIVS, adds its Gauss-Newton terms into lx [NX], lu [NJ], lxx [NX*NX],
// lxu [NX*NJ], luu [NJ*NJ] (row-major).
template <int NJ, bool DERIVS>
AG_FN float item_costs(const float* C, int it, const float* row,
                       const float* q, const float* v, const float* u,
                       const M3<float>* R, const V3<float>* P, float* lx,
                       float* lu, float* lxx, float* lxu, float* luu) {
  constexpr int NX = 2 * NJ;
  const float* D = C + NJ * JSTRIDE + 3 + it * Desc<NJ>::STRIDE;
  int kind = (int)D[I_KIND];
  float wgt = D[I_WEIGHT];
  // streamed w_collision_avoidance scale of an update=True collision item
  // (Pallas :482-483, :631-632)
  if ((int)D[Desc<NJ>::WCOLL] >= 0) wgt *= row[(int)D[Desc<NJ>::WCOLL]];
  float li = 0.f;
  if (kind == K_STATE || kind == K_CONTROL) {
    int n = kind == K_STATE ? NX : NJ;
    for (int i = 0; i < n; ++i) {
      float xi = kind == K_CONTROL ? u[i] : (i < NJ ? q[i] : v[i - NJ]);
      float r = xi - item_ref(D, row, i);
      float w = item_weight<NJ>(D, row, i);
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
      float w = item_weight<NJ>(D, row, i);
      float r = u[i] - g[i];
      wr[i] = w * r;
      li += 0.5f * w * r * r;
    }
    if (DERIVS) {
      // J_u = I, J_x = [-Jg, 0]
      for (int i = 0; i < NJ; ++i) {
        lu[i] += wgt * wr[i];
        luu[i * NJ + i] += wgt * item_weight<NJ>(D, row, i);
      }
      for (int k = 0; k < NJ; ++k) {
        float s = 0.f;
        for (int i = 0; i < NJ; ++i) s += Jg[k][i] * wr[i];
        lx[k] += -wgt * s;
        for (int i = 0; i < NJ; ++i)
          lxu[k * NJ + i] += -wgt * Jg[k][i] * item_weight<NJ>(D, row, i);
        for (int k2 = 0; k2 <= k; ++k2) {
          float h = 0.f;
          for (int i = 0; i < NJ; ++i)
            h += Jg[k][i] * item_weight<NJ>(D, row, i) * Jg[k2][i];
          lxx[k * NX + k2] += wgt * h;
          if (k2 != k) lxx[k2 * NX + k] += wgt * h;
        }
      }
    }
  } else {  // frame, visual-servoing and collision kinds: residual of q;
            // frame_velocity: of q and v
    // Jc[k][i] = d r_i / d x_k over the nd tangents (x = (q, v))
    const int nd = kind == K_FRAME_VELOCITY ? NX : NJ;
    float r[6], Jc[NX][6];
    int nr = 0;
    if (DERIVS) {
      for (int k = 0; k < nd; ++k) {
        Dual qd[NJ], vd[NJ], rd[6];
        for (int i = 0; i < NJ; ++i) {
          qd[i] = Dual(q[i], i == k ? 1.f : 0.f);
          vd[i] = Dual(v[i], NJ + i == k ? 1.f : 0.f);
        }
        nr = frame_residual<NJ, Dual>(C, D, row, kind, qd, vd, rd);
        for (int i = 0; i < nr; ++i) {
          r[i] = rd[i].v;
          Jc[k][i] = rd[i].d;
        }
      }
    } else {
      nr = frame_residual<NJ, float>(C, D, row, kind, q, v, r);
    }
    float a_dr[6], a_drr[6];
    li = activation<NJ>(D, row, nr, r, a_dr, a_drr);
    if (DERIVS) {
      for (int k = 0; k < nd; ++k) {
        float s = 0.f;
        for (int i = 0; i < nr; ++i) s += Jc[k][i] * a_dr[i];
        lx[k] += wgt * s;
        for (int k2 = 0; k2 <= k; ++k2) {
          float h = 0.f;
          for (int i = 0; i < nr; ++i) h += Jc[k][i] * a_drr[i] * Jc[k2][i];
          lxx[k * NX + k2] += wgt * h;
          if (k2 != k) lxx[k2 * NX + k] += wgt * h;
        }
      }
    }
  }
  return wgt * li;
}

// Adds every cost item of the table (Gauss-Newton when DERIVS) into l and
// lx, lu, lxx, lxu, luu (`item_costs`), in the table's order.
template <int NJ, bool DERIVS>
AG_FN void node_costs(const float* C, int n_items, const float* row,
                      const float* q, const float* v, const float* u,
                      const M3<float>* R, const V3<float>* P, float* l,
                      float* lx, float* lu, float* lxx, float* lxu,
                      float* luu) {
  for (int it = 0; it < n_items; ++it)
    *l += item_costs<NJ, DERIVS>(C, it, row, q, v, u, R, P, lx, lu, lxx,
                                 lxu, luu);
}

// ---- the dynamics of one node on one thread (K2) ---------------------------
// Semi-implicit Euler step at (q, v, u, dt = h): joint transforms, RNEA bias,
// mass matrix, Cholesky, x+ into xo [NX]; when DERIVS also Fx into fx
// [NX*NX] and Fu into fu [NX*NJ] (row-major): 2 NJ dual-number RNEA passes
// and the M^-1 columns (K5a's and K5b's one-thread body before the `k5_*`
// phases; the host harness holds those against it). The joint transforms
// at q are left in R, P for the caller's cost items. The Pallas body is
// `pallas_dynamics.py::dynamics_terms`.
template <int NJ, bool DERIVS>
AG_FN void dynamics_node(const float* C, const float* q, const float* v,
                         const float* un, float h, M3<float>* R, V3<float>* P,
                         float* xo, float* fx, float* fu) {
  constexpr int NX = 2 * NJ;
  joint_transforms<NJ, float>(C, q, R, P);
  float z[NJ], b[NJ], M[NJ * NJ], L[NJ * NJ], rhs[NJ], a[NJ];
  for (int i = 0; i < NJ; ++i) z[i] = 0.f;
  rnea<NJ, float>(C, R, P, v, z, b);
  mass_matrix<NJ>(C, R, P, M);
  chol_factor<NJ>(M, L);
  for (int i = 0; i < NJ; ++i) rhs[i] = un[i] - b[i];
  chol_solve<NJ>(L, rhs, a);
  for (int i = 0; i < NJ; ++i) {
    float vn = v[i] + h * a[i];
    xo[NJ + i] = vn;
    xo[i] = q[i] + h * vn;
  }
  if (DERIVS) {
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
  }
}

// ---- K5b: one node across the lanes of a warp slice -----------------------
// LANES = the power of two >= 2 NJ lanes run one node (16 for the Panda), at
// most 32: past 16 joints a lane takes items lane, lane + 32, ... of each
// phase (2 tangents on lanes 0-1 at NJ = 17). The primal step is computed
// once per node and shared through the node's scratch; the phases, with a
// warp barrier between them (the .cu kernel places them):
//   k5_place      joint i's placement at q_i, on lane i mod LANES;
//   k5_mass_bias  pass j < NJ column j of the mass matrix, pass NJ the bias
//                 rnea(q, v, 0) and the joints' velocity values, pass j on
//                 lane j mod LANES;
//   k5_solve      lane 0 the Cholesky factor L, a = M^-1 (u - b) and the
//                 joints' acceleration values and forces of rnea(q, v, a)
//                 (one serial chain; no lane waits on it less by repeating
//                 it);
//   k5_tangent    tangent k < NX on lane k mod LANES: x+ component k and
//                 the derivative parts of rnea(q, v, a) along tangent k of
//                 (q, v), forward mode around the shared primal values ->
//                 Fx column k; for k < NJ the M^-1 column k -> Fu column k.
// x+, Fx and Fu go to the node's output scratch; the kernel stores a
// block's outputs together, at consecutive addresses.
template <int NJ> struct K5Shape {
  static constexpr int NX = 2 * NJ;
  static constexpr int LANES = node_lanes(NX);
  // node scratch (floats): placements R [NJ][9] and P [NJ][3], M, the
  // bias b, a, the Cholesky factor L, then per joint the primal values of
  // rnea(q, v, a), JV 3-vectors each (`JointValue`)
  static constexpr int S_R = 0, S_P = 9 * NJ, S_M = 12 * NJ,
                       S_B = S_M + NJ * NJ, S_A = S_B + NJ, S_L = S_A + NJ,
                       S_J = S_L + NJ * NJ;
  static constexpr int JV = 8;
  static constexpr int SIZE = S_J + 3 * JV * NJ;
};
// a joint's primal values: velocity w, v and acceleration aw, al (angular,
// linear, in the joint frame), the momenta hf, hn, the force fn, ff (the
// joint's own, then with its subtree's after the backward pass)
enum JointValue { JW, JVL, JAW, JAL, JHF, JHN, JFN, JFF };

template <int NJ>
AG_HD M3<float>* k5_R(float* S) {
  return reinterpret_cast<M3<float>*>(S + K5Shape<NJ>::S_R);
}
template <int NJ>
AG_HD V3<float>* k5_P(float* S) {
  return reinterpret_cast<V3<float>*>(S + K5Shape<NJ>::S_P);
}
template <int NJ>
AG_HD V3<float>* k5_J(float* S) {  // [NJ][JV]
  return reinterpret_cast<V3<float>*>(S + K5Shape<NJ>::S_J);
}

template <int NJ, int LANES>
AG_FN void k5_place(int lane, const float* C, const float* xn, float* S) {
  for (int r = 0; r < rounds(NJ, LANES); ++r) {
    const int i = r * LANES + lane;
    if (i >= NJ) break;
    joint_transform<float>(C, i, xn[i], k5_R<NJ>(S)[i], k5_P<NJ>(S)[i]);
  }
}

// The parent of joint i: i - 1 over a serial chain (CHAIN), where the
// joint loops unroll and per-joint arrays indexed so stay in registers.
template <int NJ, bool CHAIN>
AG_HD int k5_parent(const float* C, int i) {
  return CHAIN ? i - 1 : parent_of(C, i);
}

// The bias b = rnea(q, v, 0) (the operations of `rnea`) into the scratch,
// with each joint's velocity values w, v, hf, hn, which do not depend on
// the acceleration, into the joint table when VALUES (K5b's tangents read
// them; K5a's scratch ends before the table).
template <int NJ, bool CHAIN, bool VALUES>
AG_FN void k5_bias(const float* C, const float* xn, const ForceSlots& fs,
                   float* S) {
  typedef K5Shape<NJ> K;
  const M3<float>* R = k5_R<NJ>(S);
  const V3<float>* P = k5_P<NJ>(S);
  V3<float>* Jv = k5_J<NJ>(S);
  const float* g = C + NJ * JSTRIDE;
  V3<float> w[NJ], lv[NJ], aw[NJ], al[NJ];
  AG_UNROLL
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    const int par = k5_parent<NJ, CHAIN>(C, i);
    V3<float> vpw = zero3<float>(), vpl = zero3<float>(),
              apw = zero3<float>(), apl;
    if (par >= 0) {
      vpw = w[par]; vpl = lv[par]; apw = aw[par]; apl = al[par];
    } else {
      apl[0] = -g[0]; apl[1] = -g[1]; apl[2] = -g[2];
    }
    V3<float> wi = mattvec(R[i], vpw);
    V3<float> vi = mattvec(R[i], vpl - cross(P[i], vpw));
    V3<float> wai = mattvec(R[i], apw);
    V3<float> vai = mattvec(R[i], apl - cross(P[i], apw));
    V3<float> ax = load3<float>(J + J_AXIS);
    V3<float> sdot = scale<float>(xn[NJ + i], ax);
    if (revolute(C, i)) {
      wi = wi + sdot;
      wai = wai + cross(wi, sdot);
      vai = vai + cross(vi, sdot);
    } else {
      vi = vi + sdot;
      vai = vai + cross(wi, sdot);
    }
    w[i] = wi; lv[i] = vi; aw[i] = wai; al[i] = vai;
    const float m = J[J_MASS];
    V3<float> c = load3<float>(J + J_COM);
    M3<float> I = load9<float>(J + J_INER);
    V3<float> hf = scale<float>(m, vi + cross(wi, c));
    V3<float> hn = matvec(I, wi) + cross(c, hf);
    V3<float> f_l = scale<float>(m, vai + cross(wai, c));
    V3<float> f_n = matvec(I, wai) + cross(c, f_l);
    fs.set(i, 0, f_n + (cross(wi, hn) + cross(vi, hf)));
    fs.set(i, 1, f_l + cross(wi, hf));
    if (VALUES) {
      V3<float>* jv = Jv + i * K::JV;
      jv[JW] = wi; jv[JVL] = vi; jv[JHF] = hf; jv[JHN] = hn;
    }
  }
  AG_UNROLL
  for (int i = NJ - 1; i >= 0; --i) {
    V3<float> ax = load3<float>(C + i * JSTRIDE + J_AXIS);
    const V3<float> fn = fs.get(i, 0), ff = fs.get(i, 1);
    S[K::S_B + i] = revolute(C, i) ? dot(ax, fn) : dot(ax, ff);
    const int par = k5_parent<NJ, CHAIN>(C, i);
    if (par >= 0) {
      V3<float> flp = matvec(R[i], ff);
      V3<float> fnp = matvec(R[i], fn) + cross(P[i], flp);
      fs.set(par, 0, fs.get(par, 0) + fnp);
      fs.set(par, 1, fs.get(par, 1) + flp);
    }
  }
}

// rnea(q, v, a)'s acceleration values aw, al and forces fn, ff (with the
// subtree's) per joint into the joint table, around its velocity values
// (`k5_bias`): the operations of `rnea`.
template <int NJ, bool CHAIN>
AG_FN void k5_primal(const float* C, const float* xn, const float* a,
                     const ForceSlots& fs, float* S) {
  typedef K5Shape<NJ> K;
  const M3<float>* R = k5_R<NJ>(S);
  const V3<float>* P = k5_P<NJ>(S);
  V3<float>* Jv = k5_J<NJ>(S);
  const float* g = C + NJ * JSTRIDE;
  V3<float> aw[NJ], al[NJ];
  AG_UNROLL
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    const int par = k5_parent<NJ, CHAIN>(C, i);
    V3<float> apw = zero3<float>(), apl;
    if (par >= 0) {
      apw = aw[par]; apl = al[par];
    } else {
      apl[0] = -g[0]; apl[1] = -g[1]; apl[2] = -g[2];
    }
    V3<float>* jv = Jv + i * K::JV;
    const V3<float> wi = jv[JW], vi = jv[JVL];
    V3<float> wai = mattvec(R[i], apw);
    V3<float> vai = mattvec(R[i], apl - cross(P[i], apw));
    V3<float> ax = load3<float>(J + J_AXIS);
    V3<float> sdot = scale<float>(xn[NJ + i], ax);
    if (revolute(C, i)) {
      wai = wai + scale<float>(a[i], ax);
      wai = wai + cross(wi, sdot);
      vai = vai + cross(vi, sdot);
    } else {
      vai = vai + scale<float>(a[i], ax);
      vai = vai + cross(wi, sdot);
    }
    aw[i] = wai; al[i] = vai;
    jv[JAW] = wai; jv[JAL] = vai;
    const float m = J[J_MASS];
    V3<float> c = load3<float>(J + J_COM);
    M3<float> I = load9<float>(J + J_INER);
    const V3<float> hf = jv[JHF], hn = jv[JHN];
    V3<float> f_l = scale<float>(m, vai + cross(wai, c));
    V3<float> f_n = matvec(I, wai) + cross(c, f_l);
    fs.set(i, 0, f_n + (cross(wi, hn) + cross(vi, hf)));
    fs.set(i, 1, f_l + cross(wi, hf));
  }
  AG_UNROLL
  for (int i = NJ - 1; i >= 0; --i) {
    V3<float>* jv = Jv + i * K::JV;
    const V3<float> fn = fs.get(i, 0), ff = fs.get(i, 1);
    jv[JFN] = fn;
    jv[JFF] = ff;
    const int par = k5_parent<NJ, CHAIN>(C, i);
    if (par >= 0) {
      V3<float> flp = matvec(R[i], ff);
      V3<float> fnp = matvec(R[i], fn) + cross(P[i], flp);
      fs.set(par, 0, fs.get(par, 0) + fnp);
      fs.set(par, 1, fs.get(par, 1) + flp);
    }
  }
}

// Passes j = lane, lane + LANES, ... <= NJ: j < NJ the mass-matrix column
// j, j = NJ the bias. VALUES as `k5_bias`: K5b keeps the velocity values,
// K5a does not.
template <int NJ, int LANES, bool VALUES = true>
AG_FN void k5_mass_bias(int lane, const float* C, const float* xn,
                        const ForceSlots& fs, float* S) {
  typedef K5Shape<NJ> K;
  const M3<float>* R = k5_R<NJ>(S);
  const V3<float>* P = k5_P<NJ>(S);
  for (int r = 0; r < rounds(NJ + 1, LANES); ++r) {
    const int j = r * LANES + lane;
    if (j > NJ) break;
    if (j < NJ) {
      if (is_chain<NJ>(C))
        mass_matrix_column_chain<NJ>(C, R, P, j, fs, S + K::S_M);
      else
        mass_matrix_column<NJ>(C, R, P, j, S + K::S_M);
    } else {
      if (is_chain<NJ>(C))
        k5_bias<NJ, true, VALUES>(C, xn, fs, S);
      else
        k5_bias<NJ, false, VALUES>(C, xn, fs, S);
    }
  }
}

template <int NJ>
AG_FN void k5_solve(int lane, const float* C, const float* xn,
                    const float* un, const ForceSlots& fs, float* S) {
  typedef K5Shape<NJ> K;
  if (lane != 0) return;
  float L[NJ * NJ], rhs[NJ], a[NJ];
  chol_factor<NJ>(S + K::S_M, L);
  for (int i = 0; i < NJ; ++i) rhs[i] = un[i] - S[K::S_B + i];
  chol_solve<NJ>(L, rhs, a);
  for (int i = 0; i < NJ * NJ; ++i) S[K::S_L + i] = L[i];
  for (int i = 0; i < NJ; ++i) S[K::S_A + i] = a[i];
  if (is_chain<NJ>(C))
    k5_primal<NJ, true>(C, xn, a, fs, S);
  else
    k5_primal<NJ, false>(C, xn, a, fs, S);
}

// d rnea(q, v, a) / d(q, v) along tangent (kq: q_kq, or kv: v_kv; the
// other -1) into dtau, a held fixed: the forward-mode derivative parts of
// `rnea` around the primal values of `k5_primal`. q enters only through
// the placements, so the q-tangent differentiates joint kq's alone (dR,
// dP). CHAIN as `k5_parent`. The joints' force derivatives wait for the
// backward pass in fs.
template <int NJ, bool CHAIN>
AG_FN void k5_tangent_rnea(const float* C, const float* xn, const float* S,
                           int kq, int kv, const ForceSlots& fs,
                           float* dtau) {
  typedef K5Shape<NJ> K;
  const M3<float>* R = reinterpret_cast<const M3<float>*>(S + K::S_R);
  const V3<float>* P = reinterpret_cast<const V3<float>*>(S + K::S_P);
  const V3<float>* Jv = reinterpret_cast<const V3<float>*>(S + K::S_J);
  const float* g = C + NJ * JSTRIDE;
  M3<float> dR;
  V3<float> dP;
  for (int c = 0; c < 9; ++c) dR[c] = 0.f;
  dP = zero3<float>();
  if (kq >= 0) {
    M3<Dual> Rk;
    V3<Dual> Pk;
    joint_transform<Dual>(C, kq, Dual(xn[kq], 1.f), Rk, Pk);
    for (int c = 0; c < 9; ++c) dR[c] = Rk[c].d;
    for (int c = 0; c < 3; ++c) dP[c] = Pk[c].d;
  }
  V3<float> dw[NJ], dv[NJ], daw[NJ], dal[NJ];
  AG_UNROLL
  for (int i = 0; i < NJ; ++i) {
    const float* J = C + i * JSTRIDE;
    const int par = k5_parent<NJ, CHAIN>(C, i);
    const V3<float>* jv = Jv + i * K::JV;
    V3<float> dpw = zero3<float>(), dpl = zero3<float>(),
              dapw = zero3<float>(), dapl = zero3<float>();
    if (par >= 0) {
      dpw = dw[par]; dpl = dv[par]; dapw = daw[par]; dapl = dal[par];
    }
    V3<float> dwi = mattvec(R[i], dpw);
    V3<float> dvi = mattvec(R[i], dpl - cross(P[i], dpw));
    V3<float> dwai = mattvec(R[i], dapw);
    V3<float> dvai = mattvec(R[i], dapl - cross(P[i], dapw));
    if (i == kq) {  // the placement's own derivative, at the parent's values
      V3<float> pw = zero3<float>(), pl = zero3<float>(),
                paw = zero3<float>(), pal;
      if (par >= 0) {
        const V3<float>* pv = Jv + par * K::JV;
        pw = pv[JW]; pl = pv[JVL]; paw = pv[JAW]; pal = pv[JAL];
      } else {
        pal[0] = -g[0]; pal[1] = -g[1]; pal[2] = -g[2];
      }
      dwi = dwi + mattvec(dR, pw);
      dvi = dvi + mattvec(dR, pl - cross(P[i], pw)) -
            mattvec(R[i], cross(dP, pw));
      dwai = dwai + mattvec(dR, paw);
      dvai = dvai + mattvec(dR, pal - cross(P[i], paw)) -
             mattvec(R[i], cross(dP, paw));
    }
    const V3<float> ax = load3<float>(J + J_AXIS);
    const V3<float> sdot = scale<float>(xn[NJ + i], ax);
    const V3<float> dsdot = i == kv ? ax : zero3<float>();
    const V3<float> wi = jv[JW], vi = jv[JVL];
    if (revolute(C, i)) {
      dwi = dwi + dsdot;
      dwai = dwai + (cross(dwi, sdot) + cross(wi, dsdot));
      dvai = dvai + (cross(dvi, sdot) + cross(vi, dsdot));
    } else {
      dvi = dvi + dsdot;
      dvai = dvai + (cross(dwi, sdot) + cross(wi, dsdot));
    }
    const float m = J[J_MASS];
    const V3<float> c = load3<float>(J + J_COM);
    const M3<float> I = load9<float>(J + J_INER);
    const V3<float> hf = jv[JHF], hn = jv[JHN];
    V3<float> dhf = scale<float>(m, dvi + cross(dwi, c));
    V3<float> dhn = matvec(I, dwi) + cross(c, dhf);
    V3<float> dfl = scale<float>(m, dvai + cross(dwai, c));
    V3<float> dfnl = matvec(I, dwai) + cross(c, dfl);
    fs.set(i, 0, dfnl + ((cross(dwi, hn) + cross(wi, dhn)) +
                          (cross(dvi, hf) + cross(vi, dhf))));
    fs.set(i, 1, dfl + (cross(dwi, hf) + cross(wi, dhf)));
    dw[i] = dwi; dv[i] = dvi; daw[i] = dwai; dal[i] = dvai;
  }
  AG_UNROLL
  for (int i = NJ - 1; i >= 0; --i) {
    const V3<float> ax = load3<float>(C + i * JSTRIDE + J_AXIS);
    const V3<float> dfn = fs.get(i, 0), dff = fs.get(i, 1);
    dtau[i] = revolute(C, i) ? dot(ax, dfn) : dot(ax, dff);
    const int par = k5_parent<NJ, CHAIN>(C, i);
    if (par < 0) continue;
    V3<float> dflp = matvec(R[i], dff);
    V3<float> dfnp = matvec(R[i], dfn);
    if (i == kq) {  // the placement's own derivative, at the subtree's force
      const V3<float>* jv = Jv + i * K::JV;
      dflp = dflp + matvec(dR, jv[JFF]);
      dfnp = dfnp + matvec(dR, jv[JFN]) +
             cross(dP, matvec(R[i], jv[JFF]));
    }
    dfnp = dfnp + cross(P[i], dflp);
    fs.set(par, 0, fs.get(par, 0) + dfnp);
    fs.set(par, 1, fs.get(par, 1) + dflp);
  }
}

// Tangent k of the node: x+ component k, Fx column k and, for k < NJ, Fu
// column k.
template <int NJ>
AG_FN void k5_tangent_one(int k, const float* C, const float* xn, float h,
                          const float* S, const ForceSlots& fs, float* xo,
                          float* fx, float* fu) {
  typedef K5Shape<NJ> K;
  constexpr int NX = K::NX;
  const float* L = S + K::S_L;
  const float* a = S + K::S_A;
  const float h2 = h * h;
  // x+: semi-implicit Euler, lane i component i
  const int c = k % NJ;
  const float vn = xn[NJ + c] + h * a[c];
  xo[k] = k < NJ ? xn[c] + h * vn : vn;
  float dtau[NJ];
  if (is_chain<NJ>(C))
    k5_tangent_rnea<NJ, true>(C, xn, S, k < NJ ? k : -1,
                              k < NJ ? -1 : k - NJ, fs, dtau);
  else
    k5_tangent_rnea<NJ, false>(C, xn, S, k < NJ ? k : -1,
                               k < NJ ? -1 : k - NJ, fs, dtau);
  float col[NJ], da[NJ];
  for (int i = 0; i < NJ; ++i) col[i] = -dtau[i];
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
  if (k < NJ) {  // Fu: the M^-1 column k
    float e[NJ], mcol[NJ];
    for (int i = 0; i < NJ; ++i) e[i] = i == k ? 1.f : 0.f;
    chol_solve<NJ>(L, e, mcol);
    for (int i = 0; i < NJ; ++i) {
      fu[i * NJ + k] = h2 * mcol[i];
      fu[(NJ + i) * NJ + k] = h * mcol[i];
    }
  }
}

// Lane `lane` takes the tangents lane, lane + LANES, ... < NX.
template <int NJ>
AG_FN void k5_tangent(int lane, const float* C, const float* xn, float h,
                      const float* S, const ForceSlots& fs, float* xo,
                      float* fx, float* fu) {
  typedef K5Shape<NJ> K;
  for (int r = 0; r < rounds(K::NX, K::LANES); ++r) {
    const int k = r * K::LANES + lane;
    if (k >= K::NX) break;
    k5_tangent_one<NJ>(k, C, xn, h, S, fs, xo, fx, fu);
  }
}

// ---- K5a: the primal step of one node across NJ + 1 lanes -----------------
// LANES = the power of two >= NJ + 1 lanes run one node (8 for the Panda,
// 4 for the 2-DoF arm, 32 from 16 joints on), in K5b's first two phases and
// a finish of its own, with a warp barrier between them:
//   k5_place            joint i's placement at q_i, on lane i mod LANES;
//   k5_mass_bias<NJ, LANES, false>  pass j < NJ column j of the mass
//                       matrix, pass NJ the bias rnea(q, v, 0), pass j on
//                       lane j mod LANES;
//   k5a_finish          lane 0 the Cholesky factor, a = M^-1 (u - b) and
//                       x+ (K5b's `k5_solve` also keeps L, a and the
//                       forces of rnea(q, v, a) for its tangents; K5a needs
//                       none of them).
// The scratch holds what these phases read: the placements, M and b.
template <int NJ> struct K5aShape {
  static constexpr int LANES = node_lanes(NJ + 1);
  static constexpr int SIZE = K5Shape<NJ>::S_A;  // R, P, M, b
};

template <int NJ>
AG_FN void k5a_finish(int lane, const float* xn, const float* un, float h,
                      const float* S, float* xo) {
  typedef K5Shape<NJ> K;
  if (lane != 0) return;
  float L[NJ * NJ], rhs[NJ], a[NJ];
  chol_factor<NJ>(S + K::S_M, L);
  for (int i = 0; i < NJ; ++i) rhs[i] = un[i] - S[K::S_B + i];
  chol_solve<NJ>(L, rhs, a);
  for (int i = 0; i < NJ; ++i) {  // semi-implicit Euler
    const float vn = xn[NJ + i] + h * a[i];
    xo[NJ + i] = vn;
    xo[i] = xn[i] + h * vn;
  }
}

// ---- refs gathered in the kernel (K1/K2) ----------------------------------
// One entry per layout key of `ops/cuda_costs.py::_ref_layout`, passed by
// value as a kernel parameter: node time t's columns [off, off + ncomp) of
// the packed ref row are src[(per_node ? t : row) * stride + i]. A null src
// (a key the caller does not stream) reads 0. Must match
// `ops/cuda_costs.py::RefSrc` / `RefTable`.
constexpr int kMaxRefs = 24;
struct RefSrc {
  const float* src;
  long long stride;  // floats between two node times, or geometry rows
  int ncomp, per_node, row, off;
};
struct RefTable {
  int n;
  RefSrc e[kMaxRefs];
};

// Lane `lane` of `lanes` copies its share of node time t's ref row into
// row. Per key, a lane issues all its loads (G of them; a key has at most
// G * lanes components on this path) before its stores, so it waits on
// memory once per key and not once per value.
template <int G>
AG_FN void gather_row(const RefTable& tab, long long t, int lane, int lanes,
                      float* row) {
  for (int k = 0; k < tab.n; ++k) {
    const RefSrc& s = tab.e[k];
    const long long base = (s.per_node ? t : (long long)s.row) * s.stride;
    float buf[G];
    AG_UNROLL
    for (int c = 0; c < G; ++c) {
      const int i = lane + c * lanes;
      buf[c] = s.src && i < s.ncomp ? s.src[base + i] : 0.f;
    }
    AG_UNROLL
    for (int c = 0; c < G; ++c) {
      const int i = lane + c * lanes;
      if (i < s.ncomp) row[s.off + i] = buf[c];
    }
    for (int i = lane + G * lanes; i < s.ncomp; i += lanes)
      row[s.off + i] = s.src ? s.src[base + i] : 0.f;
  }
}

// ---- K1: one node across the lanes of a warp slice ------------------------
// LANES = the power of two >= 2 NJ lanes run one node (16 for the Panda), at
// most 32: past 16 joints lane k takes tangents k, k + 32, ... (lanes 0-1
// two each at NJ = 17, a node's chain about twice as long).
// Phases, with a warp barrier between them (the .cu kernel places them):
//   k1_load      the node's x, u, dt and gathered ref row into its scratch;
//   k1_dynamics  every lane the primal step (redundantly; one lane per
//                component stores x+), then lane k the RNEA tangents k,
//                k + LANES, ... of (q, v) -> Fx columns and the M^-1
//                columns k, k + LANES, ... < NJ -> Fu columns, into the
//                scratch;
//   per cost item, in the table's order:
//     k1_item_tangent     every lane the item's value; lane k its tangents
//                         k, k + LANES, ... -> those rows of the item's
//                         Jacobian in the scratch;
//     k1_item_accumulate  each lane adds the item's Gauss-Newton terms to
//                         the output entries it owns (e = lane mod LANES of
//                         the node's lx | lu | lxx | lxu | luu), in registers;
//   k1_store     Fx, Fu from the scratch and the owned entries, dt-scaled,
//                each stored once at consecutive addresses across the lanes.
// The sums run in the order of the one-thread version, so the outputs are
// the same numbers up to the order of the tangent evaluations.
template <int NJ> struct K1Shape {
  static constexpr int NX = 2 * NJ;
  static constexpr int LANES = node_lanes(NX);
  // owned output entries: lx, lu, lxx, lxu, luu of one node
  static constexpr int NE = NX + NJ + NX * NX + NX * NJ + NJ * NJ;
  // loads per lane and ref key in the gather: the widest key is xref / w_x
  // (NX) or a rotation (9)
  static constexpr int GATHER = ((NX > 9 ? NX : 9) + LANES - 1) / LANES;
  static constexpr int OWN = (NE + LANES - 1) / LANES;
  // node scratch (floats): x, u, dt, Fx, Fu, one item's Jacobian (Jc [nd][6]
  // or Jg [NJ][NJ]) and two item vectors, then the ref row of width W
  static constexpr int S_X = 0, S_U = NX, S_H = NX + NJ, S_FX = S_H + 1,
                       S_FU = S_FX + NX * NX, S_J = S_FU + NX * NJ;
  static constexpr int J_SIZE = NX * 6 > NJ * NJ ? NX * 6 : NJ * NJ;
  static constexpr int V_SIZE = NX > 6 ? NX : 6;  // r, w / da/dr, d2a/dr2
  static constexpr int S_V1 = S_J + J_SIZE, S_V2 = S_V1 + V_SIZE,
                       S_ROW = S_V2 + V_SIZE;
  static AG_HD int scratch(int W) { return S_ROW + W; }
};

// What a lane keeps in registers across the phases of its node (x and u
// are reread from the scratch, which keeps them out of the registers that
// the dual passes need).
template <int NJ> struct K1Lane {
  float h;
  float l;                        // sum over the items of weight * value
  float acc[K1Shape<NJ>::OWN];    // the lane's output entries, unscaled
};

// One cost item as the accumulate phase reads it.
struct K1Item {
  int kind, nd, nr;  // kind code, Jacobian rows (tangents), residual size
  float wgt;
};

template <int NJ>
AG_FN void k1_load(int lane, int lanes, const RefTable& tab, long long t,
                   const float* xn, const float* un, float h, float* S) {
  typedef K1Shape<NJ> K;
  gather_row<K::GATHER>(tab, t, lane, lanes, S + K::S_ROW);
  for (int i = lane; i < K::NX; i += lanes) S[K::S_X + i] = xn[i];
  for (int i = lane; i < NJ; i += lanes) S[K::S_U + i] = un[i];
  if (lane == 0) S[K::S_H] = h;
}

// Phases A and B (the body of `dynamics_node` with derivs, split over lanes).
template <int NJ, int LANES>
AG_FN void k1_dynamics(int lane, const float* C, float* S, K1Lane<NJ>& st,
                       float* xo) {
  typedef K1Shape<NJ> K;
  constexpr int NX = K::NX;
  const float* q = S + K::S_X;
  const float* v = S + K::S_X + NJ;
  const float* u = S + K::S_U;
  const float h = S[K::S_H];
  st.h = h;
  st.l = 0.f;
  for (int j = 0; j < K::OWN; ++j) st.acc[j] = 0.f;
  // A: the primal step, every lane
  M3<float> R[NJ];
  V3<float> P[NJ];
  float qr[NJ], vr[NJ];
  for (int i = 0; i < NJ; ++i) {
    qr[i] = q[i];
    vr[i] = v[i];
  }
  joint_transforms<NJ, float>(C, qr, R, P);
  float z[NJ], b[NJ], M[NJ * NJ], L[NJ * NJ], rhs[NJ], a[NJ];
  for (int i = 0; i < NJ; ++i) z[i] = 0.f;
  rnea<NJ, float>(C, R, P, vr, z, b);
  mass_matrix<NJ>(C, R, P, M);
  chol_factor<NJ>(M, L);
  for (int i = 0; i < NJ; ++i) rhs[i] = u[i] - b[i];
  chol_solve<NJ>(L, rhs, a);
  for (int i = 0; i < NJ; ++i) {
    float vn = vr[i] + h * a[i];
    if (owns_item<LANES, NX>(lane, i)) xo[i] = qr[i] + h * vn;
    if (owns_item<LANES, NX>(lane, NJ + i)) xo[NJ + i] = vn;
  }
  // B: lane k the tangents k, k + LANES, ... of (q, v); in the first round
  // lanes >= NX repeat one and store nothing, in a later round a lane past
  // the last tangent stops. da/d(q,v) = -M^-1 d rnea(q, v, a)/d(q, v), a
  // held fixed.
  const float h2 = h * h;
  float* fx = S + K::S_FX;
  for (int r = 0; r < rounds(NX, LANES); ++r) {
    const int t = r * LANES + lane;
    if (r > 0 && t >= NX) break;
    const int k = t < NX ? t : t - NX;
    Dual qd[NJ], vd[NJ], ad[NJ], td[NJ];
    for (int i = 0; i < NJ; ++i) {
      qd[i] = Dual(qr[i], k == i ? 1.f : 0.f);
      vd[i] = Dual(vr[i], k == NJ + i ? 1.f : 0.f);
      ad[i] = Dual(a[i]);
    }
    M3<Dual> Rd[NJ];
    V3<Dual> Pd[NJ];
    joint_transforms<NJ, Dual>(C, qd, Rd, Pd);
    rnea<NJ, Dual>(C, Rd, Pd, vd, ad, td);
    float col[NJ], da[NJ];
    for (int i = 0; i < NJ; ++i) col[i] = -td[i].d;
    chol_solve<NJ>(L, col, da);
    if (t < NX) {
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
  }
  // Fu: lane j the M^-1 columns j, j + LANES, ... < NJ (in the first round
  // lanes >= NJ repeat one and store nothing)
  float* fu = S + K::S_FU;
  for (int r = 0; r < rounds(NJ, LANES); ++r) {
    const int t = r * LANES + lane;
    if (r > 0 && t >= NJ) break;
    const int j = t % NJ;
    float e[NJ], mcol[NJ];
    for (int i = 0; i < NJ; ++i) e[i] = i == j ? 1.f : 0.f;
    chol_solve<NJ>(L, e, mcol);
    if (t < NJ) {
      for (int i = 0; i < NJ; ++i) {
        fu[i * NJ + j] = h2 * mcol[i];
        fu[(NJ + i) * NJ + j] = h * mcol[i];
      }
    }
  }
}

// Phase C for cost item `it`: every lane its value (into st.l), lane k the
// rows k, k + LANES, ... < nd of its Jacobian; lane 0 the item vectors (state/control: r and w;
// control_grav: w r and w; the residual kinds: da/dr and the Gauss-Newton
// diagonal).
template <int NJ, int LANES>
AG_FN K1Item k1_item_tangent(int lane, const float* C, int it, float* S,
                             K1Lane<NJ>& st) {
  typedef K1Shape<NJ> K;
  constexpr int NX = K::NX;
  const float* D = C + NJ * JSTRIDE + 3 + it * Desc<NJ>::STRIDE;
  const float* row = S + K::S_ROW;
  const float* x = S + K::S_X;  // q, v
  const float* u = S + K::S_U;
  float* J = S + K::S_J;
  float* v1 = S + K::S_V1;
  float* v2 = S + K::S_V2;
  K1Item o;
  o.kind = (int)D[I_KIND];
  o.wgt = D[I_WEIGHT];
  // streamed w_collision_avoidance scale of an update=True collision item
  if ((int)D[Desc<NJ>::WCOLL] >= 0)
    o.wgt *= row[(int)D[Desc<NJ>::WCOLL]];
  float li = 0.f;
  if (o.kind == K_STATE || o.kind == K_CONTROL) {
    const int n = o.kind == K_STATE ? NX : NJ;
    for (int i = 0; i < n; ++i) {
      float xi = o.kind == K_CONTROL ? u[i] : x[i];
      float r = xi - item_ref(D, row, i);
      float w = item_weight<NJ>(D, row, i);
      li += 0.5f * w * r * r;
      if (lane == 0) {
        v1[i] = r;
        v2[i] = w;
      }
    }
    o.nd = 0;
    o.nr = n;
  } else if (o.kind == K_CONTROL_GRAV) {
    // J[k][i] = d g_i / d q_k; lane k the tangents k, k + LANES, ... < NJ
    // (in the first round lanes >= NJ repeat one and store nothing), the
    // value from the first round's pass
    for (int r = 0; r < rounds(NJ, LANES); ++r) {
      const int t = r * LANES + lane;
      if (r > 0 && t >= NJ) break;
      const int k = t % NJ;
      Dual qd[NJ], zd[NJ], td[NJ];
      for (int i = 0; i < NJ; ++i) qd[i] = Dual(x[i], i == k ? 1.f : 0.f);
      M3<Dual> Rd[NJ];
      V3<Dual> Pd[NJ];
      joint_transforms<NJ, Dual>(C, qd, Rd, Pd);
      rnea<NJ, Dual>(C, Rd, Pd, zd, zd, td);
      for (int i = 0; i < NJ; ++i) {
        if (t < NJ) J[k * NJ + i] = td[i].d;
        if (r > 0) continue;
        float w = item_weight<NJ>(D, row, i);
        float r = u[i] - td[i].v;
        li += 0.5f * w * r * r;
        if (lane == 0) {
          v1[i] = w * r;
          v2[i] = w;
        }
      }
    }
    o.nd = NJ;
    o.nr = NJ;
  } else {  // frame, visual-servoing and collision kinds: residual of q;
            // frame_velocity: of q and v. J[k][i] = d r_i / d x_k; lane k
            // the tangents k, k + LANES, ... < nd (in the first round lanes
            // >= nd take tangent 0 and store nothing), the residual from the
            // first round's pass
    o.nd = o.kind == K_FRAME_VELOCITY ? NX : NJ;
    float r[6], a_dr[6], a_drr[6];
    for (int rnd = 0; rnd < rounds(NX, LANES); ++rnd) {
      const int t = rnd * LANES + lane;
      if (rnd > 0 && t >= o.nd) break;
      const int k = t < o.nd ? t : 0;
      Dual qd[NJ], vd[NJ], rd[6];
      for (int i = 0; i < NJ; ++i) {
        qd[i] = Dual(x[i], i == k ? 1.f : 0.f);
        vd[i] = Dual(x[NJ + i], NJ + i == k ? 1.f : 0.f);
      }
      o.nr = frame_residual<NJ, Dual>(C, D, row, o.kind, qd, vd, rd);
      for (int i = 0; i < 6; ++i) {
        if (rnd == 0) r[i] = rd[i].v;
        if (i < o.nr && t < o.nd) J[k * 6 + i] = rd[i].d;
      }
    }
    li = activation<NJ>(D, row, o.nr, r, a_dr, a_drr);
    if (lane == 0) {
      for (int i = 0; i < o.nr; ++i) {
        v1[i] = a_dr[i];
        v2[i] = a_drr[i];
      }
    }
  }
  st.l += o.wgt * li;
  return o;
}

// The item's weighted Gauss-Newton term of output entry e of the node's
// lx | lu | lxx | lxu | luu (row-major blocks), as the one-thread version
// forms it; 0 where the item adds nothing.
template <int NJ>
AG_FN float k1_entry_term(const K1Item& o, int e, const float* J,
                          const float* v1, const float* v2) {
  constexpr int NX = 2 * NJ;
  int blk, r = 0, c = 0;
  if (e < NX) {
    blk = 0; r = e;
  } else if (e < NX + NJ) {
    blk = 1; r = e - NX;
  } else if (e < NX + NJ + NX * NX) {
    blk = 2; r = (e - NX - NJ) / NX; c = (e - NX - NJ) % NX;
  } else if (e < NX + NJ + NX * NX + NX * NJ) {
    e -= NX + NJ + NX * NX;
    blk = 3; r = e / NJ; c = e % NJ;
  } else {
    e -= NX + NJ + NX * NX + NX * NJ;
    blk = 4; r = e / NJ; c = e % NJ;
  }
  const float wgt = o.wgt;
  const int hi = r > c ? r : c, lo = r > c ? c : r;
  if (o.kind == K_STATE) {
    if (blk == 0) return wgt * v2[r] * v1[r];
    return blk == 2 && r == c ? wgt * v2[r] : 0.f;
  }
  if (o.kind == K_CONTROL) {
    if (blk == 1) return wgt * v2[r] * v1[r];
    return blk == 4 && r == c ? wgt * v2[r] : 0.f;
  }
  if (o.kind == K_CONTROL_GRAV) {  // J_u = I, J_x = [-Jg, 0]
    if (blk == 1) return wgt * v1[r];
    if (blk == 4) return r == c ? wgt * v2[r] : 0.f;
    if (blk == 0 && r < NJ) {
      float s = 0.f;
      for (int i = 0; i < NJ; ++i) s += J[r * NJ + i] * v1[i];
      return -wgt * s;
    }
    if (blk == 3 && r < NJ) return -wgt * J[r * NJ + c] * v2[c];
    if (blk == 2 && r < NJ && c < NJ) {
      float hs = 0.f;
      for (int i = 0; i < NJ; ++i) hs += J[hi * NJ + i] * v2[i] * J[lo * NJ + i];
      return wgt * hs;
    }
    return 0.f;
  }
  if (blk == 0 && r < o.nd) {
    float s = 0.f;
    for (int i = 0; i < o.nr; ++i) s += J[r * 6 + i] * v1[i];
    return wgt * s;
  }
  if (blk == 2 && r < o.nd && c < o.nd) {
    float hs = 0.f;
    for (int i = 0; i < o.nr; ++i) hs += J[hi * 6 + i] * v2[i] * J[lo * 6 + i];
    return wgt * hs;
  }
  return 0.f;
}

// Phase D for one item: each lane adds the item's terms to its entries.
template <int NJ, int LANES>
AG_FN void k1_item_accumulate(int lane, const K1Item& o, const float* S,
                              K1Lane<NJ>& st) {
  typedef K1Shape<NJ> K;
  AG_UNROLL
  for (int j = 0; j < K::OWN; ++j) {
    const int e = lane + j * LANES;
    if (e < K::NE)
      st.acc[j] += k1_entry_term<NJ>(o, e, S + K::S_J, S + K::S_V1,
                                     S + K::S_V2);
  }
}

// Stores the node's Fx, Fu (from the scratch), l and the lane's entries of
// lx, lu, lxx, lxu, luu, dt-scaled (the running cost; the terminal model
// has dt = 0 semantics, `ocp_croco_generic.py:808-812`).
template <int NJ, int LANES>
AG_FN void k1_store(int lane, const float* S, const K1Lane<NJ>& st,
                    long long n, float* Fx, float* Fu, float* l, float* lx,
                    float* lu, float* lxx, float* lxu, float* luu) {
  typedef K1Shape<NJ> K;
  constexpr int NX = K::NX;
  for (int e = lane; e < NX * NX; e += LANES)
    Fx[n * NX * NX + e] = S[K::S_FX + e];
  for (int e = lane; e < NX * NJ; e += LANES)
    Fu[n * NX * NJ + e] = S[K::S_FU + e];
  if (lane == 0) l[n] = st.l * st.h;
  AG_UNROLL
  for (int j = 0; j < K::OWN; ++j) {
    int e = lane + j * LANES;
    if (e >= K::NE) continue;
    const float val = st.acc[j] * st.h;
    if (e < NX) { lx[n * NX + e] = val; continue; }
    e -= NX;
    if (e < NJ) { lu[n * NJ + e] = val; continue; }
    e -= NJ;
    if (e < NX * NX) { lxx[n * NX * NX + e] = val; continue; }
    e -= NX * NX;
    if (e < NX * NJ) { lxu[n * NX * NJ + e] = val; continue; }
    luu[n * NJ * NJ + e - NX * NJ] = val;
  }
}

// ---- K3: the terminal node on K1's lanes ------------------------------------
// The terminal cost items at u = 0 with no dt scale, on LANES = the power of
// two >= 2 NJ lanes and K1's node scratch (its Fx/Fu region unused):
//   k3_load   the horizon's ref row, x and u = 0 into the scratch, and the
//             lane's sums cleared;
//   per cost item, in the table's order, `k1_item_tangent` (lane k tangent
//   k) and `k1_item_accumulate` (each lane its owned entries);
//   k3_store  l, lx and lxx, each once, at consecutive addresses across the
//             lanes; the owned lu, lxu, luu entries are dropped, as
//             `terminal_node` drops them.
template <int NJ, int LANES>
AG_FN void k3_load(int lane, const RefTable& tab, long long t,
                   const float* xn, float* S, K1Lane<NJ>& st) {
  typedef K1Shape<NJ> K;
  gather_row<K::GATHER>(tab, t, lane, LANES, S + K::S_ROW);
  for (int i = lane; i < K::NX; i += LANES) S[K::S_X + i] = xn[i];
  for (int i = lane; i < NJ; i += LANES) S[K::S_U + i] = 0.f;
  st.h = 1.f;  // the terminal model's costs are not dt-scaled
  st.l = 0.f;
  for (int j = 0; j < K::OWN; ++j) st.acc[j] = 0.f;
}

template <int NJ, int LANES>
AG_FN void k3_store(int lane, const K1Lane<NJ>& st, long long n, float* l,
                    float* lx, float* lxx) {
  typedef K1Shape<NJ> K;
  constexpr int NX = K::NX;
  if (lane == 0) l[n] = st.l;
  AG_UNROLL
  for (int j = 0; j < K::OWN; ++j) {
    const int e = lane + j * LANES;  // of lx | lu | lxx | lxu | luu
    if (e < NX)
      lx[n * NX + e] = st.acc[j];
    else if (e >= NX + NJ && e < NX + NJ + NX * NX)
      lxx[n * NX * NX + e - NX - NJ] = st.acc[j];
  }
}

// ---- K2: the step and the cost items of one node, on two warps -------------
// Inputs node-major, x [NX], u [NJ], dt, the gathered ref row; the step
// writes x+ into xo [NX], the costs return the dt-scaled l.
template <int NJ>
AG_FN void k2_step(const float* C, const float* xn, const float* un, float h,
                   float* xo) {
  float q[NJ], v[NJ], u[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = xn[i];
    v[i] = xn[NJ + i];
    u[i] = un[i];
  }
  M3<float> R[NJ];
  V3<float> P[NJ];
  dynamics_node<NJ, false>(C, q, v, u, h, R, P, xo, nullptr, nullptr);
}

template <int NJ>
AG_FN float k2_costs(const float* C, int n_items, const float* row,
                     const float* xn, const float* un, float h) {
  float q[NJ], v[NJ], u[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = xn[i];
    v[i] = xn[NJ + i];
    u[i] = un[i];
  }
  M3<float> R[NJ];
  V3<float> P[NJ];
  joint_transforms<NJ, float>(C, q, R, P);
  float lv = 0.f;
  node_costs<NJ, false>(C, n_items, row, q, v, u, R, P, &lv, nullptr, nullptr,
                        nullptr, nullptr, nullptr);
  return lv * h;
}

// ---- one node of K3 / K4 ---------------------------------------------------
// The terminal cost items at u = 0, no dt scale, of the node's state xn
// [NX] and ref row: its l, lx [NX] and lxx [NX*NX], on one thread (K3's
// body before the `k3_*` phases; the host harness holds those against it).
template <int NJ>
AG_FN void terminal_node(const float* xn, const float* row, const float* C,
                         int n_items, float* l, float* lx, float* lxx) {
  constexpr int NX = 2 * NJ;
  float q[NJ], v[NJ], un[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = xn[i];
    v[i] = xn[NJ + i];
    un[i] = 0.f;
  }
  M3<float> R[NJ];
  V3<float> P[NJ];
  joint_transforms<NJ, float>(C, q, R, P);
  // the terminal model has no control: its lu/lxu/luu are dropped
  float lu[NJ], lxu[NX * NJ], luu[NJ * NJ];
  for (int i = 0; i < NX; ++i) lx[i] = 0.f;
  for (int i = 0; i < NX * NX; ++i) lxx[i] = 0.f;
  for (int i = 0; i < NJ; ++i) lu[i] = 0.f;
  for (int i = 0; i < NX * NJ; ++i) lxu[i] = 0.f;
  for (int i = 0; i < NJ * NJ; ++i) luu[i] = 0.f;
  float lv = 0.f;
  node_costs<NJ, true>(C, n_items, row, q, v, un, R, P, &lv, lx, lu, lxx,
                       lxu, luu);
  *l = lv;
}

// K4, split over the lanes: lane `lane` of 32 the weighted value of the items
// lane, lane + 32, ... of the node (u = 0) into vals [n_items]; the sum in
// the table's order is the caller's (one lane, after a warp barrier).
template <int NJ>
AG_FN void terminal_item_values(int lane, const float* xn, const float* row,
                                const float* C, int n_items, float* vals) {
  float q[NJ], v[NJ], un[NJ];
  for (int i = 0; i < NJ; ++i) {
    q[i] = xn[i];
    v[i] = xn[NJ + i];
    un[i] = 0.f;
  }
  M3<float> R[NJ];
  V3<float> P[NJ];
  joint_transforms<NJ, float>(C, q, R, P);
  for (int it = lane; it < n_items; it += 32)
    vals[it] = item_costs<NJ, false>(C, it, row, q, v, un, R, P, nullptr,
                                     nullptr, nullptr, nullptr, nullptr);
}

// ---- the kernels' blocks ----------------------------------------------------
constexpr int kBlock = 128;    // threads per block of K1, K3, K5a and K5b
constexpr int kK2Nodes = 32;   // K2 nodes per block; two warps
constexpr int kTermNodes = 4;  // K4 nodes (warps) per block

// n floats rounded up to 16 bytes, so the shared-memory region after them
// starts aligned.
AG_HD constexpr int round4(int n) { return (n + 3) & ~3; }

// K5a's shared memory (floats) after the constants: per block the inputs
// X [NPB, NX], U [NPB, NJ], H [NPB], the output XO [NPB, NX], the node
// scratch W [NPB, K5aShape::SIZE] and the threads' force slots
// DF [6 NJ, kBlock] (`ForceSlots`, thread-minor); each region starts
// 16-byte aligned.
template <int NJ> struct K5aBlock {
  typedef K5aShape<NJ> K;
  static constexpr int NX = 2 * NJ, NPB = kBlock / K::LANES;
  static constexpr int X = 0, U = X + round4(NPB * NX),
                       H = U + round4(NPB * NJ), XO = H + round4(NPB),
                       W = XO + round4(NPB * NX),
                       DF = W + round4(NPB * K::SIZE),
                       SIZE = DF + 6 * NJ * kBlock;
};

// K5b's shared memory (floats) after the constants: per block the inputs
// X [NPB, NX], U [NPB, NJ], H [NPB], the outputs XO [NPB, NX],
// FX [NPB, NX*NX], FU [NPB, NX*NJ] (a block's nodes are contiguous, as in
// the outputs), the node scratch W [NPB, SIZE] and the threads' force
// slots DF [6 NJ, kBlock] (`ForceSlots`, thread-minor); each region starts
// 16-byte aligned.
template <int NJ> struct K5Block {
  typedef K5Shape<NJ> K;
  static constexpr int NX = K::NX, NPB = kBlock / K::LANES;
  static constexpr int X = 0, U = X + round4(NPB * NX),
                       H = U + round4(NPB * NJ), XO = H + round4(NPB),
                       FX = XO + round4(NPB * NX),
                       FU = FX + round4(NPB * NX * NX),
                       W = FU + round4(NPB * NX * NJ),
                       DF = W + round4(NPB * K::SIZE),
                       SIZE = DF + 6 * NJ * kBlock;
};

// The kernels by number (`smem_floats`; `ops/cuda_dynamics.py` KERNEL_IDS).
enum KernelId { KID_K1 = 1, KID_K2, KID_K3, KID_K4, KID_K5A, KID_K5B };

// Dynamic shared memory of one block of `kernel` in floats: the packed
// constants, then K1/K3 the node scratch [kBlock / LANES, K1Shape::scratch],
// K2 per node x, x+, u, dt and the ref row, K4 the states [kTermNodes, NX],
// the ref rows and the item values, K5a/K5b their `K5aBlock`/`K5Block`.
// `ops/cuda_dynamics.py::smem_bytes` computes the same.
template <int NJ>
AG_HD int smem_floats(int kernel, int consts_len, int W, int n_items) {
  typedef K1Shape<NJ> K;
  const int c = round4(consts_len);
  switch (kernel) {
    case KID_K1:
    case KID_K3:
      return c + (kBlock / K::LANES) * K::scratch(W);
    case KID_K2:
      return c + kK2Nodes * (2 * K::NX + NJ + 1 + W);
    case KID_K4:
      return c + round4(kTermNodes * K::NX) + kTermNodes * (W + n_items);
    case KID_K5A:
      return c + K5aBlock<NJ>::SIZE;
    default:
      return c + K5Block<NJ>::SIZE;
  }
}

}  // namespace ag
