// The per-row optimizer math of the apply kernels (csrc/apply_pairs.cu,
// csrc/planar_apply.cu, csrc/sweep_apply.cu, csrc/bisect_apply.cu,
// csrc/rowmajor_pairs.cu, csrc/rowmajor_sweep.cu), in the formula order of
// difacto_tpu_torch/ops/sweep_ms.py::fused_table_update, so that a kernel
// built with --fmad=false rounds as the plain version does.
//
// Each update comes in three stages — load, step, store — so that a
// kernel can issue a row's loads before its arithmetic, or store back
// what it loaded (csrc/planar_apply.cu); update_w and update_v chain the three for the
// kernels that do one row at a time. The load and store stages exist for
// both table layouts: planar leaves (one array per leaf, V and nV [K, N])
// and the row-major table [N, 4+2K] with columns w|z|n|cnt|V|nV
// (csrc/rowmajor_pairs.cu), whose stages move VEC consecutive floats of a
// row at a time. The planar stages say which leaves each updater reads
// and writes, and move them through a memory policy `Mem` (plain loads
// and stores by default; csrc/planar_apply.cu's floor passes accesses the
// compiler cannot drop). The step stages are the one copy of the formulas.
#pragma once
#include <math.h>

struct ApplyParams {
  float lr_eta, lr_beta, l1, l2;
  float V_lr_eta, V_lr_beta, V_l2, V_threshold;
  int tail;        // tail_feature_filter (0 = off)
  int w_updater;   // 0 ftrl, 1 adagrad, 2 sgd
  int V_updater;   // 0 adagrad, 1 sgd
};

struct WRow { float w, z, n; };   // the (w, z, n) of one table row
struct VEnt { float v, nv; };     // one factor entry and its accumulator

// How the planar stages move a leaf entry: plain loads and stores.
struct PlainMem {
  __device__ __forceinline__ float ld(const float* a) const { return *a; }
  __device__ __forceinline__ void st(float* a, float v) const { *a = v; }
};

// The leaves of row `id` that the w updater reads (others come back 0).
template <class Mem = PlainMem>
__device__ __forceinline__ WRow load_w(const float* w, const float* z,
                                       const float* nn, long long id,
                                       const ApplyParams& p,
                                       const Mem& m = Mem()) {
  WRow r;
  r.w = m.ld(w + id);
  r.z = p.w_updater == 0 ? m.ld(z + id) : 0.0f;
  r.n = p.w_updater <= 1 ? m.ld(nn + id) : 0.0f;
  return r;
}

// FTRL, AdaGrad or SGD on (w, z, n) for the summed gradient g.
__device__ __forceinline__ WRow step_w(WRow r, float g, const ApplyParams& p) {
  WRow o = r;
  if (p.w_updater == 0) {          // ftrl
    o.n = r.n + g * g;
    float sigma = (sqrtf(o.n) - sqrtf(r.n)) / p.lr_eta;
    o.z = r.z + g - sigma * r.w;
    if (fabsf(o.z) <= p.l1) {
      o.w = 0.0f;
    } else {
      float sgn = o.z > 0.0f ? 1.0f : (o.z < 0.0f ? -1.0f : 0.0f);
      o.w = -(o.z - sgn * p.l1) /
            ((p.lr_beta + sqrtf(o.n)) / p.lr_eta + p.l2);
    }
  } else if (p.w_updater == 1) {   // adagrad
    float g_r = g + p.l2 * r.w;
    o.n = r.n + g_r * g_r;
    o.w = r.w - p.lr_eta * g_r / (sqrtf(o.n) + p.lr_beta);
  } else {                         // sgd
    o.w = r.w - p.lr_eta * (g + p.l2 * r.w);
  }
  return o;
}

// Writes back the leaves the w updater changes.
template <class Mem = PlainMem>
__device__ __forceinline__ void store_w(float* w, float* z, float* nn,
                                        long long id, WRow r,
                                        const ApplyParams& p,
                                        const Mem& m = Mem()) {
  m.st(w + id, r.w);
  if (p.w_updater == 0) m.st(z + id, r.z);
  if (p.w_updater <= 1) m.st(nn + id, r.n);
}

// The w update of table row `id`, in place. The caller gates it (touch,
// tail filter).
__device__ __forceinline__ void update_w(float* w, float* z, float* nn,
                                         long long id, float g,
                                         const ApplyParams& p) {
  store_w(w, z, nn, id, step_w(load_w(w, z, nn, id, p), g, p), p);
}

template <class Mem = PlainMem>
__device__ __forceinline__ VEnt load_v(const float* V, const float* nV,
                                       long long at, const ApplyParams& p,
                                       const Mem& m = Mem()) {
  VEnt e;
  e.v = m.ld(V + at);
  e.nv = p.V_updater == 0 ? m.ld(nV + at) : 0.0f;
  return e;
}

// AdaGrad or SGD on one factor entry for the summed gradient gv.
__device__ __forceinline__ VEnt step_v(VEnt e, float gv,
                                       const ApplyParams& p) {
  VEnt o = e;
  if (p.V_updater == 0) {          // adagrad
    float gv_r = gv + p.V_l2 * e.v;
    o.nv = e.nv + gv_r * gv_r;
    o.v = e.v - p.V_lr_eta * gv_r / (sqrtf(o.nv) + p.V_lr_beta);
  } else {                         // sgd
    o.v = e.v - p.V_lr_eta * (gv + p.V_l2 * e.v);
  }
  return o;
}

template <class Mem = PlainMem>
__device__ __forceinline__ void store_v(float* V, float* nV, long long at,
                                        VEnt e, const ApplyParams& p,
                                        const Mem& m = Mem()) {
  m.st(V + at, e.v);
  if (p.V_updater == 0) m.st(nV + at, e.nv);
}

// The update of one factor entry (V, nV)[at], in place. The caller gates
// it (touch, tail filter, PRE-update count).
__device__ __forceinline__ void update_v(float* V, float* nV, long long at,
                                         float gv, const ApplyParams& p) {
  store_v(V, nV, at, step_v(load_v(V, nV, at, p), gv, p), p);
}

// ---- row-major stages: VEC consecutive floats of a table row ------------
// VEC = 4 moves 16 bytes (the row must be 16-byte aligned: K even and an
// aligned table), VEC = 2 moves 8, VEC = 1 is the scalar path.
template <int VEC>
__device__ __forceinline__ void ld_vec(const float* p, float* d);
template <>
__device__ __forceinline__ void ld_vec<4>(const float* p, float* d) {
  float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
template <>
__device__ __forceinline__ void ld_vec<2>(const float* p, float* d) {
  float2 v = *reinterpret_cast<const float2*>(p);
  d[0] = v.x; d[1] = v.y;
}
template <>
__device__ __forceinline__ void ld_vec<1>(const float* p, float* d) {
  d[0] = *p;
}

template <int VEC>
__device__ __forceinline__ void st_vec(float* p, const float* s);
template <>
__device__ __forceinline__ void st_vec<4>(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}
template <>
__device__ __forceinline__ void st_vec<2>(float* p, const float* s) {
  *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
}
template <>
__device__ __forceinline__ void st_vec<1>(float* p, const float* s) {
  *p = s[0];
}

// The head w|z|n|cnt of a row-major table row, whole (h[4]).
template <int VEC>
__device__ __forceinline__ void load_head(const float* row, float* h) {
#pragma unroll
  for (int i = 0; i < 4; i += VEC) ld_vec<VEC>(row + i, h + i);
}

template <int VEC>
__device__ __forceinline__ void store_head(float* row, const float* h) {
#pragma unroll
  for (int i = 0; i < 4; i += VEC) st_vec<VEC>(row + i, h + i);
}

// VEC factor entries V[j..j+VEC) of a row with their accumulators: `v`
// points at the row's V[j], the accumulators lie K floats further.
template <int VEC>
__device__ __forceinline__ void load_v_row(const float* v, int K, VEnt* e,
                                           const ApplyParams& p) {
  float a[VEC], b[VEC];
  ld_vec<VEC>(v, a);
  if (p.V_updater == 0) ld_vec<VEC>(v + K, b);
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    e[c].v = a[c];
    e[c].nv = p.V_updater == 0 ? b[c] : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void store_v_row(float* v, int K, const VEnt* e,
                                            const ApplyParams& p) {
  float a[VEC], b[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) { a[c] = e[c].v; b[c] = e[c].nv; }
  st_vec<VEC>(v, a);
  if (p.V_updater == 0) st_vec<VEC>(v + K, b);
}
