// The per-row optimizer math of the apply kernels (csrc/apply_pairs.cu,
// csrc/apply_pairs2.cu, csrc/packed_pairs.cu, csrc/sweep_apply.cu,
// csrc/bisect_apply.cu), in the formula order of
// difacto_tpu_torch/ops/sweep_ms.py::fused_table_update, so that a kernel
// built with --fmad=false rounds as the plain version does.
//
// Each update comes in three stages — load, step, store — so that a
// kernel can start the loads of several rows before any row's arithmetic
// (csrc/apply_pairs2.cu); update_w and update_v chain the three for the
// kernels that do one row at a time.
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

// The leaves of row `id` that the w updater reads (others come back 0).
__device__ __forceinline__ WRow load_w(const float* w, const float* z,
                                       const float* nn, long long id,
                                       const ApplyParams& p) {
  WRow r;
  r.w = w[id];
  r.z = p.w_updater == 0 ? z[id] : 0.0f;
  r.n = p.w_updater <= 1 ? nn[id] : 0.0f;
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
__device__ __forceinline__ void store_w(float* w, float* z, float* nn,
                                        long long id, WRow r,
                                        const ApplyParams& p) {
  w[id] = r.w;
  if (p.w_updater == 0) z[id] = r.z;
  if (p.w_updater <= 1) nn[id] = r.n;
}

// The w update of table row `id`, in place. The caller gates it (touch,
// tail filter).
__device__ __forceinline__ void update_w(float* w, float* z, float* nn,
                                         long long id, float g,
                                         const ApplyParams& p) {
  store_w(w, z, nn, id, step_w(load_w(w, z, nn, id, p), g, p), p);
}

__device__ __forceinline__ VEnt load_v(const float* V, const float* nV,
                                       long long at, const ApplyParams& p) {
  VEnt e;
  e.v = V[at];
  e.nv = p.V_updater == 0 ? nV[at] : 0.0f;
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

__device__ __forceinline__ void store_v(float* V, float* nV, long long at,
                                        VEnt e, const ApplyParams& p) {
  V[at] = e.v;
  if (p.V_updater == 0) nV[at] = e.nv;
}

// The update of one factor entry (V, nV)[at], in place. The caller gates
// it (touch, tail filter, PRE-update count).
__device__ __forceinline__ void update_v(float* V, float* nV, long long at,
                                         float gv, const ApplyParams& p) {
  store_v(V, nV, at, step_v(load_v(V, nV, at, p), gv, p), p);
}
