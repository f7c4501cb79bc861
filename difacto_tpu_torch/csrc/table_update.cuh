// The per-row optimizer math of the apply kernels (csrc/apply_pairs.cu,
// csrc/sweep_apply.cu), in the formula order of
// difacto_tpu_torch/ops/sweep_ms.py::fused_table_update, so that a kernel
// built with --fmad=false rounds as the plain version does.
#pragma once
#include <math.h>

struct ApplyParams {
  float lr_eta, lr_beta, l1, l2;
  float V_lr_eta, V_lr_beta, V_l2, V_threshold;
  int tail;        // tail_feature_filter (0 = off)
  int w_updater;   // 0 ftrl, 1 adagrad, 2 sgd
  int V_updater;   // 0 adagrad, 1 sgd
};

// FTRL, AdaGrad or SGD on (w, z, n) of table row `id` for the summed
// gradient g. The caller gates it (touch, tail filter).
__device__ __forceinline__ void update_w(float* __restrict__ w,
                                         float* __restrict__ z,
                                         float* __restrict__ nn, long long id,
                                         float g, const ApplyParams& p) {
  float wv = w[id];
  if (p.w_updater == 0) {          // ftrl
    float nv = nn[id], zv = z[id];
    float n_new = nv + g * g;
    float sigma = (sqrtf(n_new) - sqrtf(nv)) / p.lr_eta;
    float z_new = zv + g - sigma * wv;
    float w_new;
    if (fabsf(z_new) <= p.l1) {
      w_new = 0.0f;
    } else {
      float sgn = z_new > 0.0f ? 1.0f : (z_new < 0.0f ? -1.0f : 0.0f);
      w_new = -(z_new - sgn * p.l1) /
              ((p.lr_beta + sqrtf(n_new)) / p.lr_eta + p.l2);
    }
    w[id] = w_new;
    z[id] = z_new;
    nn[id] = n_new;
  } else if (p.w_updater == 1) {   // adagrad
    float g_r = g + p.l2 * wv;
    float n_new = nn[id] + g_r * g_r;
    w[id] = wv - p.lr_eta * g_r / (sqrtf(n_new) + p.lr_beta);
    nn[id] = n_new;
  } else {                         // sgd
    w[id] = wv - p.lr_eta * (g + p.l2 * wv);
  }
}

// AdaGrad or SGD on one factor entry (V, nV)[at] for the summed gradient
// gv. The caller gates it (touch, tail filter, PRE-update count).
__device__ __forceinline__ void update_v(float* __restrict__ V,
                                         float* __restrict__ nV, long long at,
                                         float gv, const ApplyParams& p) {
  float v = V[at];
  if (p.V_updater == 0) {          // adagrad
    float gv_r = gv + p.V_l2 * v;
    float nv_new = nV[at] + gv_r * gv_r;
    V[at] = v - p.V_lr_eta * gv_r / (sqrtf(nv_new) + p.V_lr_beta);
    nV[at] = nv_new;
  } else {                         // sgd
    V[at] = v - p.V_lr_eta * (gv + p.V_l2 * v);
  }
}
