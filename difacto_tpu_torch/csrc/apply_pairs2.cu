// Apply, second design: two table rows per thread, the loads of both
// started before either row's arithmetic.
//
// Replaces difacto_tpu/ops/pair_sweep.py::apply_pairs2 (Pallas kernel
// _apply_pairs2_kernel, schedule DualPairMeta). It computes exactly what
// csrc/apply_pairs.cu computes — payload rows gw | gV[K] | add_cnt |
// touch, planar [3+K, U]; per table row whose summed touch is > 0 the w
// updater masked by the tail filter, cnt += add_cnt, and the V updater
// gated by the PRE-update cnt; untouched rows keep their exact bits — and
// exists to be timed against it (probes/hw_apply2.py).
//
// The TPU kernel gave each sequential grid step two unique windows and
// one commit, to ask whether a unit of work doing twice as much recovers
// per-step overhead. A Hopper kernel has no grid steps to amortise; what
// holds csrc/apply_pairs.cu above its byte bound is the latency of random
// 4-byte accesses, each its own 32-byte sector. So the question here is
// whether more independent accesses in flight per thread hide it.
//
// Arrangement: thread t owns the adjacent lanes 2t and 2t + 1. The real
// ids are a prefix of the stream (sentinels pad its end), so adjacent
// lanes give nearly every working thread two rows, where lanes t and
// t + U/2 would leave the threads past the last real id's half with one;
// a warp's uid and payload loads still cover 64 consecutive floats. For
// each stage — (cnt, w, z, n), then each of the K factor entries — the
// thread loads the leaves of both its rows, then does both rows'
// arithmetic and stores (csrc/table_update.cuh's load/step/store stages),
// so twice as many random loads are outstanding per thread as in
// csrc/apply_pairs.cu. A thread one of whose lanes is past U, is a
// sentinel, or does not start a run, does one row (or none). The two rows
// of a thread are different table rows (each lane starts a run of a
// distinct id), so each row's PRE-update cnt is read before that row's
// cnt is written. Determinism as csrc/apply_pairs.cu: no atomics, each
// run summed in lane order by the lane that starts it
// (csrc/pair_runs.cuh), so the two designs give the same bits.
//
// Measured on an H100 (PERF.md): 1.01 to 1.09 times csrc/apply_pairs.cu's
// time at the flagship shapes, never faster: the apply is held by the
// rate at which the memory system retires scattered sectors, not by the
// loads one thread has in flight.
//
// Bound: bytes, as csrc/apply_pairs.cu.
#include <cuda_runtime.h>

#include "pair_runs.cuh"
#include "table_update.cuh"

__global__ void apply_pairs2_kernel(float* __restrict__ w,
                                    float* __restrict__ z,
                                    float* __restrict__ nn,
                                    float* __restrict__ cnt,
                                    float* __restrict__ V,
                                    float* __restrict__ nV,
                                    const int* __restrict__ uids,
                                    const float* __restrict__ pay,
                                    long long N, int K, int U, int half,
                                    ApplyParams p) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  int lo[2] = {2 * t, 2 * t + 1}, hi[2] = {0, 0}, id[2];
  bool on[2], v_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    id[s] = lo[s] < U ? run_start(uids, lo[s], U, N, &hi[s]) : -1;
    // rows not touched keep their bits
    on[s] = id[s] >= 0 && run_sum(pay, 2 + K, U, lo[s], hi[s]) > 0.0f;
  }
  if (!on[0] && !on[1]) return;

  // stage 1: the loads of both rows ...
  float c[2] = {0.0f, 0.0f}, g[2] = {0.0f, 0.0f}, add_cnt[2] = {0.0f, 0.0f};
  WRow r[2] = {};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!on[s]) continue;
    c[s] = cnt[id[s]];                              // PRE-update count
    r[s] = load_w(w, z, nn, id[s], p);
    g[s] = run_sum(pay, 0, U, lo[s], hi[s]);
    add_cnt[s] = run_sum(pay, 1 + K, U, lo[s], hi[s]);
  }
  // ... then both rows' arithmetic and stores
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    v_on[s] = false;
    if (!on[s]) continue;
    bool tail_ok = p.tail <= 0 || c[s] >= (float)p.tail;
    if (tail_ok) store_w(w, z, nn, id[s], step_w(r[s], g[s], p), p);
    cnt[id[s]] = c[s] + add_cnt[s];
    v_on[s] = K > 0 && tail_ok && c[s] >= p.V_threshold;
  }
  if (!v_on[0] && !v_on[1]) return;

  // stage 2, per factor: both entries loaded, then both updated
  for (int k = 0; k < K; ++k) {
    VEnt e[2] = {};
    float gv[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!v_on[s]) continue;
      e[s] = load_v(V, nV, (long long)k * N + id[s], p);
      gv[s] = run_sum(pay, 1 + k, U, lo[s], hi[s]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!v_on[s]) continue;
      store_v(V, nV, (long long)k * N + id[s], step_v(e[s], gv[s], p), p);
    }
  }
}

extern "C" int dft_apply_pairs2(void* w, void* z, void* n, void* cnt, void* V,
                                void* nV, const void* uids, const void* pay,
                                long long N, int K, int U, float lr_eta,
                                float lr_beta, float l1, float l2,
                                float V_lr_eta, float V_lr_beta, float V_l2,
                                float V_threshold, int tail, int w_updater,
                                int V_updater, void* stream) {
  if (U > 0) {
    ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                  V_threshold, tail, w_updater, V_updater};
    const int threads = 128;
    int half = (U + 1) / 2;
    unsigned int blocks = (unsigned int)((half + threads - 1) / threads);
    apply_pairs2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)w, (float*)z, (float*)n, (float*)cnt, (float*)V, (float*)nV,
        (const int*)uids, (const float*)pay, N, K, U, half, p);
  }
  return (int)cudaGetLastError();
}
