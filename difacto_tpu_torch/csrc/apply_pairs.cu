// Apply: sum the per-lane payload per table row, then update each touched
// row once, in place.
//
// Replaces difacto_tpu/ops/pair_sweep.py::apply_pairs (Pallas kernel
// _apply_pairs_kernel) with the per-row math of
// difacto_tpu/ops/sweep_ms.py::fused_table_update. Payload rows are
// gw | gV[K] | add_cnt | touch, planar [3+K, U]. For every table row whose
// summed touch is > 0:
//   * FTRL, AdaGrad or SGD on (w, z, n), masked by the tail filter;
//   * cnt += add_cnt;
//   * AdaGrad or SGD on (V, nV), gated by the PRE-update cnt.
// Rows not touched keep their exact bits; sentinel ids are ignored.
//
// Bound: bytes. Each touched row reads and writes its 4 + 2K floats at a
// random position and reads its 3+K payload floats. The TPU kernel swept
// host-scheduled (block, window) pairs with one-hot matmuls and carried a
// block accumulator across sequential grid steps; Hopper blocks run in no
// order, so instead the uid stream must be non-decreasing (the wrapper
// asserts it) and the lane that starts a run of equal ids sums the
// payload over its run in lane order — deterministic, no atomics — then
// does the update with the formulas in fused_table_update's order
// (csrc/table_update.cuh, shared with csrc/sweep_apply.cu), so
// results match the plain version to float rounding (built with
// --fmad=false). On the train path ids are unique, so every valid lane
// starts a run.
//
// One thread per run does the whole row: w/z/n, cnt, then the K factor
// entries. Every factor access hits a 32-byte sector for 4 useful bytes
// (planar [K, N] V at a random row), which holds the kernel far above its
// byte bound. A variant that spread the K factor rows over K threads per
// lane, in a second launch, measured no faster on an H100 (PERF.md), so
// the one launch stays; a row-major V is the ROADMAP's open question.
//
// K1, the sharded store owner's receive stream (S segments of C lanes,
// each non-decreasing, ids repeated across segments): the Pallas kernel's
// apply_pairs (difacto_tpu/ops/pair_sweep.py:449) with a
// build_pair_meta(..., seg_len=C) schedule (pair_sweep.py:180-215). On a
// path, ops/pair_sweep.py launches csrc/seg_merge.cu's stable merge and
// then apply_pairs_kernel below on the merged stream, whose run of an id
// lists its lanes segment first, then lane: the kernel needs no segment
// code. Bound: the bytes the update needs, as for one stream (the merge's
// own traffic is not added). The merge does S - 1 binary searches once a
// lane; the first design, dft_apply_pairs_segs below, did them for each
// of the 3 + K payload rows a row sums, serially on the owning thread.
// That design stays as the yardstick (pair_sweep.apply_pairs_segs_search,
// on no path): the lane that owns a row (csrc/pair_runs.cuh, seg_owner)
// sums its run and then the id's run in each later segment, found by a
// binary search; the same order, so the same bits.
#include <cuda_runtime.h>

#include "pair_runs.cuh"
#include "table_update.cuh"

// The update of table row `id` from its payload sums, `sum(r)` the sum of
// payload row r over the row's lanes: a run of one stream, or K1's runs
// over segments.
template <class Sum>
__device__ __forceinline__ void apply_row(float* __restrict__ w,
                                          float* __restrict__ z,
                                          float* __restrict__ nn,
                                          float* __restrict__ cnt,
                                          float* __restrict__ V,
                                          float* __restrict__ nV, int id,
                                          long long N, int K, const Sum& sum,
                                          ApplyParams p) {
  if (!(sum(2 + K) > 0.0f)) return;                 // keep bits
  float add_cnt = sum(1 + K);
  float c = cnt[id];                                // PRE-update count
  bool tail_ok = p.tail <= 0 || c >= (float)p.tail;
  if (tail_ok) update_w(w, z, nn, id, sum(0), p);
  cnt[id] = c + add_cnt;
  if (K > 0 && tail_ok && c >= p.V_threshold) {
    for (int r = 0; r < K; ++r)
      update_v(V, nV, (long long)r * N + id, sum(1 + r), p);
  }
}

__global__ void apply_pairs_kernel(float* __restrict__ w, float* __restrict__ z,
                                   float* __restrict__ nn, float* __restrict__ cnt,
                                   float* __restrict__ V, float* __restrict__ nV,
                                   const int* __restrict__ uids,
                                   const float* __restrict__ pay,
                                   long long N, int K, int U, ApplyParams p) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= U) return;
  int end;
  int id = run_start(uids, lane, U, N, &end);
  if (id < 0) return;
  apply_row(w, z, nn, cnt, V, nV, id, N, K,
            [&](int r) { return run_sum(pay, r, U, lane, end); }, p);
}

// K1 by the search design, the yardstick (no path launches it): the
// stream is S segments of C lanes (csrc/pair_runs.cuh, seg_owner); the
// lane that owns a row sums its run, then the id's runs in the later
// segments, and updates the row once.
__global__ void apply_pairs_segs_kernel(
    float* __restrict__ w, float* __restrict__ z, float* __restrict__ nn,
    float* __restrict__ cnt, float* __restrict__ V, float* __restrict__ nV,
    const int* __restrict__ uids, const float* __restrict__ pay, long long N,
    int K, int U, int C, ApplyParams p) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= U) return;
  int end;
  int id = seg_owner(uids, lane, C, N, &end);
  if (id < 0) return;
  apply_row(w, z, nn, cnt, V, nV, id, N, K,
            [&](int r) { return seg_sum(pay, uids, r, U, C, id, lane, end); },
            p);
}

extern "C" int dft_apply_pairs(void* w, void* z, void* n, void* cnt, void* V,
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
    unsigned int blocks = (unsigned int)((U + threads - 1) / threads);
    apply_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)w, (float*)z, (float*)n, (float*)cnt, (float*)V, (float*)nV,
        (const int*)uids, (const float*)pay, N, K, U, p);
  }
  return (int)cudaGetLastError();
}

// K1 by the search design (the yardstick): apply over S segments of C
// lanes (U = S*C), each non-decreasing; ids repeat across segments. One
// thread a lane, as dft_apply_pairs.
extern "C" int dft_apply_pairs_segs(void* w, void* z, void* n, void* cnt,
                                    void* V, void* nV, const void* uids,
                                    const void* pay, long long N, int K,
                                    int U, int C, float lr_eta,
                                    float lr_beta, float l1, float l2,
                                    float V_lr_eta, float V_lr_beta,
                                    float V_l2, float V_threshold, int tail,
                                    int w_updater, int V_updater,
                                    void* stream) {
  if (U > 0) {
    ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                  V_threshold, tail, w_updater, V_updater};
    const int threads = 128;
    unsigned int blocks = (unsigned int)((U + threads - 1) / threads);
    apply_pairs_segs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)w, (float*)z, (float*)n, (float*)cnt, (float*)V, (float*)nV,
        (const int*)uids, (const float*)pay, N, K, U, C, p);
  }
  return (int)cudaGetLastError();
}
