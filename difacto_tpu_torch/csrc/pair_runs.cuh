// Runs of equal ids in the sorted unique-id stream of the pair apply
// kernels (csrc/apply_pairs.cu, csrc/planar_apply.cu,
// csrc/rowmajor_pairs.cu). The stream is
// non-decreasing (the wrappers assert it, the row-major kernel does so
// itself), so the lanes of one table row are consecutive: the lane
// that starts a run sums the run's payload in lane order — deterministic,
// no atomics — and updates the row once.
#pragma once

// The sum of payload row `row` over lanes [lo, hi), in lane order.
__device__ __forceinline__ float run_sum(const float* __restrict__ pay,
                                         int row, int u, int lo, int hi) {
  const float* p = pay + (long long)row * u;
  float s = 0.0f;
  for (int j = lo; j < hi; ++j) s += p[j];
  return s;
}

// The table row of `lane` when the lane starts a run of equal real ids,
// with the run's end in *end; -1 otherwise.
__device__ __forceinline__ int run_start(const int* __restrict__ uids,
                                         int lane, int U, long long N,
                                         int* end) {
  int id = uids[lane];
  if (id < 0 || id >= N) return -1;                 // sentinel
  if (lane > 0 && uids[lane - 1] == id) return -1;  // not the run's start
  int e = lane + 1;
  while (e < U && uids[e] == id) ++e;
  *end = e;
  return id;
}

// ---------------------------------------------------------------------------
// K1 by its first design, the search, kept as the yardstick of the merge
// (csrc/seg_merge.cu, which paths launch before the one-stream kernels)
// and launched by no path: a stream of S segments of C lanes (U = S*C),
// each non-decreasing with sentinels at its end, ids repeated ACROSS
// segments: the receive stream of the sharded store's owner, one segment
// per source rank (difacto_tpu/parallel/store.py::_push_pairs). A lane
// owns its row when it is the first lane of that id in its own segment
// and no earlier segment holds the id (a binary search over each earlier
// segment's C sorted lanes). The owner sums its own run, then the id's
// run in each later segment, in segment order: segment first, then lane,
// the order of a stable sort of the whole stream, and so the merge's.
// Its cost is latency: the search into each later segment is repeated
// for every payload row summed, up to (S - 1)(K + 4) dependent searches
// a row on the planar kernel.

// The first lane in [a, b) whose id is >= id (b when none).
__device__ __forceinline__ int lane_lower_bound(const int* __restrict__ uids,
                                                int a, int b, int id) {
  while (a < b) {
    const int m = a + ((b - a) >> 1);
    if (uids[m] < id) a = m + 1; else b = m;
  }
  return a;
}

// The table row `lane` owns in segments of C lanes, with the end of its
// run in its own segment in *end; -1 when it owns none (a sentinel, a lane
// after the run's first, or an id an earlier segment holds).
__device__ __forceinline__ int seg_owner(const int* __restrict__ uids,
                                         int lane, int C, long long N,
                                         int* end) {
  const int id = uids[lane];
  if (id < 0 || id >= N) return -1;                 // sentinel
  const int a = lane - lane % C;                    // this segment's start
  if (lane > a && uids[lane - 1] == id) return -1;  // not the run's start
  for (int s0 = 0; s0 < a; s0 += C) {
    const int l = lane_lower_bound(uids, s0, s0 + C, id);
    if (l < s0 + C && uids[l] == id) return -1;     // an earlier segment's
  }
  int e = lane + 1;
  while (e < a + C && uids[e] == id) ++e;
  *end = e;
  return id;
}

// The payload row `p` (one row of [rows, U]) summed over the id's runs in
// the segments after the one holding `lane`, in segment order, onto acc.
__device__ __forceinline__ float later_segs_sum(float acc,
                                                const float* __restrict__ p,
                                                const int* __restrict__ uids,
                                                int U, int C, int id,
                                                int lane) {
  for (int a = lane - lane % C + C; a < U; a += C) {
    for (int j = lane_lower_bound(uids, a, a + C, id);
         j < a + C && uids[j] == id; ++j)
      acc += p[j];
  }
  return acc;
}

// The sum of payload row `row` over the owner's run [lo, hi), then the
// id's runs in every later segment.
__device__ __forceinline__ float seg_sum(const float* __restrict__ pay,
                                         const int* __restrict__ uids,
                                         int row, int U, int C, int id,
                                         int lo, int hi) {
  return later_segs_sum(run_sum(pay, row, U, lo, hi), pay + (long long)row * U,
                        uids, U, C, id, lo);
}
