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
