// Slot addressing and the row scan of the whole-table sweep kernels
// (csrc/sweep_pull.cu, csrc/sweep_apply.cu).
//
// The slot ids `sid` are S streams laid end to end, each sorted. Table
// block i (rows [i*R, (i+1)*R)) owns, in stream s, the slice
// sid[off[s*(nb+1) + i] : off[s*(nb+1) + i + 1]) — the per-stream
// searchsorted boundaries of ops/sweep.py. A slot takes part in the sweep
// when it lies in the slice of its own id's block in some stream; every
// other slot (the sentinel N, an id outside its slice) is ignored, as the
// TPU kernels' in-bound masks ignore it (difacto_tpu/ops/sweep_ms.py::
// _inbound and the one-hot select from ids alone).
//
// Both kernels give one CUDA block to each CHUNK consecutive table rows
// and work in two phases:
//   scan:  one thread per table row (consecutive threads, consecutive
//          rows) binary-searches its row in each stream's slice; the rows
//          some slot names are compacted, in row order, into a list in
//          shared memory (a ballot and a prefix sum over the warps —
//          deterministic, no atomics), with their run in stream 0;
//   work:  the block's threads take (table leaf, named row) items of that
//          list, so every load of the planar [K, N] table is issued by its
//          own thread. (One thread doing a named row's K factor entries in
//          a loop, the first design, left 2 % of the threads to wait on K
//          memory round trips each: 2.4x slower than apply_pairs on an
//          H100.)
// A chunk whose table blocks have no slot in any stream returns at once.
#pragma once
#include <assert.h>

#define CHUNK 1024     // table rows per CUDA block
#define THREADS 256    // threads per CUDA block (a multiple of 32)

// First slot in [a, b) whose id is >= r; sid[a:b) is sorted.
__device__ __forceinline__ int slot_lower_bound(const int* __restrict__ sid,
                                                int a, int b, int r) {
  while (a < b) {
    int m = a + ((b - a) >> 1);
    if (__ldg(sid + m) < r) a = m + 1; else b = m;
  }
  return a;
}

// The run [*lo, *hi) of the slots with id r in stream s's slice of its
// table block; empty (*lo == *hi) when r has none there. Duplicates make
// the run longer; its reader walks it in slot order.
__device__ __forceinline__ void find_run(const int* __restrict__ sid,
                                         const int* __restrict__ off, int s,
                                         int nb1, int R, int r, int* lo,
                                         int* hi) {
  const int* o = off + s * nb1 + r / R;
  int b = __ldg(o + 1);
  int l = slot_lower_bound(sid, __ldg(o), b, r);
  int h = l;
  while (h < b && __ldg(sid + h) == r) ++h;
  *lo = l;
  *hi = h;
}

// True when no stream has a slot in the table blocks of rows [c0, c1).
__device__ __forceinline__ bool chunk_empty(const int* __restrict__ off,
                                            int S, int nb1, int R, int c0,
                                            int c1) {
  for (int i = c0 / R; i <= (c1 - 1) / R; ++i)
    for (int s = 0; s < S; ++s)
      if (off[s * nb1 + i] < off[s * nb1 + i + 1]) return false;
  return true;
}

// The scan phase over this block's rows: fills rows[] (in row order) and
// lo0[]/hi0[] (their run in stream 0) and returns how many rows some slot
// names. Called by every thread of the block.
__device__ __forceinline__ int scan_named_rows(const int* __restrict__ sid,
                                               const int* __restrict__ off,
                                               long long N, int S, int nb1,
                                               int R, int c0, int* rows,
                                               int* lo0, int* hi0) {
  __shared__ int warp_n[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int base = 0; base < CHUNK; base += THREADS) {
    int r = c0 + base + threadIdx.x;
    bool named = false;
    int l0 = 0, h0 = 0;
    if (r < N) {
      for (int s = 0; s < S; ++s) {
        int lo, hi;
        find_run(sid, off, s, nb1, R, r, &lo, &hi);
        if (s == 0) {
          l0 = lo;
          h0 = hi;
        }
        named |= lo < hi;
      }
    }
    unsigned m = __ballot_sync(0xffffffffu, named);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int at = n, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) at += warp_n[w];
      total += warp_n[w];
    }
    if (named) {
      at += __popc(m & ((1u << lane) - 1u));
      rows[at] = r;
      lo0[at] = l0;
      hi0[at] = h0;
    }
    n += total;
    __syncthreads();  // warp_n is rewritten by the next round
  }
  return n;
}

// The run of a named row in stream s: stream 0's from the scan, the
// others searched again.
__device__ __forceinline__ void named_run(const int* __restrict__ sid,
                                          const int* __restrict__ off,
                                          int s, int nb1, int R, int r,
                                          int m, const int* lo0,
                                          const int* hi0, int* lo, int* hi) {
  if (s == 0) {
    *lo = lo0[m];
    *hi = hi0[m];
  } else {
    find_run(sid, off, s, nb1, R, r, lo, hi);
  }
}

// Traps when slot j and j+1 lie in one stream's covered range
// [off[s, 0], off[s, nb]) but descend: the binary searches need each
// stream sorted (the TPU kernels' one-hot selects did not).
__device__ __forceinline__ void check_sorted(const int* __restrict__ sid,
                                             const int* __restrict__ off,
                                             int S, int nb1, int nnz, int j) {
  if (j + 1 >= nnz || sid[j] <= sid[j + 1]) return;
  for (int s = 0; s < S; ++s) {
    bool inside = off[s * nb1] <= j && j + 1 < off[s * nb1 + nb1 - 1];
    assert(!inside && "sweep kernels: each id stream must be sorted");
  }
}
