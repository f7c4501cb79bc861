// K1's first pass: a stable merge of the sharded store owner's receive
// stream into one sorted stream, for the one-stream apply kernels
// (csrc/apply_pairs.cu apply_pairs_kernel, csrc/rowmajor_pairs.cu
// rowmajor_apply_kernel<VEC, false>).
//
// Replaces no TPU kernel. K1 is difacto_tpu/ops/pair_sweep.py:449
// apply_pairs with a build_pair_meta(..., seg_len=C) schedule
// (pair_sweep.py:180-215); the Pallas kernel needed no merge, because its
// grid ran the schedule's (block, window) pairs in order and carried a
// block's sums from one pair to the next. Hopper blocks run in no order,
// so here the S segments are merged first, and every run of an id is then
// consecutive.
//
// Input: uids [S*C], S segments of C lanes, each non-decreasing (a
// descent fails a device-side assert), the local sentinel (above every
// real id) at each segment's end; ids repeat across segments and within
// one. payload [P, S*C] planar. Output: the merged ids [S*C],
// non-decreasing, and the payload's columns moved with them. Ties go to
// the lower segment, then the lower lane: a stable sort's order, so the
// run of an id lists its lanes segment first, then lane, which is the
// order in which K1 sums them.
//
// Design: rank and scatter, a thread a lane. Lane j of segment s holding
// id x lands at its offset in its own segment, plus, for each earlier
// segment, the count of its ids <= x, plus, for each later segment, the
// count of its ids < x; the thread then writes the id and its P payload
// values there (the reads coalesced, the writes spread over about S times
// the warp's span). Those counts are S - 1 searches over C sorted lanes,
// whose dependent loads, not bytes, set the time. So a block takes a tile
// of 128 lanes of one segment, and warp w finds where the tile's least and
// greatest ids fall in other segment w, its two halves at once, by a
// 16-ary search (a probe a thread, a ballot a round: ~log16(C) rounds
// where one thread makes log2(C)); the tile's warps search up to four
// other segments side by side. The ids between the two bounds, about a
// tile's worth, are staged in shared memory, and each thread counts its
// own id there. The payload rows are loaded before the searches. Writing
// the reordered payload, rather than reading it through a permutation,
// leaves the one-stream kernels as they are, the row-major apply's
// cp.async staging of 128-byte gV rows included.
//
// Measured on an H100 against other designs, each exact, in turns
// (PERF.md, section 6): a thread a lane with S - 1 binary searches of its
// own took 0.0073 / 0.0103 / 0.0159 ms at S = 2 / 4 / 8 (K = 16), this
// design 0.0065 / 0.0082 / 0.0123; a sample of every q-th id staged first,
// to bound each window in shared memory, 0.0090 / 0.0129 / 0.0194 (its
// strided sample loads cost more than the searches they save); a window
// a warp, its other segments one after another, 0.0070 / 0.0105 at S = 2
// / 4. With 3 payload rows this design still takes 0.0047 ms at S = 2:
// most of the time is the chain of dependent loads, not the bytes.
//
// Bound: bytes. It reads every id and payload value once and writes each
// once: 2 (1 + P) S C 4 bytes, 8.6 MB for S = 2, C = 26,880, K = 16
// (P = 19), 2.6 us at 3.35 TB/s; the searches' comparisons are far below
// the card's rate. K1's own bound stays the bytes its update needs; this
// pass's traffic is not added to it.
#include <assert.h>
#include <cuda_runtime.h>

#define MERGE_THREADS 128  // a block, and the lanes of its tile
#define MERGE_WARPS (MERGE_THREADS / 32)
#define MERGE_WIN 512      // ids of another segment staged a window
#define MERGE_PRE 24       // payload rows a thread loads before its searches

// The lanes of [a, a + C) whose id is below x (LE: at most x).
template <bool LE>
__device__ __forceinline__ int count_below(const int* __restrict__ uids,
                                           int a, int C, int x) {
  int lo = a, hi = a + C;
  while (lo < hi) {
    const int m = lo + ((hi - lo) >> 1);
    if (LE ? uids[m] <= x : uids[m] < x) lo = m + 1; else hi = m;
  }
  return lo - a;
}

// count_below by the 16 threads of each half of the calling warp together,
// each half for its own key: a 16-ary search, one probe a thread and a
// ballot a round, so ~log16(C) dependent loads where a thread alone makes
// log2(C). Every thread of the warp calls it.
template <bool LE>
__device__ __forceinline__ int count_below_half(const int* __restrict__ uids,
                                                int a, int C, int key,
                                                int t) {
  const int j = t & 15;
  const int shift = t & 16;
  int lo = 0, hi = C;  // the count lies in [lo, hi]
  while (__any_sync(0xffffffffu, lo < hi)) {
    const long long len = hi - lo;
    bool below = false;
    if (lo < hi) {
      const int v = uids[a + lo + (int)((j * len) >> 4)];
      below = LE ? v <= key : v < key;
    }
    // the probes below the key are a prefix of the half's 16
    const unsigned int m = __ballot_sync(0xffffffffu, below) >> shift;
    const int c = __popc(m & 0xffffu);
    if (lo < hi) {
      if (c == 0) {
        hi = lo;             // the first probe, at lo, is not below
      } else {
        const int next = c < 16 ? lo + (int)((c * len) >> 4) : hi;
        lo += (int)(((c - 1) * len) >> 4) + 1;
        hi = next;
      }
    }
  }
  return lo;
}

// A block takes MERGE_THREADS consecutive lanes of segment blockIdx.y, a
// lane a thread. For MERGE_WARPS other segments at a time, warp w bounds
// the tile's ids in other segment u0 + w; the window between the bounds
// (at most MERGE_WIN ids, else the thread searches them in device memory)
// is staged in shared memory, all windows at once, and each thread counts
// its own id in each by a binary search there.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_segments_kernel(const int* __restrict__ uids,
                      const float* __restrict__ pay, int* __restrict__ mu,
                      float* __restrict__ mp, int U, int C, int P) {
  __shared__ int win[MERGE_WARPS][MERGE_WIN];
  __shared__ int bounds[MERGE_WARPS][2];
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = blockIdx.y, a = s * C;  // this segment and its first lane
  const int j0 = blockIdx.x * MERGE_THREADS;
  const int n = min(MERGE_THREADS, C - j0);  // the tile's lanes
  const bool mine = (int)threadIdx.x < n;
  const int lane = a + j0 + (mine ? (int)threadIdx.x : n - 1);
  const int x = uids[lane];
  assert((!mine || lane == a || uids[lane - 1] <= x) &&
         "merge_segments: each segment's uids must be non-decreasing");
  const float* src = pay + lane;
  float pre[MERGE_PRE];
#pragma unroll
  for (int r = 0; r < MERGE_PRE; ++r)
    pre[r] = r < P ? src[(long long)r * U] : 0.0f;
  const int key = uids[a + j0 + (t < 16 ? 0 : n - 1)];
  const int S = (int)gridDim.y;
  int pos = j0 + (int)threadIdx.x;
  for (int u0 = 0; u0 < S; u0 += MERGE_WARPS) {
    // other segment u0 + w: its bounds, ties to the lower segment
    const int uw = u0 + w;
    if (uw < S && uw != s) {
      const int c = uw < s ? count_below_half<true>(uids, uw * C, C, key, t)
                           : count_below_half<false>(uids, uw * C, C, key, t);
      if ((t & 15) == 0) bounds[w][t >> 4] = c;
    }
    __syncthreads();
    for (int v = 0; v < MERGE_WARPS && u0 + v < S; ++v) {
      const int lo = bounds[v][0], R = bounds[v][1] - lo;
      if (u0 + v != s && R <= MERGE_WIN)
        for (int i = threadIdx.x; i < R; i += MERGE_THREADS)
          win[v][i] = uids[(u0 + v) * C + lo + i];
    }
    __syncthreads();
    for (int v = 0; v < MERGE_WARPS && u0 + v < S; ++v) {
      const int u = u0 + v;
      if (u == s) continue;
      const int lo = bounds[v][0], R = bounds[v][1] - lo;
      const int* ids = R <= MERGE_WIN ? win[v] : uids + u * C + lo;
      pos += lo + (u < s ? count_below<true>(ids, 0, R, x)
                         : count_below<false>(ids, 0, R, x));
    }
    __syncthreads();                    // read before the next windows
  }
  if (!mine) return;
  mu[pos] = x;
  float* dst = mp + pos;
#pragma unroll
  for (int r = 0; r < MERGE_PRE; ++r)
    if (r < P) dst[(long long)r * U] = pre[r];
#pragma unroll 8
  for (int r = MERGE_PRE; r < P; ++r)
    dst[(long long)r * U] = src[(long long)r * U];
}

// uids i32 [U], pay f32 [P, U] -> mu i32 [U], mp f32 [P, U]; U = S*C.
extern "C" int dft_merge_segments(const void* uids, const void* pay, void* mu,
                                  void* mp, int U, int C, int P,
                                  void* stream) {
  if (C <= 0 || U % C != 0) return (int)cudaErrorInvalidValue;
  if (U > 0) {
    const dim3 grid((unsigned int)((C + MERGE_THREADS - 1) / MERGE_THREADS),
                    (unsigned int)(U / C));
    merge_segments_kernel<<<grid, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)uids, (const float*)pay, (int*)mu, (float*)mp, U, C, P);
  }
  return (int)cudaGetLastError();
}
