// Sweep pull and sweep apply over the ROW-MAJOR table (layout=packed):
//   tbl [N, 4+2K], columns w | z | n | cnt | V[K] | nV[K].
//
// Second design, for this card, of the functions of csrc/sweep_pull.cu and
// csrc/sweep_apply.cu (the Pallas kernels _pull_ms_kernel and
// _apply_ms_kernel of difacto_tpu/ops/sweep_ms.py), with the same
// contracts apart from the table's layout. The slot ids `sid` are S
// sorted streams laid end to end; off [S, nb+1] holds each stream's slice
// of every table block of R rows (csrc/sweep.cuh). A slot takes part when
// it lies in the slice of its own id's block in some stream:
//
//   pull:  out [1+K, NNZ] planar; for a slot that takes part row 0 is
//          w[sid], rows 1..K are V[sid], zero unless cnt[sid] >=
//          V_threshold; every other slot is 0 in every row.
//   apply: payload [3+K, NNZ] planar, gw | gV[K] | add_cnt | touch. The
//          slots of one table row, within a stream and across streams,
//          all add, in stream order, then slot order; the row is updated
//          once, in place: cnt += add_cnt, and where the summed touch is
//          > 0 the w updater under the tail filter and the V updater gated
//          by the PRE-update cnt. A row no slot names keeps its exact
//          bits; no atomics. The math is csrc/table_update.cuh's step_w /
//          step_v and the sums run in the planar kernel's order, so the
//          result has the bits of csrc/sweep_apply.cu's on the same
//          inputs.
//   Both trap when two neighbouring slots inside one stream's covered
//   range descend.
//
// Bound: bytes, and on this card the number of 32-byte sectors touched.
// The planar kernels lose their time in three places, and the design
// answers each:
//  - sectors: a planar leaf entry is its own sector (36 of them read and
//    written per row of K = 16 in the apply). Here the row's head
//    w|z|n|cnt is one 16-byte load that decides touch, tail filter and V
//    gate, so a row below the gate costs one sector, and V and nV move in
//    16-byte pieces (csrc/rowmajor_pairs.cu measured 5-14x for that);
//  - the scan: the planar kernels give every one of the table's rows a
//    thread and a binary search, though a few percent of the rows are
//    named. Here the work is dealt by SLOTS, as in the row-major pair
//    kernels: a thread per slot reads its id and the two offsets of its
//    block's slice in each stream. A slot owns its row when it is the
//    first slot of that id in the first stream that names it: with one
//    stream that is `sid[j-1] != sid[j]`, with more a binary search in the
//    earlier streams' short slices. Cost follows the slots, not the table,
//    and a dense block is no special case;
//  - idle threads: a warp owns 32 consecutive slots. Phase A (thread =
//    slot) does the head; phase B deals the 32 x K/VEC pieces of (V, nV)
//    to the threads piece-fastest, owner, gate and run bounds by shuffle,
//    the gV payload from a shared-memory tile [K][32] that cp.async fills
//    while phase A runs. The pull reads every covered slot's row itself
//    (equal ids re-read a row the L1 holds) and writes the planar output
//    through a transposed tile in 128-byte stores, zeros included, in one
//    launch. Past RM_KC factors (csrc/rowmajor.cuh) phase B takes them
//    in chunks, as the pair kernels do.
// The order check is the kernels' own: each slot compares itself with its
// left neighbour, ids the kernel reads anyway.
#include <assert.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowmajor.cuh"
#include "sweep.cuh"
#include "table_update.cuh"

// The id of slot j when some stream's slice of the id's table block
// covers j; -1 otherwise (the sentinel, an id outside its slice).
__device__ __forceinline__ int covered_id(const int* __restrict__ sid,
                                          const int* __restrict__ off,
                                          long long N, int S, int nb1, int R,
                                          int j) {
  const int id = sid[j];
  if (id < 0 || id >= N) return -1;
  const int* o = off + id / R;
  for (int s = 0; s < S; ++s, o += nb1)
    if (o[0] <= j && j < o[1]) return id;
  return -1;
}

// The table row that slot j OWNS: j's id when j is the first slot of that
// id in the first stream whose slice names it; -1 otherwise. *s0 is that
// stream and [j, *end) the id's run in it.
__device__ __forceinline__ int owned_row(const int* __restrict__ sid,
                                         const int* __restrict__ off,
                                         long long N, int S, int nb1, int R,
                                         int j, int* s0, int* end) {
  const int id = sid[j];
  if (id < 0 || id >= N) return -1;
  const int* o = off + id / R;
  for (int s = 0; s < S; ++s, o += nb1) {
    const int a = o[0], b = o[1];
    if (a <= j && j < b) {
      if (j > a && sid[j - 1] == id) return -1;  // an earlier slot of s owns
      int e = j + 1;
      while (e < b && sid[e] == id) ++e;
      *s0 = s;
      *end = e;
      return id;
    }
    // an earlier stream that names the row owns it
    const int l = slot_lower_bound(sid, a, b, id);
    if (l < b && sid[l] == id) return -1;
  }
  return -1;                                     // no slice covers j
}

// The sum of payload row `p` over the row's slots: the owner's run
// [j, end) in stream s0, then the id's run in every later stream, each in
// slot order (the order of csrc/sweep_apply.cu's runs_sum).
__device__ __forceinline__ float slots_sum(const float* __restrict__ p,
                                           const int* __restrict__ sid,
                                           const int* __restrict__ off, int S,
                                           int nb1, int R, int id, int s0,
                                           int j, int end) {
  float acc = 0.0f;
  for (int i = j; i < end; ++i) acc += p[i];
  for (int s = s0 + 1; s < S; ++s) {
    int lo, hi;
    find_run(sid, off, s, nb1, R, id, &lo, &hi);
    for (int i = lo; i < hi; ++i) acc += p[i];
  }
  return acc;
}

// slots_sum for a gV row, whose slots [lane0, lane0 + 32) sit in the
// warp's tile row `tr`.
__device__ __forceinline__ float slots_sum_tiled(
    const float* tr, int lane0, const float* __restrict__ p,
    const int* __restrict__ sid, const int* __restrict__ off, int S, int nb1,
    int R, int id, int s0, int j, int end) {
  float acc = 0.0f;
  for (int i = j; i < end; ++i)
    acc += (unsigned)(i - lane0) < 32u ? tr[i - lane0] : p[i];
  for (int s = s0 + 1; s < S; ++s) {
    int lo, hi;
    find_run(sid, off, s, nb1, R, id, &lo, &hi);
    for (int i = lo; i < hi; ++i)
      acc += (unsigned)(i - lane0) < 32u ? tr[i - lane0] : p[i];
  }
  return acc;
}

// CHUNKED as in csrc/rowmajor_pairs.cu's pull: past RM_KC factors, this
// block's chunk is blockIdx.y.
template <int VEC, bool CHUNKED>
__global__ void __launch_bounds__(RM_THREADS)
rowmajor_sweep_pull_kernel(const float* __restrict__ tbl,
                           const int* __restrict__ sid,
                           const int* __restrict__ off,
                           float* __restrict__ out, long long N, int K,
                           int nnz, int S, int nb, int R, float thr) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane0 = (blockIdx.x * RM_WARPS + warp) * 32;
  if (lane0 >= nnz) return;        // the whole warp: no block barrier below
  const int D = 4 + 2 * K;
  const int nb1 = nb + 1;
  const int lane = lane0 + t;
  // phase A: the head of this thread's slot
  int id = -1;
  if (lane < nnz) {
    if (lane > 0) check_sorted(sid, off, S, nb1, nnz, lane - 1);
    id = covered_id(sid, off, N, S, nb1, R, lane);
  }
  float w = 0.0f;
  bool act = false;
  if (id >= 0) {
    const float* row = tbl + (long long)id * D;
    if (VEC == 4) {
      float h[4];
      ld_vec<4>(row, h);
      w = h[0];
      act = h[3] >= thr;
    } else {
      w = row[0];
      act = K > 0 && row[3] >= thr;
    }
  }
  if (K == 0) {
    if (lane < nnz) out[lane] = w;
    return;
  }
  float* tile =
      smem + (size_t)warp * (1 + (CHUNKED ? RM_KC : K)) * RM_TILE_LD;
  tile[t] = w;
  // phase B: the V pieces of the warp's 32 slots through the tile
  if (CHUNKED) {
    const int k0 = blockIdx.y * RM_KC;
    pull_chunk<VEC>(tbl, D, id, act, tile, out, nnz, lane, t, k0,
                    min(K - k0, RM_KC));
  } else {
    pull_chunk<VEC>(tbl, D, id, act, tile, out, nnz, lane, t, 0, K);
  }
}

// The table is read and written here: no __restrict__ on it.
template <int VEC>
__global__ void __launch_bounds__(RM_THREADS)
rowmajor_sweep_apply_kernel(float* tbl, const int* __restrict__ sid,
                            const float* __restrict__ pay,
                            const int* __restrict__ off, long long N, int K,
                            int nnz, int S, int nb, int R, ApplyParams p) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31;
  const int lane0 = (blockIdx.x * RM_WARPS + (threadIdx.x >> 5)) * 32;
  if (lane0 >= nnz) return;
  const int D = 4 + 2 * K;
  const int nb1 = nb + 1;
  const int lane = lane0 + t;
  // the warp's tile [Kc][32] of the gV payload, one 128-byte row a copy:
  // the first chunk is on its way to shared memory (cp.async) while
  // phase A runs
  float* tile = smem + (size_t)(threadIdx.x >> 5) * rm_chunk(K) * 32;
  stage_gv(tile, pay, nnz, lane, 0, rm_chunk(K));
  // phase A: the slot that owns a row updates the row's head
  int id = -1, end = 0, s0 = 0;
  if (lane < nnz) {
    if (lane > 0) check_sorted(sid, off, S, nb1, nnz, lane - 1);
    id = owned_row(sid, off, N, S, nb1, R, lane, &s0, &end);
  }
  bool active = false;
  if (id >= 0) {
    const float touch = slots_sum(pay + (long long)(2 + K) * nnz, sid, off, S,
                                  nb1, R, id, s0, lane, end);
    const float add_cnt = slots_sum(pay + (long long)(1 + K) * nnz, sid, off,
                                    S, nb1, R, id, s0, lane, end);
    float* row = tbl + (long long)id * D;
    float h[4];
    load_head<VEC>(row, h);
    const float c = h[3];                           // PRE-update count
    const bool on = touch > 0.0f && (p.tail <= 0 || c >= (float)p.tail);
    if (on) {
      WRow o = step_w(WRow{h[0], h[1], h[2]},
                      slots_sum(pay, sid, off, S, nb1, R, id, s0, lane, end),
                      p);
      h[0] = o.w;
      h[1] = o.z;
      h[2] = o.n;
    }
    h[3] = c + add_cnt;
    store_head<VEC>(row, h);
    active = K > 0 && on && c >= p.V_threshold;
  }
  // phase B, a chunk of at most RM_KC factors at a time: the chunk's
  // (V, nV) pieces of the rows past the gate, piece-fastest. Each factor
  // steps on its own, so the chunks change no bit
  for (int k0 = 0; k0 < K; k0 += RM_KC) {
    const int kc = min(K - k0, RM_KC);
    if (k0 > 0) {
      __syncwarp();                // the last chunk's tile is read
      stage_gv(tile, pay, nnz, lane, k0, kc);
    }
    __pipeline_wait_prior(0);
    __syncwarp();
    const int PV = kc / VEC;
    for (int it = 0; it < PV; ++it) {
      const int q = it * 32 + t;
      const int ll = q / PV;
      const int piece = q - ll * PV;
      const int rid = __shfl_sync(0xffffffffu, id, ll);
      const int rend = __shfl_sync(0xffffffffu, end, ll);
      const int rs0 = __shfl_sync(0xffffffffu, s0, ll);
      const int ract = __shfl_sync(0xffffffffu, (int)active, ll);
      if (ract) {
        float* v = tbl + (long long)rid * D + 4 + k0 + piece * VEC;
        VEnt e[VEC];
        load_v_row<VEC>(v, K, e, p);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const int r = piece * VEC + c;
          const float gv = slots_sum_tiled(
              tile + r * 32, lane0, pay + (long long)(1 + k0 + r) * nnz, sid,
              off, S, nb1, R, rid, rs0, lane0 + ll, rend);
          e[c] = step_v(e[c], gv, p);
        }
        store_v_row<VEC>(v, K, e, p);
      }
    }
  }
}

extern "C" int dft_sweep_pull_rowmajor(const void* tbl, const void* sid,
                                       const void* off, void* out,
                                       long long N, int K, int nnz, int S,
                                       int nb, int R, float thr, int vec,
                                       void* stream) {
  if (nnz <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pull_grid(nnz, K);
  const size_t smem = pull_smem(K);
#define RM_SWEEP_PULL(V, C)                                                 \
  do {                                                                      \
    cudaError_t e = allow_smem(rowmajor_sweep_pull_kernel<V, C>, smem);     \
    if (e != cudaSuccess) return (int)e;                                    \
    rowmajor_sweep_pull_kernel<V, C><<<grid, RM_THREADS, smem, st>>>(       \
        (const float*)tbl, (const int*)sid, (const int*)off, (float*)out,   \
        N, K, nnz, S, nb, R, thr);                                          \
  } while (0)
  const bool chunked = K > RM_KC;
#define RM_SWEEP_PULL_C(V)                                                  \
  do {                                                                      \
    if (chunked) RM_SWEEP_PULL(V, true);                                    \
    else RM_SWEEP_PULL(V, false);                                           \
  } while (0)
  switch (pick_vec(tbl, K, vec)) {
    case 4: RM_SWEEP_PULL_C(4); break;
    case 2: RM_SWEEP_PULL_C(2); break;
    default: RM_SWEEP_PULL_C(1); break;
  }
#undef RM_SWEEP_PULL_C
#undef RM_SWEEP_PULL
  return (int)cudaGetLastError();
}

extern "C" int dft_sweep_apply_rowmajor(
    void* tbl, const void* sid, const void* pay, const void* off, long long N,
    int K, int nnz, int S, int nb, int R, float lr_eta, float lr_beta,
    float l1, float l2, float V_lr_eta, float V_lr_beta, float V_l2,
    float V_threshold, int tail, int w_updater, int V_updater, int vec,
    void* stream) {
  if (nnz <= 0) return (int)cudaGetLastError();
  ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                V_threshold, tail, w_updater, V_updater};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks =
      (unsigned int)((nnz + RM_THREADS - 1) / RM_THREADS);
  const size_t smem = sizeof(float) * RM_WARPS * (size_t)rm_chunk(K) * 32;
#define RM_SWEEP_APPLY(V)                                                   \
  do {                                                                      \
    cudaError_t e = allow_smem(rowmajor_sweep_apply_kernel<V>, smem);       \
    if (e != cudaSuccess) return (int)e;                                    \
    rowmajor_sweep_apply_kernel<V><<<blocks, RM_THREADS, smem, st>>>(       \
        (float*)tbl, (const int*)sid, (const float*)pay, (const int*)off,   \
        N, K, nnz, S, nb, R, p);                                            \
  } while (0)
  switch (pick_vec(tbl, K, vec)) {
    case 4: RM_SWEEP_APPLY(4); break;
    case 2: RM_SWEEP_APPLY(2); break;
    default: RM_SWEEP_APPLY(1); break;
  }
#undef RM_SWEEP_APPLY
  return (int)cudaGetLastError();
}
