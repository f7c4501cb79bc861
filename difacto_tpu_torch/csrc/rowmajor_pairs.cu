// Pull and apply over the ROW-MAJOR table (layout=packed): one array
//   tbl [N, 4+2K], columns w | z | n | cnt | V[K] | nV[K],
// so that one id's state is 16 + 8K contiguous bytes (144 at K = 16).
//
// Second design, for this card, of the functions of csrc/pull_pairs.cu
// and csrc/apply_pairs.cu (the Pallas kernels _pull_pairs_kernel and
// _apply_pairs_kernel of difacto_tpu/ops/pair_sweep.py), with the same
// contracts apart from the table's layout:
//
//   pull:  out [1+K, U] planar; row 0 is w[uid], rows 1..K are V[uid],
//          zero unless cnt[uid] >= V_threshold; sentinel lanes (uid
//          outside [0, N)) are 0 in every row.
//   apply: payload [3+K, U] planar, gw | gV[K] | add_cnt | touch, over
//          non-decreasing uids (a descent fails a device-side assert);
//          the lane that starts a run of equal ids sums the run in lane
//          order (csrc/pair_runs.cuh) and updates the row once, in place:
//          the w updater under the tail filter, cnt += add_cnt, the V
//          updater gated by the PRE-update cnt. Rows not touched keep
//          their exact bits; no atomics. The math is
//          csrc/table_update.cuh's step_w / step_v, so the result has the
//          bits of csrc/apply_pairs.cu's on the same inputs.
//
// Bound: bytes, and on this card the number of 32-byte sectors touched
// rather than the bytes in them. The planar kernels spend one sector per
// 4-byte leaf entry (36 sectors per row of K = 16 in the apply, 18 in the
// pull), and every thread arrangement tried on them ran at the same
// sector rate. Here a row's leaves share sectors: the pull reads bytes
// 0..16+4K (3-4 sectors), the apply reads and writes 5-6.
//
// Design, both kernels: a warp owns 32 consecutive lanes, in two phases.
//   A  thread t takes lane t: the uid (coalesced), the row's head
//      w|z|n|cnt as one 16-byte load. That decides the gate, so a row
//      below the V threshold costs its first sector and nothing else. The
//      apply also sums the lane's gw, add_cnt and touch here (coalesced
//      payload rows), steps w and writes the head back.
//   B  the 32 x K/VEC pieces of VEC consecutive V entries are dealt to
//      the threads piece-fastest, so that neighbouring threads move
//      neighbouring 16-byte pieces of one row; id, gate and run end come
//      from the lane's thread by shuffle. The apply takes the gV payload
//      for its piece from the warp's shared-memory tile [K][32], which
//      cp.async filled with one 128-byte payload row a copy while phase A
//      ran, steps (V, nV) and writes both pieces back. The pull stages
//      its pieces in a shared-memory tile [1+K][32] per warp and then
//      writes the planar output one row per 128-byte store.
//   Past RM_KC = 128 factors (csrc/rowmajor.cuh) phase B takes them in
//   chunks, each through the tile: the pull's chunks are grid rows, the
//   apply's are walked in turn; K <= 128 is the one tile of every K.
// VEC is 4 when K % 4 == 0 and the table is 16-byte aligned (V and nV
// pieces then pair up as float4), 2 when K is even, 1 (the scalar path)
// for odd K: the same kernel template, narrower pieces.
//
// Measured on an H100 (PERF.md, section 6): the kernels' own times are
// 0.005 ms (pull) and 0.014 ms (apply) with the touched rows in the L2,
// 0.013 and 0.026 ms with the L2 flushed, against 0.026-0.037 and 0.20 ms
// for the planar kernels. Tried beside it, each in turns in one run:
//  - the gV payload read straight from the planar payload in phase B (8
//    consecutive lanes of a payload row per 4 pieces, whole sectors): 8-9 %
//    slower at K = 16 (0.0150 and 0.0284 ms) than the cp.async tile; kept
//    only for the lanes of a run that outlasts the warp;
//  - 2 and 8 warps a block instead of 4: no difference in the apply or
//    the K = 16 pull; 2 warps slow the K = 0 pull (0.0026 against 0.0021);
//  - the narrower pieces (`vec` 1 or 2 at even K): a few percent to a
//    fifth slower; they stay only as the path of the K that need them;
//  - the apply's order check as three small kernels launched by the
//    wrapper cost the step more than this kernel does; it is the assert
//    in phase A now.
// TMA was not tried: the rows are scattered 144-byte pieces.
//
// K1, dft_apply_rowmajor_segs: the apply over the sharded store owner's
// receive stream, S segments of C lanes, each non-decreasing, ids repeated
// across segments. The same kernel, its SEGS instantiation: phase A takes
// the owner rule and the sums of csrc/pair_runs.cuh (seg_owner, seg_sum:
// the own run, then the id's run in each later segment by a binary
// search), phase B adds the later segments' gV from the payload after the
// own run's, in that order; so it has the bits of
// csrc/apply_pairs.cu's apply_pairs_segs_kernel. The order check is per
// segment.
#include <assert.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_runs.cuh"
#include "rowmajor.cuh"
#include "table_update.cuh"

// CHUNKED: K > RM_KC, this block's chunk of the factors is blockIdx.y;
// else the one tile of all K (the code of every K up to RM_KC).
template <int VEC, bool CHUNKED>
__global__ void __launch_bounds__(RM_THREADS)
rowmajor_pull_kernel(const float* __restrict__ tbl,
                     const int* __restrict__ uids, float* __restrict__ out,
                     long long N, int K, int U, float thr) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane0 = (blockIdx.x * RM_WARPS + warp) * 32;
  if (lane0 >= U) return;          // the whole warp: no block barrier below
  const int D = 4 + 2 * K;
  const int lane = lane0 + t;
  // phase A: the head of this thread's lane
  int id = lane < U ? uids[lane] : -1;
  if (id < 0 || id >= N) id = -1;  // sentinel
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
    if (lane < U) out[lane] = w;
    return;
  }
  float* tile =
      smem + (size_t)warp * (1 + (CHUNKED ? RM_KC : K)) * RM_TILE_LD;
  tile[t] = w;
  // phase B: the V pieces of the warp's 32 rows through the tile
  if (CHUNKED) {
    const int k0 = blockIdx.y * RM_KC;
    pull_chunk<VEC>(tbl, D, id, act, tile, out, U, lane, t, k0,
                    min(K - k0, RM_KC));
  } else {
    pull_chunk<VEC>(tbl, D, id, act, tile, out, U, lane, t, 0, K);
  }
}

// The table is read and written here: no __restrict__ on it. SEGS: K1,
// the stream is segments of C lanes (csrc/pair_runs.cuh, seg_owner), and
// a row's sums go on over the id's runs in the later segments; else one
// stream (C unused).
template <int VEC, bool SEGS>
__global__ void __launch_bounds__(RM_THREADS)
rowmajor_apply_kernel(float* tbl, const int* __restrict__ uids,
                      const float* __restrict__ pay, long long N, int K,
                      int U, int C, ApplyParams p) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31;
  const int lane0 = (blockIdx.x * RM_WARPS + (threadIdx.x >> 5)) * 32;
  if (lane0 >= U) return;
  const int D = 4 + 2 * K;
  const int lane = lane0 + t;
  // the warp's tile [Kc][32] of the gV payload, one 128-byte row a copy:
  // the first chunk is on its way to shared memory (cp.async) while
  // phase A runs
  float* tile = smem + (size_t)(threadIdx.x >> 5) * rm_chunk(K) * 32;
  stage_gv(tile, pay, U, lane, 0, rm_chunk(K));
  // phase A: the lane that starts a run updates the row's head
  int id = -1, end = 0;
  if (lane < U) {
    // runs of equal ids must be consecutive (within each segment, for
    // K1). Checked here, on ids the lane reads anyway, and not by the
    // wrapper: a check outside the kernel costs the step three more
    // launches
    if (SEGS) {
      assert((lane % C == 0 || uids[lane - 1] <= uids[lane]) &&
             "apply_rowmajor: each segment's uids must be non-decreasing");
      id = seg_owner(uids, lane, C, N, &end);
    } else {
      assert((lane == 0 || uids[lane - 1] <= uids[lane]) &&
             "apply_rowmajor: uids must be non-decreasing");
      id = run_start(uids, lane, U, N, &end);
    }
  }
  // the sum of payload row r over the row's lanes
  auto sum = [&](int r) {
    return SEGS ? seg_sum(pay, uids, r, U, C, id, lane, end)
                : run_sum(pay, r, U, lane, end);
  };
  bool active = false;
  if (id >= 0 && sum(2 + K) > 0.0f) {  // else keep bits
    float add_cnt = sum(1 + K);
    float* row = tbl + (long long)id * D;
    float h[4];
    load_head<VEC>(row, h);
    const float c = h[3];                           // PRE-update count
    const bool tail_ok = p.tail <= 0 || c >= (float)p.tail;
    if (tail_ok) {
      WRow o = step_w(WRow{h[0], h[1], h[2]}, sum(0), p);
      h[0] = o.w;
      h[1] = o.z;
      h[2] = o.n;
    }
    h[3] = c + add_cnt;
    store_head<VEC>(row, h);
    active = K > 0 && tail_ok && c >= p.V_threshold;
  }
  // phase B, a chunk of at most RM_KC factors at a time: the chunk's
  // (V, nV) pieces of the rows past the gate, piece-fastest. Each factor
  // steps on its own, so the chunks change no bit
  for (int k0 = 0; k0 < K; k0 += RM_KC) {
    const int kc = min(K - k0, RM_KC);
    if (k0 > 0) {
      __syncwarp();                // the last chunk's tile is read
      stage_gv(tile, pay, U, lane, k0, kc);
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
      const int ract = __shfl_sync(0xffffffffu, (int)active, ll);
      if (ract) {
        float* v = tbl + (long long)rid * D + 4 + k0 + piece * VEC;
        VEnt e[VEC];
        load_v_row<VEC>(v, K, e, p);
        // the run's lanes inside the warp's tile, then (a run that
        // outlasts the warp) the rest from the payload: lane order, as
        // run_sum; for K1 then the id's runs in the later segments
        const int cut = min(rend, lane0 + 32);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const int r = piece * VEC + c;
          const float* prow = pay + (long long)(1 + k0 + r) * U;
          float gv = 0.0f;
          for (int j = ll; j < cut - lane0; ++j) gv += tile[r * 32 + j];
          for (int j = cut; j < rend; ++j) gv += prow[j];
          if (SEGS) gv = later_segs_sum(gv, prow, uids, U, C, rid, lane0 + ll);
          e[c] = step_v(e[c], gv, p);
        }
        store_v_row<VEC>(v, K, e, p);
      }
    }
  }
}

extern "C" int dft_pull_rowmajor(const void* tbl, const void* uids, void* out,
                                 long long N, int K, int U, float thr, int vec,
                                 void* stream) {
  if (U <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pull_grid(U, K);
  const size_t smem = pull_smem(K);
#define RM_PULL(V, C)                                                       \
  do {                                                                      \
    cudaError_t e = allow_smem(rowmajor_pull_kernel<V, C>, smem);           \
    if (e != cudaSuccess) return (int)e;                                    \
    rowmajor_pull_kernel<V, C><<<grid, RM_THREADS, smem, st>>>(             \
        (const float*)tbl, (const int*)uids, (float*)out, N, K, U, thr);    \
  } while (0)
  const bool chunked = K > RM_KC;
  switch (pick_vec(tbl, K, vec)) {
    case 4: if (chunked) RM_PULL(4, true); else RM_PULL(4, false); break;
    case 2: if (chunked) RM_PULL(2, true); else RM_PULL(2, false); break;
    default: if (chunked) RM_PULL(1, true); else RM_PULL(1, false); break;
  }
#undef RM_PULL
  return (int)cudaGetLastError();
}

// The row-major apply over one stream (C = 0) or, K1, over segments of C
// lanes (U a multiple of C).
static int apply_rowmajor(void* tbl, const void* uids, const void* pay,
                          long long N, int K, int U, int C, float lr_eta,
                          float lr_beta, float l1, float l2, float V_lr_eta,
                          float V_lr_beta, float V_l2, float V_threshold,
                          int tail, int w_updater, int V_updater, int vec,
                          void* stream) {
  if (U <= 0) return (int)cudaGetLastError();
  ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                V_threshold, tail, w_updater, V_updater};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)((U + RM_THREADS - 1) / RM_THREADS);
  const size_t smem = sizeof(float) * RM_WARPS * (size_t)rm_chunk(K) * 32;
#define RM_APPLY(V, SG)                                                     \
  do {                                                                      \
    cudaError_t e = allow_smem(rowmajor_apply_kernel<V, SG>, smem);         \
    if (e != cudaSuccess) return (int)e;                                    \
    rowmajor_apply_kernel<V, SG><<<blocks, RM_THREADS, smem, st>>>(         \
        (float*)tbl, (const int*)uids, (const float*)pay, N, K, U, C, p);   \
  } while (0)
  const bool segs = C > 0;
  switch (pick_vec(tbl, K, vec)) {
    case 4: if (segs) RM_APPLY(4, true); else RM_APPLY(4, false); break;
    case 2: if (segs) RM_APPLY(2, true); else RM_APPLY(2, false); break;
    default: if (segs) RM_APPLY(1, true); else RM_APPLY(1, false); break;
  }
#undef RM_APPLY
  return (int)cudaGetLastError();
}

extern "C" int dft_apply_rowmajor(void* tbl, const void* uids, const void* pay,
                                  long long N, int K, int U, float lr_eta,
                                  float lr_beta, float l1, float l2,
                                  float V_lr_eta, float V_lr_beta, float V_l2,
                                  float V_threshold, int tail, int w_updater,
                                  int V_updater, int vec, void* stream) {
  return apply_rowmajor(tbl, uids, pay, N, K, U, 0, lr_eta, lr_beta, l1, l2,
                        V_lr_eta, V_lr_beta, V_l2, V_threshold, tail,
                        w_updater, V_updater, vec, stream);
}

// K1 on the row-major table: S segments of C lanes (U = S*C).
extern "C" int dft_apply_rowmajor_segs(void* tbl, const void* uids,
                                       const void* pay, long long N, int K,
                                       int U, int C, float lr_eta,
                                       float lr_beta, float l1, float l2,
                                       float V_lr_eta, float V_lr_beta,
                                       float V_l2, float V_threshold,
                                       int tail, int w_updater, int V_updater,
                                       int vec, void* stream) {
  if (C <= 0 || U % C != 0) return (int)cudaErrorInvalidValue;
  return apply_rowmajor(tbl, uids, pay, N, K, U, C, lr_eta, lr_beta, l1, l2,
                        V_lr_eta, V_lr_beta, V_l2, V_threshold, tail,
                        w_updater, V_updater, vec, stream);
}
