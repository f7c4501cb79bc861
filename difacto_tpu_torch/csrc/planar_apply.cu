// The planar apply: two entries over csrc/apply_pairs.cu's kernel and a
// tile design for this card.
//
// Replaces two Pallas kernels that compute the function of
// csrc/apply_pairs.cu on planar leaves:
//   dft_apply_pairs2  difacto_tpu/ops/pair_sweep.py::apply_pairs2
//                     (_apply_pairs2_kernel, schedule DualPairMeta), on the
//                     six leaves of an FMState;
//   dft_apply_packed  scripts/hw_packed_pairs.py's apply_packed_kernel, in
//                     place on A [2+K, N] = w|cnt|V and B [2+K, N] = z|n|nV.
// Every leaf of both lies at a row N floats from the next, so each kernel
// takes six leaf pointers and serves both entries. The contract is
// csrc/apply_pairs.cu's: payload gw | gV[K] | add_cnt | touch, planar
// [3+K, U]; a non-decreasing uid stream with sentinels (>= N) at its end,
// equal ids one run summed in lane order; per row whose summed touch is
// > 0, the w updater under the tail filter, cnt += add_cnt, then the V
// updater gated by the PRE-update cnt; untouched rows keep their bits; no
// atomics. Every sum starts from 0 and runs in lane order, and the
// formulas are csrc/table_update.cuh's (built with --fmad=false), so every
// design has csrc/apply_pairs.cu's bits.
//
// Bound: bytes, and on this card the scattered 32-byte sectors: each leaf
// entry of a touched row is a lone 4-byte access to its own sector, N
// floats from the row's next leaf. The tile design (planar_apply_kernel)
// takes a tile of PA_T lanes a block:
//   1  stage: the tile's uids, and its gw, add_cnt and touch rows by
//      cp.async (16-byte copies where the rows allow), in one round trip;
//      a tile with no real id (sentinels only) leaves;
//   2  runs: the lane that starts a run of equal ids finds its end in
//      shared memory; a run that crosses the tile's end belongs to the
//      tile where it starts and is read on in device memory, however many
//      tiles it spans; it sums touch, gw and add_cnt in lane order;
//   3  compact: a ballot and a prefix over the warps list the touched rows
//      in lane order;
//   4  the row stage: a listed row a thread, its cnt and w leaves loaded
//      before any arithmetic; then the gate, and a second ballot that
//      lists the rows past it;
//   5  the factor stage: a row past the gate a thread, so that no lane
//      idles, its K factor entries in turn (load, step, store), gV read
//      from the payload.
//
// Measured on an H100 (PERF.md), kernel time at the flagship batch
// (3.6 M sector reads and writes): csrc/apply_pairs.cu's kernel (a lane a
// thread), B6's first design (two lanes a thread) and the tiles come
// within 0.130-0.141 ms, and the tiles' rmwonly floor is their own time.
// So the card's rate for lone sectors, not the kernel, sets the cost;
// what moves it is the loads in flight, and fewer win: 8 (row, factor)
// entries a thread loaded before any store took 1.13x one entry, the
// leaves loaded L1::no_allocate with an L2 evict-first policy 1.10-1.14x
// plain loads, the entries flattened row-fastest over the block 1.02x a
// row a thread; staging the gV rows too and a 32-byte L2 fetch
// granularity (the device takes the limit) changed nothing. The tiles
// beat the two-lane design but stay 0.5-4.5 % behind a lane a thread on
// either entry. So both entries hand their leaves to
// csrc/apply_pairs.cu's kernel, the fastest arrangement with these bits,
// and the tiles are a stage word of both.
//
// Flags (the wrappers' stage words): none, csrc/apply_pairs.cu's kernel;
// PA_TILES, the tile design; PA_RMWONLY, the tiles' floor: the same
// staging, compaction, loads and stores of every leaf the update would
// touch, each stored back as loaded (no sums but touch, no step), so the
// state's bits do not change. Nothing on Hopper gathers by TMA, and a
// row's leaves are 16 MB apart at 2^22 rows, so table rows are never
// staged.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_runs.cuh"
#include "table_update.cuh"

#define PA_T 128     // lanes of a tile = threads of a block
#define PA_WARPS (PA_T / 32)

// flags of the C entries (the probe words of the wrappers)
#define PA_TILES 1    // the tile design
#define PA_RMWONLY 2  // its loads and stores, no arithmetic: the floor

struct Leaves { float *w, *z, *n, *cnt, *V, *nV; };

// Loads and stores the compiler must issue, even where a store writes
// back the value just loaded (the floor).
struct OpaqueMem {
  __device__ __forceinline__ float ld(const float* a) const {
    float v;
    asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(a));
    return v;
  }
  __device__ __forceinline__ void st(float* a, float v) const {
    asm volatile("st.global.f32 [%0], %1;" :: "l"(a), "f"(v));
  }
};

// The sum of a payload row over lanes [lo, hi) in lane order: the tile's
// lanes from its staged copy `srow` (lane0 first), a run's lanes past the
// tile from the row `grow` in device memory.
__device__ __forceinline__ float tile_run_sum(const float* srow,
                                              const float* __restrict__ grow,
                                              int lane0, int nl, int lo,
                                              int hi) {
  const int cut = min(hi, lane0 + nl);
  float s = 0.0f;
  for (int j = lo; j < cut; ++j) s += srow[j - lane0];
  for (int j = cut; j < hi; ++j) s += grow[j];
  return s;
}

// Block-wide list position of each flagged thread, in thread order;
// returns the list's length. Contains barriers: every thread calls it.
__device__ __forceinline__ int block_compact(bool flag, int* pos,
                                             int* warp_n) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned ball = __ballot_sync(0xffffffffu, flag);
  __syncthreads();                     // warp_n free from any earlier use
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < PA_WARPS; ++w) {
    before += w < warp ? warp_n[w] : 0;
    total += warp_n[w];
  }
  *pos = before + __popc(ball & ((1u << lane) - 1u));
  return total;
}

template <class Mem, bool FLOOR>
__global__ void __launch_bounds__(PA_T)
planar_apply_kernel(Leaves L, const int* __restrict__ uids,
                    const float* __restrict__ pay, long long N, int K, int U,
                    bool vec16, ApplyParams p) {
  // the staged rows gw, add_cnt, touch; the uids; list 1, the touched
  // rows (table row, first lane, end lane, summed gw and add_cnt); list 2,
  // the rows past the gate (their list-1 index)
  __shared__ __align__(16) float pay_s[3][PA_T];
  __shared__ int uid_s[PA_T], r_id[PA_T], r_lo[PA_T], r_hi[PA_T];
  __shared__ float r_g[PA_T], r_add[PA_T];
  __shared__ int v_ent[PA_T], warp_n[PA_WARPS];

  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * PA_T;
  const int nl = min(PA_T, U - lane0);
  const Mem mem{};

  // 1 stage, one round trip: the uids, and the rows 0, 1+K, 2+K
  const int id = t < nl ? uids[lane0 + t] : -1;
  const int before = lane0 > 0 ? uids[lane0 - 1] : -1;
  uid_s[t] = id;
  const int per = vec16 ? PA_T / 4 : PA_T;  // copies per row
  for (int c = t; c < 3 * per; c += PA_T) {
    const int q = c / per, off = (c - q * per) * (vec16 ? 4 : 1);
    const long long r = q == 0 ? 0 : K + q;
    if (off < nl)
      __pipeline_memcpy_async(&pay_s[q][off], pay + r * U + lane0 + off,
                              vec16 ? 16 : 4);
  }
  __pipeline_commit();
  if (!__syncthreads_or(id >= 0 && id < N)) {  // sentinels only
    __pipeline_wait_prior(0);      // no copy outlives the block
    return;
  }

  // 2 runs: the lane that starts one finds its end and sums it
  const bool start = id >= 0 && id < N &&
                     id != (t > 0 ? uid_s[t - 1] : before);
  int hi = 0;
  if (start) {
    int e = t + 1;
    while (e < nl && uid_s[e] == id) ++e;
    hi = lane0 + e;
    if (e == nl)                   // the run may go on past the tile
      while (hi < U && uids[hi] == id) ++hi;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  bool touched = false;
  float g = 0.0f, add = 0.0f;
  if (start) {
    touched = tile_run_sum(pay_s[2], pay + (2 + K) * (long long)U, lane0, nl,
                           lane0 + t, hi) > 0.0f;  // else the row keeps bits
    if (touched && !FLOOR) {
      g = tile_run_sum(pay_s[0], pay, lane0, nl, lane0 + t, hi);
      add = tile_run_sum(pay_s[1], pay + (1 + K) * (long long)U, lane0, nl,
                         lane0 + t, hi);
    }
  }

  // 3 compact the touched rows
  int pos;
  const int n1 = block_compact(touched, &pos, warp_n);
  if (touched) {
    r_id[pos] = id;
    r_lo[pos] = lane0 + t;
    r_hi[pos] = hi;
    r_g[pos] = g;
    r_add[pos] = add;
  }
  if (n1 == 0) return;             // uniform: no touched row in the tile
  __syncthreads();

  // 4 the row stage: the row's leaves loaded, then stepped and stored
  bool gated = false;
  if (t < n1) {
    const long long row = r_id[t];
    const float c = mem.ld(L.cnt + row);          // PRE-update count
    WRow w = load_w(L.w, L.z, L.n, row, p, mem);  // speculative under tail
    const bool tail_ok = p.tail <= 0 || c >= (float)p.tail;
    if (tail_ok)
      store_w(L.w, L.z, L.n, row, FLOOR ? w : step_w(w, r_g[t], p), p, mem);
    mem.st(L.cnt + row, FLOOR ? c : c + r_add[t]);
    gated = K > 0 && tail_ok && c >= p.V_threshold;
  }
  const int n2 = block_compact(gated, &pos, warp_n);
  if (gated) v_ent[pos] = t;
  if (n2 > 0) {                    // uniform: some row past the gate
    __syncthreads();

    // 5 the factor stage: a row past the gate a thread, factor by factor
    if (t < n2) {
      const int li = v_ent[t];
      const long long row = r_id[li];
      const int lo = r_lo[li], end = r_hi[li];
      for (int k = 0; k < K; ++k) {
        const long long at = (long long)k * N + row;
        VEnt v = load_v(L.V, L.nV, at, p, mem);
        if (!FLOOR) v = step_v(v, run_sum(pay, 1 + k, U, lo, end), p);
        store_v(L.V, L.nV, at, v, p, mem);
      }
    }
  }
}

// csrc/apply_pairs.cu's entry: a lane a thread, the entries' default.
extern "C" int dft_apply_pairs(void* w, void* z, void* n, void* cnt, void* V,
                               void* nV, const void* uids, const void* pay,
                               long long N, int K, int U, float lr_eta,
                               float lr_beta, float l1, float l2,
                               float V_lr_eta, float V_lr_beta, float V_l2,
                               float V_threshold, int tail, int w_updater,
                               int V_updater, void* stream);

static int launch(Leaves L, const void* uids, const void* pay, long long N,
                  int K, int U, ApplyParams p, int flags, void* stream) {
  if (!(flags & (PA_TILES | PA_RMWONLY)))
    return dft_apply_pairs(L.w, L.z, L.n, L.cnt, L.V, L.nV, uids, pay, N, K,
                           U, p.lr_eta, p.lr_beta, p.l1, p.l2, p.V_lr_eta,
                           p.V_lr_beta, p.V_l2, p.V_threshold, p.tail,
                           p.w_updater, p.V_updater, stream);
  if (U <= 0) return (int)cudaGetLastError();
  const int* ids = (const int*)uids;
  const float* py = (const float*)pay;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)((U + PA_T - 1) / PA_T);
  const bool vec16 = U % 4 == 0 && (uintptr_t)pay % 16 == 0;
  if (flags & PA_RMWONLY)
    planar_apply_kernel<OpaqueMem, true><<<blocks, PA_T, 0, st>>>(
        L, ids, py, N, K, U, vec16, p);
  else
    planar_apply_kernel<PlainMem, false><<<blocks, PA_T, 0, st>>>(
        L, ids, py, N, K, U, vec16, p);
  return (int)cudaGetLastError();
}

extern "C" int dft_apply_pairs2(void* w, void* z, void* n, void* cnt, void* V,
                                void* nV, const void* uids, const void* pay,
                                long long N, int K, int U, float lr_eta,
                                float lr_beta, float l1, float l2,
                                float V_lr_eta, float V_lr_beta, float V_l2,
                                float V_threshold, int tail, int w_updater,
                                int V_updater, int flags, void* stream) {
  ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                V_threshold, tail, w_updater, V_updater};
  Leaves L{(float*)w, (float*)z, (float*)n, (float*)cnt, (float*)V,
           (float*)nV};
  return launch(L, uids, pay, N, K, U, p, flags, stream);
}

extern "C" int dft_apply_packed(void* A, void* B, const void* uids,
                                const void* pay, long long N, int K, int U,
                                float lr_eta, float lr_beta, float l1,
                                float l2, float V_lr_eta, float V_lr_beta,
                                float V_l2, float V_threshold, int tail,
                                int w_updater, int V_updater, int flags,
                                void* stream) {
  ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                V_threshold, tail, w_updater, V_updater};
  // A = w | cnt | V, B = z | n | nV: the leaves are rows of A and B
  float *a = (float*)A, *b = (float*)B;
  Leaves L{a, b, b + N, a + N, a + 2 * N, b + 2 * N};
  return launch(L, uids, pay, N, K, U, p, flags, stream);
}
