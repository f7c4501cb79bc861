// Segment sum over the host-sorted slot stream, second design for this
// card: out[r, u] = sum of the payload of row r over the slots s with
// lanes[s] == u; lanes no slot touches come out exactly 0. Two entries,
// one per payload layout, sharing their second pass:
//   dft_segsum_tiles: planar payload payT [pp, BLp]  (segsum_sorted)
//   dft_segsum_rows:  row-major payload pay [BLp, pp] (segsum_sorted_rows)
// and a third, FM's per-key gradients with the payload built inside:
//   dft_segsum_fm: d, S, the stream, the pulled rows -> [1 + K, U]
//     (segsum_fm; fm_keysum_kernel, fm_keysum_join, below)
//
// Replaces difacto_tpu/ops/segsum.py::segsum_sorted (Pallas kernel
// _segsum_kernel). The first design (csrc/segsum.cu) gives a warp one
// payload row of one 512-slot chunk: the lane stream is read once per
// payload row (18 times at K = 16), twice each; a warp has one 128-byte
// load in flight, then ten shuffles with compares and a loop-carried
// carry before the next; and the segment bounds go through a memset,
// scattered stores and a pass of pp x ub threads.
//
// Bound: bytes — every payload float is read once and added once. As in
// the first design the work is split by SLOTS (a power-law hot key covers
// a sixth of the stream), in two passes, without atomics, so the sums
// repeat bit for bit. What changed:
//   pass 1, planar (segsum_tiles_kernel): a warp owns a tile of 32 x SPT
//     consecutive slots (SPT = 4 a thread) for all pp payload rows, or for
//     a group of them when the tiles alone give the card too few warps
//     (ST_MIN_WARPS; each group works the structure out again). It reads the tile's lanes
//     once (16 bytes a thread) and works out the segment structure once:
//     where runs end inside each thread's SPT slots, which threads a carry
//     passes through (one ballot; the five steps of the warp's segmented
//     scan become five precomputed predicates), and where each run's sum
//     goes. Per payload row a thread then loads its SPT floats as 16-byte
//     pieces, sums its runs serially, and the warp scans one value per
//     thread: 6 shuffles per 32 x SPT slots, no compares; the next row's
//     load is in flight meanwhile.
//   pass 1, row-major (segsum_rows_kernel): a thread per (tile, payload
//     column) walks the tile's slots, as csrc/slot_accum.cu does at 128
//     columns; no shuffles.
//   A run inside one tile is written to out directly; the tile's first
//   piece, if its run began in an earlier tile, goes to head[tile, r]; its
//   last piece, if the run goes on in the next tile and began in this one,
//   to tail[tile, r] (a run that spans the whole tile goes to head).
//   pass 2 (segsum_cross): a thread per (tile, payload row), striding
//     over the rows where pp exceeds the block. Only the
//     thread of the tile in which a crossing run BEGINS works: it finds the
//     run's last tile c1 (the next tile, or a binary search over the tiles'
//     first lanes: the lanes are monotone) and writes tail[c0] +
//     head[c0+1] + ... + head[c1]; a long run's heads are dealt over the
//     block's threads. nt x pp threads instead of pp x ub, and no seg_lo /
//     seg_hi.
//   out is zeroed first (a memset), which is what lanes no slot touches
//   keep.
// Pad slots carry payload 0 and repeat the last lane, so they add nothing.
//
// FM's fused per-key sums (dft_segsum_fm) replace a composition of the
// step (learners/step.py before): cat(d, S), a gather of it by example
// into [BLp, 1 + K], the products dw = d x, dw x and dw S_k, a transposed
// cat into the payload [2 + K, BLp], B3 over it, then gV = sum dw S -
// V sum dw x and a cat into [1 + K, U]: ~2.5 GB a step at the FM cells'
// 5.24 M slots, 2.8-3.5 ms on an H100, where B3 itself took 0.17-0.40.
// Bound: bytes, a lane, an example and a value a slot read once (12 B),
// the d|S rows of the batch (from the L2 after their first read), the
// touched lanes' pulled factors, the 1 + K sums written once. Pass 1
// (fm_keysum_kernel) is B3's pass 1 with the payload rows formed in
// registers from d[b], x and S[b, :] and the combine folded into the
// writes of the runs inside a tile, against row 1's sum held in
// registers; pass 2 (fm_keysum_join) is segsum_cross's joins (the one
// body cross_runs, with its WIDE mode past 254 factors), in the same tile
// order, then the combine. Every product is rounded alone
// (__fmul_rn), every difference too (__fsub_rn), and the sums keep B3's
// order, so the gradient is the composition's bit for bit. The kernels
// have names of their own: a trace reader that credits B3's names with
// B3's payload bytes must not credit these, which read no payload.
#include <cuda_runtime.h>
#include <stdint.h>

#define ST_WARPS 4      // warps (tiles) per pass-1 block, planar and FM
#define SPT 4           // slots per thread, planar: one 16-byte load a row
                        // (8 was 10-17 % slower on an H100)
#define ST_SLOTS (32 * SPT)  // slots per tile, planar
#define ST_MIN_WARPS 4096  // fewer tiles than this: the rows are split
                          // into groups, a warp each (FFM's 97 rows over
                          // 768 tiles, a warp walking all of them, took
                          // 0.065 ms on an H100, the first design 0.059)
#define FM_CH 4         // factors of S a slot loads at a time, FM: 4 (one
                        // 16-byte load) with no load ahead took 0.198 ms
                        // at the FM cells' 5.24 M slots on an H100, 8 or
                        // 16 0.32, 4 with the next 4 in flight 0.26
#define FM_MIN_BLOCKS 8 // FM pass-1 blocks an SM holds: 64 registers, no
                        // spill; 1 (100) took 0.26 ms there, 10 or 12
                        // (spills) 0.22-0.25
#define SR_SLOTS 128    // slots per tile, row-major
#define SR_THREADS 256  // at most, per pass-1 block, row-major

// Where a run's sum goes.
#define ST_NONE 0u      // the run goes on in the next thread
#define ST_OUT 1u       // a run inside the tile
#define ST_HEAD 2u      // began in an earlier tile
#define ST_TAIL 3u      // began here, goes on in the next tile

// A warp's tile of 32 x SPT sorted slots and its segment structure,
// worked out once for all payload rows: the thread's lanes, where runs
// end inside its SPT slots, which threads a carry passes through (one
// ballot; the five steps of the warp's segmented scan become five
// precomputed predicates), and where each run's sum goes.
struct TileRuns {
  int l[SPT];        // the slots' lanes; -2 past the stream
  int j0, end;       // the thread's first slot; the tile's end
  bool vec;          // 16-byte loads: arrays aligned, the slots inside
  bool cut;          // no carry enters from the thread before (the
                     // tile's first thread takes none: pass 2 joins)
  unsigned brk;      // bit i: a run ends at slot i, another begins at i + 1
  unsigned steps;    // bit k: step k of the warp's scan adds
  int first_end;     // the slot at which the thread's first run ends
  unsigned dest;     // two bits a slot: where the run ending there goes
};

__device__ __forceinline__ void tile_runs(const int* __restrict__ lanes,
                                          int blp, int ub, int c, int t,
                                          int aligned, TileRuns& tr) {
  const int start = c * ST_SLOTS;
  tr.end = min(start + ST_SLOTS, blp);
  tr.j0 = start + t * SPT;
  // 16-byte loads need the arrays aligned and the thread's slots inside
  tr.vec = aligned && tr.j0 + SPT <= tr.end;
  int* l = tr.l;
  if (tr.vec) {
#pragma unroll
    for (int q = 0; q < SPT; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(lanes + tr.j0 + q);
      l[q] = v.x; l[q + 1] = v.y; l[q + 2] = v.z; l[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      l[i] = tr.j0 + i < tr.end ? lanes[tr.j0 + i] : -2;
  }
  const int prev_tile = start > 0 ? lanes[start - 1] : -1;
  const int next_tile = tr.end < blp ? lanes[tr.end] : -1;
  int pl = __shfl_up_sync(0xffffffffu, l[SPT - 1], 1);
  int nl = __shfl_down_sync(0xffffffffu, l[0], 1);
  if (t == 0) pl = prev_tile;
  if (t == 31) nl = next_tile;
  unsigned brk = 0;
#pragma unroll
  for (int i = 0; i + 1 < SPT; ++i) brk |= (l[i] != l[i + 1] ? 1u : 0u) << i;
  tr.brk = brk;
  tr.cut = t == 0 || l[0] != pl;
  // a carry passes THROUGH a thread whose slots are all one run
  const unsigned stops = __ballot_sync(0xffffffffu, tr.cut || brk != 0);
  // step d of the warp's scan adds thread t - d's value when no thread of
  // (t - d, t] stops the carry
  unsigned steps = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    if (t >= d) {
      const unsigned window = (d == 32 ? ~0u : ((1u << d) - 1u)) << (t - d + 1);
      if ((stops & window) == 0) steps |= 1u << k;
    }
  }
  tr.steps = steps;
  tr.first_end = brk ? __ffs(brk) - 1 : SPT - 1;
  unsigned dest = 0;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int lane = l[i];
    const bool ends = i + 1 < SPT ? ((brk >> i) & 1u) != 0 : nl != lane;
    const bool to_next = i + 1 == SPT && t == 31 && nl == lane;
    unsigned code = ST_NONE;
    if (lane >= 0 && lane < ub) {
      if (lane == prev_tile) code = (ends || to_next) ? ST_HEAD : ST_NONE;
      else if (to_next) code = ST_TAIL;
      else if (ends) code = ST_OUT;
    }
    dest |= code << (2 * i);
  }
  tr.dest = dest;
}

// sum[i]: one payload row's sum over the run that ends at slot i, from
// the run's first slot in the tile, given the thread's SPT values v
// (meaningful where the slot's code is not ST_NONE). The thread sums its
// runs serially, the warp scans one value a thread: 6 shuffles for 32 x
// SPT slots, no compares.
__device__ __forceinline__ void run_sums(const TileRuns& tr,
                                         const float (&v)[SPT],
                                         float (&sum)[SPT]) {
  float s[SPT];
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    run += v[i];
    s[i] = run;
    if ((tr.brk >> i) & 1u) run = 0.0f;
  }
  // inclusive segmented scan of the threads' last runs
  float x = s[SPT - 1];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float y = __shfl_up_sync(0xffffffffu, x, 1 << k);
    if ((tr.steps >> k) & 1u) x += y;
  }
  const float carry = __shfl_up_sync(0xffffffffu, x, 1);
#pragma unroll
  for (int i = 0; i < SPT; ++i)
    sum[i] = (i == tr.first_end && !tr.cut) ? carry + s[i] : s[i];
}

__device__ __forceinline__ unsigned run_code(const TileRuns& tr, int i) {
  return (tr.dest >> (2 * i)) & 3u;
}

// A tile's pieces of payload row r: a run inside the tile to out, its
// first piece (the run began in an earlier tile) to head, its last (the
// run goes on in the next tile and began here) to tail.
__device__ __forceinline__ void put_row(const TileRuns& tr,
                                        const float (&sum)[SPT], int r,
                                        float* __restrict__ out,
                                        float* __restrict__ head,
                                        float* __restrict__ tail,
                                        long long piece, int ub) {
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const unsigned code = run_code(tr, i);
    if (code == ST_OUT) out[(long long)r * ub + tr.l[i]] = sum[i];
    else if (code == ST_HEAD) head[piece + r] = sum[i];
    else if (code == ST_TAIL) tail[piece + r] = sum[i];
  }
}

__global__ void __launch_bounds__(32 * ST_WARPS)
segsum_tiles_kernel(const float* __restrict__ pay,
                    const int* __restrict__ lanes, float* __restrict__ out,
                    float* __restrict__ head, float* __restrict__ tail,
                    int pp, int blp, int ub, int nt, int aligned, int rg) {
  const int t = threadIdx.x & 31;
  const int c = blockIdx.x * ST_WARPS + (threadIdx.x >> 5);
  if (c >= nt) return;                              // uniform per warp
  TileRuns tr;
  tile_runs(lanes, blp, ub, c, t, aligned, tr);
  const long long piece = (long long)c * pp;
  // a thread's SPT floats of payload row r (0 past the stream)
  auto load_row = [&](int r, float* v) {
    const float* row = pay + (long long)r * blp;
    if (tr.vec) {
#pragma unroll
      for (int q = 0; q < SPT; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + tr.j0 + q);
        v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        v[i] = tr.j0 + i < tr.end ? row[tr.j0 + i] : 0.0f;
    }
  };
  // this warp's rows: group blockIdx.y of rg rows. The load of row r + 1
  // starts before row r is summed: 9 % faster on an H100 than loading in
  // turn; two to four rows ahead were slower
  const int r_lo = blockIdx.y * rg, r_hi = min(pp, r_lo + rg);
  float ahead[SPT];
  load_row(r_lo, ahead);
#pragma unroll 1
  for (int r = r_lo; r < r_hi; ++r) {
    float v[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) v[i] = ahead[i];
    if (r + 1 < r_hi) load_row(r + 1, ahead);
    float sum[SPT];
    run_sums(tr, v, sum);
    put_row(tr, sum, r, out, head, tail, piece, ub);
  }
}

// FM's fused pass 1 (fm_keysum_kernel): B3's tile and run structure, with
// the 2 + K payload rows built in registers from what the payload was
// made of. A thread reads its SPT slots' example b, value x and lane
// once, d[b], and S[b, :] FM_CH factors at a time (16-byte loads from the
// L2: S is the [B, K] output of the forward). Scratch row 0 is dw = d[b] x, row 1
// dw x, row 2 + k dw S[b, k], each product rounded alone (__fmul_rn),
// summed in B3's order. A run inside the tile is written combined:
// out[0, u] = sum dw, out[1 + k, u] = sum dw S_k - V[u, 1 + k] sum dw x
// (the product rounded, then the difference), with row 1's sum held in
// registers; the pieces of crossing runs go to head and tail, all 2 + K
// rows, for the join. V is the pulled rows [U, 1 + K] at any strides.
__global__ void __launch_bounds__(32 * ST_WARPS, FM_MIN_BLOCKS)
fm_keysum_kernel(const float* __restrict__ d, const float* __restrict__ S,
                 const float* __restrict__ x, const int* __restrict__ bidx,
                 const int* __restrict__ lanes, const float* __restrict__ V,
                 long long v_lane, long long v_col, float* __restrict__ out,
                 float* __restrict__ head, float* __restrict__ tail, int K,
                 int blp, int ub, int nt, int aligned, int s_vec) {
  const int t = threadIdx.x & 31;
  const int c = blockIdx.x * ST_WARPS + (threadIdx.x >> 5);
  if (c >= nt) return;                              // uniform per warp
  TileRuns tr;
  tile_runs(lanes, blp, ub, c, t, aligned, tr);
  const int pp = 2 + K;
  const long long piece = (long long)c * pp;
  // the slots' example and value (example 0 and value 0 past the stream)
  int b[SPT];
  float xv[SPT];
  bool in[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) in[i] = tr.j0 + i < tr.end;
  if (tr.vec) {
#pragma unroll
    for (int q = 0; q < SPT; q += 4) {
      const int4 bi = *reinterpret_cast<const int4*>(bidx + tr.j0 + q);
      const float4 xi = *reinterpret_cast<const float4*>(x + tr.j0 + q);
      b[q] = bi.x; b[q + 1] = bi.y; b[q + 2] = bi.z; b[q + 3] = bi.w;
      xv[q] = xi.x; xv[q + 1] = xi.y; xv[q + 2] = xi.z; xv[q + 3] = xi.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      b[i] = in[i] ? bidx[tr.j0 + i] : 0;
      xv[i] = in[i] ? x[tr.j0 + i] : 0.0f;
    }
  }
  // FM_CH factors of S[b, :] from k0 for each slot (0 past K and the
  // stream)
  constexpr int CH = FM_CH;
  auto load_s = [&](int k0, float (&sv)[SPT][CH]) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float* row = S + (long long)b[i] * K + k0;
      if (s_vec && in[i]) {
#pragma unroll
        for (int q = 0; q < CH; q += 4) {
          float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (k0 + q < K) f = *reinterpret_cast<const float4*>(row + q);
          sv[i][q] = f.x; sv[i][q + 1] = f.y; sv[i][q + 2] = f.z;
          sv[i][q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CH; ++j)
          sv[i][j] = in[i] && k0 + j < K ? row[j] : 0.0f;
      }
    }
  };
  float cur[SPT][CH];
  load_s(0, cur);
  float dw[SPT], v[SPT], sum[SPT], s1[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) dw[i] = in[i] ? __fmul_rn(d[b[i]], xv[i]) : 0.0f;
  run_sums(tr, dw, sum);
  put_row(tr, sum, 0, out, head, tail, piece, ub);
#pragma unroll
  for (int i = 0; i < SPT; ++i) v[i] = __fmul_rn(dw[i], xv[i]);
  run_sums(tr, v, s1);
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const unsigned code = run_code(tr, i);
    if (code == ST_HEAD) head[piece + 1] = s1[i];
    else if (code == ST_TAIL) tail[piece + 1] = s1[i];
  }
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += CH) {
    if (k0 > 0) load_s(k0, cur);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int k = k0 + j;
      if (k >= K) break;                            // uniform
#pragma unroll
      for (int i = 0; i < SPT; ++i) v[i] = __fmul_rn(dw[i], cur[i][j]);
      run_sums(tr, v, sum);
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const unsigned code = run_code(tr, i);
        if (code == ST_OUT) {
          const long long u = tr.l[i];
          const float vu = V[u * v_lane + (long long)(1 + k) * v_col];
          out[(long long)(1 + k) * ub + u] =
              __fsub_rn(sum[i], __fmul_rn(vu, s1[i]));
        } else if (code == ST_HEAD) {
          head[piece + 2 + k] = sum[i];
        } else if (code == ST_TAIL) {
          tail[piece + 2 + k] = sum[i];
        }
      }
    }
  }
}

// Row-major payload pay [blp, pp]: thread (g, col) of a block walks tile
// blockIdx.x * G + g in column col.
__global__ void __launch_bounds__(SR_THREADS)
segsum_rows_kernel(const float* __restrict__ pay,
                   const int* __restrict__ lanes, float* __restrict__ out,
                   float* __restrict__ head, float* __restrict__ tail, int pp,
                   int blp, int ub, int nt, int G) {
  const int g = threadIdx.x / pp;
  const int col = threadIdx.x - g * pp;
  const int c = blockIdx.x * G + g;
  if (g >= G || c >= nt) return;
  const int start = c * SR_SLOTS;
  const int len = min(SR_SLOTS, blp - start);
  const int before = start > 0 ? lanes[start - 1] : -1;
  const int after = start + len < blp ? lanes[start + len] : -1;
  const int* ln = lanes + start;
  const float* p = pay + (long long)start * pp + col;
  float acc = 0.0f;
  int lane = ln[0];
  bool from_prev = lane == before;
#pragma unroll 8
  for (int j = 0; j < len; ++j) {
    acc += p[(long long)j * pp];
    const bool last = j == len - 1;
    const int nxt = last ? after : ln[j + 1];
    if (!last && nxt == lane) continue;
    // the piece of `lane` ends at slot j
    if (lane >= 0 && lane < ub) {
      if (from_prev) head[(long long)c * pp + col] = acc;
      else if (last && nxt == lane) tail[(long long)c * pp + col] = acc;
      else out[(long long)col * ub + lane] = acc;
    }
    acc = 0.0f;
    from_prev = false;
    lane = nxt;
  }
}

// Pass 2 for tiles of W slots: the runs that cross tile boundaries. A
// block takes G = SC_THREADS / ppb consecutive tiles, ppb = min(pp,
// SC_THREADS); thread (g, r0) payload rows r0, r0 + ppb, ... of tile
// blockIdx.x * G + g. Up to SC_THREADS rows (WIDE false) that is one row
// a thread and the row loops fall away: with them left in, the pass took
// 0.0127 instead of 0.0093 ms at 18 rows on an H100. Beyond that (WIDE) a
// block has one tile, so a long run is summed by one thread per row. The thread of the tile in which a
// crossing run BEGINS finds the run's last tile c1 (the next tile, or a
// binary search over the tiles' first lanes: the lanes are monotone) and
// sums the run's pieces tail[c0] + head[c0+1] + ... + head[c1], in tile
// order. That is for a run of up to SC_SERIAL tiles (nearly all). A longer
// one (the hot key spans hundreds of tiles: one thread per row took
// 0.024 ms over it on an H100, as long as pass 1) is dealt over the whole
// block afterwards: thread (g, r) sums the heads c0+1+g, c0+1+g+G, ... of
// row r, then one thread per row adds tail[c0] and the G partial sums in
// g order. Both orders are fixed, so the sums repeat bit for bit.
//
// The joins are written once (cross_runs) for two kernels that differ in
// what they do with a joined sum (the Put): segsum_cross stores it (B3),
// fm_keysum_join combines it with row 1's sum of the same run, which
// Put::ROW1 has kept in shared memory first.
#define SC_THREADS 256
#define SC_SERIAL 32
#define FM_AHEAD 32     // head loads in flight a thread, FM's join

// s + head[first, r] + head[first + step, r] + ... up to tile `last`, added
// in that order, eight loads in flight (left to the compiler the loop ran
// one load per trip to the L2: 0.2 us a tile on an H100).
template <int AHEAD = 8>
__device__ __forceinline__ float heads_sum(const float* __restrict__ head,
                                           int first, int last, int step,
                                           int pp, int r, float s) {
  int k = first;
  for (; (long long)k + (AHEAD - 1LL) * step <= last; k += AHEAD * step) {
    float v[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      v[u] = head[(long long)(k + u * step) * pp + r];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) s += v[u];
  }
  for (; k <= last; k += step) s += head[(long long)k * pp + r];
  return s;
}

// B3's Put: out[r, lane] = s.
struct StorePut {
  static constexpr bool ROW1 = false;
  float* __restrict__ out;
  int ub;
  __device__ __forceinline__ void operator()(int r, int lane, float s,
                                             float) const {
    out[(long long)r * ub + lane] = s;
  }
};

// FM's Put, pass 1's combine on a joined run, s1 the run's row-1 sum:
// out[0, u] = sum dw, out[1 + k, u] = sum dw S_k - V[u, 1 + k] sum dw x.
struct FmPut {
  static constexpr bool ROW1 = true;
  float* __restrict__ out;
  const float* __restrict__ V;
  long long v_lane, v_col;
  int ub;
  __device__ __forceinline__ void operator()(int r, int lane, float s,
                                             float s1) const {
    if (r == 0) {
      out[lane] = s;
    } else if (r >= 2) {
      const float vu = V[(long long)lane * v_lane + (long long)(r - 1) * v_col];
      out[(long long)(r - 1) * ub + lane] = __fsub_rn(s, __fmul_rn(vu, s1));
    }
  }
};

template <bool WIDE, int AHEAD, class Put>
__device__ __forceinline__ void cross_runs(const int* __restrict__ lanes,
                                           const float* __restrict__ head,
                                           const float* __restrict__ tail,
                                           int pp, int blp, int ub, int nt,
                                           int W, const Put& put) {
  __shared__ float part[SC_THREADS];
  __shared__ float row1[Put::ROW1 ? SC_THREADS : 1];  // a tile's row-1 sum
  __shared__ int pub[3];
  const int ppb = WIDE ? SC_THREADS : pp;
  const int G = WIDE ? 1 : SC_THREADS / pp;
  const int rows = WIDE ? pp : 1;                   // trips of a row loop
  const int g = threadIdx.x / ppb;
  const int r0 = threadIdx.x - g * ppb;
  const int c = blockIdx.x * G + g;
  const long long e = (long long)(c + 1) * W;       // the next tile's start
  int lane = -1, c1 = c;
  // a run crosses into the next tile, and it began in this one
  bool mine = g < G && e < blp;
  if (mine) {
    lane = lanes[e - 1];
    mine = lanes[e] == lane && lane >= 0 && lane < ub &&
           !(c > 0 && lanes[(long long)c * W - 1] == lane);
  }
  if (mine) {
    int lo = c + 1, hi = nt - 1;
    if (lo < hi && lanes[(long long)(lo + 1) * W] != lane) hi = lo;
    while (lo < hi) {
      const int m = lo + ((hi - lo + 1) >> 1);
      if (lanes[(long long)m * W] == lane) lo = m; else hi = m - 1;
    }
    c1 = lo;
  }
  const bool is_long = mine && c1 - c > SC_SERIAL;
  for (int rb = 0; rb < rows; rb += SC_THREADS) {   // uniform
    const int r = rb + r0;
    const bool on = mine && !is_long && (!WIDE || r < pp);
    float s = 0.0f;
    if (on)
      s = heads_sum<AHEAD>(head, c + 1, c1, 1, pp, r,
                           tail[(long long)c * pp + r]);
    if constexpr (Put::ROW1) {
      if (rb == 0) {                                // row 1 is in the first trip
        if (on && r == 1) row1[g] = s;
        __syncthreads();
      }
      if (on) put(r, lane, s, row1[g]);
    } else {
      if (on) put(r, lane, s, 0.0f);
    }
  }
  if (!__syncthreads_or(is_long)) return;
  for (int gg = 0; gg < G; ++gg) {                  // the block's tiles in turn
    if (threadIdx.x == gg * ppb) {
      pub[0] = is_long;
      pub[1] = c1;
      pub[2] = lane;
    }
    __syncthreads();
    if (pub[0]) {                                   // uniform over the block
      const int c0 = blockIdx.x * G + gg, last = pub[1], ln = pub[2];
      for (int rb = 0; rb < rows; rb += SC_THREADS) {  // uniform
        const int r = rb + r0;
        const bool row = !WIDE || r < pp;
        if (g < G && row)
          part[threadIdx.x] =
              heads_sum<AHEAD>(head, c0 + 1 + g, last, G, pp, r, 0.0f);
        __syncthreads();
        float s = 0.0f;
        if (g == 0 && row) {
          s = tail[(long long)c0 * pp + r];
          for (int q = 0; q < G; ++q) s += part[q * ppb + r0];
        }
        if constexpr (Put::ROW1) {
          if (rb == 0) {
            if (g == 0 && r == 1) row1[0] = s;
            __syncthreads();
          }
          if (g == 0 && row) put(r, ln, s, row1[0]);
        } else {
          if (g == 0 && row) put(r, ln, s, 0.0f);
        }
        if (WIDE) __syncthreads();                  // part is reused
      }
    }
    __syncthreads();                                // pub, part, row1 reused
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(SC_THREADS)
segsum_cross(const int* __restrict__ lanes, float* __restrict__ out,
             const float* __restrict__ head, const float* __restrict__ tail,
             int pp, int blp, int ub, int nt, int W) {
  cross_runs<WIDE, 8>(lanes, head, tail, pp, blp, ub, nt, W,
                      StorePut{out, ub});
}

// FM's fused pass 2 (fm_keysum_join): segsum_cross's joins over the 2 + K
// scratch rows, in the same tile order, then pass 1's combine on each
// joined run against the run's row-1 sum.
template <bool WIDE>
__global__ void __launch_bounds__(SC_THREADS)
fm_keysum_join(const int* __restrict__ lanes, float* __restrict__ out,
               const float* __restrict__ head, const float* __restrict__ tail,
               const float* __restrict__ V, long long v_lane, long long v_col,
               int pp, int blp, int ub, int nt) {
  cross_runs<WIDE, FM_AHEAD>(lanes, head, tail, pp, blp, ub, nt, ST_SLOTS,
                             FmPut{out, V, v_lane, v_col, ub});
}

// Pass 2's blocks: one tile a block past SC_THREADS rows (WIDE), else
// SC_THREADS / pp tiles.
static unsigned int cross_blocks(int pp, int nt) {
  const int G = pp > SC_THREADS ? 1 : SC_THREADS / pp;
  return (unsigned int)((nt + G - 1) / G);
}

static int cross_pass(const int* lanes, float* out, const float* head,
                      const float* tail, int pp, int blp, int ub, int nt,
                      int W, cudaStream_t s) {
  if (pp > SC_THREADS)
    segsum_cross<true><<<cross_blocks(pp, nt), SC_THREADS, 0, s>>>(
        lanes, out, head, tail, pp, blp, ub, nt, W);
  else
    segsum_cross<false><<<cross_blocks(pp, nt), SC_THREADS, 0, s>>>(
        lanes, out, head, tail, pp, blp, ub, nt, W);
  return (int)cudaGetLastError();
}

// head, tail: scratch [nt, pp] with nt = ceil(blp / 128).
extern "C" int dft_segsum_tiles(const void* pay, const void* lanes, void* out,
                                void* head, void* tail, int pp, int blp,
                                int ub, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ub <= 0 || pp <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)pp * ub, s);
  if (blp <= 0) return (int)cudaGetLastError();
  const int nt = (blp + ST_SLOTS - 1) / ST_SLOTS;
  const int aligned = blp % 4 == 0 && (uintptr_t)pay % 16 == 0 &&
                      (uintptr_t)lanes % 16 == 0;
  // each row's sum is the same whichever group takes it: the bits do not
  // depend on the split
  int groups = nt < ST_MIN_WARPS ? min(pp, (ST_MIN_WARPS + nt - 1) / nt) : 1;
  const int rg = (pp + groups - 1) / groups;
  groups = (pp + rg - 1) / rg;
  const dim3 blocks((unsigned int)((nt + ST_WARPS - 1) / ST_WARPS),
                    (unsigned int)groups);
  segsum_tiles_kernel<<<blocks, 32 * ST_WARPS, 0, s>>>(
      (const float*)pay, (const int*)lanes, (float*)out, (float*)head,
      (float*)tail, pp, blp, ub, nt, aligned, rg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return cross_pass((const int*)lanes, (float*)out, (const float*)head,
                    (const float*)tail, pp, blp, ub, nt, ST_SLOTS, s);
}

// head, tail: scratch [nt, pp] with nt = ceil(blp / 128); pp <= 256 (a
// thread per column of a tile).
extern "C" int dft_segsum_rows(const void* pay, const void* lanes, void* out,
                               void* head, void* tail, int pp, int blp,
                               int ub, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ub <= 0 || pp <= 0) return (int)cudaGetLastError();
  if (pp > SR_THREADS) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)pp * ub, s);
  if (blp <= 0) return (int)cudaGetLastError();
  const int nt = (blp + SR_SLOTS - 1) / SR_SLOTS;
  const int G = SR_THREADS / pp;
  segsum_rows_kernel<<<(unsigned int)((nt + G - 1) / G), G * pp, 0, s>>>(
      (const float*)pay, (const int*)lanes, (float*)out, (float*)head,
      (float*)tail, pp, blp, ub, nt, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return cross_pass((const int*)lanes, (float*)out, (const float*)head,
                    (const float*)tail, pp, blp, ub, nt, SR_SLOTS, s);
}

// FM's per-key sums, fused (segsum_fm): d [B], S [B, K] (row-major), x,
// bidx and lanes [blp] in sorted-slot order, V the pulled rows at element
// strides v_lane, v_col; out [1 + K, ub]; head, tail: scratch [nt, 2 + K]
// with nt = ceil(blp / 128). K >= 1.
extern "C" int dft_segsum_fm(const void* d, const void* S, const void* x,
                             const void* bidx, const void* lanes,
                             const void* V, long long v_lane, long long v_col,
                             void* out, void* head, void* tail, int K,
                             int blp, int ub, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int pp = 2 + K;
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (ub <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)(1 + K) * ub, s);
  if (blp <= 0) return (int)cudaGetLastError();
  const int nt = (blp + ST_SLOTS - 1) / ST_SLOTS;
  const int aligned = blp % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)bidx % 16 == 0 && (uintptr_t)lanes % 16 == 0;
  const int s_vec = K % 4 == 0 && (uintptr_t)S % 16 == 0;
  fm_keysum_kernel<<<(unsigned int)((nt + ST_WARPS - 1) / ST_WARPS),
                     32 * ST_WARPS, 0, s>>>(
      (const float*)d, (const float*)S, (const float*)x, (const int*)bidx,
      (const int*)lanes, (const float*)V, v_lane, v_col, (float*)out,
      (float*)head, (float*)tail, K, blp, ub, nt, aligned, s_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (pp > SC_THREADS)
    fm_keysum_join<true><<<cross_blocks(pp, nt), SC_THREADS, 0, s>>>(
        (const int*)lanes, (float*)out, (const float*)head,
        (const float*)tail, (const float*)V, v_lane, v_col, pp, blp, ub, nt);
  else
    fm_keysum_join<false><<<cross_blocks(pp, nt), SC_THREADS, 0, s>>>(
        (const int*)lanes, (float*)out, (const float*)head,
        (const float*)tail, (const float*)V, v_lane, v_col, pp, blp, ub, nt);
  return (int)cudaGetLastError();
}
