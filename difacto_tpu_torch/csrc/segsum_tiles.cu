// Segment sum over the host-sorted slot stream, second design for this
// card: out[r, u] = sum of the payload of row r over the slots s with
// lanes[s] == u; lanes no slot touches come out exactly 0. Two entries,
// one per payload layout, sharing their second pass:
//   dft_segsum_tiles: planar payload payT [pp, BLp]  (segsum_sorted)
//   dft_segsum_rows:  row-major payload pay [BLp, pp] (segsum_sorted_rows)
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
#include <cuda_runtime.h>
#include <stdint.h>

#define ST_WARPS 4      // warps (tiles) per pass-1 block, planar
#define SPT 4           // slots per thread, planar: one 16-byte load a row
                        // (8 was 10-17 % slower on an H100)
#define ST_SLOTS (32 * SPT)  // slots per tile, planar
#define ST_MIN_WARPS 4096  // fewer tiles than this: the rows are split
                          // into groups, a warp each (FFM's 97 rows over
                          // 768 tiles, a warp walking all of them, took
                          // 0.065 ms on an H100, the first design 0.059)
#define SR_SLOTS 128    // slots per tile, row-major
#define SR_THREADS 256  // at most, per pass-1 block, row-major

// Where a run's sum goes.
#define ST_NONE 0u      // the run goes on in the next thread
#define ST_OUT 1u       // a run inside the tile
#define ST_HEAD 2u      // began in an earlier tile
#define ST_TAIL 3u      // began here, goes on in the next tile

__global__ void __launch_bounds__(32 * ST_WARPS)
segsum_tiles_kernel(const float* __restrict__ pay,
                    const int* __restrict__ lanes, float* __restrict__ out,
                    float* __restrict__ head, float* __restrict__ tail,
                    int pp, int blp, int ub, int nt, int aligned, int rg) {
  constexpr int W = ST_SLOTS;
  const int t = threadIdx.x & 31;
  const int c = blockIdx.x * ST_WARPS + (threadIdx.x >> 5);
  if (c >= nt) return;                              // uniform per warp
  const int start = c * W;
  const int end = min(start + W, blp);
  const int j0 = start + t * SPT;
  // 16-byte loads need the arrays aligned and the thread's slots inside
  const bool vec = aligned && j0 + SPT <= end;
  int l[SPT];                                       // -2: past the stream
  if (vec) {
#pragma unroll
    for (int q = 0; q < SPT; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(lanes + j0 + q);
      l[q] = v.x; l[q + 1] = v.y; l[q + 2] = v.z; l[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i) l[i] = j0 + i < end ? lanes[j0 + i] : -2;
  }
  const int prev_tile = start > 0 ? lanes[start - 1] : -1;
  const int next_tile = end < blp ? lanes[end] : -1;
  int pl = __shfl_up_sync(0xffffffffu, l[SPT - 1], 1);
  int nl = __shfl_down_sync(0xffffffffu, l[0], 1);
  if (t == 0) pl = prev_tile;
  if (t == 31) nl = next_tile;
  // ---- the tile's segment structure, once for all payload rows --------
  // brk bit i: a run ends at slot i and another begins at i + 1, inside
  // this thread's slots
  unsigned brk = 0;
#pragma unroll
  for (int i = 0; i + 1 < SPT; ++i) brk |= (l[i] != l[i + 1] ? 1u : 0u) << i;
  // cut: no carry enters from the thread before (the tile's first thread
  // takes none: pass 2 joins the tiles)
  const bool cut = t == 0 || l[0] != pl;
  // a carry passes THROUGH a thread whose slots are all one run
  const unsigned stops = __ballot_sync(0xffffffffu, cut || brk != 0);
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
  // the slot at which this thread's first run ends, and what becomes of
  // the run that ends at each slot: two bits a slot
  const int first_end = brk ? __ffs(brk) - 1 : SPT - 1;
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
  // ---- the payload rows ----------------------------------------------
  const long long piece = (long long)c * pp;
  // a thread's SPT floats of payload row r (0 past the stream)
  auto load_row = [&](int r, float* v) {
    const float* row = pay + (long long)r * blp;
    if (vec) {
#pragma unroll
      for (int q = 0; q < SPT; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + j0 + q);
        v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < SPT; ++i) v[i] = j0 + i < end ? row[j0 + i] : 0.0f;
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
    // s[i]: the sum of slot i's run from its first slot in this thread
    float s[SPT];
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      run += v[i];
      s[i] = run;
      if ((brk >> i) & 1u) run = 0.0f;
    }
    // inclusive segmented scan of the threads' last runs
    float x = s[SPT - 1];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float y = __shfl_up_sync(0xffffffffu, x, 1 << k);
      if ((steps >> k) & 1u) x += y;
    }
    const float carry = __shfl_up_sync(0xffffffffu, x, 1);
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const unsigned code = (dest >> (2 * i)) & 3u;
      if (code == ST_NONE) continue;
      const float sum = (i == first_end && !cut) ? carry + s[i] : s[i];
      if (code == ST_OUT) out[(long long)r * ub + l[i]] = sum;
      else if (code == ST_HEAD) head[piece + r] = sum;
      else tail[piece + r] = sum;
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
#define SC_THREADS 256
#define SC_SERIAL 32

// s + head[first, r] + head[first + step, r] + ... up to tile `last`, added
// in that order, eight loads in flight (left to the compiler the loop ran
// one load per trip to the L2: 0.2 us a tile on an H100).
__device__ __forceinline__ float heads_sum(const float* __restrict__ head,
                                           int first, int last, int step,
                                           int pp, int r, float s) {
  int k = first;
  for (; (long long)k + 7LL * step <= last; k += 8 * step) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = head[(long long)(k + u * step) * pp + r];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; k <= last; k += step) s += head[(long long)k * pp + r];
  return s;
}

template <bool WIDE>
__global__ void __launch_bounds__(SC_THREADS)
segsum_cross(const int* __restrict__ lanes, float* __restrict__ out,
             const float* __restrict__ head, const float* __restrict__ tail,
             int pp, int blp, int ub, int nt, int W) {
  __shared__ float part[SC_THREADS];
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
  if (mine && !is_long) {
    for (int rb = 0; rb < rows; rb += SC_THREADS) {
      const int r = rb + r0;
      if (!WIDE || r < pp)
        out[(long long)r * ub + lane] = heads_sum(
            head, c + 1, c1, 1, pp, r, tail[(long long)c * pp + r]);
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
        if (g < G && (!WIDE || r < pp))
          part[threadIdx.x] =
              heads_sum(head, c0 + 1 + g, last, G, pp, r, 0.0f);
        __syncthreads();
        if (g == 0 && (!WIDE || r < pp)) {
          float s = tail[(long long)c0 * pp + r];
          for (int q = 0; q < G; ++q) s += part[q * ppb + r0];
          out[(long long)r * ub + ln] = s;
        }
        if (WIDE) __syncthreads();                  // part is reused
      }
    }
    __syncthreads();                                // pub and part are reused
  }
}

static int cross_pass(const int* lanes, float* out, const float* head,
                      const float* tail, int pp, int blp, int ub, int nt,
                      int W, cudaStream_t s) {
  if (pp > SC_THREADS) {
    segsum_cross<true><<<(unsigned int)nt, SC_THREADS, 0, s>>>(
        lanes, out, head, tail, pp, blp, ub, nt, W);
  } else {
    const int G = SC_THREADS / pp;
    segsum_cross<false><<<(unsigned int)((nt + G - 1) / G), SC_THREADS, 0,
                          s>>>(lanes, out, head, tail, pp, blp, ub, nt, W);
  }
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
