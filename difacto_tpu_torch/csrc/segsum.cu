// Segment sum over the host-sorted slot stream: out[r, u] = sum of
// payT[r, s] over the slots s with lanes[s] == u; lanes no slot touches
// come out exactly 0.
//
// Replaces difacto_tpu/ops/segsum.py::segsum_sorted (Pallas kernel
// _segsum_kernel), which turned each (slot tile, lane window) incidence
// into a one-hot matmul on the MXU and carried window sums across
// sequential grid steps.
//
// Bound: bytes — every payload float is read once and added once. The
// hazard is skew: the ids are power-law, so the hottest key's segment can
// cover a sixth of the stream, and a design with one thread (or one warp)
// per output lane would serialise it. So the work is split by SLOTS, in
// two passes, deterministically and without atomics:
//   pass 1: one warp per (row, chunk of CHUNK slots) walks its chunk 32
//     slots at a time with a segmented inclusive scan in registers
//     (shuffles in a fixed order, plus a carry between sub-tiles). A
//     segment that begins and ends inside the chunk is written to out
//     directly; the chunk's first piece, if its segment began in an
//     earlier chunk, goes to head[r, chunk], and its last piece, if its
//     segment continues into the next chunk, to tail[r, chunk] (one piece
//     spanning the whole chunk goes to both). The row-0 warps also record
//     each segment's first and one-past-last slot (seg_lo, seg_hi);
//   pass 2: one thread per (row, lane) reads its segment's bounds: an
//     empty segment writes 0, a segment that spans chunks c0 < c1 writes
//     tail[c0] + head[c0+1] + ... + head[c1], in chunk order; a segment
//     inside one chunk was written by pass 1. The hottest key spans a
//     few hundred chunks at the flagship shapes, a short loop in each of
//     its rows' threads. (A first version searched the bounds per lane
//     and looped over every row in one thread: the hot key's rows x
//     chunks serial loads made it 9x its bound.)
// Pad slots carry payload 0 and repeat the last lane, so they add nothing.
#include <cuda_runtime.h>

#define CHUNK 512

__global__ void segsum_chunks(const float* __restrict__ pay,
                              const int* __restrict__ lanes,
                              float* __restrict__ out, float* __restrict__ head,
                              float* __restrict__ tail, int* __restrict__ seg_lo,
                              int* __restrict__ seg_hi, int pp, int blp,
                              int ub, int nch) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int t = threadIdx.x & 31;
  if (warp >= (long long)pp * nch) return;        // uniform per warp
  int r = (int)(warp / nch);
  int c = (int)(warp - (long long)r * nch);
  const float* row = pay + (long long)r * blp;
  int start = c * CHUNK;
  int end = min(start + CHUNK, blp);
  int prev_lane = start > 0 ? lanes[start - 1] : -1;
  int next_lane = end < blp ? lanes[end] : -1;
  float carry = 0.0f;
  int carry_lane = -1;
  for (int base = start; base < end; base += 32) {
    int j = base + t;
    bool in = j < end;
    int l = in ? lanes[j] : -2;                   // -2 matches no real lane
    float v = in ? row[j] : 0.0f;
    int pl = __shfl_up_sync(0xffffffffu, l, 1);   // lane of slot j - 1
    if (t == 0) pl = base == start ? prev_lane : carry_lane;
    // segmented inclusive scan: lanes are monotone, so equal lanes at a
    // distance mean one contiguous segment between them
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float vo = __shfl_up_sync(0xffffffffu, v, off);
      int lo = __shfl_up_sync(0xffffffffu, l, off);
      if (t >= off && lo == l) v += vo;
    }
    if (in && l == carry_lane) v += carry;
    int nl = (j + 1 < end) ? lanes[j + 1] : next_lane;
    bool piece_end = in && (j == end - 1 || nl != l);
    if (in && l >= 0 && l < ub) {
      if (r == 0 && pl != l) seg_lo[l] = j;
      if (r == 0 && nl != l) seg_hi[l] = j + 1;
      if (piece_end) {
        bool from_prev = l == prev_lane;
        bool to_next = j == end - 1 && nl == l;
        if (!from_prev && !to_next) out[(long long)r * ub + l] = v;
        if (from_prev) head[(long long)r * nch + c] = v;
        if (to_next) tail[(long long)r * nch + c] = v;
      }
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
    carry_lane = __shfl_sync(0xffffffffu, l, 31);
  }
}

__global__ void segsum_combine(const int* __restrict__ seg_lo,
                               const int* __restrict__ seg_hi,
                               float* __restrict__ out,
                               const float* __restrict__ head,
                               const float* __restrict__ tail, int pp,
                               int ub, int nch) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)pp * ub) return;
  int r = (int)(i / ub);
  int u = (int)(i - (long long)r * ub);
  int lo = seg_lo[u];
  if (lo < 0) {                                   // no slot: exact zero
    out[i] = 0.0f;
    return;
  }
  int c0 = lo / CHUNK, c1 = (seg_hi[u] - 1) / CHUNK;
  if (c0 == c1) return;                           // written by pass 1
  const float* h = head + (long long)r * nch;
  float s = tail[(long long)r * nch + c0];
  for (int c = c0 + 1; c <= c1; ++c) s += h[c];
  out[i] = s;
}

extern "C" int dft_segsum_sorted(const void* pay, const void* lanes, void* out,
                                 void* head, void* tail, void* seg_lo,
                                 void* seg_hi, int pp, int blp, int ub,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nch = (blp + CHUNK - 1) / CHUNK;
  const int threads = 256;
  if (ub <= 0 || pp <= 0) return (int)cudaGetLastError();
  // -1 marks the lanes no slot touches (pass 1 overwrites touched ones)
  cudaMemsetAsync(seg_lo, 0xff, sizeof(int) * (size_t)ub, s);
  if (nch > 0) {
    long long nthreads = (long long)pp * nch * 32;
    segsum_chunks<<<(unsigned int)((nthreads + threads - 1) / threads),
                    threads, 0, s>>>((const float*)pay, (const int*)lanes,
                                     (float*)out, (float*)head, (float*)tail,
                                     (int*)seg_lo, (int*)seg_hi, pp, blp, ub,
                                     nch);
  }
  long long total = (long long)pp * ub;
  segsum_combine<<<(unsigned int)((total + threads - 1) / threads), threads,
                   0, s>>>((const int*)seg_lo, (const int*)seg_hi,
                           (float*)out, (const float*)head,
                           (const float*)tail, pp, ub, nch);
  return (int)cudaGetLastError();
}
