// Per-slot accumulate over a ROW-MAJOR payload: out[sid[j], :] += pay[j, :]
// with out zeroed first; sid is sorted, pay is [nslots, 128] f32.
//
// Replaces the Pallas kernel of scripts/bench_slot_accum.py, which measured
// the cost per slot of a dynamic-sublane read-modify-write into a VMEM block
// accumulator, one slot after another on the TPU's single sequential grid.
// On Hopper nothing is sequential across blocks, and the sorted ids make the
// slots of one row a contiguous run, so this is the segment sum of
// csrc/segsum.cu in the other layout: there a slot's values lie `BLp`
// floats apart (planar), here they are 512 contiguous bytes.
//
// Bound: bytes — every payload float is read once and added once. Two
// passes, no atomics, so the result repeats bit for bit:
//   pass 1 (slot_accum_chunks): one block of 128 threads per CHUNK
//     consecutive slots, thread c owning column c, so each slot is one
//     coalesced 512-byte read. The chunk's ids sit in shared memory; a
//     thread carries a running sum while the id repeats. A run that begins
//     and ends inside the chunk is written to out directly; the chunk's
//     first piece, if its run began in an earlier chunk, goes to
//     head[chunk, c]; its last piece, if the run continues into the next
//     chunk, to tail[chunk, c] (one piece spanning the whole chunk goes
//     to head only);
//   pass 2 (slot_accum_combine): one thread per (row, column)
//     binary-searches the row's slots [lo, hi): an empty row writes 0; a
//     row inside one chunk was written by pass 1; a row that spans chunks
//     c0 < c1 writes tail[c0] + head[c0+1] + ... + head[c1], in chunk
//     order. A hot id spanning many chunks makes that a serial loop in its
//     128 threads.
// Ids outside [0, num_rows) are skipped.
#include <cuda_runtime.h>

#define SA_CHUNK 128   // slots per pass-1 block
#define SA_COLS 128    // payload width = threads per block

__global__ void __launch_bounds__(SA_COLS)
slot_accum_chunks(const int* __restrict__ sid, const float* __restrict__ pay,
                  float* __restrict__ out, float* __restrict__ head,
                  float* __restrict__ tail, int nslots, int num_rows) {
  __shared__ int ids[SA_CHUNK + 2];  // ids[1 + j] = sid[start + j]
  const int c = threadIdx.x;
  const int chunk = blockIdx.x;
  const int start = chunk * SA_CHUNK;
  const int len = min(SA_CHUNK, nslots - start);
  if (c < len) ids[1 + c] = sid[start + c];
  if (c == 0) {
    ids[0] = start > 0 ? sid[start - 1] : -1;
    ids[1 + len] = start + len < nslots ? sid[start + len] : -1;
  }
  __syncthreads();
  const int before = ids[0], after = ids[1 + len];
  const float* p = pay + (long long)start * SA_COLS + c;
  float acc = 0.0f;
  bool from_prev = len > 0 && ids[1] == before;     // the running piece
#pragma unroll 8
  for (int j = 0; j < len; ++j) {
    acc += p[(long long)j * SA_COLS];
    int id = ids[1 + j];
    bool last = j == len - 1;
    if (!last && ids[2 + j] == id) continue;
    // the piece of `id` ends at slot j
    bool to_next = last && after == id;
    if (from_prev) {
      // a piece that spans the whole chunk goes to head only: pass 2 adds
      // the heads of every chunk after the run's first
      head[(long long)chunk * SA_COLS + c] = acc;
    } else if (to_next) {
      tail[(long long)chunk * SA_COLS + c] = acc;
    } else if (id >= 0 && id < num_rows) {
      out[(long long)id * SA_COLS + c] = acc;
    }
    acc = 0.0f;
    from_prev = false;
  }
}

// First slot in [0, n) whose id is >= r.
__device__ __forceinline__ int sa_lower_bound(const int* __restrict__ sid,
                                              int n, int r) {
  int a = 0, b = n;
  while (a < b) {
    int m = a + ((b - a) >> 1);
    if (sid[m] < r) a = m + 1; else b = m;
  }
  return a;
}

__global__ void slot_accum_combine(const int* __restrict__ sid,
                                   float* __restrict__ out,
                                   const float* __restrict__ head,
                                   const float* __restrict__ tail, int nslots,
                                   int num_rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rows * SA_COLS) return;
  int r = i / SA_COLS, c = i - r * SA_COLS;
  int lo = sa_lower_bound(sid, nslots, r);
  int hi = sa_lower_bound(sid, nslots, r + 1);
  if (lo == hi) {                                   // no slot: exact zero
    out[i] = 0.0f;
    return;
  }
  int c0 = lo / SA_CHUNK, c1 = (hi - 1) / SA_CHUNK;
  if (c0 == c1) return;                             // written by pass 1
  float s = tail[(long long)c0 * SA_COLS + c];
  for (int k = c0 + 1; k <= c1; ++k) s += head[(long long)k * SA_COLS + c];
  out[i] = s;
}

extern "C" int dft_slot_accum(const void* sid, const void* pay, void* out,
                              void* head, void* tail, int nslots,
                              int num_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (num_rows <= 0) return (int)cudaGetLastError();
  int nch = (nslots + SA_CHUNK - 1) / SA_CHUNK;
  if (nch > 0)
    slot_accum_chunks<<<nch, SA_COLS, 0, st>>>(
        (const int*)sid, (const float*)pay, (float*)out, (float*)head,
        (float*)tail, nslots, num_rows);
  const int threads = 256;
  int total = num_rows * SA_COLS;
  slot_accum_combine<<<(total + threads - 1) / threads, threads, 0, st>>>(
      (const int*)sid, (float*)out, (const float*)head, (const float*)tail,
      nslots, num_rows);
  return (int)cudaGetLastError();
}
