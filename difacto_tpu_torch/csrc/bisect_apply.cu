// The stripped whole-table sweep apply, for splitting its cost by stage.
//
// Replaces the two Pallas kernels of scripts/bisect_apply.py (`kernel`
// and `kernel4`), microbenchmarks of the sweep apply with the optimizer
// stripped to one leaf (bisect_w) or to FTRL on (w, z, n) plus a count
// (bisect_ftrl4). `sid` is one sorted stream of slot ids (ids outside
// [0, N) pad it and are ignored), `pay` a planar payload [PP, nnz].
//
//   bisect_w:     w_o[r] = w[r] + sum of pay[0, j] over the slots j with
//                 sid[j] == r, for EVERY table row r (out of place);
//   bisect_ftrl4: g, t, a = the per-row sums of pay rows 0, 1, 2; where
//                 t != 0, FTRL on (w, z, n) with gradient g and the fixed
//                 constants of the script (lr_eta 0.01, lr_beta 1, l1 1,
//                 l2 0.1), else the row is copied; c_o = c + a. Every row
//                 of the four outputs is written; they may be the inputs
//                 themselves (in place).
//
// The TPU kernels walked 1024-slot windows of the stream per table block
// and selected rows with a one-hot matmul; their stage variants (nodma,
// dmaonly, selonly, precision) isolate Mosaic's stages. Here one CUDA
// block owns `block_rows` consecutive table rows and finds its slice of
// the stream by two searches (the searchsorted boundaries the TPU script
// computed on the host). No atomics, no matmul, so the script's `highest`
// and `default` precisions are one function here.
//
// bisect_w is SPARSE: the stream names a tenth of the rows, and a search
// per table row (the first design, kept as ROWSCAN) made the kernel lose
// to index_add, which never visits a row no id names. The block
//   (a) copies its rows w -> w_o, 16 bytes a thread where the block's
//       range is aligned, its first load in flight while
//   (b) warps 0 and 1 find the slice bounds, each by a 64-way search (two
//       probes a lane: 3 round trips for 2^17 slots where a binary
//       search takes 17), then, past one barrier,
//   (c) walks its slice one thread per slot: the slot that starts a run
//       of equal ids sums the run in slot order and writes w[id] + sum.
// The block owns its rows, so (a) and (c) need no order across blocks.
// Work falls from N searches to one visit per slot. Tried and dropped: a
// 512-way search by half a block each (two round trips instead of three)
// took 0.0066 ms against 0.0051 on an H100: four times the probes, each a
// 32-byte sector of its own, cost more than the round trip they saved.
// The stage variants isolate THIS kernel's stages and return w unchanged:
//   SCANONLY: the slice searches and the copy, no stream read;
//   LOADONLY: the copy and the block's read of its slice of sid and
//             pay[0] (coalesced), no run sums and no add;
//   ROWSCAN:  the first design, whole: every row binary-searches the
//             slice. It computes bisect_w, out of place.
// The stage variants' results feed a branch that cannot be taken on
// finite payloads, so the compiler keeps the work. bisect_ftrl4 keeps the
// row scan: every row of its four outputs is read, stepped and written.
//
// Bound: bytes — w read and written whole (4 leaves for bisect_ftrl4),
// plus the stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "table_update.cuh"

#define BISECT_THREADS 256
enum { FULL = 0, SCANONLY = 1, LOADONLY = 2, ROWSCAN = 3 };

// First slot in [a, b) whose id is >= r; sid[a:b) is sorted.
__device__ __forceinline__ int lower_bound(const int* __restrict__ sid, int a,
                                           int b, long long r) {
  while (a < b) {
    int m = a + ((b - a) >> 1);
    if (sid[m] < r) a = m + 1; else b = m;
  }
  return a;
}

// The block's slice [s0, s1) of the stream: the slots of its table rows.
__device__ __forceinline__ void block_slice(const int* __restrict__ sid,
                                            int nnz, long long base,
                                            long long top, int* s0, int* s1) {
  __shared__ int bounds[2];
  if (threadIdx.x < 2)
    bounds[threadIdx.x] = lower_bound(sid, 0, nnz, threadIdx.x ? top : base);
  __syncthreads();
  *s0 = bounds[0];
  *s1 = bounds[1];
}

// The sum of payload row `row` over the run of slots [lo, hi) with id r
// that starts at lo, in slot order.
__device__ __forceinline__ float run_of(const int* __restrict__ sid,
                                        const float* __restrict__ pay, int row,
                                        int nnz, int lo, int s1, long long r) {
  const float* p = pay + (long long)row * nnz;
  float acc = 0.0f;
  for (int j = lo; j < s1 && sid[j] == r; ++j) acc += p[j];
  return acc;
}

// lower_bound by a whole warp: each round probes 64 evenly spaced slots,
// two a lane, and keeps the one gap the answer lies in: 2^17 slots take
// three round trips to memory (gaps of 1584, of 25, then the last probe)
// where a binary search takes 17. All 32 lanes must call it.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ sid,
                                                int a, int b, long long r) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  while (b - a > 64) {
    const int step = (b - a + 63) >> 6;
    const int v0 = sid[min(a + (lane + 1) * step - 1, b - 1)];
    const int v1 = sid[min(a + (lane + 33) * step - 1, b - 1)];
    const int c = __popc(__ballot_sync(full, v0 < r)) +
                  __popc(__ballot_sync(full, v1 < r));
    if (c == 64) return b;         // every probe, the last slot too, is < r
    b = min(a + (c + 1) * step - 1, b - 1);   // probe c: the first >= r
    a = a + c * step;                         // one past probe c - 1
  }
  const int i0 = a + lane, i1 = a + lane + 32;
  const int v0 = i0 < b ? sid[i0] : 0;
  const int v1 = i1 < b ? sid[i1] : 0;
  return a + __popc(__ballot_sync(full, i0 < b && v0 < r)) +
         __popc(__ballot_sync(full, i1 < b && v1 < r));
}

// The sparse design (see the header). `vec` says that w, w_o and every
// block's first row are 16-byte aligned.
template <int VARIANT>
__global__ void __launch_bounds__(BISECT_THREADS)
bisect_w_kernel(const int* __restrict__ sid, const float* __restrict__ pay,
                const float* __restrict__ w, float* __restrict__ w_o,
                long long N, int nnz, int block_rows, int vec) {
  const long long base = (long long)blockIdx.x * block_rows;
  const long long top = min(base + block_rows, N);
  const int rows = (int)(top - base);
  const int tid = threadIdx.x;
  // (a) the copy; each thread's first load is issued before the searches
  const int nvec = vec ? rows >> 2 : 0;
  const float4* w4 = reinterpret_cast<const float4*>(w + base);
  float4* o4 = reinterpret_cast<float4*>(w_o + base);
  float4 first = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < nvec) first = w4[tid];
  // (b) the slice [s0, s1) of the stream: warp 0 finds s0, warp 1 s1
  __shared__ int bounds[2];
  if (tid < 64) {
    const int s = warp_lower_bound(sid, 0, nnz, tid < 32 ? base : top);
    if ((tid & 31) == 0) bounds[tid >> 5] = s;
  }
  if (tid < nvec) o4[tid] = first;
  for (int i = tid + BISECT_THREADS; i < nvec; i += BISECT_THREADS)
    o4[i] = w4[i];
  for (int i = 4 * nvec + tid; i < rows; i += BISECT_THREADS)
    w_o[base + i] = w[base + i];
  __syncthreads();
  const int s0 = bounds[0], s1 = bounds[1];
  if (VARIANT == SCANONLY) {
    if (s0 > s1 && tid == 0) w_o[base] = (float)s0;  // never: s0 <= s1
    return;
  }
  // (c) the slice, one thread per slot; what a run's start needs is
  // loaded before it is known whether the slot starts a run
  float streamed = 0.0f;
  for (int j = s0 + tid; j < s1; j += BISECT_THREADS) {
    const int id = sid[j];
    if (VARIANT == LOADONLY) {
      streamed += pay[j] + (float)id;
      continue;
    }
    if (id < base || id >= top) continue;  // only an unsorted stream
    const int prev = j > s0 ? sid[j - 1] : -1;
    const int next = j + 1 < s1 ? sid[j + 1] : -1;
    const float wv = w[id];
    float acc = 0.0f;
    acc += pay[j];
    if (prev == id) continue;                       // not the run's start
    if (next == id)
      for (int e = j + 1; e < s1 && sid[e] == id; ++e) acc += pay[e];
    w_o[id] = wv + acc;
  }
  if (VARIANT == LOADONLY && streamed != streamed)  // never: finite payload
    w_o[base + (tid < rows ? tid : 0)] = streamed;
}

// The first design of bisect_w: every table row searches the block's
// slice for its run.
__global__ void __launch_bounds__(BISECT_THREADS)
bisect_rowscan_kernel(const int* __restrict__ sid,
                      const float* __restrict__ pay,
                      const float* __restrict__ w, float* __restrict__ w_o,
                      long long N, int nnz, int block_rows) {
  const long long base = (long long)blockIdx.x * block_rows;
  const long long top = min(base + block_rows, N);
  int s0, s1;
  block_slice(sid, nnz, base, top, &s0, &s1);
  for (long long r = base + threadIdx.x; r < top; r += BISECT_THREADS)
    w_o[r] = w[r] + run_of(sid, pay, 0, nnz, lower_bound(sid, s0, s1, r), s1, r);
}

// The outputs may alias the inputs (in place), so no __restrict__ here.
__global__ void __launch_bounds__(BISECT_THREADS)
bisect_ftrl4_kernel(const int* __restrict__ sid,
                    const float* __restrict__ pay, const float* w,
                    const float* z, const float* nn, const float* c,
                    float* w_o, float* z_o, float* n_o, float* c_o,
                    long long N, int nnz, int block_rows, ApplyParams p) {
  const long long base = (long long)blockIdx.x * block_rows;
  const long long top = min(base + block_rows, N);
  int s0, s1;
  block_slice(sid, nnz, base, top, &s0, &s1);
  for (long long r = base + threadIdx.x; r < top; r += BISECT_THREADS) {
    int lo = lower_bound(sid, s0, s1, r);
    float g = run_of(sid, pay, 0, nnz, lo, s1, r);
    float touch = run_of(sid, pay, 1, nnz, lo, s1, r);
    float add = run_of(sid, pay, 2, nnz, lo, s1, r);
    WRow row{w[r], z[r], nn[r]};
    float cv = c[r];
    if (touch != 0.0f) row = step_w(row, g, p);
    w_o[r] = row.w;
    z_o[r] = row.z;
    n_o[r] = row.n;
    c_o[r] = cv + add;
  }
}

extern "C" int dft_bisect_w(const void* sid, const void* pay, const void* w,
                            void* w_o, long long N, int nnz, int block_rows,
                            int variant, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  unsigned int blocks = (unsigned int)((N + block_rows - 1) / block_rows);
  if (variant == ROWSCAN) {
    bisect_rowscan_kernel<<<blocks, BISECT_THREADS, 0, st>>>(
        (const int*)sid, (const float*)pay, (const float*)w, (float*)w_o, N,
        nnz, block_rows);
    return (int)cudaGetLastError();
  }
  const int vec = block_rows % 4 == 0 &&
                  ((uintptr_t)w | (uintptr_t)w_o) % 16 == 0;
#define BISECT_LAUNCH(V)                                                   \
  bisect_w_kernel<V><<<blocks, BISECT_THREADS, 0, st>>>(                   \
      (const int*)sid, (const float*)pay, (const float*)w, (float*)w_o, N, \
      nnz, block_rows, vec)
  if (variant == SCANONLY) BISECT_LAUNCH(SCANONLY);
  else if (variant == LOADONLY) BISECT_LAUNCH(LOADONLY);
  else BISECT_LAUNCH(FULL);
#undef BISECT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int dft_bisect_ftrl4(const void* sid, const void* pay,
                                const void* w, const void* z, const void* n,
                                const void* c, void* w_o, void* z_o,
                                void* n_o, void* c_o, long long N, int nnz,
                                int block_rows, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  // FTRL with the constants of scripts/bisect_apply.py::kernel4
  ApplyParams p{0.01f, 1.0f, 1.0f, 0.1f, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0, 0};
  unsigned int blocks = (unsigned int)((N + block_rows - 1) / block_rows);
  bisect_ftrl4_kernel<<<blocks, BISECT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)sid, (const float*)pay, (const float*)w, (const float*)z,
      (const float*)n, (const float*)c, (float*)w_o, (float*)z_o,
      (float*)n_o, (float*)c_o, N, nnz, block_rows, p);
  return (int)cudaGetLastError();
}
