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
// block owns `block_rows` consecutive table rows: it binary-searches the
// block's slice of the stream (the searchsorted boundaries the TPU script
// computed on the host), each thread binary-searches its row inside the
// slice and sums the row's run in slot order — no atomics, no matmul, so
// the script's `highest` and `default` precisions are one function here.
// The stage variants isolate THIS kernel's stages and return w unchanged:
//   SCANONLY: the slice and row searches, no payload read;
//   LOADONLY: the block streams its slice of sid and pay[0] (coalesced),
//             no row search and no sum per row.
// Their results feed a branch that cannot be taken on finite payloads, so
// the compiler keeps the work.
//
// Bound: bytes — w read and written whole (4 leaves for bisect_ftrl4),
// plus the stream.
#include <cuda_runtime.h>

#include "table_update.cuh"

#define BISECT_THREADS 256
enum { FULL = 0, SCANONLY = 1, LOADONLY = 2 };

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

template <int VARIANT>
__global__ void __launch_bounds__(BISECT_THREADS)
bisect_w_kernel(const int* __restrict__ sid, const float* __restrict__ pay,
                const float* __restrict__ w, float* __restrict__ w_o,
                long long N, int nnz, int block_rows) {
  const long long base = (long long)blockIdx.x * block_rows;
  const long long top = min(base + block_rows, N);
  int s0, s1;
  block_slice(sid, nnz, base, top, &s0, &s1);
  float streamed = 0.0f;
  if (VARIANT == LOADONLY) {
    for (int j = s0 + threadIdx.x; j < s1; j += BISECT_THREADS)
      streamed += pay[j] + (float)sid[j];
  }
  for (long long r = base + threadIdx.x; r < top; r += BISECT_THREADS) {
    float out = w[r];
    if (VARIANT == LOADONLY) {
      if (streamed != streamed) out = streamed;     // never: finite payload
    } else {
      int lo = lower_bound(sid, s0, s1, r);
      if (VARIANT == SCANONLY) {
        if (lo > s1) out = (float)lo;               // never: lo <= s1
      } else {
        out += run_of(sid, pay, 0, nnz, lo, s1, r);
      }
    }
    w_o[r] = out;
  }
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
#define BISECT_LAUNCH(V)                                                   \
  bisect_w_kernel<V><<<blocks, BISECT_THREADS, 0, st>>>(                   \
      (const int*)sid, (const float*)pay, (const float*)w, (float*)w_o, N, \
      nnz, block_rows)
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
