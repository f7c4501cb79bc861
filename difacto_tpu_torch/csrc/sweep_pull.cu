// Sweep pull: per-slot rows [1+K, NNZ] of S sorted id streams.
//
// Replaces difacto_tpu/ops/sweep_ms.py::sweep_pull_ms (Pallas kernel
// _pull_ms_kernel, behind ops/sweep.py::sweep_pull, kernel=pallas). For
// every slot j that lies in the slice of its id's table block in some
// stream (csrc/sweep.cuh), row 0 is w[sid[j]] and rows 1..K are
// V[:, sid[j]], zero unless cnt[sid[j]] >= V_threshold. Every other slot
// (the sentinel N) is 0 in every row; the TPU kernel left those undefined.
//
// Bound: bytes. The useful traffic is the ids, w and cnt of the slots'
// rows, V of the rows past the gate, and the [1+K, NNZ] output; there is
// no arithmetic to speak of. The TPU kernel streamed each whole table
// block through VMEM and gathered with one-hot matmuls over 1024-aligned
// windows of the id stream, blending the output read-modify-write
// (sweep_ms.py:12-31), because Mosaic cannot address single rows. Hopper
// can, and its blocks run in no order, so this kernel keeps the sweep's
// order but not its traffic:
//   * sweep_pull_rows: the scan of csrc/sweep.cuh finds the rows of its
//     1024-row chunk that some slot names; then one thread per (output
//     row p, named row) reads w, or cnt and one factor entry, and writes
//     it to every slot of the row's runs. Rows no slot names are never
//     read, so the table is not read whole. Duplicate ids make a run
//     longer; its thread writes it serially.
//   * sweep_pull_lanes: one thread per slot writes zeros where no slice
//     covers the slot, so every output element is written exactly once,
//     and traps on a stream that is not sorted.
// Deterministic; no atomics.
#include <cuda_runtime.h>

#include "sweep.cuh"

__global__ void __launch_bounds__(THREADS)
sweep_pull_rows(const float* __restrict__ w, const float* __restrict__ cnt,
                const float* __restrict__ V, const int* __restrict__ sid,
                const int* __restrict__ off, float* __restrict__ out,
                long long N, int K, int nnz, int S, int nb, int R,
                float thr) {
  __shared__ int rows[CHUNK], lo0[CHUNK], hi0[CHUNK];
  const int nb1 = nb + 1;
  const int c0 = blockIdx.x * CHUNK;
  const int c1 = (int)min((long long)c0 + CHUNK, N);
  if (chunk_empty(off, S, nb1, R, c0, c1)) return;
  const int n = scan_named_rows(sid, off, N, S, nb1, R, c0, rows, lo0, hi0);
  const int items = n * (1 + K);
  for (int it = threadIdx.x; it < items; it += THREADS) {
    int p = it / n, m = it - p * n;  // consecutive threads, consecutive rows
    int r = rows[m];
    float v;
    if (p == 0) v = w[r];
    else v = cnt[r] >= thr ? V[(long long)(p - 1) * N + r] : 0.0f;
    float* o = out + (long long)p * nnz;
    for (int s = 0; s < S; ++s) {
      int lo, hi;
      named_run(sid, off, s, nb1, R, r, m, lo0, hi0, &lo, &hi);
      for (int j = lo; j < hi; ++j) o[j] = v;
    }
  }
}

__global__ void sweep_pull_lanes(const int* __restrict__ sid,
                                 const int* __restrict__ off,
                                 float* __restrict__ out, long long N, int K,
                                 int nnz, int S, int nb, int R) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nnz) return;
  const int nb1 = nb + 1;
  check_sorted(sid, off, S, nb1, nnz, j);
  int id = sid[j];
  if (id >= 0 && id < N) {
    const int* o = off + id / R;
    for (int s = 0; s < S; ++s, o += nb1)
      if (o[0] <= j && j < o[1]) return;  // covered: the row pass writes it
  }
  for (int p = 0; p <= K; ++p) out[(long long)p * nnz + j] = 0.0f;
}

extern "C" int dft_sweep_pull(const void* w, const void* cnt, const void* V,
                              const void* sid, const void* off, void* out,
                              long long N, int K, int nnz, int S, int nb,
                              int R, float thr, void* stream) {
  if (nnz <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  sweep_pull_lanes<<<(nnz + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const int*)sid, (const int*)off, (float*)out, N, K, nnz, S, nb, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unsigned int blocks = (unsigned int)((N + CHUNK - 1) / CHUNK);
  sweep_pull_rows<<<blocks, THREADS, 0, st>>>(
      (const float*)w, (const float*)cnt, (const float*)V, (const int*)sid,
      (const int*)off, (float*)out, N, K, nnz, S, nb, R, thr);
  return (int)cudaGetLastError();
}
