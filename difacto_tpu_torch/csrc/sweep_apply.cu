// Sweep apply: sum S sorted streams of per-slot payload into their table
// rows, then update each row once, in place.
//
// Replaces difacto_tpu/ops/sweep_ms.py::sweep_apply_ms (Pallas kernel
// _apply_ms_kernel, behind ops/sweep.py::sweep_apply, kernel=pallas).
// Payload rows are gw | gV[K] | add_cnt | touch, planar [3+K, NNZ]. Every
// slot that lies in the slice of its id's block in some stream
// (csrc/sweep.cuh) adds its payload to its row — equal ids within a
// stream and across streams all add. Then, per row, fused_table_update
// (csrc/table_update.cuh): where the summed touch is > 0, FTRL, AdaGrad
// or SGD on (w, z, n) masked by the tail filter, and AdaGrad or SGD on
// (V, nV) gated by the PRE-update cnt; cnt += add_cnt on every row a slot
// names. A row no slot names keeps its exact bits.
//
// Bound: bytes. Each named row reads and writes the leaves its updaters
// use and reads its slots' payload. The TPU kernel streamed every table
// block through VMEM, scatter-added 1024-slot windows of the payload with
// one-hot matmuls into a block accumulator and rewrote the whole block
// (sweep_ms.py:12-31). Hopper blocks run in no order and address single
// rows, so sweep_apply_rows keeps the sweep's order but touches only the
// named rows: the scan of csrc/sweep.cuh lists the named rows of its
// 1024-row chunk, then
//   * one thread per named row sums the run's gw, add_cnt and touch (in
//     stream order, then slot order — deterministic, no atomics), reads
//     the PRE-update cnt, updates (w, z, n), writes cnt, and records the
//     V gate in shared memory;
//   * after a barrier, one thread per (factor k, named row) past the gate
//     sums its gV in the same order and updates (V, nV)[k, row].
// A hot id repeated over many slots is summed serially by its threads.
// sweep_apply_check runs first and traps on a stream that is not sorted.
#include <cuda_runtime.h>

#include "sweep.cuh"
#include "table_update.cuh"

// The sum of payload row `row` over the named row's runs in every
// stream, in stream order, then slot order.
__device__ __forceinline__ float runs_sum(const float* __restrict__ pay,
                                          long long row, int nnz,
                                          const int* __restrict__ sid,
                                          const int* __restrict__ off, int S,
                                          int nb1, int R, int r, int m,
                                          const int* lo0, const int* hi0) {
  const float* p = pay + row * nnz;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    int lo, hi;
    named_run(sid, off, s, nb1, R, r, m, lo0, hi0, &lo, &hi);
    for (int j = lo; j < hi; ++j) acc += p[j];
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
sweep_apply_rows(float* __restrict__ w, float* __restrict__ z,
                 float* __restrict__ nn, float* __restrict__ cnt,
                 float* __restrict__ V, float* __restrict__ nV,
                 const int* __restrict__ sid, const float* __restrict__ pay,
                 const int* __restrict__ off, long long N, int K, int nnz,
                 int S, int nb, int R, ApplyParams p) {
  __shared__ int rows[CHUNK], lo0[CHUNK], hi0[CHUNK];
  __shared__ bool v_on[CHUNK];
  const int nb1 = nb + 1;
  const int c0 = blockIdx.x * CHUNK;
  const int c1 = (int)min((long long)c0 + CHUNK, N);
  if (chunk_empty(off, S, nb1, R, c0, c1)) return;
  const int n = scan_named_rows(sid, off, N, S, nb1, R, c0, rows, lo0, hi0);
  for (int m = threadIdx.x; m < n; m += THREADS) {
    int r = rows[m];
    float touch = runs_sum(pay, 2 + K, nnz, sid, off, S, nb1, R, r, m, lo0,
                           hi0);
    float add_cnt = runs_sum(pay, 1 + K, nnz, sid, off, S, nb1, R, r, m,
                             lo0, hi0);
    float c = cnt[r];                          // PRE-update count
    bool touched = touch > 0.0f;
    bool tail_ok = p.tail <= 0 || c >= (float)p.tail;
    if (touched && tail_ok)
      update_w(w, z, nn, r,
               runs_sum(pay, 0, nnz, sid, off, S, nb1, R, r, m, lo0, hi0),
               p);
    cnt[r] = c + add_cnt;
    v_on[m] = touched && tail_ok && c >= p.V_threshold;
  }
  __syncthreads();
  const int items = n * K;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    int k = it / n, m = it - k * n;  // consecutive threads, consecutive rows
    if (!v_on[m]) continue;
    int r = rows[m];
    update_v(V, nV, (long long)k * N + r,
             runs_sum(pay, 1 + k, nnz, sid, off, S, nb1, R, r, m, lo0, hi0),
             p);
  }
}

__global__ void sweep_apply_check(const int* __restrict__ sid,
                                  const int* __restrict__ off, int nnz,
                                  int S, int nb) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nnz) check_sorted(sid, off, S, nb + 1, nnz, j);
}

extern "C" int dft_sweep_apply(void* w, void* z, void* n, void* cnt, void* V,
                               void* nV, const void* sid, const void* pay,
                               const void* off, long long N, int K, int nnz,
                               int S, int nb, int R, float lr_eta,
                               float lr_beta, float l1, float l2,
                               float V_lr_eta, float V_lr_beta, float V_l2,
                               float V_threshold, int tail, int w_updater,
                               int V_updater, void* stream) {
  if (nnz <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  sweep_apply_check<<<(nnz + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const int*)sid, (const int*)off, nnz, S, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                V_threshold, tail, w_updater, V_updater};
  unsigned int blocks = (unsigned int)((N + CHUNK - 1) / CHUNK);
  sweep_apply_rows<<<blocks, THREADS, 0, st>>>(
      (float*)w, (float*)z, (float*)n, (float*)cnt, (float*)V, (float*)nV,
      (const int*)sid, (const float*)pay, (const int*)off, N, K, nnz, S, nb,
      R, p);
  return (int)cudaGetLastError();
}
