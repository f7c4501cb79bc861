// Pull and apply over a PACKED planar state: two arrays
//   A [2+K, N] = w | cnt | V      (what the pull reads)
//   B [2+K, N] = z | n  | nV      (what only the apply also needs)
// instead of the six leaves of FMState.
//
// Replaces the two Pallas kernels of scripts/hw_packed_pairs.py
// (pull_packed_kernel, apply_packed_kernel), which asked on the TPU
// whether fewer, larger block copies per grid step beat six small ones.
// A Hopper kernel addresses single floats, so a thread reads the same
// scattered 4-byte entries from A and B as from six arrays: rows of A and
// B are N floats apart exactly as the rows of V are. The probe
// (probes/hw_packed_pairs.py) times these kernels against
// csrc/pull_pairs.cu and csrc/apply_pairs.cu to put a number on that.
//
// pull_packed_kernel: out [1+K, U]; row 0 is A[0, uid] (w), rows 1..K are
// A[2.., uid] (V), zero unless A[1, uid] (cnt) >= V_threshold; sentinel
// lanes are 0 in every row. One thread per (output row, lane), lanes
// fastest, so the stores and the uid loads of a warp are coalesced.
//
// apply_packed_kernel: the function of csrc/apply_pairs.cu, in place on A
// and B, with the same thread arrangement so that the two times differ by
// the layout alone: the lane that starts a run of equal ids sums the run's
// payload in lane order (csrc/pair_runs.cuh) and updates the row once. The
// optimizer math is csrc/table_update.cuh's, handed row pointers into A
// and B. Rows not touched keep their exact bits.
//
// Bound: bytes, as csrc/pull_pairs.cu and csrc/apply_pairs.cu.
#include <cuda_runtime.h>

#include "pair_runs.cuh"
#include "table_update.cuh"

__global__ void pull_packed_kernel(const float* __restrict__ A,
                                   const int* __restrict__ uids,
                                   float* __restrict__ out, long long n,
                                   int k, int u, float thr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(1 + k) * u) return;
  int r = (int)(i / u);
  int lane = (int)(i - (long long)r * u);
  int id = uids[lane];
  float v = 0.0f;
  if (id >= 0 && id < n) {
    if (r == 0) {
      v = A[id];                                    // w
    } else if (A[n + id] >= thr) {                  // cnt gate
      v = A[(long long)(1 + r) * n + id];           // V[r - 1]
    }
  }
  out[i] = v;
}

__global__ void apply_packed_kernel(float* A, float* B,
                                    const int* __restrict__ uids,
                                    const float* __restrict__ pay,
                                    long long N, int K, int U, ApplyParams p) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= U) return;
  int end;
  int id = run_start(uids, lane, U, N, &end);
  if (id < 0) return;
  if (!(run_sum(pay, 2 + K, U, lane, end) > 0.0f)) return;  // keep bits
  float* w = A;
  float* cnt = A + N;
  float* V = A + 2 * N;
  float* z = B;
  float* nn = B + N;
  float* nV = B + 2 * N;
  float add_cnt = run_sum(pay, 1 + K, U, lane, end);
  float c = cnt[id];                                // PRE-update count
  bool tail_ok = p.tail <= 0 || c >= (float)p.tail;
  if (tail_ok) update_w(w, z, nn, id, run_sum(pay, 0, U, lane, end), p);
  cnt[id] = c + add_cnt;
  if (K > 0 && tail_ok && c >= p.V_threshold) {
    for (int r = 0; r < K; ++r)
      update_v(V, nV, (long long)r * N + id, run_sum(pay, 1 + r, U, lane, end),
               p);
  }
}

extern "C" int dft_pull_packed(const void* A, const void* uids, void* out,
                               long long n, int k, int u, float thr,
                               void* stream) {
  long long total = (long long)(1 + k) * u;
  if (total > 0) {
    const int threads = 256;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    pull_packed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)A, (const int*)uids, (float*)out, n, k, u, thr);
  }
  return (int)cudaGetLastError();
}

extern "C" int dft_apply_packed(void* A, void* B, const void* uids,
                                const void* pay, long long N, int K, int U,
                                float lr_eta, float lr_beta, float l1,
                                float l2, float V_lr_eta, float V_lr_beta,
                                float V_l2, float V_threshold, int tail,
                                int w_updater, int V_updater, void* stream) {
  if (U > 0) {
    ApplyParams p{lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2,
                  V_threshold, tail, w_updater, V_updater};
    const int threads = 128;
    unsigned int blocks = (unsigned int)((U + threads - 1) / threads);
    apply_packed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)A, (float*)B, (const int*)uids, (const float*)pay, N, K, U, p);
  }
  return (int)cudaGetLastError();
}
