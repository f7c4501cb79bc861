// Pull: planar rows [1+K, U] of the batch's sorted unique ids.
//
// Replaces difacto_tpu/ops/pair_sweep.py::pull_pairs (Pallas kernel
// _pull_pairs_kernel). Row 0 is w[uid]; rows 1..K are V[:, uid], zero
// unless cnt[uid] >= V_threshold; sentinel lanes (uid outside [0, N))
// are 0 in every row.
//
// Bound: bytes. Per valid lane it reads w, cnt and K values of V at a
// random table row, and writes 1+K floats; there is no arithmetic to
// speak of. The TPU kernel walked host-built (block, window) pairs and
// gathered with one-hot matmuls because Mosaic cannot address single
// rows; Hopper gathers directly, so this kernel takes no schedule: one
// thread per (output row, lane), lanes fastest so the output stores and
// the uid loads of a warp are coalesced. The gathers from the planar
// [K, N] V cost one 32-byte sector per useful 4 bytes (a row-major V
// would make them one contiguous row; ROADMAP open question).
#include <cuda_runtime.h>

__global__ void pull_pairs_kernel(const float* __restrict__ w,
                                  const float* __restrict__ cnt,
                                  const float* __restrict__ V,
                                  const int* __restrict__ uids,
                                  float* __restrict__ out,
                                  long long n, int k, int u, float thr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)(1 + k) * u;
  if (i >= total) return;
  int r = (int)(i / u);
  int lane = (int)(i - (long long)r * u);
  int id = uids[lane];
  float v = 0.0f;
  if (id >= 0 && id < n) {
    if (r == 0) {
      v = w[id];
    } else if (cnt[id] >= thr) {
      v = V[(long long)(r - 1) * n + id];
    }
  }
  out[i] = v;
}

extern "C" int dft_pull_pairs(const void* w, const void* cnt, const void* V,
                              const void* uids, void* out, long long n, int k,
                              int u, float thr, void* stream) {
  long long total = (long long)(1 + k) * u;
  if (total > 0) {
    const int threads = 256;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    pull_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)cnt, (const float*)V,
        (const int*)uids, (float*)out, n, k, u, thr);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
