// Pull over a PACKED planar state: two arrays
//   A [2+K, N] = w | cnt | V      (what the pull reads)
//   B [2+K, N] = z | n  | nV      (what only the apply also needs)
// instead of the six leaves of FMState.
//
// Replaces the pull of scripts/hw_packed_pairs.py (pull_packed_kernel),
// which asked on the TPU whether fewer, larger block copies per grid step
// beat six small ones. A Hopper kernel addresses single floats, so a
// thread reads the same scattered 4-byte entries from A as from the
// leaves: rows of A are N floats apart exactly as the rows of V are. The
// probe (probes/hw_packed_pairs.py) times it against csrc/pull_pairs.cu to
// put a number on that. The apply over A and B is csrc/planar_apply.cu's
// dft_apply_packed.
//
// pull_packed_kernel: out [1+K, U]; row 0 is A[0, uid] (w), rows 1..K are
// A[2.., uid] (V), zero unless A[1, uid] (cnt) >= V_threshold; sentinel
// lanes are 0 in every row. One thread per (output row, lane), lanes
// fastest, so the stores and the uid loads of a warp are coalesced.
//
// The floor (flag PP_READONLY, the probe word `readonly`): the same
// threads issue the same loads (the uid; w, or cnt and then V past the
// gate) and store nothing unless the value equals a NaN payload no table
// holds. A load must feed something: ptxas deletes a load whose result
// no instruction reads, `asm volatile` or not (the asm keeps it in the
// PTX only; without the compare the floor's SASS held no load at all), so
// the compare is what keeps the floor's loads. Its time against the
// pull's is what the output's stores cost, and with the distinct sectors
// it reads, the card's rate for these lone-sector reads.
//
// Bound: bytes, as csrc/pull_pairs.cu.
#include <cuda_runtime.h>

#define PP_READONLY 1        // flag of the C entry: the loads alone
#define PP_SINK 0x7fc0ad5eu  // a NaN payload: the floor's never-taken store

template <bool OPAQUE>
__device__ __forceinline__ float load_f(const float* a) {
  if (!OPAQUE) return *a;
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(a));
  return v;
}

template <bool OPAQUE>
__device__ __forceinline__ int load_i(const int* a) {
  if (!OPAQUE) return *a;
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(a));
  return v;
}

template <bool READONLY>
__global__ void pull_packed_kernel(const float* __restrict__ A,
                                   const int* __restrict__ uids,
                                   float* __restrict__ out, long long n,
                                   int k, int u, float thr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(1 + k) * u) return;
  int r = (int)(i / u);
  int lane = (int)(i - (long long)r * u);
  int id = load_i<READONLY>(uids + lane);
  float v = 0.0f;
  if (id >= 0 && id < n) {
    if (r == 0) {
      v = load_f<READONLY>(A + id);                             // w
    } else if (load_f<READONLY>(A + n + id) >= thr) {           // cnt gate
      v = load_f<READONLY>(A + (long long)(1 + r) * n + id);    // V[r - 1]
    }
  }
  if (!READONLY || __float_as_uint(v) == PP_SINK) out[i] = v;
}

extern "C" int dft_pull_packed(const void* A, const void* uids, void* out,
                               long long n, int k, int u, float thr,
                               int flags, void* stream) {
  long long total = (long long)(1 + k) * u;
  if (total > 0) {
    const int threads = 256;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    if (flags & PP_READONLY)
      pull_packed_kernel<true><<<blocks, threads, 0, st>>>(
          (const float*)A, (const int*)uids, (float*)out, n, k, u, thr);
    else
      pull_packed_kernel<false><<<blocks, threads, 0, st>>>(
          (const float*)A, (const int*)uids, (float*)out, n, k, u, thr);
  }
  return (int)cudaGetLastError();
}
