// What the kernels over the ROW-MAJOR table share (csrc/rowmajor_pairs.cu,
// csrc/rowmajor_sweep.cu): the block shape, the pitch of the pull's
// transposing tile, the factor chunk, and the launch helpers. The table is
//   tbl [N, 4+2K], columns w | z | n | cnt | V[K] | nV[K];
// csrc/table_update.cuh holds its load and store stages.
#pragma once
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "table_update.cuh"

#define RM_WARPS 4                 // warps per block
#define RM_THREADS (32 * RM_WARPS)
#define RM_TILE_LD 33              // tile row pitch: 32 lanes + 1 pad
// The widest chunk of the factor axis one warp's tile holds. A kernel
// past it walks V in chunks of RM_KC factors, so that its shared memory
// stays within the card's limit at any K (a whole [1+K][33] pull tile
// passes the 227 KB a block may have at K = 440, a whole [K][32] apply
// tile at K = 455) and a block's tile leaves room for three blocks an SM
// (4 warps x 129 x 33 x 4 B = 68,112 B for the pull, 65,536 B for the
// apply). K <= RM_KC is one chunk: the launches of the flagship's K = 16
// and FFM's K = 96 are those of one whole tile. The pulls deal the chunks
// to the grid's second axis (a table read has no order); the applies
// walk them in turn within the warp, since a row's head is updated once,
// before its factors, and the V gate reads the count from before it.
#define RM_KC 128

// The widest piece the row layout and the table's address allow, capped
// by `vec` when it is 1, 2 or 4 (0 = no cap).
static inline int pick_vec(const void* tbl, int K, int vec) {
  const uintptr_t a = (uintptr_t)tbl;
  int best = 1;
  if (K % 4 == 0 && a % 16 == 0) best = 4;
  else if (K % 2 == 0 && a % 8 == 0) best = 2;
  if (vec > 0 && vec < best) best = vec;
  return best;
}

// The factors a chunk holds at width K.
__host__ __device__ static inline int rm_chunk(int K) {
  return K < RM_KC ? K : RM_KC;
}

// A kernel that asks for more than 48 KB of dynamic shared memory (a wide
// K) must be allowed it first.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// An apply's gV payload rows 1+k0 .. k0+kc for this thread's lane, into
// the warp's tile [kc][32] by cp.async, one 128-byte payload row a copy
// across the warp, committed as one group.
__device__ __forceinline__ void stage_gv(float* tile,
                                         const float* __restrict__ pay,
                                         int U, int lane, int k0, int kc) {
  if (lane < U)
    for (int r = 0; r < kc; ++r)
      __pipeline_memcpy_async(tile + r * 32 + (lane & 31),
                              pay + (long long)(1 + k0 + r) * U + lane, 4);
  __pipeline_commit();
}

// Phase B of the row-major pulls (csrc/rowmajor_pairs.cu,
// csrc/rowmajor_sweep.cu) for the factors k0 .. k0+kc-1: the warp's 32
// lanes x kc/VEC pieces of VEC consecutive V entries, dealt to the
// threads piece-fastest (a piece's row and gate by shuffle from its
// lane's thread), into tile rows 1..kc (row 0 holds w), then out to rows
// 1+k0 .. k0+kc of the planar output [1+K, n] (row 0 with the first
// chunk), one 128-byte store a row. t is the thread's place in the warp.
template <int VEC>
__device__ __forceinline__ void pull_chunk(const float* __restrict__ tbl,
                                           int D, int id, bool act,
                                           float* tile,
                                           float* __restrict__ out, int n,
                                           int lane, int t, int k0, int kc) {
  const int PV = kc / VEC;
  for (int it = 0; it < PV; ++it) {
    const int q = it * 32 + t;
    const int ll = q / PV;
    const int piece = q - ll * PV;
    const int rid = __shfl_sync(0xffffffffu, id, ll);
    const int ract = __shfl_sync(0xffffffffu, (int)act, ll);
    float v[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) v[c] = 0.0f;
    if (ract) ld_vec<VEC>(tbl + (long long)rid * D + 4 + k0 + piece * VEC, v);
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      tile[(1 + piece * VEC + c) * RM_TILE_LD + ll] = v[c];
  }
  __syncwarp();
  if (lane < n)
    for (int r = k0 == 0 ? 0 : 1; r <= kc; ++r)
      out[(long long)(k0 + r) * n + lane] = tile[r * RM_TILE_LD + t];
}

// A pull's launch: blocks of RM_WARPS warps over the lanes, and past
// RM_KC factors one grid row (blockIdx.y) per chunk; the dynamic shared
// memory of its [1+Kc][33] tiles.
static inline dim3 pull_grid(int n, int K) {
  return dim3((unsigned int)((n + RM_THREADS - 1) / RM_THREADS),
              K > RM_KC ? (unsigned int)((K + RM_KC - 1) / RM_KC) : 1u);
}
static inline size_t pull_smem(int K) {
  return K > 0 ? sizeof(float) * RM_WARPS * (size_t)(1 + rm_chunk(K)) *
                     RM_TILE_LD
               : 0;
}
