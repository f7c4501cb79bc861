// What the kernels over the ROW-MAJOR table share (csrc/rowmajor_pairs.cu,
// csrc/rowmajor_sweep.cu): the block shape, the pitch of the pull's
// transposing tile, and the launch helpers. The table is
//   tbl [N, 4+2K], columns w | z | n | cnt | V[K] | nV[K];
// csrc/table_update.cuh holds its load and store stages.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define RM_WARPS 4                 // warps per block
#define RM_THREADS (32 * RM_WARPS)
#define RM_TILE_LD 33              // tile row pitch: 32 lanes + 1 pad

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

// A kernel that asks for more than 48 KB of dynamic shared memory (a wide
// K) must be allowed it first.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
