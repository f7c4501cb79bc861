// Native batch localizer: radix dedup + inverse for one padded batch.
//
// The port's copy of the JAX package's csrc/localizer.cpp, the counterpart
// of the reference's src/data/localizer.h :: Localizer (C++ on worker
// CPUs). The NumPy engine (difacto_tpu_torch/data/prep.py ::
// _localize_numpy) sorts and then builds the inverse from an id->lane
// lookup table, which it caps at 2^24 rows (past it a searchsorted over
// the batch's uniques); this index-tracking LSD radix sort needs O(batch)
// memory at any table size, so prep takes it past the cap.
//
// Exported C ABI (ctypes via difacto_tpu_torch/data/_native.py):
//   int dft_localize(const int32* ids, int64 n, int32 num_rows,
//                    int32* inv, int32* uids, int64* counts,
//                    int64* n_unique);
// ids: raw per-slot ids, negatives = padding (mapped to the sentinel
// num_rows, which sorts last). Outputs mirror the NumPy engine: sorted
// unique keys (sentinel included when present), per-unique counts, and
// inv[slot] -> unique lane. uids/counts must have capacity n; inv is
// [n]. Returns 0 on success.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int needed_bits(uint32_t v) {
  int b = 0;
  while (v) { ++b; v >>= 1; }
  return b > 0 ? b : 1;
}

}  // namespace

extern "C" {

int dft_localize(const int32_t* ids, int64_t n, int32_t num_rows,
                 int32_t* inv, int32_t* uids, int64_t* counts,
                 int64_t* n_unique) {
  if (n <= 0 || num_rows <= 0) {
    *n_unique = 0;
    return 0;
  }
  const uint32_t sent = static_cast<uint32_t>(num_rows);
  std::vector<uint32_t> keys(n), keys2(n);
  std::vector<int32_t> idx(n), idx2(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = ids[i];
    keys[i] = (v < 0 || static_cast<uint32_t>(v) > sent)
                  ? sent
                  : static_cast<uint32_t>(v);
    idx[i] = static_cast<int32_t>(i);
  }
  // LSD radix over (key, slot) pairs, 11 bits per pass, only as many
  // passes as the key range needs (2^22 tables: 3; 2^10: 1)
  constexpr int kBits = 11;
  constexpr int kBuckets = 1 << kBits;
  const int total_bits = needed_bits(sent);
  const int passes = (total_bits + kBits - 1) / kBits;
  std::vector<size_t> hist(kBuckets + 1);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kBits;
    std::memset(hist.data(), 0, sizeof(size_t) * (kBuckets + 1));
    for (int64_t i = 0; i < n; ++i)
      ++hist[((keys[i] >> shift) & (kBuckets - 1)) + 1];
    for (int b = 0; b < kBuckets; ++b) hist[b + 1] += hist[b];
    for (int64_t i = 0; i < n; ++i) {
      const size_t d = hist[(keys[i] >> shift) & (kBuckets - 1)]++;
      keys2[d] = keys[i];
      idx2[d] = idx[i];
    }
    keys.swap(keys2);
    idx.swap(idx2);
  }
  // dedup + per-slot inverse in one scan of the sorted pairs
  int64_t u = -1;
  uint32_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || keys[i] != prev) {
      ++u;
      uids[u] = static_cast<int32_t>(keys[i]);
      counts[u] = 0;
      prev = keys[i];
    }
    ++counts[u];
    inv[idx[i]] = static_cast<int32_t>(u);
  }
  *n_unique = u + 1;
  return 0;
}

}  // extern "C"
