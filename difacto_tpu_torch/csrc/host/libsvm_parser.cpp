// Multithreaded libsvm text parser.
//
// The port's copy of the JAX package's csrc/libsvm_parser.cpp (the port
// builds and loads its own: difacto_tpu_torch/data/_native.py), the native
// counterpart of the reference's dmlc-core libsvm parser
// (dmlc-core/src/data/libsvm_parser.h :: LibSVMParser): text is parsed in
// line-aligned chunks on worker threads, one thread per chunk, so that
// parsing keeps up with the card; the NumPy engine
// (difacto_tpu_torch/data/libsvm.py::parse_libsvm_numpy) gives the same
// arrays.
//
// Semantics: one example per line, "label idx:val idx:val ...".
//   * blank lines and lines starting with '#' are skipped;
//   * a bare "idx" token (no ":val") means value 1.0 (dmlc behavior);
//   * labels parsed as float (supports -1/0/1 and fractional);
//   * indices are uint64 (feature ids are hashed downstream).
//
// Exported C ABI:
//   int dft_parse_libsvm(const char* data, int64 len,
//                        int64* n_rows, int64* nnz,
//                        void** labels_f32, void** indptr_i64,
//                        void** indices_u64, void** values_f32,
//                        int nthreads);
//   void dft_free(void* p);
// Returns 0 on success; output buffers are malloc'd and owned by the
// caller (freed with dft_free).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

struct Shard {
  std::vector<float> labels;
  std::vector<int64_t> rownnz;
  std::vector<uint64_t> indices;
  std::vector<float> values;
  bool error = false;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// fast float parse: sign, digits, optional frac/exponent. Falls back to
// strtof for exotic forms (hex, inf, nan).
inline bool parse_f32(const char*& p, const char* end, float* out) {
  const char* q = p;
  bool neg = false;
  if (q < end && (*q == '-' || *q == '+')) { neg = (*q == '-'); ++q; }
  double v = 0.0;
  bool any = false;
  while (q < end && *q >= '0' && *q <= '9') { v = v * 10.0 + (*q - '0'); ++q; any = true; }
  if (q < end && *q == '.') {
    ++q;
    double scale = 0.1;
    while (q < end && *q >= '0' && *q <= '9') { v += (*q - '0') * scale; scale *= 0.1; ++q; any = true; }
  }
  if (q < end && (*q == 'e' || *q == 'E')) {
    ++q;
    bool eneg = false;
    if (q < end && (*q == '-' || *q == '+')) { eneg = (*q == '-'); ++q; }
    int ex = 0;
    bool eany = false;
    while (q < end && *q >= '0' && *q <= '9') { ex = ex * 10 + (*q - '0'); ++q; eany = true; }
    if (!eany) return false;
    double mul = 1.0;
    double base = eneg ? 0.1 : 10.0;
    for (int i = 0; i < ex; ++i) mul *= base;
    v *= mul;
  }
  if (!any) {
    // strtof fallback (inf/nan); bounded copy to keep strtof in range
    char buf[64];
    size_t n = static_cast<size_t>(end - p);
    if (n > 63) n = 63;
    memcpy(buf, p, n);
    buf[n] = 0;
    char* e2 = nullptr;
    float f = strtof(buf, &e2);
    if (e2 == buf) return false;
    p += (e2 - buf);
    *out = f;
    return true;
  }
  *out = static_cast<float>(neg ? -v : v);
  p = q;
  return true;
}

inline bool parse_u64(const char*& p, const char* end, uint64_t* out) {
  const char* q = p;
  uint64_t v = 0;
  bool any = false;
  while (q < end && *q >= '0' && *q <= '9') {
    v = v * 10u + static_cast<uint64_t>(*q - '0');
    ++q;
    any = true;
  }
  if (!any) return false;
  *out = v;
  p = q;
  return true;
}

void parse_chunk(const char* begin, const char* end, Shard* out) {
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* q = skip_ws(p, line_end);
    p = nl ? nl + 1 : end;
    if (q >= line_end || *q == '#') continue;  // blank / comment
    float label;
    if (!parse_f32(q, line_end, &label)) { out->error = true; return; }
    out->labels.push_back(label);
    int64_t nnz = 0;
    for (;;) {
      q = skip_ws(q, line_end);
      if (q >= line_end || *q == '#') break;
      uint64_t idx;
      if (!parse_u64(q, line_end, &idx)) { out->error = true; return; }
      float val = 1.0f;  // bare index => 1.0 (dmlc semantics)
      if (q < line_end && *q == ':') {
        ++q;
        if (!parse_f32(q, line_end, &val)) { out->error = true; return; }
      }
      out->indices.push_back(idx);
      out->values.push_back(val);
      ++nnz;
    }
    out->rownnz.push_back(nnz);
  }
}

}  // namespace

extern "C" {

int dft_parse_libsvm(const char* data, int64_t len,
                     int64_t* n_rows, int64_t* nnz,
                     void** labels_out, void** indptr_out,
                     void** indices_out, void** values_out,
                     int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  const char* end = data + len;

  // line-aligned chunk boundaries
  std::vector<const char*> bounds;
  bounds.push_back(data);
  for (int t = 1; t < nthreads; ++t) {
    const char* cand = data + (len * t) / nthreads;
    if (cand <= bounds.back()) { bounds.push_back(bounds.back()); continue; }
    const char* nl = static_cast<const char*>(memchr(cand, '\n', end - cand));
    bounds.push_back(nl ? nl + 1 : end);
  }
  bounds.push_back(end);

  std::vector<Shard> shards(nthreads);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back(parse_chunk, bounds[t], bounds[t + 1], &shards[t]);
    }
    for (auto& th : threads) th.join();
  }
  for (const auto& s : shards) {
    if (s.error) return 1;
  }

  int64_t rows = 0, total = 0;
  for (const auto& s : shards) {
    rows += static_cast<int64_t>(s.labels.size());
    total += static_cast<int64_t>(s.indices.size());
  }
  float* labels = static_cast<float*>(malloc(sizeof(float) * (rows ? rows : 1)));
  int64_t* indptr = static_cast<int64_t*>(malloc(sizeof(int64_t) * (rows + 1)));
  uint64_t* indices =
      static_cast<uint64_t*>(malloc(sizeof(uint64_t) * (total ? total : 1)));
  float* values = static_cast<float*>(malloc(sizeof(float) * (total ? total : 1)));
  if (!labels || !indptr || !indices || !values) {
    free(labels); free(indptr); free(indices); free(values);
    return 2;
  }
  int64_t r = 0, o = 0;
  indptr[0] = 0;
  for (const auto& s : shards) {
    if (!s.labels.empty()) {
      memcpy(labels + r, s.labels.data(), sizeof(float) * s.labels.size());
    }
    for (int64_t k : s.rownnz) {
      indptr[r + 1] = indptr[r] + k;
      ++r;
    }
    if (!s.indices.empty()) {
      memcpy(indices + o, s.indices.data(), sizeof(uint64_t) * s.indices.size());
      memcpy(values + o, s.values.data(), sizeof(float) * s.values.size());
      o += static_cast<int64_t>(s.indices.size());
    }
  }
  *n_rows = rows;
  *nnz = total;
  *labels_out = labels;
  *indptr_out = indptr;
  *indices_out = indices;
  *values_out = values;
  return 0;
}

void dft_free(void* p) { free(p); }

}  // extern "C"
