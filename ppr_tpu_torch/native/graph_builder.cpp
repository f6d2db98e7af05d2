// Native graph-builder: CSV/edge-list -> CSR/COO arrays.
//
// The reference's ingestion path is the Neo4j store import plus the
// HeavyGraph bulk load (PPR.java:141-147) — both JVM machinery. The TPU
// engine replaces them with this small C++ runtime: a counting-sort CSR
// builder and a zero-copy edge-list parser, O(n + m) with no Python-object
// overhead, so million/billion-edge graphs load at memory bandwidth before
// being handed to device memory.
//
// A copy of ppr_tpu/native/graph_builder.cpp, so the two packages build the
// same arrays. Exposed via ctypes (see ppr_tpu_torch/native/__init__.py);
// all buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Build CSR (indptr/indices) + src-sorted COO from a directed edge list.
// src/dst: int64[m] with values in [0, n). Outputs:
//   indptr:     int32[n_pad + 1]
//   indices:    int32[m]  (dst sorted by src, stable)
//   sorted_src: int32[m]
//   out_deg:    int32[n_pad]  (zero-filled past n)
//   in_deg:     int32[n_pad]
// Returns 0 on success, -1 on out-of-range endpoints.
int ppr_build_csr(int64_t m, const int64_t* src, const int64_t* dst,
                  int64_t n, int64_t n_pad,
                  int32_t* indptr, int32_t* indices, int32_t* sorted_src,
                  int32_t* out_deg, int32_t* in_deg) {
  memset(out_deg, 0, sizeof(int32_t) * n_pad);
  memset(in_deg, 0, sizeof(int32_t) * n_pad);
  for (int64_t i = 0; i < m; ++i) {
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -1;
    ++out_deg[src[i]];
    ++in_deg[dst[i]];
  }
  indptr[0] = 0;
  for (int64_t v = 0; v < n_pad; ++v) indptr[v + 1] = indptr[v] + out_deg[v];
  // counting sort by src (stable: preserves input edge order per source)
  int32_t* cursor = (int32_t*)malloc(sizeof(int32_t) * (n_pad + 1));
  memcpy(cursor, indptr, sizeof(int32_t) * (n_pad + 1));
  for (int64_t i = 0; i < m; ++i) {
    int32_t pos = cursor[src[i]]++;
    indices[pos] = (int32_t)dst[i];
    sorted_src[pos] = (int32_t)src[i];
  }
  free(cursor);
  return 0;
}

// Parse a whitespace/comma-separated "src dst" edge-list file (SNAP style,
// '#' comments) into preallocated int64 buffers. Returns the number of
// edges parsed, or -1 if the file can't be opened, or -2 if cap exceeded.
int64_t ppr_parse_edge_list(const char* path, int64_t cap,
                            int64_t* src, int64_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t m = 0;
  char line[8192];
  while (fgets(line, sizeof(line), f)) {
    // a line longer than the buffer: consume its remainder so continuation
    // bytes are never parsed as a fresh (phantom) edge
    size_t len = strlen(line);
    if (len + 1 == sizeof(line) && line[len - 1] != '\n') {
      int c;
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    }
    const char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '#' || *p == '\n' || *p == '\0') continue;
    char* end;
    long long a = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    while (*p == ' ' || *p == '\t' || *p == ',') ++p;
    long long b = strtoll(p, &end, 10);
    if (end == p) continue;
    if (m >= cap) { fclose(f); return -2; }
    src[m] = a;
    dst[m] = b;
    ++m;
  }
  fclose(f);
  return m;
}

// Build Walker alias tables over CSR segments for O(1) weighted neighbor
// sampling. coef[j] is the normalized edge probability (sums to 1 per
// source segment). Outputs (both length m_pad, caller-initialized tail):
//   prob[j]  : accept probability of slot j's own target
//   other[j] : global slot index redirected to on reject
// Uses the classic small/large two-stack construction, O(d) per node.
int ppr_build_alias(int64_t n_pad, const int32_t* indptr, const float* coef,
                    float* prob, int32_t* other) {
  int64_t max_d = 0;
  for (int64_t v = 0; v < n_pad; ++v) {
    int64_t d = indptr[v + 1] - indptr[v];
    if (d > max_d) max_d = d;
  }
  double* q = (double*)malloc(sizeof(double) * (max_d > 0 ? max_d : 1));
  int32_t* small_s = (int32_t*)malloc(sizeof(int32_t) * (max_d > 0 ? max_d : 1));
  int32_t* large_s = (int32_t*)malloc(sizeof(int32_t) * (max_d > 0 ? max_d : 1));
  if (!q || !small_s || !large_s) return -1;

  for (int64_t v = 0; v < n_pad; ++v) {
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t d = hi - lo;
    if (d <= 1) {
      if (d == 1) {
        prob[lo] = 1.0f;
        other[lo] = (int32_t)lo;
      }
      continue;
    }
    int64_t ns = 0, nl = 0;
    for (int64_t j = 0; j < d; ++j) {
      q[j] = (double)coef[lo + j] * (double)d;
      if (q[j] < 1.0)
        small_s[ns++] = (int32_t)j;
      else
        large_s[nl++] = (int32_t)j;
    }
    while (ns > 0 && nl > 0) {
      int32_t s_j = small_s[--ns];
      int32_t l_j = large_s[--nl];
      prob[lo + s_j] = (float)q[s_j];
      other[lo + s_j] = (int32_t)(lo + l_j);
      q[l_j] -= (1.0 - q[s_j]);
      if (q[l_j] < 1.0)
        small_s[ns++] = l_j;
      else
        large_s[nl++] = l_j;
    }
    while (ns > 0) {
      int32_t j = small_s[--ns];
      prob[lo + j] = 1.0f;
      other[lo + j] = (int32_t)(lo + j);
    }
    while (nl > 0) {
      int32_t j = large_s[--nl];
      prob[lo + j] = 1.0f;
      other[lo + j] = (int32_t)(lo + j);
    }
  }
  free(q);
  free(small_s);
  free(large_s);
  return 0;
}

}  // extern "C"
