// Levenshtein edit distance over token-id sequences.
//
// The reference stack computes WER with the `editdistance` C extension
// (reference: utils/metrics.py:1-22). This is our native equivalent: a
// small C++ library exposed over a C ABI and loaded via ctypes, used on the
// host side (metrics never run on the device). One row + O(min(n,m)) memory.
//
// Built at first use by p4fr_tpu_torch/native/__init__.py (g++ -O3
// -std=c++17 -shared -fPIC) into build/p4fr_tpu_torch/.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Edit distance between two int64 token sequences.
int64_t p4fr_edit_distance(const int64_t* a, int64_t n, const int64_t* b,
                           int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  // Ensure the inner row is the shorter sequence.
  if (m > n) {
    std::swap(a, b);
    std::swap(n, m);
  }
  std::vector<int64_t> row(static_cast<size_t>(m) + 1);
  for (int64_t j = 0; j <= m; ++j) row[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t prev_diag = row[0];  // row[i-1][0]
    row[0] = i;
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t prev_up = row[j];  // row[i-1][j]
      const int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
      row[j] = std::min({row[j] + 1,          // deletion
                         row[j - 1] + 1,      // insertion
                         prev_diag + cost});  // substitution
      prev_diag = prev_up;
    }
  }
  return row[m];
}

// Batched edit distance: `count` sequence pairs, flattened into `a`/`b`
// with per-pair lengths. Fills `out[count]`.
void p4fr_edit_distance_batch(const int64_t* a, const int64_t* a_lens,
                              const int64_t* b, const int64_t* b_lens,
                              int64_t count, int64_t* out) {
  int64_t a_off = 0, b_off = 0;
  for (int64_t i = 0; i < count; ++i) {
    out[i] = p4fr_edit_distance(a + a_off, a_lens[i], b + b_off, b_lens[i]);
    a_off += a_lens[i];
    b_off += b_lens[i];
  }
}

}  // extern "C"
