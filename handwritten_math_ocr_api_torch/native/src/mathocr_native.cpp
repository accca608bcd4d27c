// Native runtime for the host-side hot paths that sit outside the model.
//
// The reference ran these in pure Python / Python deps (the LaTeX token
// scan over ~220k training formulas, editdistance over the ~7k-sample eval
// split, per-sample batch assembly in DataLoader workers). Here they are
// C++ with a C ABI, bound via ctypes (native/__init__.py); every entry
// point has a pure-Python fallback at its call site.
//
// Built at first use by native/__init__.py (g++ -O3 -std=c++17 -shared
//   -fPIC -pthread, no external dependencies) into the package's
//   .kernel_build/ directory.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Levenshtein edit distance over UTF-32 codepoints.
// a/b: little-endian uint32 codepoint arrays of length la/lb.
// ---------------------------------------------------------------------------
int64_t mathocr_edit_distance(const uint32_t* a, size_t la,
                              const uint32_t* b, size_t lb) {
  if (la == 0) return static_cast<int64_t>(lb);
  if (lb == 0) return static_cast<int64_t>(la);
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (size_t j = 0; j <= lb; ++j) prev[j] = static_cast<int64_t>(j);
  for (size_t i = 1; i <= la; ++i) {
    cur[0] = static_cast<int64_t>(i);
    const uint32_t ca = a[i - 1];
    for (size_t j = 1; j <= lb; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// ---------------------------------------------------------------------------
// LaTeX tokenizer with the reference regex semantics (src/utils.py:97):
//   \\[a-zA-Z]+ | [{}_^$%&#] | [0-9]+ | [a-zA-Z]+ | [^\s]
// UTF-8 aware: a multi-byte character is a single [^\s] token.
// Output: tokens joined by '\x1f' into out (capacity out_cap, incl. NUL).
// Returns the number of tokens, or -1 if out_cap is too small.
// ---------------------------------------------------------------------------
static inline bool is_alpha(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
static inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }
static inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
static inline bool is_structural(unsigned char c) {
  switch (c) {
    case '{': case '}': case '_': case '^': case '$': case '%':
    case '&': case '#':
      return true;
    default:
      return false;
  }
}
static inline size_t utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xe) return 3;
  if ((c >> 3) == 0x1e) return 4;
  return 1;  // invalid byte: consume one
}

int64_t mathocr_tokenize(const char* text, size_t len, char* out,
                         size_t out_cap) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
  size_t i = 0, w = 0;
  int64_t count = 0;
  auto emit = [&](const unsigned char* start, size_t n) -> bool {
    const size_t need = n + (count > 0 ? 1 : 0);
    if (w + need + 1 > out_cap) return false;
    if (count > 0) out[w++] = '\x1f';
    std::memcpy(out + w, start, n);
    w += n;
    ++count;
    return true;
  };
  while (i < len) {
    const unsigned char c = s[i];
    if (is_space(c)) {
      ++i;
      continue;
    }
    size_t start = i, n = 0;
    if (c == '\\' && i + 1 < len && is_alpha(s[i + 1])) {
      n = 2;
      while (start + n < len && is_alpha(s[start + n])) ++n;
    } else if (is_structural(c)) {
      n = 1;
    } else if (is_digit(c)) {
      n = 1;
      while (start + n < len && is_digit(s[start + n])) ++n;
    } else if (is_alpha(c)) {
      n = 1;
      while (start + n < len && is_alpha(s[start + n])) ++n;
    } else {
      n = std::min(utf8_len(c), len - i);  // any single non-space char
    }
    if (!emit(s + start, n)) return -1;
    i = start + n;
  }
  out[w] = '\0';
  return count;
}

// ---------------------------------------------------------------------------
// Parallel batch assembly: scatter N contiguous (h*w) uint8 images into a
// (N, h, w, 1) batch buffer using a small thread pool. `srcs` is an array
// of N pointers. Replaces the per-sample Python copy loop of the loader.
// ---------------------------------------------------------------------------
void mathocr_assemble_batch(const uint8_t** srcs, size_t n, size_t img_bytes,
                            uint8_t* dst, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  if (static_cast<size_t>(num_threads) > n) num_threads = static_cast<int>(n);
  std::atomic<size_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n) return;
      std::memcpy(dst + i * img_bytes, srcs[i], img_bytes);
    }
  };
  if (num_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// Batched edit distance: distances[i] = levenshtein(a_i, b_i) computed in
// parallel. Strings are concatenated UTF-32 buffers with offset arrays
// (offsets have n+1 entries).
// ---------------------------------------------------------------------------
void mathocr_edit_distance_batch(const uint32_t* a, const int64_t* a_off,
                                 const uint32_t* b, const int64_t* b_off,
                                 size_t n, int64_t* distances,
                                 int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<size_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n) return;
      distances[i] = mathocr_edit_distance(
          a + a_off[i], static_cast<size_t>(a_off[i + 1] - a_off[i]),
          b + b_off[i], static_cast<size_t>(b_off[i + 1] - b_off[i]));
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads - 1; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

const char* mathocr_version() { return "mathocr-native 0.1.0"; }

}  // extern "C"
