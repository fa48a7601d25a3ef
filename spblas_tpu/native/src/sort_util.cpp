// Host-side sort utility for the distributed SpGEMM symbolic phase:
// a parallel stable LSD radix argsort of packed (row, col) keys, which
// emits both the order and the sorted keys.  Semantics-identical to
// np.argsort(key, kind="stable").
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int nthreads_for(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? (int)hw : 1;
  if (t > 8) t = 8;
  // below ~1M elements thread spawn + barrier overhead dominates
  while (t > 1 && n / t < 262144) --t;
  return t;
}

template <typename F>
void parallel_blocks(int64_t n, int nt, F&& body) {
  if (nt <= 1) {
    body(0, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b0 = t * per, b1 = std::min<int64_t>(n, b0 + per);
    if (b0 >= b1) break;
    ts.emplace_back([&, t, b0, b1] { body(t, b0, b1); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

// Stable LSD radix argsort of non-negative int64 keys; fills order
// (int32) and sorted_key.  Identical order to np.argsort(key,
// kind="stable").  Returns 0, or -1 when n does not fit int32.
extern "C" int64_t spblas_argsort_i64(
    int64_t n, const int64_t* key, int32_t* order, int64_t* sorted_key) {
  if (n >= INT32_MAX) return -1;
  if (n == 0) return 0;
  int nt = nthreads_for(n);

  // max key -> number of 8-bit passes.  The same scan rejects negative
  // keys (return -2 -> callers fall back to np.argsort): LSD radix on
  // two's-complement would SILENTLY order negatives after positives,
  // and a caller's packed-key overflow must not become a mis-sorted
  // plan.
  std::vector<int64_t> mx(nt ? nt : 1, 0);
  std::vector<int64_t> mn(nt ? nt : 1, 0);
  parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
    int64_t m = 0, lo = 0;
    for (int64_t i = b0; i < b1; ++i) {
      if (key[i] > m) m = key[i];
      if (key[i] < lo) lo = key[i];
    }
    mx[t] = m;
    mn[t] = lo;
  });
  for (int64_t v : mn)
    if (v < 0) return -2;
  int64_t maxkey = 0;
  for (int64_t v : mx) maxkey = std::max(maxkey, v);
  int passes = 1;
  while (passes < 8 && (maxkey >> (8 * passes)) != 0) ++passes;

  std::vector<int64_t> kbuf_a(n), kbuf_b(n);
  std::vector<int32_t> ibuf_a(n), ibuf_b(n);
  std::memcpy(kbuf_a.data(), key, n * sizeof(int64_t));
  parallel_blocks(n, nt, [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) ibuf_a[i] = (int32_t)i;
  });

  int64_t* kin = kbuf_a.data();
  int64_t* kout = kbuf_b.data();
  int32_t* iin = ibuf_a.data();
  int32_t* iout = ibuf_b.data();

  std::vector<std::vector<int64_t>> cnt(nt, std::vector<int64_t>(256));
  for (int p = 0; p < passes; ++p) {
    const int sh = 8 * p;
    for (auto& c : cnt) std::fill(c.begin(), c.end(), 0);
    parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
      int64_t* c = cnt[t].data();
      for (int64_t i = b0; i < b1; ++i) ++c[(kin[i] >> sh) & 255];
    });
    // skip pass if every key shares this digit
    int64_t dom = 0;
    for (int d = 0; d < 256; ++d) {
      int64_t tot = 0;
      for (int t = 0; t < nt; ++t) tot += cnt[t][d];
      if (tot == n) { dom = 1; break; }
      if (tot) break;  // cheap early-out only valid for d with counts
    }
    if (dom) continue;
    // exclusive prefix over (digit major, thread minor) -> stable
    int64_t run = 0;
    for (int d = 0; d < 256; ++d)
      for (int t = 0; t < nt; ++t) {
        int64_t c = cnt[t][d];
        cnt[t][d] = run;
        run += c;
      }
    parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
      int64_t* pos = cnt[t].data();
      for (int64_t i = b0; i < b1; ++i) {
        int64_t j = pos[(kin[i] >> sh) & 255]++;
        kout[j] = kin[i];
        iout[j] = iin[i];
      }
    });
    std::swap(kin, kout);
    std::swap(iin, iout);
  }
  std::memcpy(order, iin, n * sizeof(int32_t));
  std::memcpy(sorted_key, kin, n * sizeof(int64_t));
  return 0;
}
