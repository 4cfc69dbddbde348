// Native text formatting for the VTP writer (sphinxsys_tpu_torch/io/vtk.py).
//
// The port's own copy of native/fastio.cpp: the "%.7g" serialisation of
// millions of floats per output frame is host-bound, so it is native.  Here
// it has a plain C interface, loaded with ctypes (no Python headers), and
// formats row chunks on several threads; each chunk goes to its own buffer
// and the chunks are joined in row order, so the bytes do not depend on the
// thread count.  float32 values are promoted to double before formatting,
// as the JAX package's native and Python formatters both do.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

void format_chunk(const char *data, int64_t r0, int64_t r1, int64_t cols,
                  int is_double, std::string *out) {
  char tmp[64];
  const int64_t elem = is_double ? 8 : 4;
  out->reserve(static_cast<size_t>(r1 - r0) * cols * 14);
  for (int64_t i = r0; i < r1; ++i) {
    const char *rp = data + i * cols * elem;
    for (int64_t j = 0; j < cols; ++j) {
      double v;
      if (is_double) {
        std::memcpy(&v, rp + j * 8, 8);
      } else {
        float f;
        std::memcpy(&f, rp + j * 4, 4);
        v = static_cast<double>(f);
      }
      int n = std::snprintf(tmp, sizeof(tmp), "%.7g", v);
      if (j > 0) out->push_back(' ');
      out->append(tmp, n);
    }
    out->push_back('\n');
  }
}

}  // namespace

extern "C" {

// The largest number of bytes format_rows writes for rows x cols values:
// "%.7g" of a double takes at most 14 characters ("-1.234567e-308"), plus
// a separator or newline after each value.
int64_t format_rows_bound(int64_t rows, int64_t cols) {
  return rows * cols * 15;
}

// Format a C-contiguous (rows, cols) float32 / float64 buffer as ASCII
// rows, "v v v\n" per row with %.7g, into `out` (at least
// format_rows_bound bytes).  Returns the number of bytes written.
int64_t format_rows(const void *buf, int64_t rows, int64_t cols,
                    int is_double, int n_threads, char *out) {
  const char *data = static_cast<const char *>(buf);
  int64_t t = std::max<int64_t>(1, std::min<int64_t>(n_threads, rows));
  if (rows * cols < (1 << 16)) t = 1;
  std::vector<std::string> parts(t);
  std::vector<std::thread> pool;
  const int64_t per = (rows + t - 1) / t;
  for (int64_t k = 0; k < t; ++k) {
    const int64_t r0 = std::min(rows, k * per);
    const int64_t r1 = std::min(rows, r0 + per);
    if (t == 1) {
      format_chunk(data, r0, r1, cols, is_double, &parts[k]);
    } else {
      pool.emplace_back(format_chunk, data, r0, r1, cols, is_double,
                        &parts[k]);
    }
  }
  for (auto &th : pool) th.join();
  int64_t n = 0;
  for (const auto &p : parts) {
    std::memcpy(out + n, p.data(), p.size());
    n += static_cast<int64_t>(p.size());
  }
  return n;
}

}  // extern "C"
