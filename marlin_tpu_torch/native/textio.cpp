// textio — native parser/writer for the Marlin row-text matrix format.
//
// The reference's data plane is JVM-side: Spark textFile + per-line
// String.split parsing (MTUtils.loadMatrixFile, utils/MTUtils.scala:286-300).
// Python's equivalent (str.split + float()) parses at ~30 MB/s, which turns
// multi-GB matrix loads into minutes. This C library parses the
// "rowIdx:v,v,..." format at memory-bandwidth-ish speed and is exposed to
// Python via ctypes (marlin_tpu_torch/native/__init__.py) with a pure-Python
// fallback when the shared object hasn't been built.
//
// Build: at first use by marlin_tpu_torch/native/__init__.py (g++ -O3
// -std=c++17 -fPIC -shared), into build/marlin_tpu_torch/native/
//
// Exported C ABI (all return 0 on success, negative on error):
//   mt_count_matrix(path, *rows, *cols)   — scan pass: dimensions
//   mt_load_matrix(path, out, rows, cols) — parse pass: fill row-major f64
//   mt_save_matrix(path, data, rows, cols)— write the same format
//   mt_save_coo(path, rows, cols, vals, nnz) — "i j v" COO lines
//     (CoordinateMatrix text format, matrix/CoordinateMatrix.scala entries;
//      std::to_chars shortest round-trip, matching Python repr() precision)

#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "parse_common.h"

namespace {

using marlin_native::FileBuf;
using marlin_native::parse_value;
using marlin_native::skip_seps;

// Shortest-round-trip value formatter. FP to_chars where libstdc++ has it
// (GCC 11+); otherwise printf with the dtype's round-trip precision (%.17g
// f64 / %.9g f32 — longer than shortest for some values, still exact).
inline char* format_value(char* p, char* cap, double v) {
#if defined(__cpp_lib_to_chars)
  return std::to_chars(p, cap, v).ptr;
#else
  return p + std::snprintf(p, cap - p, "%.17g", v);
#endif
}

inline char* format_value(char* p, char* cap, float v) {
#if defined(__cpp_lib_to_chars)
  return std::to_chars(p, cap, v).ptr;
#else
  return p + std::snprintf(p, cap - p, "%.9g", static_cast<double>(v));
#endif
}

}  // namespace

extern "C" {

int mt_count_matrix(const char* path, int64_t* rows, int64_t* cols) {
  FileBuf buf;
  if (int rc = buf.read(path); rc != 0) return rc;
  int64_t max_row = -1, ncols = 0;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* colon = static_cast<const char*>(std::memchr(p, ':', line_end - p));
    if (!colon) {
      // only blank lines may lack the "rowIdx:" prefix — anything else is
      // not this format (the Python parser raises there too)
      for (const char* q = p; q < line_end; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') return -EINVAL;
      }
    } else {
      char* after = nullptr;
      long long r = std::strtoll(p, &after, 10);
      if (after == p || !after || after > colon) return -EINVAL;  // bad row idx
      {
        if (r > max_row) max_row = r;
        // count values on every line: ragged inputs get the max width,
        // matching the Python parser's behavior. An unparseable token is a
        // hard error (the Python parser raises there too) — never silently
        // truncate.
        int64_t line_cols = 0;
        const char* q = colon + 1;
        while (q < line_end) {
          q = skip_seps(q, line_end);
          if (q >= line_end) break;
          double v;
          const char* next = parse_value(q, line_end, &v);
          if (!next) return -EINVAL;
          ++line_cols;
          q = next;
        }
        if (line_cols > ncols) ncols = line_cols;
      }
    }
    p = line_end + 1;
  }
  *rows = max_row + 1;
  *cols = ncols;
  return 0;
}

int mt_load_matrix(const char* path, double* out, int64_t rows, int64_t cols) {
  FileBuf buf;
  if (int rc = buf.read(path); rc != 0) return rc;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* colon = static_cast<const char*>(std::memchr(p, ':', line_end - p));
    if (!colon) {
      for (const char* q = p; q < line_end; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') return -EINVAL;
      }
    } else {
      char* after = nullptr;
      long long r = std::strtoll(p, &after, 10);
      if (after == p || !after || after > colon) return -EINVAL;
      if (r >= 0 && r < rows) {
        double* row_out = out + r * cols;
        const char* q = colon + 1;
        int64_t j = 0;
        while (q < line_end && j < cols) {
          q = skip_seps(q, line_end);
          if (q >= line_end) break;
          double v;
          const char* next = parse_value(q, line_end, &v);
          if (!next) return -EINVAL;  // corrupt token: fail, don't zero-fill
          row_out[j++] = v;
          q = next;
        }
      }
    }
    p = line_end + 1;
  }
  return 0;
}

int mt_save_matrix(const char* path, const double* data, int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -errno;
  static char iobuf[1 << 20];
  std::setvbuf(f, iobuf, _IOFBF, sizeof(iobuf));
  for (int64_t i = 0; i < rows; ++i) {
    std::fprintf(f, "%lld:", static_cast<long long>(i));
    const double* row = data + i * cols;
    for (int64_t j = 0; j < cols; ++j) {
      std::fprintf(f, j + 1 == cols ? "%.17g" : "%.17g,", row[j]);
    }
    std::fputc('\n', f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"

namespace {

// Format into a big user-space buffer with to_chars (shortest round-trip,
// like Python repr) and flush in MB-scale fwrites — 10^8 nnz in ~20 s where
// the per-line Python writer took minutes (matrix/sparse.py). The f32
// overload is ~5x faster per value AND exact for f32-originated data (the
// CoordinateMatrix value type, matching the reference's Float entries,
// matrix/CoordinateMatrix.scala:14) — shortest-repr of the f64 image of an
// f32 would pay up to 17 digits for nothing.
template <typename V>
int save_coo_impl(const char* path, const int64_t* rows, const int64_t* cols,
                  const V* vals, int64_t nnz) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -errno;
  constexpr size_t kCap = size_t{1} << 22;
  constexpr size_t kMaxLine = 96;  // 2 int64s + value + separators, worst case
  char* buf = static_cast<char*>(std::malloc(kCap));
  if (!buf) {
    std::fclose(f);
    return -ENOMEM;
  }
  size_t used = 0;
  for (int64_t k = 0; k < nnz; ++k) {
    if (used + kMaxLine > kCap) {
      if (std::fwrite(buf, 1, used, f) != used) {
        std::free(buf);
        std::fclose(f);
        return -EIO;
      }
      used = 0;
    }
    char* p = buf + used;
    char* cap = buf + kCap;
    p = std::to_chars(p, cap, static_cast<long long>(rows[k])).ptr;
    *p++ = ' ';
    p = std::to_chars(p, cap, static_cast<long long>(cols[k])).ptr;
    *p++ = ' ';
    p = format_value(p, cap, vals[k]);
    *p++ = '\n';
    used = p - buf;
  }
  int rc = 0;
  if (used && std::fwrite(buf, 1, used, f) != used) rc = -EIO;
  std::free(buf);
  if (std::fclose(f) != 0 && rc == 0) rc = -errno;
  return rc;
}

}  // namespace

extern "C" {

int mt_save_coo(const char* path, const int64_t* rows, const int64_t* cols,
                const double* vals, int64_t nnz) {
  return save_coo_impl(path, rows, cols, vals, nnz);
}

int mt_save_coo_f32(const char* path, const int64_t* rows, const int64_t* cols,
                    const float* vals, int64_t nnz) {
  return save_coo_impl(path, rows, cols, vals, nnz);
}

}  // extern "C"
