// parse_common — helpers shared by the native IO libraries (textio.cpp,
// chunkstore.cpp): the reference's separator rule, the fast float parser,
// and the whole-file read buffer. Header-only so each .so compiles its own
// copy (no cross-library linkage; the two libraries stay independently
// loadable via ctypes).
//
// Portability: libstdc++ only grew floating-point from_chars/to_chars in
// GCC 11 (__cpp_lib_to_chars). On older toolchains the parser falls back to
// strtod — correctly rounded too, just without the Eisel-Lemire fast path —
// so the native libraries build (and run) instead of silently ceding the
// data plane to the pure-Python parser.

#pragma once

#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace marlin_native {

inline const char* skip_seps(const char* p, const char* end) {
  // the reference's separator rule: ",\s?|\s+"
  while (p < end && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Fast float parse. With FP from_chars (Eisel-Lemire): correctly rounded,
// locale-free, bounded by `end`, ~4x faster than strtod. Without it: strtod
// on the NUL-terminated file buffer (see FileBuf) — the token ends before
// `end`, so strtod cannot scan out of bounds; a result past `end` is
// rejected. Both paths keep Python float()'s '1e400' -> inf / '1e-400' -> 0
// semantics; leading '+' is skipped for parity with float().
inline const char* parse_value(const char* q, const char* end, double* out) {
  if (q < end && *q == '+') ++q;
#if defined(__cpp_lib_to_chars)
  auto r = std::from_chars(q, end, *out);
  if (r.ec == std::errc()) return r.ptr;
  if (r.ec != std::errc::result_out_of_range) return nullptr;
  // fall through to strtod for its ±HUGE_VAL / ±0 out-of-range semantics
#endif
  char* next = nullptr;
  *out = std::strtod(q, &next);
  if (next == q || next > end) return nullptr;
  return next;
}

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
  // Read the whole file into a NUL-terminated buffer. Every step is
  // checked: an unseekable/unsizeable stream (ftell -1), a failed or SHORT
  // fread (the file shrank, or the path is a directory — Linux fopen()s
  // directories happily and only fread fails with EISDIR) returns a
  // negative errno instead of silently parsing an empty or truncated
  // buffer as a smaller matrix.
  int read(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -errno;
    long n = -1;
    if (std::fseek(f, 0, SEEK_END) == 0) n = std::ftell(f);
    if (n < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
      int rc = errno ? -errno : -EIO;
      std::fclose(f);
      return rc;
    }
    data = static_cast<char*>(std::malloc(n + 1));
    if (!data) {
      std::fclose(f);
      return -ENOMEM;
    }
    errno = 0;
    size = std::fread(data, 1, n, f);
    if (size != static_cast<size_t>(n) || std::ferror(f)) {
      int rc = errno ? -errno : -EIO;
      std::fclose(f);
      return rc;
    }
    data[size] = '\0';
    std::fclose(f);
    return 0;
  }
};

}  // namespace marlin_native
