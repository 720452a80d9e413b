// chunkstore — the native binary chunk container behind the out-of-core
// data plane (marlin_tpu_torch/io/chunkstore.py binds this via ctypes).
//
// The tall-skinny streamed Gramian (BASELINE.md config 4) is fed from the
// host, and a text parser on the host cannot keep up with the card: the
// prefetch pipeline overlaps production with compute and leaves the producer
// as the wall. This library replaces the producer with an mmap'd binary
// format the OS page cache can feed at memory speed, checksum-validated,
// with dtype conversion (f64/f32 -> bf16/f32/f64) done in C outside the
// GIL — ctypes releases the GIL for the duration of every call, and
// mcs_read additionally fans the touched chunks over a small std::thread
// pool. The reader fills caller-provided buffers: no per-chunk Python
// allocation, no pickling, no parse.
//
// MarlinChunk container layout (little-endian, fixed — offsets of every
// chunk are computable from the file header, which is what makes mmap'd
// random-access windows ("scatter/gather of arbitrary chunk_rows windows")
// O(1)):
//
//   FileHeader (64 B): magic "MRLNCHK1", version, dtype, nrows, ncols,
//                      chunk_rows, nchunks
//   chunk k (k = 0..nchunks-1), at 64 + k * (32 + chunk_rows*rowbytes):
//     ChunkHeader (32 B): magic "MCHK", crc32c(body), row_offset, nrows,
//                         body_bytes
//     body: row-major values, nrows*ncols elements of dtype
//
// Only the last chunk may be short. The CRC is Castagnoli (CRC32C), the
// storage-checksum polynomial; a flipped byte anywhere in a chunk body is
// detected at read time (-EBADMSG), and a truncated file is detected at
// open time (the expected size is computable — -EIO, "short mmap").
//
// Exported C ABI (0 on success, negative errno-style on error; handles are
// opaque pointers):
//   mcs_writer_open / mcs_writer_append / mcs_writer_close / mcs_writer_abort
//   mcs_open / mcs_info / mcs_read / mcs_close
//   mcs_from_text  — transcode the row-text format (reuses the textio
//                    parser helpers from parse_common.h)
//   mcs_crc32c     — the checksum itself, for tests/tools
//
// Build: at first use by marlin_tpu_torch/native/__init__.py (g++ -O3
// -std=c++17 -fPIC -shared -pthread), into build/marlin_tpu_torch/native/

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "parse_common.h"

namespace {

using marlin_native::FileBuf;
using marlin_native::parse_value;
using marlin_native::skip_seps;

constexpr char kFileMagic[8] = {'M', 'R', 'L', 'N', 'C', 'H', 'K', '1'};
constexpr uint32_t kChunkMagic = 0x4B48434Du;  // "MCHK" little-endian
constexpr uint32_t kVersion = 1;

// dtype codes shared with the Python binding (io/chunkstore.py DTYPES)
enum Dtype : int32_t { kF32 = 1, kF64 = 2, kBF16 = 3 };

inline int64_t itemsize(int32_t dtype) {
  switch (dtype) {
    case kF32: return 4;
    case kF64: return 8;
    case kBF16: return 2;
    default: return 0;
  }
}

#pragma pack(push, 1)
struct FileHeader {
  char magic[8];
  uint32_t version;
  int32_t dtype;
  int64_t nrows;
  int64_t ncols;
  int64_t chunk_rows;
  int64_t nchunks;
  uint64_t reserved[2];
};
struct ChunkHeader {
  uint32_t magic;
  uint32_t crc32c;
  int64_t row_offset;
  int64_t nrows;
  int64_t body_bytes;
};
#pragma pack(pop)
static_assert(sizeof(FileHeader) == 64, "FileHeader must be 64 bytes");
static_assert(sizeof(ChunkHeader) == 32, "ChunkHeader must be 32 bytes");

// ------------------------------------------------------------------ crc32c
// Castagnoli CRC-32 (poly 0x1EDC6F41, reflected 0x82F63B78) — the storage
// checksum (iSCSI, ext4, leveldb). Table-driven software implementation;
// the function-local static initializer is thread-safe (C++11 magic
// statics), so concurrent reader threads share one table.
const uint32_t* crc32c_table() {
  static const auto* table = [] {
    auto* t = new uint32_t[256];
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  return table;
}

uint32_t crc32c(const void* data, int64_t n) {
  const uint32_t* t = crc32c_table();
  const auto* p = static_cast<const uint8_t*>(data);
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------- conversion
// bf16 <-> f32: round-to-nearest-even truncation of the f32 bit pattern,
// matching ml_dtypes/JAX semantics (NaN stays quiet NaN).
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7FFFFFFFu) > 0x7F800000u) return static_cast<uint16_t>((x >> 16) | 0x0040u);
  x += 0x7FFFu + ((x >> 16) & 1u);
  return static_cast<uint16_t>(x >> 16);
}

inline float bf16_to_f32(uint16_t h) {
  uint32_t x = static_cast<uint32_t>(h) << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

template <typename S, typename D>
void convert_loop(const void* src, void* dst, int64_t count) {
  const S* s = static_cast<const S*>(src);
  D* d = static_cast<D*>(dst);
  for (int64_t i = 0; i < count; ++i) d[i] = static_cast<D>(s[i]);
}

// src/dst described by dtype codes; count elements. Same-dtype is memcpy;
// bf16 endpoints go through f32 (f64 -> bf16 double-rounds via f32, the
// same path numpy/ml_dtypes take).
int convert_rows(const void* src, int32_t sdt, void* dst, int32_t ddt,
                 int64_t count) {
  if (sdt == ddt) {
    std::memcpy(dst, src, count * itemsize(sdt));
    return 0;
  }
  const auto* s8 = static_cast<const uint8_t*>(src);
  auto* d8 = static_cast<uint8_t*>(dst);
  if (sdt == kF32 && ddt == kF64) convert_loop<float, double>(src, dst, count);
  else if (sdt == kF64 && ddt == kF32) convert_loop<double, float>(src, dst, count);
  else if (sdt == kF32 && ddt == kBF16) {
    const float* s = reinterpret_cast<const float*>(s8);
    uint16_t* d = reinterpret_cast<uint16_t*>(d8);
    for (int64_t i = 0; i < count; ++i) d[i] = f32_to_bf16(s[i]);
  } else if (sdt == kF64 && ddt == kBF16) {
    const double* s = reinterpret_cast<const double*>(s8);
    uint16_t* d = reinterpret_cast<uint16_t*>(d8);
    for (int64_t i = 0; i < count; ++i) d[i] = f32_to_bf16(static_cast<float>(s[i]));
  } else if (sdt == kBF16 && ddt == kF32) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(s8);
    float* d = reinterpret_cast<float*>(d8);
    for (int64_t i = 0; i < count; ++i) d[i] = bf16_to_f32(s[i]);
  } else if (sdt == kBF16 && ddt == kF64) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(s8);
    double* d = reinterpret_cast<double*>(d8);
    for (int64_t i = 0; i < count; ++i) d[i] = static_cast<double>(bf16_to_f32(s[i]));
  } else {
    return -EINVAL;
  }
  return 0;
}

// ------------------------------------------------------------------ writer
struct McsWriter {
  FILE* f = nullptr;
  int32_t dtype = 0;
  int64_t ncols = 0;
  int64_t chunk_rows = 0;
  int64_t rows_written = 0;  // rows in flushed chunks
  int64_t nchunks = 0;
  int64_t buffered = 0;  // rows pending in buf
  std::vector<uint8_t> buf;
};

int flush_chunk(McsWriter* w) {
  if (w->buffered == 0) return 0;
  int64_t body = w->buffered * w->ncols * itemsize(w->dtype);
  ChunkHeader ch{kChunkMagic, crc32c(w->buf.data(), body), w->rows_written,
                 w->buffered, body};
  if (std::fwrite(&ch, 1, sizeof(ch), w->f) != sizeof(ch)) return -EIO;
  if (std::fwrite(w->buf.data(), 1, body, w->f) != static_cast<size_t>(body))
    return -EIO;
  w->rows_written += w->buffered;
  w->nchunks += 1;
  w->buffered = 0;
  return 0;
}

}  // namespace

extern "C" {

uint32_t mcs_crc32c(const void* data, int64_t n) { return crc32c(data, n); }

void* mcs_writer_open(const char* path, int32_t dtype, int64_t ncols,
                      int64_t chunk_rows, int32_t* err) {
  *err = 0;
  if (itemsize(dtype) == 0 || ncols <= 0 || chunk_rows <= 0) {
    *err = -EINVAL;
    return nullptr;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    *err = -errno;
    return nullptr;
  }
  // placeholder header: finalized (nrows/nchunks) on close
  FileHeader hdr{};
  if (std::fwrite(&hdr, 1, sizeof(hdr), f) != sizeof(hdr)) {
    *err = -EIO;
    std::fclose(f);
    return nullptr;
  }
  auto* w = new McsWriter;
  w->f = f;
  w->dtype = dtype;
  w->ncols = ncols;
  w->chunk_rows = chunk_rows;
  w->buf.resize(chunk_rows * ncols * itemsize(dtype));
  return w;
}

// Append nrows row-major rows (src_dtype in {f32, f64}); the writer
// converts to the stored dtype and flushes chunk_rows-sized chunks as they
// fill. Chunk size on disk is a property of the FILE, not of the append
// granularity — callers may append one row at a time.
int mcs_writer_append(void* handle, const void* rows, int64_t nrows,
                      int32_t src_dtype) {
  auto* w = static_cast<McsWriter*>(handle);
  if (!w || nrows < 0 || (src_dtype != kF32 && src_dtype != kF64))
    return -EINVAL;
  int64_t isz = itemsize(w->dtype);
  int64_t src_isz = itemsize(src_dtype);
  const auto* src = static_cast<const uint8_t*>(rows);
  while (nrows > 0) {
    int64_t take = std::min(nrows, w->chunk_rows - w->buffered);
    int rc = convert_rows(src, src_dtype,
                          w->buf.data() + w->buffered * w->ncols * isz,
                          w->dtype, take * w->ncols);
    if (rc != 0) return rc;
    w->buffered += take;
    src += take * w->ncols * src_isz;
    nrows -= take;
    if (w->buffered == w->chunk_rows) {
      if (int frc = flush_chunk(w); frc != 0) return frc;
    }
  }
  return 0;
}

int mcs_writer_close(void* handle) {
  auto* w = static_cast<McsWriter*>(handle);
  if (!w) return -EINVAL;
  int rc = flush_chunk(w);
  if (rc == 0) {
    FileHeader hdr{};
    std::memcpy(hdr.magic, kFileMagic, 8);
    hdr.version = kVersion;
    hdr.dtype = w->dtype;
    hdr.nrows = w->rows_written;
    hdr.ncols = w->ncols;
    hdr.chunk_rows = w->chunk_rows;
    hdr.nchunks = w->nchunks;
    if (std::fseek(w->f, 0, SEEK_SET) != 0 ||
        std::fwrite(&hdr, 1, sizeof(hdr), w->f) != sizeof(hdr))
      rc = -EIO;
  }
  if (std::fclose(w->f) != 0 && rc == 0) rc = errno ? -errno : -EIO;
  delete w;
  return rc;
}

void mcs_writer_abort(void* handle) {
  auto* w = static_cast<McsWriter*>(handle);
  if (!w) return;
  std::fclose(w->f);
  delete w;
}

// ------------------------------------------------------------------ reader
struct McsReader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  FileHeader hdr{};
  int64_t rowbytes = 0;
  int64_t stride = 0;  // bytes per full chunk incl. header
};

void mcs_close(void* handle);

void* mcs_open(const char* path, int32_t* err) {
  *err = 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    *err = -errno;
    return nullptr;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    *err = -errno;
    ::close(fd);
    return nullptr;
  }
  if (static_cast<size_t>(st.st_size) < sizeof(FileHeader)) {
    *err = -EIO;  // shorter than its own header: torn write / not a store
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    *err = -errno;
    ::close(fd);
    return nullptr;
  }
  auto* r = new McsReader;
  r->fd = fd;
  r->map = static_cast<const uint8_t*>(map);
  r->size = st.st_size;
  std::memcpy(&r->hdr, r->map, sizeof(FileHeader));
  const FileHeader& h = r->hdr;
  int64_t isz = itemsize(h.dtype);
  bool valid = std::memcmp(h.magic, kFileMagic, 8) == 0 &&
               h.version == kVersion && isz > 0 && h.ncols > 0 &&
               h.chunk_rows > 0 && h.nrows >= 0;
  if (valid) {
    int64_t expect_chunks =
        h.nrows == 0 ? 0 : (h.nrows + h.chunk_rows - 1) / h.chunk_rows;
    valid = h.nchunks == expect_chunks;
  }
  if (!valid) {
    *err = -EINVAL;
    mcs_close(r);
    return nullptr;
  }
  r->rowbytes = h.ncols * isz;
  r->stride = sizeof(ChunkHeader) + h.chunk_rows * r->rowbytes;
  // the whole layout is computable — a size mismatch is a torn/truncated
  // file (short mmap) or trailing garbage, both fatal at open
  int64_t expect = sizeof(FileHeader);
  if (h.nchunks > 0) {
    int64_t last_rows = h.nrows - (h.nchunks - 1) * h.chunk_rows;
    expect += (h.nchunks - 1) * r->stride + sizeof(ChunkHeader) +
              last_rows * r->rowbytes;
  }
  if (static_cast<int64_t>(r->size) < expect) {
    *err = -EIO;
    mcs_close(r);
    return nullptr;
  }
  if (static_cast<int64_t>(r->size) > expect) {
    *err = -EINVAL;
    mcs_close(r);
    return nullptr;
  }
  return r;
}

int mcs_info(void* handle, int32_t* dtype, int64_t* nrows, int64_t* ncols,
             int64_t* chunk_rows, int64_t* nchunks) {
  auto* r = static_cast<McsReader*>(handle);
  if (!r) return -EINVAL;
  *dtype = r->hdr.dtype;
  *nrows = r->hdr.nrows;
  *ncols = r->hdr.ncols;
  *chunk_rows = r->hdr.chunk_rows;
  *nchunks = r->hdr.nchunks;
  return 0;
}

namespace {

// Validate + (optionally) checksum one chunk, then convert the rows the
// window touches into the caller's buffer. The CRC covers the whole chunk
// body, so even a partial-window read of a chunk verifies all of it —
// corruption is never skipped just because the window missed the bad byte.
int read_one_chunk(const McsReader* r, int64_t c, int64_t row_start,
                   int64_t nrows, uint8_t* out, int32_t out_dtype,
                   int64_t out_rowbytes, bool verify) {
  const FileHeader& h = r->hdr;
  const uint8_t* base = r->map + sizeof(FileHeader) + c * r->stride;
  ChunkHeader ch;
  std::memcpy(&ch, base, sizeof(ch));
  int64_t expect_rows = std::min(h.chunk_rows, h.nrows - c * h.chunk_rows);
  if (ch.magic != kChunkMagic || ch.row_offset != c * h.chunk_rows ||
      ch.nrows != expect_rows || ch.body_bytes != expect_rows * r->rowbytes)
    return -EINVAL;
  const uint8_t* body = base + sizeof(ChunkHeader);
  if (verify && crc32c(body, ch.body_bytes) != ch.crc32c) return -EBADMSG;
  int64_t lo = std::max(row_start, c * h.chunk_rows);
  int64_t hi = std::min(row_start + nrows, c * h.chunk_rows + expect_rows);
  return convert_rows(body + (lo - c * h.chunk_rows) * r->rowbytes, h.dtype,
                      out + (lo - row_start) * out_rowbytes, out_dtype,
                      (hi - lo) * h.ncols);
}

}  // namespace

// Gather rows [row_start, row_start+nrows) into `out` (row-major,
// out_dtype), validating each touched chunk's CRC when verify != 0. The
// touched chunks fan out over up to `threads` std::threads — combined with
// ctypes' GIL release this is the "multi-threaded parse/convert outside
// the GIL" half of the data plane.
int mcs_read(void* handle, int64_t row_start, int64_t nrows, void* out,
             int32_t out_dtype, int32_t threads, int32_t verify) {
  auto* r = static_cast<McsReader*>(handle);
  if (!r || itemsize(out_dtype) == 0 || row_start < 0 || nrows < 0 ||
      row_start + nrows > r->hdr.nrows)
    return -EINVAL;
  if (nrows == 0) return 0;
  int64_t c0 = row_start / r->hdr.chunk_rows;
  int64_t c1 = (row_start + nrows - 1) / r->hdr.chunk_rows;
  int64_t out_rowbytes = r->hdr.ncols * itemsize(out_dtype);
  auto* o = static_cast<uint8_t*>(out);
  int64_t nchunks = c1 - c0 + 1;
  int nthreads = std::max(1, std::min<int>({threads, 64,
                                            static_cast<int>(nchunks)}));
  if (nthreads == 1) {
    for (int64_t c = c0; c <= c1; ++c) {
      int rc = read_one_chunk(r, c, row_start, nrows, o, out_dtype,
                              out_rowbytes, verify != 0);
      if (rc != 0) return rc;
    }
    return 0;
  }
  std::atomic<int64_t> next{c0};
  std::atomic<int> first_err{0};
  auto work = [&] {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c > c1 || first_err.load(std::memory_order_relaxed) != 0) return;
      int rc = read_one_chunk(r, c, row_start, nrows, o, out_dtype,
                              out_rowbytes, verify != 0);
      if (rc != 0) {
        int expected = 0;
        first_err.compare_exchange_strong(expected, rc);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return first_err.load();
}

void mcs_close(void* handle) {
  auto* r = static_cast<McsReader*>(handle);
  if (!r) return;
  if (r->map) ::munmap(const_cast<uint8_t*>(r->map), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

// ----------------------------------------------------------- text converter
// Transcode the row-text format ("rowIdx:v,v,...") into a chunk file —
// the mc_write converter reusing the textio parser (parse_common.h). Rows
// must be contiguous and in order (0..m-1) with rectangular width, the
// same contract as the streaming text iterator (io/text.py
// iter_matrix_file_chunks): the chunk container is row-major by
// construction, so a gapped/shuffled file must go through the buffering
// loader first. A partial output file is unlinked on failure — a torn
// sidecar must never shadow its source.
int mcs_from_text(const char* src, const char* dst, int64_t chunk_rows,
                  int32_t dtype, int64_t* out_rows, int64_t* out_cols) {
  FileBuf buf;
  if (int rc = buf.read(src); rc != 0) return rc;
  int32_t werr = 0;
  void* w = nullptr;
  std::vector<double> rowbuf;
  int64_t ncols = -1, row = 0;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  int rc = 0;
  while (p < end && rc == 0) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* colon =
        static_cast<const char*>(std::memchr(p, ':', line_end - p));
    if (!colon) {
      for (const char* q = p; q < line_end; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') {
          rc = -EINVAL;
          break;
        }
      }
    } else {
      char* after = nullptr;
      long long ridx = std::strtoll(p, &after, 10);
      if (after == p || !after || after > colon || ridx != row) {
        rc = -EINVAL;  // non-contiguous/out-of-order rows: see docstring
        break;
      }
      int64_t j = 0;
      const char* q = colon + 1;
      while (q < line_end) {
        q = skip_seps(q, line_end);
        if (q >= line_end) break;
        double v;
        const char* next = parse_value(q, line_end, &v);
        if (!next) {
          rc = -EINVAL;
          break;
        }
        if (ncols < 0)
          rowbuf.push_back(v);
        else if (j < ncols)
          rowbuf[j] = v;
        ++j;
        q = next;
      }
      if (rc != 0) break;
      if (ncols < 0) {
        ncols = j;
        if (ncols == 0) {
          rc = -EINVAL;
          break;
        }
        w = mcs_writer_open(dst, dtype, ncols, chunk_rows, &werr);
        if (!w) {
          rc = werr;
          break;
        }
      }
      if (j != ncols) {
        rc = -EINVAL;  // ragged row: rectangular contract
        break;
      }
      rc = mcs_writer_append(w, rowbuf.data(), 1, kF64);
      ++row;
    }
    p = line_end + 1;
  }
  if (rc == 0 && w == nullptr) rc = -EINVAL;  // empty file: nothing to store
  if (rc == 0) rc = mcs_writer_close(w);
  else if (w) mcs_writer_abort(w);
  if (rc != 0) std::remove(dst);
  else {
    *out_rows = row;
    *out_cols = ncols;
  }
  return rc;
}

}  // extern "C"
