// f32-accurate GEMM on Hopper's tensor cores, c = a @ b, hand-written for
// sm_90a.
//
// Replaces: marlin_tpu/ops/pallas_kernels.py `_matmul_kernel` (reached through
// `pallas_matmul`), a Pallas TPU kernel over the grid (m/bm, n/bn, k/bk) that
// carries an f32 accumulator in VMEM scratch across the sequential k axis and
// pads its operands up to the tile grid.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): f32 at f32 accuracy goes
// through the tensor cores as three TF32 products (3xTF32) at 495 / 3 = 165
// TFLOP/s, 97.0 ms at 20000^3 (67 TFLOP/s of f32 outside the tensor cores
// would take 238.8 ms); bf16 in one pass at 989 TFLOP/s, 16.2 ms.
//
// Design:
// - A pre-pass (`prep_kernel`, one launch) brings both operands into the
//   K-major layout TF32 wgmma reads (its only layout for 32-bit types): A as
//   it is, B transposed through shared memory, rows padded with zeros. For
//   f32 it writes every value as two TF32 halves, hi = tf32_rna(x) and lo =
//   tf32_rna(x - hi) (tensor_core.cuh), side by side in blocks of 16 values
//   of k (64 bytes of hi, then 64 of lo), so one 128-byte row of a stage
//   holds both halves and the main loop does no conversion. bf16 has no
//   split: B is transposed, and A is copied only where its rows are not
//   16-byte aligned (TMA's rule for a global stride). The wrapper allocates
//   this scratch.
// - The main kernel is persistent (one block per SM: each takes more than
//   half of an SM's shared memory) and walks the BM x BN output tiles in a
//   grouped raster (GROUP tile rows at a time), so concurrent blocks share A
//   and B panels in the 50 MB L2. No grid dimension caps the tile count. A
//   block starts its next tile once every block has issued the loads of its
//   last one: blocks left to drift apart fell out of each other's L2 reuse
//   and ran at DRAM speed, 2x slower (an atomic counter; the launch is
//   cooperative, so all blocks are resident).
// - Warp specialisation: warpgroup 0 is the producer, one of its threads
//   keeps TMA loads in flight into a ring of kStages shared-memory stages
//   guarded by full/empty mbarriers. A stage holds 128 bytes of each row of
//   the A and B tiles (16 f32 values of k with their lo halves, or 64 bf16),
//   stored with TMA's 128-byte swizzle, which is also the wgmma
//   descriptor's layout. Warpgroups 1 .. BM/64 are the consumers, 64 output
//   rows each: per k slice (8 TF32 or 16 bf16 values, 32 bytes of a row; the
//   descriptor advances 32 bytes inside the swizzled row) they issue wgmma
//   m64nBNk8 three times (lo.hi, hi.lo, hi.hi, the small terms first) for
//   f32, or m64nBNk16 once for bf16. A stage's products run while the
//   consumer waits for the previous stage's and releases that slot (one
//   arrival a warpgroup). With two consumers `setmaxnreg` moves registers
//   from the producer to them.
// - Accumulation: the tensor cores do not round their sums to nearest; a
//   long k in one accumulator drifts (a 32768-term sum reached 5.2x the f32
//   error bound in the flash backward). So the wgmma accumulator restarts
//   from zero every kFlush stages (128 values of k for f32) and is added
//   into an IEEE f32 register accumulator: BN/2 + BN/2 floats a consumer
//   thread.
// - The epilogue stores from registers, masks the ragged edge, writes
//   a.dtype, with 64-bit offsets. No atomics in the sums: the same bits
//   every run.
//
// The instantiated (BM, BN, BK) tiles are the tile family that
// marlin_tpu_torch/ops/tile_family.py proposes, and kMaxStages /
// kSmemReserve its shared-memory model; keep the two in step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"  // the TMA, mbarrier, descriptor and wgmma helpers

namespace {

using namespace wg;

constexpr int kSmemBudget = 232448;  // dynamic shared memory of one block
constexpr int kMaxStages = 16;
constexpr int kSmemReserve = 1024 + 16 * kMaxStages;  // alignment + mbarriers
constexpr int GROUP = 8;  // tile rows of the grouped raster
constexpr int PT = 32;    // pre-pass tile edge

// ------------------------------------------------------------- pre-pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Value kk of a K-major row: f32 keeps its TF32 halves in blocks of 16 values
// of k, hi then lo, so one 128-byte row of a stage holds both halves of 16
// values; bf16 stores the value itself.
__device__ __forceinline__ void put(float* row, int64_t kk, float x) {
  const float h = __uint_as_float(tc::tf32_rna(x));
  float* p = row + (kk / 16) * 32 + kk % 16;
  p[0] = h;
  p[16] = __uint_as_float(tc::tf32_rna(x - h));
}
__device__ __forceinline__ void put(__nv_bfloat16* row, int64_t kk, float x) {
  row[kk] = __float2bfloat16_rn(x);  // exact: x came from a bf16
}

// Blocks [0, a_blocks) write A (m x k) into a_k (m rows of w), PT x PT at a
// time; the rest write B (k x n) transposed into bt_k (n rows of w) through a
// shared tile. w = 2 ks for f32, ks for bf16; values k .. ks - 1 are zeros.
// 32 x 8 threads.
template <typename T>
__global__ void __launch_bounds__(256)
prep_kernel(const T* __restrict__ a, const T* __restrict__ b, T* a_k, T* bt_k, int64_t m,
            int64_t n, int64_t k, int64_t ks, int64_t a_blocks) {
  __shared__ float tile[PT][PT + 1];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t w = sizeof(T) == 4 ? 2 * ks : ks;
  const int64_t tiles_k = (ks + PT - 1) / PT;
  int64_t blk = blockIdx.x;
  if (blk < a_blocks) {
    const int64_t r0 = blk / tiles_k * PT, c = blk % tiles_k * PT + tx;
    for (int i = ty; i < PT; i += 8) {
      const int64_t r = r0 + i;
      if (r < m && c < ks) put(a_k + r * w, c, c < k ? to_f32(a[r * k + c]) : 0.0f);
    }
    return;
  }
  blk -= a_blocks;
  const int64_t tiles_n = (n + PT - 1) / PT;
  const int64_t k0 = blk / tiles_n * PT, n0 = blk % tiles_n * PT;
  for (int i = ty; i < PT; i += 8) {
    const int64_t kk = k0 + i, c = n0 + tx;
    tile[i][tx] = (kk < k && c < n) ? to_f32(b[kk * n + c]) : 0.0f;
  }
  __syncthreads();
  for (int i = ty; i < PT; i += 8) {
    const int64_t c = n0 + i, kk = k0 + tx;
    if (c < n && kk < ks) put(bt_k + c * w, kk, tile[tx][i]);
  }
}

// ---------------------------------------------------------- main kernel

template <typename T, int BM, int BN, int BK>
struct Cfg {
  static constexpr bool kSplit = sizeof(T) == 4;  // f32: hi and lo halves
  static constexpr int kConsumers = BM / 64;      // warpgroups of 64 rows
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // setmaxnreg moves registers only within the block's own allocation: at
  // 384 threads ptxas allots 168 a thread, and the producer's 128 x (168 -
  // 40) cover the consumers' 256 x (232 - 168). One consumer warpgroup keeps
  // ptxas's own count (up to 255).
  static constexpr bool kRebalance = kConsumers == 2;
  // BK counts 4-byte words: a stage holds rows of BK * 4 = 128 bytes, one
  // swizzle span: the hi and lo halves of 16 f32 values of k, or 64 bf16
  static constexpr int kRowBytes = BK * 4;
  static constexpr int kCols = kRowBytes / (int)sizeof(T);  // stored values
  static constexpr int kK = kSplit ? kCols / 2 : kCols;     // values of k
  static constexpr int kSlices = kK * (int)sizeof(T) / 32;  // 32-byte k slices
  // stages summed in one wgmma accumulator before it is added into the f32
  // one: 8 x 16 = 128 values of k in 48 products for f32, 8 x 64 for bf16
  static constexpr int kFlush = 8;
  static constexpr int kATile = BM * kRowBytes;
  static constexpr int kBTile = BN * kRowBytes;
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kFit = (kSmemBudget - kSmemReserve) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kSmemReserve + kStages * kStageBytes;
  static_assert(BM % 64 == 0 && BM <= 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "wgmma widths with a wrapper here");
  static_assert(kRowBytes == 128, "a row is one 128-byte swizzle span");
  static_assert(kATile % 1024 == 0 && kBTile % 1024 == 0, "tiles keep swizzle alignment");
  static_assert(kStages >= 3, "two stages in a consumer's hands and one loading");
  // more than half of an SM's shared memory: never two blocks on one SM, so
  // the persistent grid of one block an SM reaches every SM
  static_assert(2 * kSmem > kSmemBudget, "one block per SM");
};

// one stage's products into d, committed as one wgmma group: a and b are
// the consumer's A rows and the B tile (f32: hi halves at byte 0 of a row,
// lo halves at byte 64)
template <typename C, int BN>
__device__ __forceinline__ void issue_stage(float (&d)[BN / 2], uint32_t a, uint32_t b,
                                            bool zero) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < C::kSlices; ++j) {
    const uint32_t o = 32 * j;
    if constexpr (C::kSplit) {  // the small terms first
      wgmma_tf32(d, smem_desc(a + 64 + o), smem_desc(b + o), j > 0 || !zero);
      wgmma_tf32(d, smem_desc(a + o), smem_desc(b + 64 + o), 1);
      wgmma_tf32(d, smem_desc(a + o), smem_desc(b + o), 1);
    } else {
      wgmma_bf16(d, smem_desc(a + o), smem_desc(b + o), j > 0 || !zero);
    }
  }
  wgmma_commit();
}

struct Maps {
  CUtensorMap a, b;  // b: the transposed (n x k) operand
};

__device__ __forceinline__ void tile_coords(int64_t t, int64_t tiles_m, int64_t tiles_n,
                                            int64_t& tm, int64_t& tn) {
  const int64_t per_group = GROUP * tiles_n;
  const int64_t first = t / per_group * GROUP;
  const int64_t rows = tiles_m - first < GROUP ? tiles_m - first : GROUP;
  const int64_t r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(Cfg<T, BM, BN, BK>::kThreads, 1)
gemm_kernel(const __grid_constant__ Maps maps, T* __restrict__ c, int64_t m, int64_t n,
            int64_t k, int64_t tiles_m, int64_t tiles_n, unsigned* waves) {
  using C = Cfg<T, BM, BN, BK>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle's alignment
  const uint32_t bars = base + S * C::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kConsumers);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t tiles = tiles_m * tiles_n;
  const int k_tiles = (int)((k + C::kK - 1) / C::kK);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (C::kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t phase = 0;
    int64_t wave = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++wave) {
      // Every block starts wave w's tile once all have issued wave w - 1's
      // loads (a full wave: this one exists). Blocks that share A and B
      // panels then stream them through the L2 together; left to drift
      // apart, they fell out of the L2 and ran at DRAM speed.
      if (wave > 0) {
        const int64_t target = wave * gridDim.x;
        while ((int64_t)*reinterpret_cast<volatile unsigned*>(waves) < target)
          __nanosleep(128);
      }
      int64_t tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
      const int row_a = (int)(tm * BM), row_b = (int)(tn * BN);
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), C::kStageBytes);
        const uint32_t st = base + s * C::kStageBytes;
        tma_load(st, &maps.a, full(s), kt * C::kCols, row_a);
        tma_load(st + C::kATile, &maps.b, full(s), kt * C::kCols, row_b);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      atomicAdd(waves, 1u);
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (C::kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    // a product completes for the whole warpgroup at once, so one thread
    // releases its slot
    const bool signals = threadIdx.x % 128 == 0;
    // Each stage's products run into d while the previous stage's finish;
    // every kFlush stages d is added into acc and restarted from zero.
    float acc[BN / 2], d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    int s = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      int64_t tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int pending = -1;  // the slot whose products may still be running
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full(s), phase);
        const uint32_t st = base + s * C::kStageBytes;
        issue_stage<C, BN>(d, st + cw * 64 * C::kRowBytes, st + C::kATile,
                           kt % C::kFlush == 0);
        if (pending >= 0) {
          wgmma_wait<1>();
          if (signals) mbar_arrive(empty(pending));
        }
        pending = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
        if ((kt + 1) % C::kFlush == 0 || kt + 1 == k_tiles) {
          wgmma_wait<0>();
          if (signals) mbar_arrive(empty(pending));
          pending = -1;
          fence_regs(d);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
        }
      }
      // accumulator (row g or g + 8 of the warp's 16, columns 8j + 2q, +1)
      const int64_t row = tm * BM + cw * 64 + warp * 16 + lane / 4;
      const int64_t col0 = tn * BN + 2 * (lane % 4);
      const bool pairs = (n % 2) == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int64_t col = col0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t r = row + 8 * h;
          if (r >= m || col >= n) continue;
          T* p = c + r * n + col;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          if (pairs) {
            store2(p, x, y);
          } else {
            store1(p, x);
            if (col + 1 < n) store1(p + 1, y);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* a_k, const void* bt_k, void* c, int64_t m, int64_t n, int64_t k,
                   int64_t ks, unsigned* waves, cudaStream_t stream) {
  using C = Cfg<T, BM, BN, BK>;
  const int64_t w = C::kSplit ? 2 * ks : ks;
  Maps maps;
  cudaError_t err;
  if ((err = make_map<T>(&maps.a, a_k, m, w, BM)) != cudaSuccess) return err;
  if ((err = make_map<T>(&maps.b, bt_k, n, w, BN)) != cudaSuccess) return err;
  auto kern = gemm_kernel<T, BM, BN, BK>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = tiles_m * tiles_n;
  // TMA coordinates are 32-bit
  if (m > 2147483647LL || n > 2147483647LL || w > 2147483647LL) return cudaErrorInvalidValue;
  // a cooperative launch: every block resident at once, which the wave
  // barrier needs (the launch fails rather than deadlock)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles < sms ? tiles : sms));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, maps, static_cast<T*>(c), m, n, k, tiles_m, tiles_n,
                            waves);
}

template <typename T>
cudaError_t dispatch(int bm, int bn, int bk, const void* a_k, const void* bt_k, void* c,
                     int64_t m, int64_t n, int64_t k, int64_t ks, unsigned* waves,
                     cudaStream_t s) {
#define MARLIN_TILE(BM_, BN_, BK_)        \
  if (bm == BM_ && bn == BN_ && bk == BK_) \
    return launch<T, BM_, BN_, BK_>(a_k, bt_k, c, m, n, k, ks, waves, s);
  MARLIN_TILE(64, 64, 32)
  MARLIN_TILE(64, 128, 32)
  MARLIN_TILE(128, 64, 32)
  MARLIN_TILE(128, 128, 32)
#undef MARLIN_TILE
  return cudaErrorInvalidValue;  // not an instantiated tile
}

template <typename T>
cudaError_t prep(const void* a, const void* b, void* a_k, void* bt_k, int64_t m, int64_t n,
                 int64_t k, int64_t ks, cudaStream_t s) {
  const int64_t tiles_k = (ks + PT - 1) / PT;
  const int64_t a_blocks = a_k == a ? 0 : (m + PT - 1) / PT * tiles_k;
  const int64_t blocks = a_blocks + tiles_k * ((n + PT - 1) / PT);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  prep_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(a_k),
      static_cast<T*>(bt_k), m, n, k, ks, a_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. a (m, k) and b (k, n) row-major and
// contiguous on the stream's device. Writes the K-major operands the GEMM
// reads: a_k (m rows) and bt_k (n rows, B transposed) of ks values of k, ks =
// k rounded up to 16 values (f32) or 16 bytes (bf16), zeros past k; f32 rows
// hold 2 ks floats, the TF32 halves of each 16 values side by side. For bf16
// a_k == a skips A's copy.
int marlin_gemm_prep(int dtype, const void* a, const void* b, void* a_k, void* bt_k,
                     long long m, long long n, long long k, long long ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)prep<float>(a, b, a_k, bt_k, m, n, k, ks, s);
  if (dtype == 1) return (int)prep<__nv_bfloat16>(a, b, a_k, bt_k, m, n, k, ks, s);
  return (int)cudaErrorInvalidValue;
}

// c (m, n) = a @ b from the pre-pass's operands, tile (bm, bn, bk). Returns
// the launch's cudaError_t (0 on success); cudaErrorInvalidValue for an
// unknown tile.
int marlin_gemm(int dtype, int bm, int bn, int bk, const void* a_k, const void* bt_k, void* c,
                long long m, long long n, long long k, long long ks, void* waves,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* w = static_cast<unsigned*>(waves);
  if (dtype == 0) return (int)dispatch<float>(bm, bn, bk, a_k, bt_k, c, m, n, k, ks, w, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(bm, bn, bk, a_k, bt_k, c, m, n, k, ks, w, s);
  return (int)cudaErrorInvalidValue;
}

const char* marlin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
