// Block-sparse (BSR) times dense, out = bsr @ b, hand-written for Hopper
// (sm_90a).
//
// Replaces: marlin_tpu/ops/sparse_bsr.py `_bsr_pallas_kernel` (reached through
// `bsr_spmm_pallas`). There the grid walks the stored blocks one at a time, in
// block-row order; the output tile of the current block row stays resident in
// VMEM while consecutive blocks share that row, the B panel of each block is
// fetched by a hand-made double-buffered DMA, `copy_of`/`slot_of` skip the copy
// when two consecutive blocks share a block column, and a final `jnp.where`
// zeroes the block rows no block visited.
//
// Common to both instances below:
// - One thread block owns one output tile: BM rows of one block row by BN
//   columns of p. Every output element has one writer, so there are no atomics
//   and a run gives the same bits every time. The grid is 1-D over
//   (block rows x row tiles x column tiles), column tiles fastest (the tiles
//   that read the same blocks run together and share them in the L2), so it
//   has no 65535 cap on the number of block rows.
// - The tile loops over its block row's stored blocks, [row_ptr[r],
//   row_ptr[r+1]) (the wrapper builds row_ptr from the sorted block rows). The
//   TPU's resident output tile becomes the registers of that loop. A block row
//   with no block runs the loop zero times and writes zeros: no mask pass.
// - The TPU kernel's panel-reuse bookkeeping has no counterpart: the tiles of
//   every block row run at once on 132 SMs, in no order, so "the previous
//   block" does not exist across blocks; a B panel that several tiles read is
//   served from the 50 MB L2 instead.
// - Every global offset is 64-bit: nnzb * bs^2 passes 2^31 at 10^5 blocks of
//   128^2. The output is written in the operand type, the ragged edge masked.
//
// The tensor-core instance (`bsr_tc_kernel`), for block sizes that are
// multiples of 64 (bs 128 is the main path and `block_size`'s default):
// - Bound on an H100 SXM (NVIDIA data sheet, 700 W): 2 * nnzb * bs^2 * p
//   operations. f32 at f32 accuracy runs as three TF32 products (3xTF32) at
//   495 / 3 = 165 TFLOP/s: 0.167 ms at the main shape (nnzb 3276, bs 128, p
//   256, 27.48 GFLOP), against 0.084 ms for its 282 MB of bytes at 3.35 TB/s;
//   bf16 in one pass at 989 TFLOP/s, 0.028 ms.
// - B goes through the GEMM's pre-pass (gemm.cu `marlin_gemm_prep`, A skipped):
//   B transposed into K-major rows, f32 values as their TF32 halves side by
//   side in blocks of 16 values of k. A (the blocks) is read as it is: the
//   blocks are K-major already, and splitting them ahead would move more
//   bytes than the whole product's bound.
// - Warp specialisation as in gemm.cu (helpers in wgmma.cuh): one producer
//   thread walks [row_ptr[r], row_ptr[r+1]) x bs / K stages and issues TMA
//   into a ring of 128-byte-swizzled stages guarded by mbarriers: A's slice
//   of the block, seen as a 2-D (nnzb * bs, bs) tensor, at (blk * bs + row0,
//   k0), and Bt's slice at (col0, bcols[blk] * bs + k0). TMA's zero fill
//   covers ragged n and p. BM / 64 consumer warpgroups own 64 rows each. A
//   tile is 128 (or 64, for bs not a multiple of 128) rows by 128 columns,
//   or 64 where the grid would leave SMs idle; f32 at 128 rows takes 64
//   columns, since 128 would spill (dispatch_tc).
// - f32 (K = 32 values a stage): a consumer reads its raw f32 A fragment of
//   each 8-value k slice from the swizzled stage, splits it into TF32 halves
//   in registers, and issues wgmma m64nBNk8 with A from registers three
//   times, the small terms first (lo.hi, hi.lo, hi.hi), B's halves by
//   descriptor, and waits for them before loading the next slice's
//   fragment (two fragments in flight were no faster, and their registers
//   spilled the 128 x 128 instance); the other consumer warpgroup's
//   products fill the gap. bf16 (K = 64): A and B by descriptor, m64nBNk16
//   once a 16-value slice, a stage's products running while the next
//   stage's are issued.
// - Accumulation: the wgmma accumulator restarts from zero every kFlush
//   stages (128 values of k for f32, 512 for bf16) and is added into IEEE f32
//   registers, as in gemm.cu (the tensor cores' sums drift over long k). The
//   consumers walk the stages in groups of kFlush, so no wait on the
//   products sits on a data-dependent branch: ptxas then inserts none of its
//   own (in gemm.cu it does, and serialises the products).
//
// The SIMT instance (`bsr_spmm_kernel`), for every other block size:
// - Within a block, the bs-deep product steps in BK slices: the block's
//   (BM x BK) slice, stored k-major with padded rows, and the B panel's (BK x
//   BN) slice are staged in shared memory as f32, and each thread does BK
//   rank-1 updates of its 8 x 8 register block with plain f32 FMA (no TF32).
//   Ragged edges are masked by the loads (B rows past n read as zero).
// - Bound: the same operations at 67 TFLOP/s of f32 outside the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

// ------------------------------------------------------- SIMT instance

constexpr int TM = 8;    // outputs per thread along the block's rows
constexpr int TN = 8;    // outputs per thread along p
constexpr int BN = 128;  // columns of p per tile
constexpr int APAD = 4;  // row padding of the k-major block slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Threads per block, and blocks per SM the register budget must allow: 384
// threads per SM leave a thread 170 registers (at 512 threads, 128, ptxas
// spilled 32 bytes of the 64-row instance).
template <int BM>
constexpr int kThreads = (BM / TM) * (BN / TN);
template <int BM>
constexpr int kMinBlocks = 384 / kThreads<BM>;

template <typename T, int BM, int BK>
__global__ void __launch_bounds__(kThreads<BM>, kMinBlocks<BM>)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                const int64_t* __restrict__ row_ptr, const T* __restrict__ b,
                T* __restrict__ out, int64_t m, int64_t n, int64_t p, int bs,
                unsigned row_tiles, unsigned col_tiles) {
  constexpr int NT = kThreads<BM>;
  constexpr int TX = BN / TN;  // threads along p
  static_assert((BM * BK) % NT == 0, "block slice must split evenly over threads");
  static_assert((BK * BN) % NT == 0, "B slice must split evenly over threads");

  __shared__ __align__(16) float As[BK][BM + APAD];  // k-major block slice
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const unsigned col_tile = blockIdx.x % col_tiles;
  const unsigned rest = blockIdx.x / col_tiles;
  const int row0 = (int)(rest % row_tiles) * BM;  // first row within the block
  const int64_t brow = rest / row_tiles;
  const int64_t col0 = (int64_t)col_tile * BN;
  const int64_t bs2 = (int64_t)bs * bs;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int64_t first = row_ptr[brow];
  const int64_t last = row_ptr[brow + 1];
  for (int64_t blk = first; blk < last; ++blk) {
    const T* a = blocks + blk * bs2;
    const int64_t brow0 = (int64_t)bcols[blk] * bs;  // first row of B's panel
    for (int k0 = 0; k0 < bs; k0 += BK) {
      // block slice: element e -> (r, kk); consecutive threads walk along k,
      // which is contiguous in the block
#pragma unroll
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = row0 + e / BK;
        const int kk = k0 + e % BK;
        float v = 0.0f;
        if (r < bs && kk < bs) v = to_f32(a[(int64_t)r * bs + kk]);
        As[e % BK][e / BK] = v;
      }
      // B slice: element e -> (kk, cc); consecutive threads walk along p
#pragma unroll
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN;
        const int cc = e % BN;
        const int64_t gk = brow0 + k0 + kk;
        const int64_t gc = col0 + cc;
        float v = 0.0f;
        if (k0 + kk < bs && gk < n && gc < p) v = to_f32(b[gk * p + gc]);
        Bs[kk][cc] = v;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
        const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
        const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
        av[0] = a_lo.x; av[1] = a_lo.y; av[2] = a_lo.z; av[3] = a_lo.w;
        av[4] = a_hi.x; av[5] = a_hi.y; av[6] = a_hi.z; av[7] = a_hi.w;
        bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
        bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    const int64_t gr = brow * bs + r;
    if (r >= bs || gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (gc < p) from_f32(&out[gr * p + gc], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BK>
cudaError_t launch(const void* blocks, const int* bcols, const int64_t* row_ptr,
                   const void* b, void* out, int64_t m, int64_t n, int64_t p,
                   int bs, int64_t n_block_rows, cudaStream_t stream) {
  const int64_t row_tiles = (bs + BM - 1) / BM;
  const int64_t col_tiles = (p + BN - 1) / BN;
  const int64_t tiles = n_block_rows * row_tiles * col_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  bsr_spmm_kernel<T, BM, BK><<<(unsigned)tiles, kThreads<BM>, 0, stream>>>(
      static_cast<const T*>(blocks), bcols, row_ptr, static_cast<const T*>(b),
      static_cast<T*>(out), m, n, p, bs, (unsigned)row_tiles,
      (unsigned)col_tiles);
  return cudaGetLastError();
}

// The tile's rows follow the block size, so that small blocks do not leave
// most of a 64-row tile idle: bs <= 16 -> 16 rows, <= 32 -> 32, else 64.
template <typename T>
cudaError_t dispatch(const void* blocks, const int* bcols, const int64_t* row_ptr,
                     const void* b, void* out, int64_t m, int64_t n, int64_t p,
                     int bs, int64_t n_block_rows, cudaStream_t s) {
  if (bs <= 16)
    return launch<T, 16, 16>(blocks, bcols, row_ptr, b, out, m, n, p, bs, n_block_rows, s);
  if (bs <= 32)
    return launch<T, 32, 32>(blocks, bcols, row_ptr, b, out, m, n, p, bs, n_block_rows, s);
  return launch<T, 64, 32>(blocks, bcols, row_ptr, b, out, m, n, p, bs, n_block_rows, s);
}


// ------------------------------------------------ tensor-core instance

constexpr int kSmemBudget = 232448;  // dynamic shared memory of one block
constexpr int kMaxStages = 8;
constexpr int kSmemReserve = 1024 + 16 * kMaxStages;  // alignment + mbarriers

template <typename T, int BM, int BN>
struct TcCfg {
  static constexpr bool kSplit = sizeof(T) == 4;  // f32: 3xTF32, A split in registers
  static constexpr int kConsumers = BM / 64;      // warpgroups of 64 rows
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // as in gemm.cu: setmaxnreg moves registers only within the block's own
  // allocation, so only the 384-thread instances rebalance
  static constexpr bool kRebalance = kConsumers == 2;
  // values of k a stage: one 128-byte row of A (32 f32 or 64 bf16); f32 B
  // rows hold 16 values with their halves, so two 128-byte boxes of B
  static constexpr int kK = kSplit ? 32 : 64;
  static constexpr int kSlices = kSplit ? kK / 8 : kK / 16;  // wgmma k steps
  static constexpr int kATile = BM * 128;
  static constexpr int kBBox = BN * 128;
  static constexpr int kBTile = (kSplit ? 2 : 1) * kBBox;
  static constexpr int kStageBytes = kATile + kBTile;
  // stages one wgmma accumulator sums before it is added into the f32 one:
  // 128 values of k for f32 (as gemm.cu), 512 for bf16
  static constexpr int kFlush = kSplit ? 4 : 8;
  static constexpr int kFit = (kSmemBudget - kSmemReserve) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kSmemReserve + kStages * kStageBytes;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "wgmma widths with a wrapper in wgmma.cuh");
  static_assert(kATile % 1024 == 0 && kBBox % 1024 == 0, "tiles keep swizzle alignment");
  static_assert(kStages >= 3, "two stages in a consumer's hands and one loading");
};

struct TcMaps {
  CUtensorMap a, b;  // a: blocks as (nnzb * bs, bs); b: Bt (p, K-major rows)
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The A fragment of k slice j (values 8 j .. 8 j + 7 of the stage) for rows
// r and r + 8 of a [rows][32 x 4 bytes] tile stored with TMA's 128-byte
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)), split into
// its TF32 halves. row = the tile + 128 r + 4 t, g16 = (r % 8) * 16: values
// 8 j + t and 8 j + t + 4 lie in chunks 2 j and 2 j + 1. g16 is made opaque
// here, so the compiler forms each offset where it loads instead of holding
// all eight across the loop (registers the 128 x 128 f32 instance lacks).
__device__ __forceinline__ void load_a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t row,
                                            uint32_t g16, int j) {
  asm volatile("" : "+r"(g16));
  const uint32_t c0 = (32u * j) ^ g16, c1 = (32u * j + 16u) ^ g16;
  uint32_t x[4];
  x[0] = lds32(row + c0);
  x[1] = lds32(row + 1024 + c0);  // row r + 8
  x[2] = lds32(row + c1);
  x[3] = lds32(row + 1024 + c1);
  const tc::Split<4> sp = tc::split_tf32(x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = sp.big[i];
    lo[i] = sp.small[i];
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TcCfg<T, BM, BN>::kThreads, 1)
bsr_tc_kernel(const __grid_constant__ TcMaps maps, const int* __restrict__ bcols,
              const int64_t* __restrict__ row_ptr, T* __restrict__ out, int64_t m, int64_t p,
              int bs, unsigned row_tiles, unsigned col_tiles) {
  using C = TcCfg<T, BM, BN>;
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

  const unsigned col_tile = blockIdx.x % col_tiles;
  const unsigned rest = blockIdx.x / col_tiles;
  const int row0 = (int)(rest % row_tiles) * BM;  // first row within the block
  const int64_t brow = rest / row_tiles;
  const int col0 = (int)col_tile * BN;
  const int64_t first = row_ptr[brow];
  const int64_t last = row_ptr[brow + 1];
  const int per_block = bs / C::kK;
  const int stages = (int)(last - first) * per_block;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (C::kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int64_t blk = first; blk < last; ++blk) {
      const int arow = (int)(blk * bs) + row0;
      const int kb = bcols[blk] * bs;  // B's first value of k for this block
      for (int kc = 0; kc < bs; kc += C::kK) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), C::kStageBytes);
        const uint32_t st = base + s * C::kStageBytes;
        tma_load(st, &maps.a, full(s), kc, arow);
        if constexpr (C::kSplit) {  // 16 values and their halves a box
          tma_load(st + C::kATile, &maps.b, full(s), 2 * (kb + kc), col0);
          tma_load(st + C::kATile + C::kBBox, &maps.b, full(s), 2 * (kb + kc) + 32, col0);
        } else {
          tma_load(st + C::kATile, &maps.b, full(s), kb + kc, col0);
        }
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  if constexpr (C::kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  // a product completes for the whole warpgroup at once, so one thread
  // releases its slot
  const bool signals = threadIdx.x % 128 == 0;
  float acc[BN / 2], d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.0f;
    d[i] = 0.0f;
  }
  int s = 0;
  uint32_t phase = 0;
  int pending = -1;  // bf16: the slot whose products may still be running
  uint32_t hi[4], lo[4];  // f32: a k slice's A fragment, split
  const int ar = cw * 64 + warp * 16 + g;  // the thread's rows ar, ar + 8
  // groups of kFlush stages: each sums into d from zero, then into acc
  for (int g0 = 0; g0 < stages; g0 += C::kFlush) {
    const int ng = min(C::kFlush, stages - g0);
    for (int k = 0; k < ng; ++k) {
      mbar_wait(full(s), phase);
      const uint32_t st = base + s * C::kStageBytes;
      const bool zero = k == 0;
      if constexpr (C::kSplit) {
#pragma unroll
        for (int j = 0; j < C::kSlices; ++j) {
          load_a_frag(hi, lo, st + ar * 128 + 4 * t, g * 16, j);
          fence_frag(hi);
          fence_frag(lo);
          wgmma_fence();
          const uint32_t bb = st + C::kATile + (j >> 1) * C::kBBox + 32 * (j & 1);
          // the small terms first
          wgmma_tf32_rs(d, lo, smem_desc(bb), j > 0 || !zero);
          wgmma_tf32_rs(d, hi, smem_desc(bb + 64), 1);
          wgmma_tf32_rs(d, hi, smem_desc(bb), 1);
          wgmma_commit();
          // the fragment is read until the products are done; the other
          // consumer warpgroup's products keep the tensor cores busy
          // while this one loads the next
          wgmma_wait<0>();
          fence_frag(hi);
          fence_frag(lo);
        }
        if (signals) mbar_arrive(empty(s));  // the stage's products are done
      } else {
        wgmma_fence();
        const uint32_t a = st + cw * 64 * 128;
#pragma unroll
        for (int j = 0; j < C::kSlices; ++j)
          wgmma_bf16(d, smem_desc(a + 32 * j), smem_desc(st + C::kATile + 32 * j),
                     j > 0 || !zero);
        wgmma_commit();
        if (k > 0) {  // the previous stage's products are done
          wgmma_wait<1>();
          if (signals) mbar_arrive(empty(pending));
        }
        pending = s;
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if constexpr (!C::kSplit)
      if (signals) mbar_arrive(empty(pending));
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
  }
  // accumulator (row g or g + 8 of the warp's 16, columns 8j + 2t, +1)
  const int64_t row = brow * bs + row0 + ar;
  const int64_t c0 = (int64_t)col0 + 2 * t;
  const bool pairs = (p % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int64_t col = c0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row + 8 * h;
      if (r >= m || col >= p) continue;
      T* o = out + r * p + col;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (pairs) {
        store2(o, x, y);
      } else {
        store1(o, x);
        if (col + 1 < p) store1(o + 1, y);
      }
    }
  }
}

template <typename T, int BM, int BN>
cudaError_t launch_tc(const void* blocks, const int* bcols, const int64_t* row_ptr,
                      const void* bt_k, void* out, int64_t m, int64_t p, int64_t ks, int bs,
                      int64_t nnzb, int64_t n_block_rows, cudaStream_t stream) {
  using C = TcCfg<T, BM, BN>;
  const int64_t w = C::kSplit ? 2 * ks : ks;
  // TMA coordinates are 32-bit
  if (nnzb * bs > 2147483647LL || w > 2147483647LL || p > 2147483647LL)
    return cudaErrorInvalidValue;
  TcMaps maps;
  cudaError_t err;
  if ((err = make_map<T>(&maps.a, blocks, nnzb * bs, bs, BM)) != cudaSuccess) return err;
  if ((err = make_map<T>(&maps.b, bt_k, p, w, BN)) != cudaSuccess) return err;
  auto kern = bsr_tc_kernel<T, BM, BN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t row_tiles = bs / BM;
  const int64_t col_tiles = (p + BN - 1) / BN;
  const int64_t tiles = n_block_rows * row_tiles * col_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)tiles, C::kThreads, C::kSmem, stream>>>(
      maps, bcols, row_ptr, static_cast<T*>(out), m, p, bs, (unsigned)row_tiles,
      (unsigned)col_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tc(int bm, int bn, const void* blocks, const int* bcols,
                        const int64_t* row_ptr, const void* bt_k, void* out, int64_t m,
                        int64_t p, int64_t ks, int bs, int64_t nnzb, int64_t n_block_rows,
                        cudaStream_t s) {
  if (bs % bm != 0) return cudaErrorInvalidValue;
#define MARLIN_BSR_TILE(BM_, BN_)                                                     \
  if (bm == BM_ && bn == BN_)                                                         \
    return launch_tc<T, BM_, BN_>(blocks, bcols, row_ptr, bt_k, out, m, p, ks, bs, nnzb, \
                                  n_block_rows, s);
  MARLIN_BSR_TILE(64, 64)
  MARLIN_BSR_TILE(64, 128)
  MARLIN_BSR_TILE(128, 64)
  // f32 at 128 x 128 needs more than the 168 registers a thread of a
  // 384-thread block holds (its A fragments beside the 2 x 64 accumulators)
  // and spills: f32 takes 128 x 64
  if constexpr (sizeof(T) == 2) {
    MARLIN_BSR_TILE(128, 128)
  }
#undef MARLIN_BSR_TILE
  return cudaErrorInvalidValue;  // not an instantiated tile
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for blocks, b and out alike. blocks
// (nnzb, bs, bs) sorted by block row, bcols (nnzb,) int32, row_ptr
// (n_block_rows + 1,) int64 offsets into the blocks, b (n, p), out (m, p); all
// contiguous, on the stream's device. Returns the launch's cudaError_t.
int marlin_bsr_spmm(int dtype, const void* blocks, const void* bcols,
                    const void* row_ptr, const void* b, void* out, long long m,
                    long long n, long long p, int bs, long long n_block_rows,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 1 || n_block_rows < 1 || p < 1) return (int)cudaErrorInvalidValue;
  const int* bc = static_cast<const int*>(bcols);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  if (dtype == 0)
    return (int)dispatch<float>(blocks, bc, rp, b, out, m, n, p, bs, n_block_rows, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(blocks, bc, rp, b, out, m, n, p, bs, n_block_rows, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core instance, tile (bm, bn) = ({64, 128}, {64, 128}) but f32
// 128 x 128, bs a multiple of bm. dtype as above; blocks (nnzb, bs, bs) sorted by block row
// and 16-byte aligned; bt_k the GEMM pre-pass's K-major Bt (p rows of 2 ks
// floats for f32, ks bf16 values for bf16; ks = n rounded up as
// `marlin_gemm_prep` takes it); out (m, p). Returns the launch's cudaError_t.
int marlin_bsr_spmm_tc(int dtype, int bm, int bn, const void* blocks, const void* bcols,
                       const void* row_ptr, const void* bt_k, void* out, long long m,
                       long long p, long long ks, int bs, long long nnzb,
                       long long n_block_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs < 64 || bs % 64 != 0 || nnzb < 1 || n_block_rows < 1 || p < 1)
    return (int)cudaErrorInvalidValue;
  const int* bc = static_cast<const int*>(bcols);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  if (dtype == 0)
    return (int)dispatch_tc<float>(bm, bn, blocks, bc, rp, bt_k, out, m, p, ks, bs, nnzb,
                                   n_block_rows, s);
  if (dtype == 1)
    return (int)dispatch_tc<__nv_bfloat16>(bm, bn, blocks, bc, rp, bt_k, out, m, p, ks, bs,
                                           nnzb, n_block_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
