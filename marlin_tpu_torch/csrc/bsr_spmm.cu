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
// Design for this card:
// - One thread block owns one output tile: BM rows of one block row by BN
//   columns of p. Every output element has one writer, so there are no atomics
//   and a run gives the same bits every time. The grid is 1-D over
//   (block rows x row tiles x column tiles), column tiles fastest, so it has no
//   65535 cap on the number of block rows.
// - The tile loops over its block row's stored blocks, [row_ptr[r],
//   row_ptr[r+1]) (the wrapper builds row_ptr from the sorted block rows). The
//   TPU's resident output tile becomes the registers of that loop. A block row
//   with no block runs the loop zero times and writes zeros: no mask pass.
// - Within a block, the bs-deep product steps in BK slices: the block's
//   (BM x BK) slice, stored k-major with padded rows, and the B panel's (BK x BN)
//   slice are staged in shared memory as f32, and each thread does BK rank-1
//   updates of its 8 x 8 register block with plain f32 FMA (no TF32), as
//   csrc/gemm.cu does.
// - The TPU kernel's panel-reuse bookkeeping has no counterpart: the tiles of
//   every block row run at once on 132 SMs, in no order, so "the previous
//   block" does not exist across blocks; a B panel that several tiles read is
//   served from the 50 MB L2 instead (all of B, 33.6 MB at the main shape, fits).
// - Ragged edges are masked here: a block row past m, a block column past n (B
//   rows past n read as zero, as the TPU wrapper's zero padding of B gives),
//   p not a multiple of BN, and bs not a multiple of BM or BK. No padded copy of
//   B is made.
// - Every global offset is 64-bit: nnzb * bs^2 passes 2^31 at 10^5 blocks of
//   128^2.
// - bf16 operands are widened to f32 on their way into shared memory; the
//   output is written in the operand type.
//
// Bound on an H100 SXM (NVIDIA data sheet, 700 W): 2 * nnzb * bs^2 * p
// operations at 67 TFLOP/s of f32 outside the tensor cores; at the main shape
// (nnzb 3276, bs 128, p 256) 27.48 GFLOP, 0.410 ms, against 0.084 ms for its
// 282 MB of bytes at 3.35 TB/s, so it is bound by operations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;    // outputs per thread along the block's rows
constexpr int TN = 8;    // outputs per thread along p
constexpr int BN = 128;  // columns of p per tile
constexpr int APAD = 4;  // row padding of the k-major block slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Threads per block, and blocks per SM the register budget must allow: 512
// threads per SM cap a thread at 128 registers, as in csrc/gemm.cu (left
// free, ptxas took 143 and an SM held one block fewer).
template <int BM>
constexpr int kThreads = (BM / TM) * (BN / TN);
template <int BM>
constexpr int kMinBlocks = 512 / kThreads<BM>;

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

}  // extern "C"
