// Montgomery product with its two constant convolutions on the int8 tensor
// cores, shared by K4 (mont_mxu.cu) and the fused Fp2 kernels K5/K6
// (fp2_mxu.cu).
//
// Algorithm: the separated-operand product of the JAX package's
// limb.mont_mul, step for step (ops/limb_mxu.py holds its plain version):
//
//   t = a b                      data-dependent: CUDA cores, one row a thread
//   q = (t mod R)(-p^-1) mod R   constant: int8 MMA against a Toeplitz band
//   s = t + q p                  constant: int8 MMA against a Toeplitz band
//   r = s / R, minus p if >= p   CUDA cores, K1's tail
//
// A convolution by a constant c is x @ T_c with T_c[i][k] = c[k - i]. Each
// operand's 24-bit limbs split into 12-bit halves and each half into two
// 6-bit pieces in [0, 63], so the four piece products x0 T0, x0 T1, x1 T0,
// x1 T1 are exact int8 x int8 -> int32 matmuls over a depth of 32 (Fr's 22
// halves padded with zeros), and one 12-bit column recombines as
// s00 + (s01 + s10) << 6 + s11 << 12 < 2^30 (32 x 63^2 a piece product).
// The tables are the reference's _toeplitz_consts over FP32/FR32, padded
// (ops/limb_mxu.kernel_tables_np).
//
// Layout (MxuConv, one per block): the product is warp-collective and runs
// one product a thread, so a warp's 32 MMA rows are 32 independent
// products; warp w issues the MMAs (wmma m16n16k16 on signed char, which
// lowers to mma.sync ... s8.s8.s32) for rows 32w..32w+31. Each thread
// stages its operand's pieces as one 16-byte row a (piece, k step); the
// column sums go back column-major, cols[column][row] at a stride of Rows
// + 4 words (4 mod 32: the accumulator stores hit 32 banks, and each thread
// reading its own row's columns reads one word a bank); the 64 columns of
// q p are taken in two passes of 32, so that one 32-column buffer serves
// both convolutions; the table fragments of an n tile are loaded once for
// both 16-row halves of the warp. The tables arrive as one straight copy of
// 384 16-byte words (kernel_tables_np lays the block out in the planes'
// order) issued with cp.async after the first tile's operand fetch, and the
// block waits for it only before its first MMA, so the copy overlaps the
// first a b. wmma wants 32-byte-aligned tile pointers, so pieces and tables
// are stored as 16-wide planes, one per k step. Rows past the end compute
// on zeros: every lane reaches every MMA and every __syncwarp.

#pragma once

#include <mma.h>

#include "tile.cuh"

namespace charon {

constexpr int kPieceBits = 6;
constexpr uint32_t kPieceMask = (1u << kPieceBits) - 1;
constexpr int kHalfBits = 12;
constexpr uint32_t kHalfMask = (1u << kHalfBits) - 1;
constexpr int kDepth = 32;     // 12-bit halves of an operand, padded: MMA depth
constexpr int kKSteps = kDepth / 16;
constexpr int kNinvCols = 32;  // 12-bit columns of t * ninv mod R, padded
constexpr int kModCols = 64;   // 12-bit columns of q * p, padded
constexpr int kConvCols = 32;  // 12-bit columns a convolution pass: ninv, or half of mod
constexpr int kNinvBytes = 2 * kKSteps * kNinvCols * 16;
constexpr int kTableBytes = kNinvBytes + 2 * kKSteps * kModCols * 16;

// The product's shared memory for a block of Rows threads.
template <int Rows>
struct MxuConv {
  static_assert(Rows % kWarpRows == 0, "the product is warp-collective");
  // pieces of one operand per row: [piece][k step][row][16 halves]
  alignas(32) int8_t x[2][kKSteps][Rows][16];
  // 12-bit column sums of one pass, column-major: [column][row]
  alignas(32) int32_t cols[kConvCols][Rows + 4];
  // piece tables in 16-deep column-major planes, [piece][k step][col][16]:
  // ninv (kNinvCols columns), then mod (kModCols)
  alignas(32) int8_t tables[kTableBytes];
};

// Start the copy of the table block into c.tables, 16 bytes a copy (no
// commit: tile_loop commits it as its prologue). Every thread calls it.
template <int Rows>
__device__ __forceinline__ void fetch_tables(const int8_t* __restrict__ tables, MxuConv<Rows>& c) {
  constexpr int kWords = kTableBytes / 16;
#pragma unroll
  for (int step = 0; step < (kWords + Rows - 1) / Rows; ++step) {
    const int i = threadIdx.x + step * Rows;
    if (i < kWords) cp_async16(&c.tables[16 * i], tables + 16 * i, 16);
  }
}

// The 6-bit pieces of this row's operand (the low N limbs of x), one
// 16-byte store a (piece, k step); halves past 2N are zero.
template <int N, int Rows>
__device__ __forceinline__ void stage_row_pieces(const uint32_t (&x)[N], MxuConv<Rows>& c,
                                                 int row) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = hi[q] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * ks + 4 * q + e;
        const uint32_t h = j < 2 * N ? (x[j >> 1] >> ((j & 1) * kHalfBits)) & kHalfMask : 0u;
        lo[q] |= (h & kPieceMask) << (8 * e);
        hi[q] |= (h >> kPieceBits) << (8 * e);
      }
    }
    *reinterpret_cast<uint4*>(&c.x[0][ks][row][0]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(&c.x[1][ks][row][0]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// The warp's 32 staged rows times Tiles x 16 columns of one piece table
// (Cols wide, from column tile nt0): recombined 12-bit column sums into
// c.cols. Each n tile's table fragments are loaded once for both m tiles.
// Warp-collective.
template <int Cols, int Tiles, int Rows>
__device__ __forceinline__ void conv_pass(MxuConv<Rows>& c, const int8_t* table, int nt0,
                                          int warp_row0) {
  using namespace nvcuda;
  static_assert(Tiles * 16 <= kConvCols, "a pass fills at most the column buffer");
#pragma unroll
  for (int nt = 0; nt < Tiles; ++nt) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> tb[2][kKSteps];
#pragma unroll
    for (int piece = 0; piece < 2; ++piece)
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wmma::load_matrix_sync(tb[piece][ks],
                               table + ((piece * kKSteps + ks) * Cols + 16 * (nt0 + nt)) * 16, 16);
#pragma unroll
    for (int mt = 0; mt < kWarpRows / 16; ++mt) {
      const int r0 = warp_row0 + 16 * mt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> s00, s01, s11;
      wmma::fill_fragment(s00, 0);
      wmma::fill_fragment(s01, 0);
      wmma::fill_fragment(s11, 0);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> x0, x1;
        wmma::load_matrix_sync(x0, &c.x[0][ks][r0][0], 16);
        wmma::load_matrix_sync(x1, &c.x[1][ks][r0][0], 16);
        wmma::mma_sync(s00, x0, tb[0][ks], s00);
        wmma::mma_sync(s01, x0, tb[1][ks], s01);
        wmma::mma_sync(s01, x1, tb[0][ks], s01);
        wmma::mma_sync(s11, x1, tb[1][ks], s11);
      }
#pragma unroll
      for (int i = 0; i < s00.num_elements; ++i)
        s00.x[i] += (s01.x[i] << kPieceBits) + (s11.x[i] << (2 * kPieceBits));
      wmma::store_matrix_sync(&c.cols[16 * nt][r0], s00, Rows + 4, wmma::mem_col_major);
    }
  }
}

// 24-bit column k of this row's pass: two 12-bit column sums.
template <int Rows>
__device__ __forceinline__ uint64_t pass_col24(const MxuConv<Rows>& c, int row, int k) {
  return static_cast<uint64_t>(static_cast<uint32_t>(c.cols[2 * k][row])) +
         (static_cast<uint64_t>(static_cast<uint32_t>(c.cols[2 * k + 1][row])) << kHalfBits);
}

// r = a * b * 2^(-24 N) mod p for reduced a, b < p, N = 16 (Fp) or 11
// (Fr); row threadIdx.x of c. Warp-collective, and block-collective when
// tables_pending: every thread of the block then waits for the tables'
// copy (the tile loop's prologue group) before the first MMA.
template <int N, int Rows>
__device__ __forceinline__ void mont_mul_mxu(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                             uint32_t (&r)[N], const Modulus& m,
                                             MxuConv<Rows>& c, bool tables_pending) {
  // s's 24-bit columns 0..2N-1 go in two passes: 0..15, then 16..2N-1
  constexpr int kLoCols = kConvCols / 2;
  constexpr int kLoTiles = kConvCols / 16;
  constexpr int kHiTiles = (4 * N + 15) / 16 - kLoTiles;
  static_assert(N > kLoCols / 2 && 2 * N <= kConvCols && kHiTiles > 0, "the passes are cut for 8 < N <= 16");
  const int row = threadIdx.x;
  const int warp_row0 = threadIdx.x & ~(kWarpRows - 1);

  // t = a b by product scanning, carried into canonical 24-bit limbs; a
  // column's products go to kChains independent sums, so the multiply-adds
  // of a column do not wait on each other (a column < 2^52, plus a carry)
  constexpr int kChains = 2;
  uint32_t t[2 * N];
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
    uint64_t part[kChains] = {};
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k - i >= 0 && k - i < N) part[i % kChains] += static_cast<uint64_t>(a[i]) * b[k - i];
#pragma unroll
    for (int h = 0; h < kChains; ++h) acc += part[h];
    t[k] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  t[2 * N - 1] = static_cast<uint32_t>(acc);  // a b < R^2: no carry beyond

  if (tables_pending) {
    cp_async_wait<1>();
    __syncthreads();
  }

  // q = (t mod R) * ninv mod R: the top carry is dropped
  uint32_t q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = t[j];
  stage_row_pieces<N>(q, c, row);
  __syncwarp();
  conv_pass<kNinvCols, (2 * N + 15) / 16>(c, c.tables, 0, warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc += pass_col24(c, row, j);
    q[j] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }

  // s = t + q p; s = 0 mod R, and s / R < 2p
  stage_row_pieces<N>(q, c, row);
  __syncwarp();  // also: every lane has read its ninv columns
  conv_pass<kModCols, kLoTiles>(c, c.tables + kNinvBytes, 0, warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int k = 0; k < kLoCols; ++k) {
    acc += t[k] + pass_col24(c, row, k);
    if (k >= N) r[k - N] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;  // below column N, s is 0 mod 2^24: only its carry goes on
  }
  __syncwarp();
  conv_pass<kModCols, kHiTiles>(c, c.tables + kNinvBytes, kLoTiles, warp_row0);
  __syncwarp();
#pragma unroll
  for (int k = kLoCols; k < 2 * N; ++k) {
    acc += t[k] + pass_col24(c, row, k - kLoCols);
    r[k - N] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  cond_sub_p<N>(r, m);
  __syncwarp();  // every lane has read its columns before the next pass
}

}  // namespace charon
