// Montgomery product with its two constant convolutions on the int8 tensor
// cores, shared by K4 (mont_mxu.cu) and the fused Fp2 kernels K5/K6
// (fp2_mxu.cu).
//
// Algorithm: the separated-operand product of the JAX package's
// limb.mont_mul, step for step (ops/limb_mxu.py holds its plain version):
//
//   t = a b                      data-dependent: CUDA cores, one row a thread
//   m = (t mod R)(-p^-1) mod R   constant: int8 MMA against a Toeplitz band
//   s = t + m p                  constant: int8 MMA against a Toeplitz band
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
// Layout: a block of kThreads rows, one row per thread; warp w owns rows
// 32w..32w+31 and issues the MMAs for them (wmma m16n16k16 on signed char,
// which lowers to mma.sync ... s8.s8.s32). A thread stages its row's pieces
// in shared memory, the warp multiplies them against the table held in
// shared memory, the int32 column sums go back to shared memory, and each
// thread reads its own row's columns. Rows past the end compute on zeros:
// every lane reaches every MMA and every __syncwarp.
//
// Shared memory, 47,104 bytes a block: pieces 8 KB, column sums 32 KB,
// tables 6 KB. wmma wants 32-byte-aligned tile pointers, so pieces and
// tables are stored as 16-wide planes, one per k step.

#pragma once

#include <mma.h>

#include "mont_field.cuh"

namespace charon {

constexpr int kPieceBits = 6;
constexpr uint32_t kPieceMask = (1u << kPieceBits) - 1;
constexpr int kHalfBits = 12;
constexpr uint32_t kHalfMask = (1u << kHalfBits) - 1;
constexpr int kDepth = 32;     // 12-bit halves of an operand, padded: MMA depth
constexpr int kKSteps = kDepth / 16;
constexpr int kNinvCols = 32;  // 12-bit columns of t * ninv mod R, padded
constexpr int kModCols = 64;   // 12-bit columns of m * p, padded
constexpr int kWarpRows = 32;

struct MxuShared {
  // pieces of one operand per row: [piece][k step][row][16 halves]
  alignas(32) int8_t x[2][kKSteps][kThreads][16];
  // recombined 12-bit column sums per row
  alignas(32) int32_t cols[kThreads][kModCols];
  // piece tables, column-major in 16-deep planes: [piece][k step][col][16]
  alignas(32) int8_t ninv[2][kKSteps][kNinvCols][16];
  alignas(32) int8_t mod[2][kKSteps][kModCols][16];
};

// Table block from device memory (nT0 | nT1 as kDepth x kNinvCols, then
// pT0 | pT1 as kDepth x kModCols, row-major int8) into the planes. Every
// thread of the block must call it.
__device__ __forceinline__ void load_tables(const int8_t* __restrict__ tables, MxuShared& sm) {
  constexpr int kNinvBytes = kDepth * kNinvCols;
  constexpr int kModBytes = kDepth * kModCols;
  for (int i = threadIdx.x; i < 2 * (kNinvBytes + kModBytes); i += blockDim.x) {
    const int8_t v = tables[i];
    if (i < 2 * kNinvBytes) {
      const int piece = i / kNinvBytes, k = (i % kNinvBytes) / kNinvCols, c = i % kNinvCols;
      sm.ninv[piece][k >> 4][c][k & 15] = v;
    } else {
      const int j = i - 2 * kNinvBytes;
      const int piece = j / kModBytes, k = (j % kModBytes) / kModCols, c = j % kModCols;
      sm.mod[piece][k >> 4][c][k & 15] = v;
    }
  }
  __syncthreads();
}

// The 6-bit pieces of this thread's N-limb operand into its row, four
// pieces to a 32-bit store; halves past 2N are zero.
template <int N>
__device__ __forceinline__ void stage_pieces(const uint32_t (&x)[N], MxuShared& sm, int row) {
#pragma unroll
  for (int q = 0; q < kDepth / 4; ++q) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      const uint32_t h = j < 2 * N ? (x[j >> 1] >> ((j & 1) * kHalfBits)) & kHalfMask : 0u;
      lo |= (h & kPieceMask) << (8 * e);
      hi |= (h >> kPieceBits) << (8 * e);
    }
    const int j = 4 * q;
    *reinterpret_cast<uint32_t*>(&sm.x[0][j >> 4][row][j & 15]) = lo;
    *reinterpret_cast<uint32_t*>(&sm.x[1][j >> 4][row][j & 15]) = hi;
  }
}

// The warp's 32 staged rows times one piece table (Cols padded columns, of
// which the first Tiles x 16 are computed): recombined 12-bit column sums
// into sm.cols. Warp-collective.
template <int Cols, int Tiles>
__device__ __forceinline__ void const_conv_mma(MxuShared& sm, const int8_t* table, int warp_row0) {
  using namespace nvcuda;
#pragma unroll
  for (int mt = 0; mt < kWarpRows / 16; ++mt) {
    const int r0 = warp_row0 + 16 * mt;
#pragma unroll
    for (int nt = 0; nt < Tiles; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> s00, s01, s11;
      wmma::fill_fragment(s00, 0);
      wmma::fill_fragment(s01, 0);
      wmma::fill_fragment(s11, 0);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> x0, x1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> c0, c1;
        wmma::load_matrix_sync(x0, &sm.x[0][ks][r0][0], 16);
        wmma::load_matrix_sync(x1, &sm.x[1][ks][r0][0], 16);
        wmma::load_matrix_sync(c0, table + ((0 * kKSteps + ks) * Cols + 16 * nt) * 16, 16);
        wmma::load_matrix_sync(c1, table + ((1 * kKSteps + ks) * Cols + 16 * nt) * 16, 16);
        wmma::mma_sync(s00, x0, c0, s00);
        wmma::mma_sync(s01, x0, c1, s01);
        wmma::mma_sync(s01, x1, c0, s01);
        wmma::mma_sync(s11, x1, c1, s11);
      }
#pragma unroll
      for (int i = 0; i < s00.num_elements; ++i)
        s00.x[i] += (s01.x[i] << kPieceBits) + (s11.x[i] << (2 * kPieceBits));
      wmma::store_matrix_sync(&sm.cols[r0][16 * nt], s00, kModCols, wmma::mem_row_major);
    }
  }
}

// 24-bit column k of this row's conv: two 12-bit column sums.
__device__ __forceinline__ uint64_t col24(const MxuShared& sm, int row, int k) {
  return static_cast<uint64_t>(static_cast<uint32_t>(sm.cols[row][2 * k])) +
         (static_cast<uint64_t>(static_cast<uint32_t>(sm.cols[row][2 * k + 1])) << kHalfBits);
}

// r = a * b * 2^(-24 N) mod p for reduced a, b < p. Warp-collective: every
// lane of the warp calls it, with zeros on rows past the end.
template <int N>
__device__ __forceinline__ void mont_mul_mxu(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                             uint32_t (&r)[N], const Modulus& m,
                                             MxuShared& sm) {
  const int row = threadIdx.x;
  const int warp_row0 = threadIdx.x & ~(kWarpRows - 1);

  // t = a b by product scanning, carried into canonical 24-bit limbs (a
  // column of N products < 2^52 plus the carry stays inside 64 bits)
  uint32_t t[2 * N];
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k - i >= 0 && k - i < N) acc += static_cast<uint64_t>(a[i]) * b[k - i];
    t[k] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  t[2 * N - 1] = static_cast<uint32_t>(acc);  // a b < R^2: no carry beyond

  // m = (t mod R) * ninv mod R: the top carry is dropped
  uint32_t q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = t[j];
  stage_pieces<N>(q, sm, row);
  __syncwarp();
  const_conv_mma<kNinvCols, (2 * N + 15) / 16>(sm, &sm.ninv[0][0][0][0], warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc += col24(sm, row, j);
    q[j] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }

  // s = t + m p; s = 0 mod R, and s / R < 2p
  stage_pieces<N>(q, sm, row);
  __syncwarp();
  const_conv_mma<kModCols, (4 * N + 15) / 16>(sm, &sm.mod[0][0][0][0], warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) {
    acc += t[k] + col24(sm, row, k);
    if (k >= N) r[k - N] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  cond_sub_p<N>(r, m);
  __syncwarp();  // every lane has read its columns before the next product
}

}  // namespace charon
