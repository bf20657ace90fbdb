// K5 and K6: fused Fp2 multiply and square with int8 tensor-core
// Montgomery products.
//
// K5 replaces charon_tpu/ops/pallas_mont.py fp2_mul_pallas(mxu=True) ->
// _fp2_mul_mxu_kernel_body; K6 replaces fp2_sqr_pallas(mxu=True) ->
// _fp2_sqr_mxu_kernel_body. The formulas are K2's and K3's (fp2.cu), with
// each inner product the tensor-core product of mont_mxu.cuh.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700 W power limit, from the
// data sheet's peak rates (per Fp2 element): K5 moves 768 bytes (0.229 ns at
// 3.35 TB/s) against 3 x 256 limb multiply-adds on the CUDA cores
// (0.046 ns) and 3 x 4 x 32 x 96 int8 multiply-adds on the tensor cores
// (0.037 ns); K6 moves 512 bytes (0.153 ns) against two products. Both
// are bound by bytes, which the fusion holds to one read of each input and
// one write of each output.
//
// K5 is tiled as K2 is (fp2_tile.cuh): 32 elements a tile, operands staged
// through shared memory with coalesced 16-byte loads and stores, and one
// Montgomery product a thread, so each warp's 32 MMA rows are 32
// independent products of one Karatsuba role and each of the two constant
// convolutions runs once a tile on each of the three warps at once. Its
// shared layout (Fp2MxuShared) is built for that: pieces stored 16 bytes a
// row in one store, column sums stored column-major (one bank a row when
// each thread reads its own), the table fragments loaded once for both
// 16-row halves of a warp, the 64 columns of m p taken in two halves of 32
// so that one 32-column buffer serves both convolutions. Blocks are
// persistent, so the tables reach shared memory once a block. K6 keeps
// K4's layout: one element a thread, its two products one after another.

#include "fp2_tile.cuh"
#include "mont_mxu.cuh"

namespace charon {

// ---------------------------------------------------------------------------
// K5: the tiled product, one Montgomery product a row
// ---------------------------------------------------------------------------

// Blocks resident on an SM (mont_kernels._RESIDENT["fp2_mul_mxu"] mirrors
// it): four blocks' shared memory fits the SM's 228 KB, and it caps the
// registers at 65,536 / (4 x 96) = 170.
constexpr int kFp2MulMxuBlocks = 4;
constexpr int kConvCols = 32;                    // columns a convolution pass: ninv, or half of mod
constexpr int kColPlane = kTileThreads + 4;      // = 4 mod 32: accumulator stores hit 32 banks

struct Fp2MxuShared {
  Fp2Tile tile;
  // pieces of one operand per row: [piece][k step][row][16 halves]
  alignas(32) int8_t x[2][kKSteps][kTileThreads][16];
  // 12-bit column sums of one pass, column-major: [column][row]
  alignas(32) int32_t cols[kConvCols][kColPlane];
  // piece tables, column-major in 16-deep planes: [piece][k step][col][16]
  alignas(32) int8_t ninv[2][kKSteps][kNinvCols][16];
  alignas(32) int8_t mod[2][kKSteps][kModCols][16];
};

// The table block from device memory into its planes (load_tables'
// layout), 16 bytes a load: 16 columns of one row of one piece table, all
// loads in flight before the first store. Every thread of the block calls
// it.
__device__ __forceinline__ void load_tile_tables(const int8_t* __restrict__ tables,
                                                 Fp2MxuShared& sm) {
  constexpr int kNinvBytes = kDepth * kNinvCols;
  constexpr int kModBytes = kDepth * kModCols;
  constexpr int kWords = 2 * (kNinvBytes + kModBytes) / 16;
  constexpr int kSteps = (kWords + kTileThreads - 1) / kTileThreads;
  uint4 v[kSteps];
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int i = threadIdx.x + step * kTileThreads;
    if (i < kWords) v[step] = __ldg(reinterpret_cast<const uint4*>(tables) + i);
  }
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int i = threadIdx.x + step * kTileThreads;
    if (i >= kWords) continue;
    const uint32_t word[4] = {v[step].x, v[step].y, v[step].z, v[step].w};
    int8_t* plane;  // this row's first column in its plane, then 16 bytes a column
    if (16 * i < 2 * kNinvBytes) {
      const int b = 16 * i, piece = b / kNinvBytes, k = (b % kNinvBytes) / kNinvCols;
      plane = &sm.ninv[piece][k >> 4][b % kNinvCols][k & 15];
    } else {
      const int b = 16 * i - 2 * kNinvBytes, piece = b / kModBytes, k = (b % kModBytes) / kModCols;
      plane = &sm.mod[piece][k >> 4][b % kModCols][k & 15];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) plane[16 * u] = static_cast<int8_t>(word[u >> 2] >> (8 * (u & 3)));
  }
  __syncthreads();
}

// The 6-bit pieces of this row's operand (the low N limbs of x), one
// 16-byte store a (piece, k step); halves past 2N are zero.
template <int N>
__device__ __forceinline__ void stage_row_pieces(const uint32_t (&x)[N], Fp2MxuShared& sm,
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
    *reinterpret_cast<uint4*>(&sm.x[0][ks][row][0]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(&sm.x[1][ks][row][0]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// The warp's 32 staged rows times kConvCols columns of one piece table
// (Cols wide, from column tile nt0): recombined 12-bit column sums into
// sm.cols. Each n tile's table fragments are loaded once for both m tiles.
// Warp-collective.
template <int Cols>
__device__ __forceinline__ void conv_pass(Fp2MxuShared& sm, const int8_t* table, int nt0,
                                          int warp_row0) {
  using namespace nvcuda;
#pragma unroll
  for (int nt = 0; nt < kConvCols / 16; ++nt) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> c[2][kKSteps];
#pragma unroll
    for (int piece = 0; piece < 2; ++piece)
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wmma::load_matrix_sync(c[piece][ks],
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
        wmma::load_matrix_sync(x0, &sm.x[0][ks][r0][0], 16);
        wmma::load_matrix_sync(x1, &sm.x[1][ks][r0][0], 16);
        wmma::mma_sync(s00, x0, c[0][ks], s00);
        wmma::mma_sync(s01, x0, c[1][ks], s01);
        wmma::mma_sync(s01, x1, c[0][ks], s01);
        wmma::mma_sync(s11, x1, c[1][ks], s11);
      }
#pragma unroll
      for (int i = 0; i < s00.num_elements; ++i)
        s00.x[i] += (s01.x[i] << kPieceBits) + (s11.x[i] << (2 * kPieceBits));
      wmma::store_matrix_sync(&sm.cols[16 * nt][r0], s00, kColPlane, wmma::mem_col_major);
    }
  }
}

// 24-bit column k of this row's pass: two 12-bit column sums.
__device__ __forceinline__ uint64_t pass_col24(const Fp2MxuShared& sm, int row, int k) {
  return static_cast<uint64_t>(static_cast<uint32_t>(sm.cols[2 * k][row])) +
         (static_cast<uint64_t>(static_cast<uint32_t>(sm.cols[2 * k + 1][row])) << kHalfBits);
}

// r = a * b * 2^(-24 N) mod p for reduced a, b < p: mont_mul_mxu's
// algorithm on this layout. Warp-collective.
template <int N>
__device__ __forceinline__ void mont_mul_mxu_row(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                                 uint32_t (&r)[N], const Modulus& m,
                                                 Fp2MxuShared& sm) {
  static_assert(2 * N == kConvCols && 4 * N == 2 * kConvCols, "the passes are cut for Fp");
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
    for (int c = 0; c < kChains; ++c) acc += part[c];
    t[k] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  t[2 * N - 1] = static_cast<uint32_t>(acc);  // a b < R^2: no carry beyond

  // q = (t mod R) * ninv mod R: the top carry is dropped
  uint32_t q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = t[j];
  stage_row_pieces<N>(q, sm, row);
  __syncwarp();
  conv_pass<kNinvCols>(sm, &sm.ninv[0][0][0][0], 0, warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc += pass_col24(sm, row, j);
    q[j] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }

  // s = t + q p in two passes of 32 12-bit columns; s = 0 mod R, s / R < 2p
  stage_row_pieces<N>(q, sm, row);
  __syncwarp();  // also: every lane has read its ninv columns
  conv_pass<kModCols>(sm, &sm.mod[0][0][0][0], 0, warp_row0);
  __syncwarp();
  acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    acc += t[k] + pass_col24(sm, row, k);
    acc >>= kLimbBits;  // the low half is 0 mod 2^24: only its carry goes on
  }
  __syncwarp();
  conv_pass<kModCols>(sm, &sm.mod[0][0][0][0], kConvCols / 16, warp_row0);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    acc += t[N + k] + pass_col24(sm, row, k);
    r[k] = static_cast<uint32_t>(acc) & kLimbMask;
    acc >>= kLimbBits;
  }
  cond_sub_p<N>(r, m);
  __syncwarp();  // every lane has read its columns before the next pass
}

__global__ void __launch_bounds__(kTileThreads, kFp2MulMxuBlocks)
    fp2_mul_mxu_kernel(Fp2Ptrs p, const int8_t* __restrict__ tables, int64_t rows, Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2MxuShared& sm = *reinterpret_cast<Fp2MxuShared*>(smem);
  load_tile_tables(tables, sm);
  fp2_mul_tiles(p, rows, m, sm.tile,
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs]) { mont_mul_mxu_row<kFp2Limbs>(x, y, r, m, sm); });
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads)
    fp2_sqr_mxu_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                       int64_t* __restrict__ c0, int64_t* __restrict__ c1,
                       const int8_t* __restrict__ tables, int64_t rows, Modulus m) {
  __shared__ MxuShared sm;
  load_tables(tables, sm);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < rows;
  uint32_t x0[N] = {}, x1[N] = {};
  if (live) {
    load_limbs<N>(a0, row, x0);
    load_limbs<N>(a1, row, x1);
  }
  uint32_t ta[N], ts[N], r[N];
  add_mod<N>(x0, x1, ta, m);
  sub_mod<N>(x0, x1, ts, m);
  mont_mul_mxu<N>(ta, ts, r, m, sm);
  if (live) store_limbs<N>(c0, row, r);
  mont_mul_mxu<N>(x0, x1, ta, m, sm);
  add_mod<N>(ta, ta, r, m);
  if (live) store_limbs<N>(c1, row, r);
}

}  // namespace charon

// The launch geometry comes from ops/mont_kernels.fp2_geometry: `elems`
// and `threads` must be the tile's, `smem` sizeof(Fp2MxuShared), and
// `grid` between 1 and the number of tiles.
extern "C" int charon_fp2_mul_mxu(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                                  const int64_t* b1, int64_t* c0, int64_t* c1,
                                  const int8_t* tables, int64_t rows, int elems, int threads,
                                  int grid, int smem, int n_limbs, const int64_t* mod_limbs,
                                  int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  if (n_limbs != kFp2Limbs || elems != kTileElems || threads != kTileThreads ||
      smem != static_cast<int>(sizeof(Fp2MxuShared)) || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  // past the 48 KB a block gets by default: ask for it
  const cudaError_t rc = cudaFuncSetAttribute(
      fp2_mul_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  const Fp2Ptrs p{{a0, a1, b0, b1}, {c0, c1}};
  fp2_mul_mxu_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p, tables, rows,
                                                                                 m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int charon_fp2_sqr_mxu(const int64_t* a0, const int64_t* a1, int64_t* c0,
                                  int64_t* c1, const int8_t* tables, int64_t rows, int n_limbs,
                                  const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (n_limbs != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  fp2_sqr_mxu_kernel<16><<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, c0, c1, tables, rows, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* charon_fp2_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
