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
// Both are tiled (tile.cuh): 32 elements a tile, operands staged through
// shared memory with coalesced 16-byte loads and stores, the next tile's
// while this one computes, and one Montgomery product a thread, so each
// warp's 32 MMA rows are 32 independent products of one role and each of
// the constant convolutions runs once a tile on every warp at once. K5 has
// three roles (K2's Karatsuba products, 96 threads); K6 two, 64 threads
// (K3's square, tile.cuh fp2_sqr_tiles).
// Blocks are persistent, so the tables reach shared memory once a block,
// as one straight copy that overlaps the first tile's a b (mont_mxu.cuh).

#include "mont_mxu.cuh"

namespace charon {

// Blocks resident on an SM (mont_kernels._RESIDENT mirrors them). K5: four
// blocks' shared memory fits the SM's 228 KB, and it caps the registers at
// 65,536 / (4 x 96) = 170. K6: six blocks of 64 threads cap them at 170.
constexpr int kFp2MulMxuBlocks = 4;
constexpr int kFp2SqrMxuBlocks = 6;

struct Fp2MulMxuShared {
  Fp2MulTile mul;
  MxuConv<kFp2MulThreads> conv;
};

struct Fp2SqrMxuShared {
  Fp2SqrTile tile;
  MxuConv<kFp2SqrThreads> conv;
};

__global__ void __launch_bounds__(kFp2MulThreads, kFp2MulMxuBlocks)
    fp2_mul_mxu_kernel(TilePtrs<4, 2> p, const int8_t* __restrict__ tables, int64_t rows,
                       Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2MulMxuShared& sm = *reinterpret_cast<Fp2MulMxuShared*>(smem);
  fp2_mul_tiles(p, rows, m, sm.mul, [&] { fetch_tables(tables, sm.conv); },
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs],
                    bool first) { mont_mul_mxu<kFp2Limbs>(x, y, r, m, sm.conv, first); });
}

__global__ void __launch_bounds__(kFp2SqrThreads, kFp2SqrMxuBlocks)
    fp2_sqr_mxu_kernel(TilePtrs<2, 2> p, const int8_t* __restrict__ tables, int64_t rows,
                       Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2SqrMxuShared& sm = *reinterpret_cast<Fp2SqrMxuShared*>(smem);
  fp2_sqr_tiles(p, rows, m, sm.tile, [&] { fetch_tables(tables, sm.conv); },
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs],
                    bool first) { mont_mul_mxu<kFp2Limbs>(x, y, r, m, sm.conv, first); });
}

}  // namespace charon

// The launch geometry comes from ops/mont_kernels.fp2_geometry: `elems`
// must be the tile's, `threads` its roles' (96 for K5, 64 for K6), `smem`
// the shared struct's size, and `grid` between 1 and the number of tiles.
extern "C" int charon_fp2_mul_mxu(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                                  const int64_t* b1, int64_t* c0, int64_t* c1,
                                  const int8_t* tables, int64_t rows, int elems, int threads,
                                  int grid, int smem, int n_limbs, const int64_t* mod_limbs,
                                  int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  if (n_limbs != kFp2Limbs || elems != kTileElems || threads != kFp2MulThreads ||
      smem != static_cast<int>(sizeof(Fp2MulMxuShared)) || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const TilePtrs<4, 2> p{{a0, a1, b0, b1}, {c0, c1}};
  return launch_tiled(fp2_mul_mxu_kernel, grid, threads, smem, stream, p, tables, rows,
                      make_modulus(mod_limbs, n_limbs, pinv));
}

extern "C" int charon_fp2_sqr_mxu(const int64_t* a0, const int64_t* a1, int64_t* c0,
                                  int64_t* c1, const int8_t* tables, int64_t rows, int elems,
                                  int threads, int grid, int smem, int n_limbs,
                                  const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  if (n_limbs != kFp2Limbs || elems != kTileElems || threads != kFp2SqrThreads ||
      smem != static_cast<int>(sizeof(Fp2SqrMxuShared)) || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const TilePtrs<2, 2> p{{a0, a1}, {c0, c1}};
  return launch_tiled(fp2_sqr_mxu_kernel, grid, threads, smem, stream, p, tables, rows,
                      make_modulus(mod_limbs, n_limbs, pinv));
}

extern "C" const char* charon_fp2_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
