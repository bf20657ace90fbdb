// K2 and K3: fused Fp2 multiply and square.
//
// K2 replaces charon_tpu/ops/pallas_mont.py fp2_mul_pallas ->
// _fp2_mul_kernel_body -> _fp2_mul_math (Karatsuba: v0 = a0 b0,
// v1 = a1 b1, s = (a0 + a1)(b0 + b1); c0 = v0 - v1, c1 = s - (v0 + v1)).
// K3 replaces fp2_sqr_pallas -> _fp2_sqr_kernel_body -> _fp2_sqr_math
// (c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1).
//
// What the TPU kernels buy, and these keep: the prep sums, the three (two)
// Montgomery products and the recombination never reach device memory.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700 W power limit, from the
// data sheet's peak rates (per Fp2 element, 16-limb Fp in int64 limbs): K2
// moves 6 x 128 = 768 bytes (0.229 ns at 3.35 TB/s) against 3 x 300
// multiply-adds of the 32-bit product (0.054 ns at 33.5 T int32 ops/s, a
// multiply-add counted as two ops); K3 moves 512 bytes (0.153 ns) against
// 2 x 300 (0.036 ns). Both are bound by bytes, which the fusion already
// holds to one read of each input and one write of each output.
//
// Both are tiled (tile.cuh): 32 elements a tile, their operands fetched
// into shared memory with coalesced 16-byte asynchronous copies (the next
// tile's while this one computes) and the results stored 16 bytes a
// thread, one Montgomery product a thread (mont_field.cuh's 32-bit Fp
// product, K1's), persistent blocks. K2 runs three roles, 96 threads a
// block (fp2_mul_tiles), so an element's three products run on three warps
// at once and the duty's launches of 6-25 thousand rows spread over all
// SMs; K3 two, 64 threads (fp2_sqr_tiles, K6's shape): role 0 squares
// through (a0 + a1)(a0 - a1), role 1 computes 2 a0 a1, so an element's two
// products run at once on two warps.

#include "tile.cuh"
#include "mont_field.cuh"

namespace charon {

// Blocks resident on an SM (mont_kernels._RESIDENT mirrors them). K2: it
// caps the registers at 65,536 / (4 x 96) = 170, where the CIOS product and
// the staged operands fit without spills; K3: 65,536 / (8 x 64) = 128.
constexpr int kFp2MulBlocks = 4;
constexpr int kFp2SqrBlocks = 8;

__global__ void __launch_bounds__(kFp2MulThreads, kFp2MulBlocks)
    fp2_mul_kernel(TilePtrs<4, 2> p, int64_t rows, Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2MulTile& t = *reinterpret_cast<Fp2MulTile*>(smem);
  fp2_mul_tiles(p, rows, m, t, [] {},
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs], bool) { mont_mul32(x, y, r, m); });
}

__global__ void __launch_bounds__(kFp2SqrThreads, kFp2SqrBlocks)
    fp2_sqr_kernel(TilePtrs<2, 2> p, int64_t rows, Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2SqrTile& t = *reinterpret_cast<Fp2SqrTile*>(smem);
  fp2_sqr_tiles(p, rows, m, t, [] {},
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs], bool) { mont_mul32(x, y, r, m); });
}

// Whether a launch's geometry is the one ops/mont_kernels.fp2_geometry
// gives: `elems` the tile's, `threads` its roles', `smem` the shared
// struct's size, and `grid` between 1 and the number of tiles.
inline bool fp2_geometry_ok(int64_t rows, int elems, int threads, int grid, int smem,
                            int n_limbs, int want_threads, int want_smem) {
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  return n_limbs == kFp2Limbs && elems == kTileElems && threads == want_threads &&
         smem == want_smem && grid >= 1 && grid <= tiles;
}

}  // namespace charon

extern "C" int charon_fp2_mul(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                              const int64_t* b1, int64_t* c0, int64_t* c1, int64_t rows,
                              int elems, int threads, int grid, int smem, int n_limbs,
                              const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (!fp2_geometry_ok(rows, elems, threads, grid, smem, n_limbs, kFp2MulThreads,
                       static_cast<int>(sizeof(Fp2MulTile))))
    return static_cast<int>(cudaErrorInvalidValue);
  const TilePtrs<4, 2> p{{a0, a1, b0, b1}, {c0, c1}};
  return launch_tiled(fp2_mul_kernel, grid, threads, smem, stream, p, rows,
                      make_modulus(mod_limbs, n_limbs, pinv));
}

extern "C" int charon_fp2_sqr(const int64_t* a0, const int64_t* a1, int64_t* c0, int64_t* c1,
                              int64_t rows, int elems, int threads, int grid, int smem,
                              int n_limbs, const int64_t* mod_limbs, int64_t pinv,
                              void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (!fp2_geometry_ok(rows, elems, threads, grid, smem, n_limbs, kFp2SqrThreads,
                       static_cast<int>(sizeof(Fp2SqrTile))))
    return static_cast<int>(cudaErrorInvalidValue);
  const TilePtrs<2, 2> p{{a0, a1}, {c0, c1}};
  return launch_tiled(fp2_sqr_kernel, grid, threads, smem, stream, p, rows,
                      make_modulus(mod_limbs, n_limbs, pinv));
}

extern "C" const char* charon_fp2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
