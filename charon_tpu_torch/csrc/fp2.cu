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
// Bound on the H100 (per Fp2 element, 16-limb Fp in int64 limbs): K2 moves
// 6 x 128 = 768 bytes (0.229 ns at 3.35 TB/s) against 3 x 528 = 1584 limb
// multiply-adds (0.095 ns at 33.5 T int32 ops/s, a multiply-add counted as
// two ops); K3 moves 512 bytes (0.153 ns) against 1056 multiply-adds
// (0.063 ns). Both are bound by bytes, which the fusion already holds to
// one read of each input and one write of each output.
//
// K2 is tiled (tile.cuh): 32 elements a tile, their operands fetched
// into shared memory with coalesced 16-byte asynchronous copies (the next
// tile's while this one computes) and the results stored 16 bytes a
// thread, and one CIOS product (mont_field.cuh, K1's) a thread, 96 threads
// a block, so an element's three products run on three warps at once and
// the duty's launches of 6-25 thousand rows spread over all SMs. Persistent
// blocks, four an SM. K3 keeps one element a thread, its operands in
// registers.

#include "tile.cuh"
#include "mont_field.cuh"

namespace charon {

// Blocks resident on an SM (mont_kernels._RESIDENT["fp2_mul"] mirrors it):
// it caps the registers at 65,536 / (4 x 96) = 170, where the CIOS product
// and the staged operands fit without spills.
constexpr int kFp2MulBlocks = 4;

__global__ void __launch_bounds__(kFp2MulThreads, kFp2MulBlocks)
    fp2_mul_kernel(TilePtrs<4, 2> p, int64_t rows, Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Fp2MulTile& t = *reinterpret_cast<Fp2MulTile*>(smem);
  fp2_mul_tiles(p, rows, m, t, [] {},
                [&](const uint32_t (&x)[kFp2Limbs], const uint32_t (&y)[kFp2Limbs],
                    uint32_t (&r)[kFp2Limbs], bool) { mont_mul<kFp2Limbs>(x, y, r, m); });
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    fp2_sqr_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                   int64_t* __restrict__ c0, int64_t* __restrict__ c1, int64_t rows,
                   Modulus m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  uint32_t x0[N], x1[N];
  load_limbs<N>(a0, row, x0);
  load_limbs<N>(a1, row, x1);
  uint32_t ta[N], ts[N], r[N];
  add_mod<N>(x0, x1, ta, m);
  sub_mod<N>(x0, x1, ts, m);
  mont_mul<N>(ta, ts, r, m);
  store_limbs<N>(c0, row, r);
  mont_mul<N>(x0, x1, ta, m);
  add_mod<N>(ta, ta, r, m);
  store_limbs<N>(c1, row, r);
}

}  // namespace charon

// The launch geometry comes from ops/mont_kernels.fp2_geometry: `elems`
// and `threads` must be the tile's, `smem` sizeof(Fp2MulTile), and `grid`
// between 1 and the number of tiles.
extern "C" int charon_fp2_mul(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                              const int64_t* b1, int64_t* c0, int64_t* c1, int64_t rows,
                              int elems, int threads, int grid, int smem, int n_limbs,
                              const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  if (n_limbs != kFp2Limbs || elems != kTileElems || threads != kFp2MulThreads ||
      smem != static_cast<int>(sizeof(Fp2MulTile)) || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const TilePtrs<4, 2> p{{a0, a1, b0, b1}, {c0, c1}};
  return launch_tiled(fp2_mul_kernel, grid, threads, smem, stream, p, rows,
                      make_modulus(mod_limbs, n_limbs, pinv));
}

extern "C" int charon_fp2_sqr(const int64_t* a0, const int64_t* a1, int64_t* c0, int64_t* c1,
                              int64_t rows, int n_limbs, const int64_t* mod_limbs,
                              int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (n_limbs != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  fp2_sqr_kernel<16><<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, c0, c1, rows, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* charon_fp2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
