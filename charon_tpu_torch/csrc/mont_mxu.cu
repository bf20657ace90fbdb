// K4: batched Montgomery product a * b * R^-1 mod m over Fp (16 limbs) or
// Fr (11 limbs), with the two constant convolutions on the int8 tensor
// cores (mont_mxu.cuh), tiled (tile.cuh).
//
// Replaces the TPU kernel charon_tpu/ops/pallas_mont.py
// mont_mul_pallas(mxu=True) -> _mont_mxu_kernel_body -> _mont_core_mxu
// (t = a b on the VPU; t * (-m^-1) mod R and m * p as int8 MXU matmuls
// against 6-bit Toeplitz pieces, ops/limb_mxu.conv_const_mxu). The same
// integers come out as K1's: reduced Montgomery values are unique.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700 W power limit, from the
// data sheet's peak rates (per Fp element): 384 bytes of int64 limbs in and out
// (0.115 ns at 3.35 TB/s) against 256 limb multiply-adds for a b on the
// CUDA cores (0.015 ns at 33.5 T int32 ops/s) plus 4 x 32 x (32 + 64)
// int8 multiply-adds of the piece products on the tensor cores (0.012 ns
// at 1,979 T int8 ops/s); Fr: 264 bytes against 121 and 4 x 22 x 66. So
// K4, like K1, is bound by bytes at large row counts; the duty sends it
// mostly 1-1,024 rows, where a launch is one product's latency.
//
// Design: one product a thread on the shared tile. A launch of at most 32
// rows runs one one-warp block (no dead warps through the table copy); a
// larger one runs tiles of 128 rows in persistent blocks of 128 threads,
// at most kMontMxuBlocks an SM, so the tables reach shared memory once a
// block and the operands stream in by 16-byte cp.async copies, the next
// tile's while this one computes. Each block issues its table copy right
// after its first operand fetch and waits for it only before its first
// MMA (mont_mxu.cuh), so at 1-1,024 rows the copy hides behind the a b
// product. Results go back through a limb plane with 16-byte stores.

#include "mont_mxu.cuh"

namespace charon {

// Rows a tile (and threads a block) of a launch of more than kWarpRows
// rows; blocks resident on an SM at that size: three blocks' shared memory
// (76,352 bytes for Fp) fits the SM's 228 KB, and the registers are capped
// at 65,536 / (3 x 128) = 170. mont_kernels.MONT_TILE_ROWS and
// _RESIDENT["mont_mul_mxu_fp"/"_fr"] mirror them.
constexpr int kMontMxuThreads = 128;
constexpr int kMontMxuBlocks = 3;

template <int N, int Elems>
struct MontMxuShared {
  Tile<N, Elems, 2, 1> tile;  // a, b -> out
  MxuConv<Elems> conv;
};

template <int N, int Elems>
__global__ void __launch_bounds__(Elems, kMontMxuBlocks)
    mont_mul_mxu_kernel(TilePtrs<2, 1> p, const int8_t* __restrict__ tables, int64_t rows,
                        Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  MontMxuShared<N, Elems>& sm = *reinterpret_cast<MontMxuShared<N, Elems>*>(smem);
  const int e = threadIdx.x;
  tile_loop<Elems>(
      p, rows, sm.tile, [&] { fetch_tables(tables, sm.conv); },
      [&](uint32_t (&x)[N], uint32_t (&y)[N]) {
        read_row<N>(sm.tile.in[0], e, x);
        read_row<N>(sm.tile.in[1], e, y);
      },
      [&](const uint32_t (&x)[N], const uint32_t (&y)[N], bool first) {
        uint32_t r[N];
        mont_mul_mxu<N>(x, y, r, m, sm.conv, first);
        write_plane(sm.tile.out[0], e, r);
      });
}

template <int N, int Elems>
int launch_mont_mul_mxu(const TilePtrs<2, 1>& p, const int8_t* tables, int64_t rows, int grid,
                        int smem, const Modulus& m, void* stream) {
  if (smem != static_cast<int>(sizeof(MontMxuShared<N, Elems>)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiled(mont_mul_mxu_kernel<N, Elems>, grid, Elems, smem, stream, p, tables, rows,
                      m);
}

}  // namespace charon

// The launch geometry comes from ops/mont_kernels.mont_geometry: `elems`
// and `threads` must be 32 for a launch of at most 32 rows and 128 above,
// `smem` the shared struct's size for that tile, and `grid` between 1 and
// the number of tiles.
extern "C" int charon_mont_mul_mxu(const int64_t* a, const int64_t* b, int64_t* out,
                                   const int8_t* tables, int64_t rows, int elems, int threads,
                                   int grid, int smem, int n_limbs, const int64_t* mod_limbs,
                                   int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int tile = rows <= kWarpRows ? kWarpRows : kMontMxuThreads;
  const int64_t tiles = (rows + tile - 1) / tile;
  if (elems != tile || threads != tile || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  const TilePtrs<2, 1> p{{a, b}, {out}};
  const bool warp = tile == kWarpRows;
  switch (n_limbs) {
    case 16:
      return warp ? launch_mont_mul_mxu<16, kWarpRows>(p, tables, rows, grid, smem, m, stream)
                  : launch_mont_mul_mxu<16, kMontMxuThreads>(p, tables, rows, grid, smem, m, stream);
    case 11:
      return warp ? launch_mont_mul_mxu<11, kWarpRows>(p, tables, rows, grid, smem, m, stream)
                  : launch_mont_mul_mxu<11, kMontMxuThreads>(p, tables, rows, grid, smem, m, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* charon_mont_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
