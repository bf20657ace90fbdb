// K1: batched Montgomery product a * b * R^-1 mod m over Fp (16 limbs) or
// Fr (11 limbs), tiled (tile.cuh).
//
// Replaces the TPU kernel charon_tpu/ops/pallas_mont.py mont_mul_pallas ->
// _mont_kernel_body -> _mont_core (separated-operand Montgomery in VMEM:
// t = a b, m = (t mod R)(-m^-1) mod R, s = t + m p, high half with a fused
// conditional subtract). Here the same value comes from a CIOS product
// (mont_field.cuh): over Fp on 32-bit words (mont_mul32), over Fr on the
// 24-bit limbs (mont_mul<11>). Reduced Montgomery values are unique, so the
// result equals the TPU kernel's and the JAX package's limb for limb.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700 W power limit, from the
// data sheet's peak rates (per element, Fp): the int64 interface moves
// 3 x 16 x 8 = 384 bytes (a, b read once, out written once), 0.115 ns at
// 3.35 TB/s; the 32-bit product needs 300 multiply-adds, 0.018 ns at 33.5 T
// int32 ops/s (a multiply-add counted as two ops). Fr: 264 bytes (0.079 ns)
// against 253 multiply-adds (0.015 ns). So the kernel is bound by bytes at
// large row counts; the duty sends it mostly 1-1,024 rows, where a launch
// is one product's latency. The int64 storage of 24-bit limbs costs 2.7x
// the bytes of packed limbs; that is the interface's price, kept for
// element-for-element parity with the JAX package.
//
// Design: K4's shape without the tables (mont_mxu.cu): one product a thread
// on the shared tile, operands streamed in by 16-byte cp.async copies (the
// next tile's while this one computes), results back through a limb plane
// with 16-byte stores, persistent blocks. K1 has no table block to
// amortise, so its tile is one warp at every size: a launch of 384 or 1,024
// rows spreads over 12 or 32 SMs. Eight blocks an SM leave a thread all the
// registers it takes (the 32-bit product spilled 104 bytes under a cap of
// 128). A launch of at most a warp's rows (1-32 rows: over half of the
// duty's K1 Fp launches) skips the staging: each thread loads its operands
// straight into registers and stores its result, in 1,280 SASS instructions
// against the tile's 2,584: 0.0036 against 0.0048 ms at 1 row on the
// NVIDIA H100 80GB HBM3 at its 700 W limit (kernel_ab.py).

#include "tile.cuh"

namespace charon {

// Rows a tile (and threads a block) of a launch of more than kWarpRows
// rows; blocks resident on an SM, which caps the registers at 65,536 /
// (8 x 32) = 256, above the 255 a thread may hold.
// mont_kernels.MONT_TILE_ROWS["mont_mul_fp"/"_fr"] and _RESIDENT mirror them.
constexpr int kMontTileRows = 32;
constexpr int kMontBlocks = 8;

template <int N>
__device__ __forceinline__ void product(const uint32_t (&x)[N], const uint32_t (&y)[N],
                                        uint32_t (&r)[N], const Modulus& m) {
  if constexpr (N == kFpLimbs)
    mont_mul32(x, y, r, m);
  else
    mont_mul<N>(x, y, r, m);
}

template <int N, int Elems>
__global__ void __launch_bounds__(Elems, kMontBlocks)
    mont_mul_kernel(TilePtrs<2, 1> p, int64_t rows, Modulus m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<N, Elems, 2, 1>& t = *reinterpret_cast<Tile<N, Elems, 2, 1>*>(smem);
  const int e = threadIdx.x;
  tile_loop<Elems>(
      p, rows, t, [] {},
      [&](uint32_t (&x)[N], uint32_t (&y)[N]) {
        read_row<N>(t.in[0], e, x);
        read_row<N>(t.in[1], e, y);
      },
      [&](const uint32_t (&x)[N], const uint32_t (&y)[N], bool) {
        uint32_t r[N];
        product<N>(x, y, r, m);
        write_plane(t.out[0], e, r);
      });
}

// Row e of an int64 limb tensor, narrowed to 32-bit words: 16 bytes a load
// for an even limb count (its rows start on 16-byte words), else 8.
template <int N>
__device__ __forceinline__ void load_row(const int64_t* __restrict__ src, int e,
                                         uint32_t (&x)[N]) {
  const int64_t* row = src + static_cast<int64_t>(e) * N;
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const longlong2 w = reinterpret_cast<const longlong2*>(row)[q];
      x[2 * q] = static_cast<uint32_t>(w.x);
      x[2 * q + 1] = static_cast<uint32_t>(w.y);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = static_cast<uint32_t>(row[j]);
  }
}

template <int N>
__device__ __forceinline__ void store_row(int64_t* __restrict__ dst, int e,
                                          const uint32_t (&x)[N]) {
  int64_t* row = dst + static_cast<int64_t>(e) * N;
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<longlong2*>(row)[q] = make_longlong2(x[2 * q], x[2 * q + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = x[j];
  }
}

// A launch of at most a warp's rows, one block: thread e multiplies row e.
template <int N>
__global__ void __launch_bounds__(kWarpRows)
    mont_mul_warp_kernel(TilePtrs<2, 1> p, int64_t rows, Modulus m) {
  const int e = threadIdx.x;
  if (e >= rows) return;
  uint32_t x[N], y[N], r[N];
  load_row<N>(p.in[0], e, x);
  load_row<N>(p.in[1], e, y);
  product<N>(x, y, r, m);
  store_row<N>(p.out[0], e, r);
}

template <int N>
int launch_mont_mul(const TilePtrs<2, 1>& p, int64_t rows, int grid, int smem, const Modulus& m,
                    void* stream) {
  if (rows <= kWarpRows) {
    if (smem != 0) return static_cast<int>(cudaErrorInvalidValue);
    mont_mul_warp_kernel<N><<<1, kWarpRows, 0, static_cast<cudaStream_t>(stream)>>>(p, rows, m);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem != static_cast<int>(sizeof(Tile<N, kMontTileRows, 2, 1>)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiled(mont_mul_kernel<N, kMontTileRows>, grid, kMontTileRows, smem, stream, p,
                      rows, m);
}

}  // namespace charon

// The launch geometry comes from ops/mont_kernels.mont_geometry: `elems`
// and `threads` must be kWarpRows for a launch of at most that many rows
// and kMontTileRows above, `smem` 0 (no staging) at most a warp's rows and
// the tile's size above, and `grid` between 1 and the number of tiles.
extern "C" int charon_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int64_t rows,
                               int elems, int threads, int grid, int smem, int n_limbs,
                               const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const int tile = rows <= kWarpRows ? kWarpRows : kMontTileRows;
  const int64_t tiles = (rows + tile - 1) / tile;
  if (elems != tile || threads != tile || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  const TilePtrs<2, 1> p{{a, b}, {out}};
  switch (n_limbs) {
    case 16:
      return launch_mont_mul<16>(p, rows, grid, smem, m, stream);
    case 11:
      return launch_mont_mul<11>(p, rows, grid, smem, m, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* charon_mont_mul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
