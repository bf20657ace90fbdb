// Tiled fused Fp2 multiply, shared by K2 (fp2.cu, CIOS products on the
// CUDA cores) and K5 (fp2_mxu.cu, products with int8 tensor-core
// convolutions).
//
// A block takes tiles of kTileElems Fp2 elements: block b the tiles b,
// b + gridDim.x, b + 2 gridDim.x, ... (ops/mont_kernels.fp2_geometry sets
// the grid to the card's resident blocks, so large launches run in whole
// waves). Per tile:
//
//   1. fetch: each operand's tile is one contiguous run of kTileElems x 128
//      bytes (16 int64 limbs a row); the block copies it into shared memory
//      with 16-byte asynchronous copies (cp.async, zero-filled past the
//      last row), rows padded to 144 bytes so that a thread reading its
//      own row 16 bytes at a time meets no bank conflict. The next tile's
//      fetch starts as soon as this tile's operands are in registers,
//      so it streams in while this tile computes;
//   2. product: one Montgomery product a thread, 3 x kTileElems threads:
//      warp-uniform roles k = 0, 1, 2 compute v0 = a0 b0, v1 = a1 b1 and
//      s = (a0 + a1)(b0 + b1) (the s threads form the Karatsuba prep sums
//      from the staged operands), into limb planes of 32-bit words
//      (plane[limb][elem], padded to kPlane words: one bank a thread);
//   3. recombine: c0 = v0 - v1 and c1 = s - (v0 + v1), one output
//      coordinate a thread, into output planes;
//   4. store: the two output tiles back with 16-byte coalesced stores.
//
// Rows past the end of the last tile stage as zeros, compute on zeros (the
// tensor-core product needs every lane of a warp) and are never stored.
// Operand pointers must be 16-byte aligned (the wrapper sees to it).

#pragma once

#include "mont_field.cuh"

namespace charon {

constexpr int kFp2Limbs = 16;
constexpr int kTileElems = 32;                // Fp2 elements a tile: one warp a role
constexpr int kTileThreads = 3 * kTileElems;  // one Montgomery product a thread
constexpr int kRowWords = kFp2Limbs + 2;      // int64 words of a staged row (144 bytes)
constexpr int kPlane = kTileElems + 1;        // 32-bit words of a limb plane
constexpr int kTileChunks = kTileElems * kFp2Limbs / 2;  // 16-byte chunks of an operand tile

struct Fp2Ptrs {
  const int64_t* a[4];  // a0, a1, b0, b1
  int64_t* c[2];        // c0, c1
};

struct Fp2Tile {
  alignas(16) int64_t in[4][kTileElems][kRowWords];  // a0, a1, b0, b1 as fetched
  uint32_t prod[3][kFp2Limbs][kPlane];               // v0, v1, s
  uint32_t out[2][kFp2Limbs][kPlane];                // c0, c1
};

// p.a[op] and p.c[op] for a computed op, as selects: indexing the
// parameter arrays would copy them to local memory.
__device__ __forceinline__ const int64_t* operand(const Fp2Ptrs& p, int op) {
  return op == 0 ? p.a[0] : op == 1 ? p.a[1] : op == 2 ? p.a[2] : p.a[3];
}
__device__ __forceinline__ int64_t* result(const Fp2Ptrs& p, int op) {
  return op == 0 ? p.c[0] : p.c[1];
}

__device__ __forceinline__ int tile_live(int64_t tile, int64_t rows) {
  const int64_t left = rows - tile * kTileElems;
  return left < kTileElems ? static_cast<int>(left) : kTileElems;
}

// 16 bytes from global to shared memory, asynchronously; zeros if !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

// Start the copies of a tile's four operands into t.in (one commit group).
__device__ __forceinline__ void fetch_tile(const Fp2Ptrs& p, int64_t tile, int64_t rows,
                                           Fp2Tile& t) {
  const int live = tile_live(tile, rows);
  constexpr int kSteps = (4 * kTileChunks + kTileThreads - 1) / kTileThreads;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int i = threadIdx.x + step * kTileThreads;
    if (i < 4 * kTileChunks) {
      const int op = i / kTileChunks, w = i % kTileChunks;
      const int e = w / (kFp2Limbs / 2), j = 2 * (w % (kFp2Limbs / 2));
      const int64_t* src = operand(p, op) + (tile * kTileElems + (e < live ? e : 0)) * kFp2Limbs + j;
      cp_async16(&t.in[op][e][j], src, e < live);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies are done (a __syncthreads then shows all of them).
__device__ __forceinline__ void fetch_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Row e of a staged operand, narrowed to 32-bit words.
__device__ __forceinline__ void read_row(const int64_t (&in)[kTileElems][kRowWords], int e,
                                         uint32_t (&x)[kFp2Limbs]) {
  const uint4* row = reinterpret_cast<const uint4*>(&in[e][0]);
#pragma unroll
  for (int q = 0; q < kFp2Limbs / 2; ++q) {
    const uint4 w = row[q];  // limbs 2q and 2q + 1, little-endian int64 < 2^24
    x[2 * q] = w.x;
    x[2 * q + 1] = w.z;
  }
}

__device__ __forceinline__ void store_tile(const Fp2Ptrs& p, int64_t tile, int64_t rows,
                                           const Fp2Tile& t) {
  const int live = tile_live(tile, rows);
  constexpr int kSteps = (2 * kTileChunks + kTileThreads - 1) / kTileThreads;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int i = threadIdx.x + step * kTileThreads;
    const int op = i / kTileChunks, w = i % kTileChunks;
    const int e = w / (kFp2Limbs / 2), j = 2 * (w % (kFp2Limbs / 2));
    if (i < 2 * kTileChunks && e < live)
      reinterpret_cast<longlong2*>(result(p, op) + (tile * kTileElems + e) * kFp2Limbs)[j / 2] =
          make_longlong2(t.out[op][j][e], t.out[op][j + 1][e]);
  }
}

__device__ __forceinline__ void read_plane(const uint32_t (&plane)[kFp2Limbs][kPlane], int e,
                                           uint32_t (&x)[kFp2Limbs]) {
#pragma unroll
  for (int j = 0; j < kFp2Limbs; ++j) x[j] = plane[j][e];
}

__device__ __forceinline__ void write_plane(uint32_t (&plane)[kFp2Limbs][kPlane], int e,
                                            const uint32_t (&x)[kFp2Limbs]) {
#pragma unroll
  for (int j = 0; j < kFp2Limbs; ++j) plane[j][e] = x[j];
}

// The tile loop. `product(x, y, r)` is r = x y R^-1 mod p for this
// thread's product; every thread of the block calls it once a tile.
template <class Product>
__device__ __forceinline__ void fp2_mul_tiles(const Fp2Ptrs& p, int64_t rows, const Modulus& m,
                                              Fp2Tile& t, Product&& product) {
  const int k = threadIdx.x / kTileElems, e = threadIdx.x % kTileElems;
  const int64_t tiles = (rows + kTileElems - 1) / kTileElems;
  if (blockIdx.x < tiles) fetch_tile(p, blockIdx.x, rows, t);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    fetch_wait();
    __syncthreads();
    uint32_t x[kFp2Limbs], y[kFp2Limbs], r[kFp2Limbs];
    if (k < 2) {
      read_row(t.in[k], e, x);
      read_row(t.in[2 + k], e, y);
    } else {
      read_row(t.in[0], e, x);
      read_row(t.in[1], e, r);
      add_mod<kFp2Limbs>(x, r, x, m);
      read_row(t.in[2], e, y);
      read_row(t.in[3], e, r);
      add_mod<kFp2Limbs>(y, r, y, m);
    }
    __syncthreads();  // every operand is in registers: the staging rows are free
    if (tile + gridDim.x < tiles) fetch_tile(p, tile + gridDim.x, rows, t);
    product(x, y, r);
    write_plane(t.prod[k], e, r);
    __syncthreads();
    if (k < 2) {
      read_plane(t.prod[0], e, x);
      read_plane(t.prod[1], e, y);
      if (k == 0) {
        sub_mod<kFp2Limbs>(x, y, r, m);
      } else {
        add_mod<kFp2Limbs>(x, y, r, m);
        read_plane(t.prod[2], e, x);
        sub_mod<kFp2Limbs>(x, r, r, m);
      }
      write_plane(t.out[k], e, r);
    }
    __syncthreads();
    store_tile(p, tile, rows, t);
  }
}

}  // namespace charon
