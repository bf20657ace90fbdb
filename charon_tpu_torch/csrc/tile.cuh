// Tiled batched field kernels: the staged tile, its fetch and store, and
// the persistent tile loop, shared by every kernel: K1 (mont_mul.cu), K2
// and K3 (fp2.cu), K4 (mont_mxu.cu), K5 and K6 (fp2_mxu.cu).
//
// A launch walks tiles of Elems elements (Fp or Fr elements for K1 and K4,
// Fp2 elements for K2, K3, K5, K6), the tile's threads split into warp-uniform roles
// of Elems threads each, one Montgomery product a thread. A block takes
// tiles b, b + gridDim.x, b + 2 gridDim.x, ... (ops/mont_kernels.
// mont_geometry and fp2_geometry set the grid to at most the card's
// resident blocks, so large launches run in whole waves). Per tile:
//
//   1. fetch: each operand's tile is one contiguous run of Elems x N int64
//      limbs; the block copies it into shared memory with 16-byte
//      asynchronous copies (cp.async, zero-filled past the last row). Rows
//      of an even limb count are staged 16 bytes apart more than they are
//      long (Fp: 144 bytes for 128), so that a thread reading its own row
//      16 bytes at a time meets no bank conflict; rows of an odd limb count
//      (Fr: 88 bytes) straddle 16-byte words and are staged as they are,
//      read 8 bytes at a time: a half-warp's 16 rows then start 22 banks
//      apart, which is all 16 even banks. The next tile's fetch starts as
//      soon as this tile's operands are in registers, so it streams in
//      while this tile computes;
//   2. compute: each thread forms its operands from the staged rows,
//      computes its product and writes its output coordinate into a limb
//      plane of 32-bit words (plane[limb][elem], padded to Elems + 1 words:
//      one bank a thread);
//   3. store: the output tiles back with 16-byte coalesced stores.
//
// Rows past the end of the last tile stage as zeros, compute on zeros (the
// tensor-core product needs every lane of a warp) and are never stored.
// Operand and result pointers must be 16-byte aligned (the wrappers see to
// it).

#pragma once

#include "mont_field.cuh"

namespace charon {

constexpr int kFp2Limbs = 16;
constexpr int kTileElems = 32;  // Fp2 elements a tile of K2, K3, K5 and K6: one warp a role
constexpr int kWarpRows = 32;   // a warp's rows: K1's and K4's tile for launches up to that many

// int64 words a staged row takes in shared memory
template <int N>
constexpr int kRowWords = N % 2 == 0 ? N + 2 : N;

template <int Ins, int Outs>
struct TilePtrs {
  const int64_t* in[Ins];
  int64_t* out[Outs];
};

template <int N, int Elems, int Ins, int Outs>
struct Tile {
  static_assert(Elems % 32 == 0, "a tile is whole warps");
  static constexpr int kChunks = Elems * N / 2;  // 16-byte chunks of one operand's tile
  alignas(16) int64_t in[Ins][Elems * kRowWords<N>];  // operands as fetched
  uint32_t out[Outs][N][Elems + 1];                   // output limb planes
};

// ptrs[k] as selects: indexing a kernel parameter's array with a value
// known only at run time would copy the array to local memory. The chain
// is written out: as a loop of selects it compiled to predicated constant
// loads in every fetch step, and K2 ran 15 % slower on the H100.
template <class T, int K>
__device__ __forceinline__ T* pick(T* const (&ptrs)[K], int k) {
  static_assert(K <= 4, "up to four operands");
  if constexpr (K == 1) return ptrs[0];
  else if constexpr (K == 2) return k == 0 ? ptrs[0] : ptrs[1];
  else if constexpr (K == 3) return k == 0 ? ptrs[0] : k == 1 ? ptrs[1] : ptrs[2];
  else return k == 0 ? ptrs[0] : k == 1 ? ptrs[1] : k == 2 ? ptrs[2] : ptrs[3];
}

template <int Elems>
__device__ __forceinline__ int tile_live(int64_t tile, int64_t rows) {
  const int64_t left = rows - tile * Elems;
  return left < Elems ? static_cast<int>(left) : Elems;
}

// 16 bytes from global to shared memory, asynchronously: the first
// src_bytes (0, 8 or 16) copied, the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies are done but for its Pending most recent groups (a
// __syncthreads then shows the done ones to the block).
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Start the copies of tile `tile`'s operands into t.in and commit them as
// one group; past the last tile, commit an empty group, so that every
// pass of the tile loop commits exactly one. Copy i of an operand is its
// 16-byte chunk i: for an even limb count, limbs j, j + 1 of one row; for
// an odd one, limbs 2i, 2i + 1 of the tile, which may lie on two rows.
template <int Threads, int N, int Elems, int Ins, int Outs>
__device__ __forceinline__ void fetch_tile(const TilePtrs<Ins, Outs>& p, int64_t tile,
                                           int64_t tiles, int64_t rows,
                                           Tile<N, Elems, Ins, Outs>& t) {
  constexpr int kChunks = Tile<N, Elems, Ins, Outs>::kChunks;
  if (tile < tiles) {
    const int live = tile_live<Elems>(tile, rows);
    constexpr int kSteps = (Ins * kChunks + Threads - 1) / Threads;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int i = threadIdx.x + step * Threads;
      if (i < Ins * kChunks) {
        const int op = i / kChunks, w = i % kChunks;
        if constexpr (N % 2 == 0) {
          const int e = w / (N / 2), j = 2 * (w % (N / 2));
          const int64_t* src = pick(p.in, op) + (tile * Elems + (e < live ? e : 0)) * N + j;
          cp_async16(&t.in[op][e * kRowWords<N> + j], src, e < live ? 16 : 0);
        } else {
          const int g = 2 * w, bytes = 8 * min(max(live * N - g, 0), 2);
          const int64_t* src = pick(p.in, op) + tile * Elems * N + (bytes ? g : 0);
          cp_async16(&t.in[op][g], src, bytes);
        }
      }
    }
  }
  cp_async_commit();
}

// Row e of a staged operand, narrowed to 32-bit words.
template <int N>
__device__ __forceinline__ void read_row(const int64_t* in, int e, uint32_t (&x)[N]) {
  const int64_t* row = in + e * kRowWords<N>;
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(row)[q];  // limbs 2q, 2q + 1: int64 < 2^24
      x[2 * q] = w.x;
      x[2 * q + 1] = w.z;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = static_cast<uint32_t>(row[j]);
  }
}

template <int N, int P>
__device__ __forceinline__ void read_plane(const uint32_t (&plane)[N][P], int e,
                                           uint32_t (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = plane[j][e];
}

template <int N, int P>
__device__ __forceinline__ void write_plane(uint32_t (&plane)[N][P], int e,
                                            const uint32_t (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) plane[j][e] = x[j];
}

// The output tiles from t.out back to device memory, 16 bytes a store,
// chunk by chunk as fetch_tile copies them (8 bytes where an odd limb
// count's chunk has its second limb past the last row).
template <int Threads, int N, int Elems, int Ins, int Outs>
__device__ __forceinline__ void store_tile(const TilePtrs<Ins, Outs>& p, int64_t tile,
                                           int64_t rows, const Tile<N, Elems, Ins, Outs>& t) {
  constexpr int kChunks = Tile<N, Elems, Ins, Outs>::kChunks;
  const int live = tile_live<Elems>(tile, rows);
  constexpr int kSteps = (Outs * kChunks + Threads - 1) / Threads;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int i = threadIdx.x + step * Threads;
    const int op = i / kChunks, w = i % kChunks;
    if constexpr (N % 2 == 0) {
      const int e = w / (N / 2), j = 2 * (w % (N / 2));
      if (i < Outs * kChunks && e < live)
        reinterpret_cast<longlong2*>(pick(p.out, op) + (tile * Elems + e) * N)[j / 2] =
            make_longlong2(t.out[op][j][e], t.out[op][j + 1][e]);
    } else {
      const int g = 2 * w;
      if (i >= Outs * kChunks || g >= live * N) continue;
      int64_t* dst = pick(p.out, op) + tile * Elems * N + g;
      const uint32_t lo = t.out[op][g % N][g / N];
      if (g + 1 < live * N)
        *reinterpret_cast<longlong2*>(dst) = make_longlong2(lo, t.out[op][(g + 1) % N][(g + 1) / N]);
      else
        *dst = lo;
    }
  }
}

// The tile loop of a launch of `rows` rows; every thread of the block
// calls it. `prologue()` issues copies that go out as one group right after
// the first tile's fetch (the int8 kernels' tables); `read(x, y)` forms
// this thread's operands from the staged tile; `compute(x, y, first)`
// computes its product and writes its outputs into t.out, `first` on the
// block's first tile (when the prologue's group may still be in flight: a
// compute that needs it waits with cp_async_wait<1>, which leaves only the
// next tile's fetch outstanding). compute may hold block-wide barriers.
template <int Threads, int N, int Elems, int Ins, int Outs, class Prologue, class Read,
          class Compute>
__device__ __forceinline__ void tile_loop(const TilePtrs<Ins, Outs>& p, int64_t rows,
                                          Tile<N, Elems, Ins, Outs>& t, Prologue&& prologue,
                                          Read&& read, Compute&& compute) {
  const int64_t tiles = (rows + Elems - 1) / Elems;
  fetch_tile<Threads>(p, blockIdx.x, tiles, rows, t);
  prologue();
  cp_async_commit();
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    if (first)
      cp_async_wait<1>();  // the operands; the prologue's group may stay in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    uint32_t x[N], y[N];
    read(x, y);
    __syncthreads();  // every operand is in registers: the staged rows are free
    fetch_tile<Threads>(p, tile + gridDim.x, tiles, rows, t);
    compute(x, y, first);
    __syncthreads();
    store_tile<Threads>(p, tile, rows, t);
  }
}

// ---------------------------------------------------------------------------
// The fused Fp2 multiply on the tile (K2, K5): four operand tiles, three
// roles k = 0, 1, 2 computing v0 = a0 b0, v1 = a1 b1 and s = (a0 + a1)(b0 +
// b1) (the s threads form the Karatsuba prep sums from the staged
// operands) into product planes; then c0 = v0 - v1 and c1 = s - (v0 + v1),
// one output coordinate a thread.
// ---------------------------------------------------------------------------

constexpr int kFp2MulThreads = 3 * kTileElems;

struct Fp2MulTile {
  Tile<kFp2Limbs, kTileElems, 4, 2> tile;  // a0, a1, b0, b1 -> c0, c1
  uint32_t prod[3][kFp2Limbs][kTileElems + 1];  // v0, v1, s
};

// `product(x, y, r, first)` is r = x y R^-1 mod p for this thread's
// product, `first` as in tile_loop.
template <class Prologue, class Product>
__device__ __forceinline__ void fp2_mul_tiles(const TilePtrs<4, 2>& p, int64_t rows,
                                              const Modulus& m, Fp2MulTile& t,
                                              Prologue&& prologue, Product&& product) {
  constexpr int N = kFp2Limbs;
  const int k = threadIdx.x / kTileElems, e = threadIdx.x % kTileElems;
  tile_loop<kFp2MulThreads>(
      p, rows, t.tile, prologue,
      [&](uint32_t (&x)[N], uint32_t (&y)[N]) {
        if (k < 2) {
          read_row<N>(t.tile.in[k], e, x);
          read_row<N>(t.tile.in[2 + k], e, y);
        } else {
          uint32_t w[N];
          read_row<N>(t.tile.in[0], e, x);
          read_row<N>(t.tile.in[1], e, w);
          add_mod<N>(x, w, x, m);
          read_row<N>(t.tile.in[2], e, y);
          read_row<N>(t.tile.in[3], e, w);
          add_mod<N>(y, w, y, m);
        }
      },
      [&](const uint32_t (&x)[N], const uint32_t (&y)[N], bool first) {
        uint32_t r[N], u[N], w[N];
        product(x, y, r, first);
        write_plane(t.prod[k], e, r);
        __syncthreads();
        if (k < 2) {
          read_plane(t.prod[0], e, u);
          read_plane(t.prod[1], e, w);
          if (k == 0) {
            sub_mod<N>(u, w, r, m);
          } else {
            add_mod<N>(u, w, r, m);
            read_plane(t.prod[2], e, u);
            sub_mod<N>(u, r, r, m);
          }
          write_plane(t.tile.out[k], e, r);
        }
      });
}

// ---------------------------------------------------------------------------
// The fused Fp2 square on the tile (K3, K6): two operand tiles, two roles:
// k = 0 forms (a0 + a1, a0 - a1) from the staged a0, a1 and computes c0 =
// (a0 + a1)(a0 - a1); k = 1 computes a0 a1 and writes c1 = 2 a0 a1.
// ---------------------------------------------------------------------------

constexpr int kFp2SqrThreads = 2 * kTileElems;

using Fp2SqrTile = Tile<kFp2Limbs, kTileElems, 2, 2>;  // a0, a1 -> c0, c1

// `product(x, y, r, first)` as in fp2_mul_tiles.
template <class Prologue, class Product>
__device__ __forceinline__ void fp2_sqr_tiles(const TilePtrs<2, 2>& p, int64_t rows,
                                              const Modulus& m, Fp2SqrTile& t,
                                              Prologue&& prologue, Product&& product) {
  constexpr int N = kFp2Limbs;
  const int k = threadIdx.x / kTileElems, e = threadIdx.x % kTileElems;
  tile_loop<kFp2SqrThreads>(
      p, rows, t, prologue,
      [&](uint32_t (&x)[N], uint32_t (&y)[N]) {
        read_row<N>(t.in[0], e, x);
        read_row<N>(t.in[1], e, y);
        if (k == 0) {
          uint32_t s[N];
          add_mod<N>(x, y, s, m);
          sub_mod<N>(x, y, y, m);
#pragma unroll
          for (int j = 0; j < N; ++j) x[j] = s[j];
        }
      },
      [&](const uint32_t (&x)[N], const uint32_t (&y)[N], bool first) {
        uint32_t r[N];
        product(x, y, r, first);
        if (k == 1) add_mod<N>(r, r, r, m);
        write_plane(t.out[k], e, r);
      });
}

// Launch a tiled kernel with `smem` bytes of dynamic shared memory, asking
// for more than the 48 KB a block gets by default where it needs it;
// returns the launch's error code.
template <class... Params, class... Args>
inline int launch_tiled(void (*kernel)(Params...), int grid, int threads, int smem, void* stream,
                        Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace charon
