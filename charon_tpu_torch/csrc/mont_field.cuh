// Per-thread BLS12-381 field arithmetic on 24-bit limbs, shared by every
// kernel: the Montgomery product of K1-K3 (mont_mul.cu, fp2.cu), and the
// modular sums and final conditional subtraction of K4-K6 (mont_mxu.cuh).
//
// Limb layout: the port's public interface, int64 tensors of 24-bit limbs
// (Fp: 16 limbs, Fr: 11 limbs, little-endian), so the Montgomery radix is
// R = 2^(24 N): 2^384 for Fp and 2^264 for Fr, equal to the JAX package's
// CPU geometry. The kernels keep that radix inside: limbs are held in
// 32-bit registers, every limb product is one widening 32x32->64 multiply
// (a 24x24-bit product is < 2^48), and columns accumulate in 64 bits with
// no carry handling until the end (2N products per column < 2^54).
//
// Design: one product a thread, operands in registers, a coarsely
// integrated operand-scanning (CIOS) Montgomery product with lazy carries,
// one sequential carry pass and one conditional subtraction. The TPU
// kernels' 256-row tiles, parallel-carry Kogge-Stone passes and bool-free
// flag tricks were workarounds for Mosaic's vector units and have no
// counterpart here: a thread resolves its own carries in order, and a
// branch-free select replaces the flag arithmetic.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace charon {

constexpr int kLimbBits = 24;
constexpr uint32_t kLimbMask = (1u << kLimbBits) - 1;
constexpr int kMaxLimbs = 16;
constexpr int kThreads = 128;

// The modulus, passed to every kernel by value (it lands in the constant
// bank, where the unrolled loops read each limb as an immediate operand).
struct Modulus {
  uint32_t p[kMaxLimbs];
  uint32_t pinv;  // -p^-1 mod 2^24
};

inline Modulus make_modulus(const int64_t* limbs, int n, int64_t pinv) {
  Modulus m{};
  for (int j = 0; j < n && j < kMaxLimbs; ++j) m.p[j] = static_cast<uint32_t>(limbs[j]);
  m.pinv = static_cast<uint32_t>(pinv);
  return m;
}

inline unsigned grid_for(int64_t rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

template <int N>
__device__ __forceinline__ void load_limbs(const int64_t* __restrict__ src, int64_t row,
                                           uint32_t (&x)[N]) {
  const int64_t* s = src + row * N;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = static_cast<uint32_t>(s[j]);
}

template <int N>
__device__ __forceinline__ void store_limbs(int64_t* __restrict__ dst, int64_t row,
                                            const uint32_t (&x)[N]) {
  int64_t* d = dst + row * N;
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = static_cast<int64_t>(x[j]);
}

// r = x - p if x >= p else x, for canonical-limb x < 2p.
template <int N>
__device__ __forceinline__ void cond_sub_p(uint32_t (&x)[N], const Modulus& m) {
  uint32_t d[N];
  int32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int32_t v = static_cast<int32_t>(x[j]) - static_cast<int32_t>(m.p[j]) + borrow;
    d[j] = static_cast<uint32_t>(v) & kLimbMask;
    borrow = v >> kLimbBits;  // arithmetic shift: -1 or 0
  }
  const bool ge = (borrow == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = ge ? d[j] : x[j];
}

// r = a * b * 2^(-24 N) mod p for reduced a, b < p.
template <int N>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                         uint32_t (&r)[N], const Modulus& m) {
  uint64_t t[N];
#pragma unroll
  for (int j = 0; j < N; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // t[j] holds column i + j of a * b + q * p.
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] += static_cast<uint64_t>(a[i]) * b[j];
    const uint32_t q = (static_cast<uint32_t>(t[0]) * m.pinv) & kLimbMask;
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] += static_cast<uint64_t>(q) * m.p[j];
    // column i is now 0 mod 2^24: pass its carry up and drop it
    const uint64_t c = t[0] >> kLimbBits;
#pragma unroll
    for (int j = 0; j < N - 1; ++j) t[j] = t[j + 1];
    t[N - 1] = 0;
    t[0] += c;
  }
  // (a b + q p) / R < 2p < R: one carry pass, then one conditional subtract
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    carry += t[j];
    r[j] = static_cast<uint32_t>(carry) & kLimbMask;
    carry >>= kLimbBits;
  }
  cond_sub_p<N>(r, m);
}

// r = a + b mod p.
template <int N>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                        uint32_t (&r)[N], const Modulus& m) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = a[j] + b[j] + c;
    r[j] = v & kLimbMask;
    c = v >> kLimbBits;
  }
  cond_sub_p<N>(r, m);  // a + b < 2p < R, so the top carry is 0
}

// r = a - b mod p.
template <int N>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[N], const uint32_t (&b)[N],
                                        uint32_t (&r)[N], const Modulus& m) {
  int32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int32_t v = static_cast<int32_t>(a[j]) - static_cast<int32_t>(b[j]) + borrow;
    r[j] = static_cast<uint32_t>(v) & kLimbMask;
    borrow = v >> kLimbBits;
  }
  const uint32_t add = borrow ? 0xffffffffu : 0u;  // a < b: add p back
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = r[j] + (m.p[j] & add) + c;
    r[j] = v & kLimbMask;
    c = v >> kLimbBits;
  }
}

}  // namespace charon
