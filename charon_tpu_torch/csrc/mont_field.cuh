// Per-thread BLS12-381 field arithmetic, shared by every kernel: the
// Montgomery products of K1-K3 (mont_mul.cu, fp2.cu), and the modular sums
// and final conditional subtraction of K4-K6 (mont_mxu.cuh).
//
// Limb layout: the port's public interface, int64 tensors of 24-bit limbs
// (Fp: 16 limbs, Fr: 11 limbs, little-endian), so the Montgomery radix is
// R = 2^(24 N): 2^384 for Fp and 2^264 for Fr, equal to the JAX package's
// CPU geometry. Limbs are held in 32-bit registers.
//
// Two products, one a thread, each a coarsely integrated operand-scanning
// (CIOS) Montgomery product ending in one conditional subtraction:
//   - mont_mul<N> on the 24-bit limbs: every limb product is one widening
//     32x32->64 multiply (< 2^48), and columns accumulate in 64 bits with
//     no carry handling until the end (2N products per column < 2^54);
//     2 N^2 + N multiply-adds, 528 for Fp, 253 for Fr;
//   - mont_mul32, Fp only, on 32-bit words: the 16 limbs regrouped into 12
//     words of the same integer, so R stays 2^384 and the result is the
//     same, for 12 x 12 x 2 + 12 = 300 multiply-adds with their carries
//     resolved in order. Fr has no such form: 264 bits are no whole number
//     of words, and a 32-bit radix would change R.
// The TPU kernels' 256-row tiles, parallel-carry Kogge-Stone passes and
// bool-free flag tricks were workarounds for Mosaic's vector units and have
// no counterpart here: a thread resolves its own carries in order, and a
// branch-free select replaces the flag arithmetic.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace charon {

constexpr int kLimbBits = 24;
constexpr uint32_t kLimbMask = (1u << kLimbBits) - 1;
constexpr int kMaxLimbs = 16;
constexpr int kFpLimbs = 16;
constexpr int kFpWords = 12;  // 32-bit words of an Fp element: 4 limbs make 3 words

// Fp's 16 24-bit limbs as the 12 32-bit words of the same integer.
__host__ __device__ __forceinline__ void limbs_to_words(const uint32_t (&x)[kFpLimbs],
                                                        uint32_t (&w)[kFpWords]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    w[3 * g] = x[4 * g] | x[4 * g + 1] << 24;
    w[3 * g + 1] = x[4 * g + 1] >> 8 | x[4 * g + 2] << 16;
    w[3 * g + 2] = x[4 * g + 2] >> 16 | x[4 * g + 3] << 8;
  }
}

__device__ __forceinline__ void words_to_limbs(const uint32_t (&w)[kFpWords],
                                               uint32_t (&x)[kFpLimbs]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    x[4 * g] = w[3 * g] & kLimbMask;
    x[4 * g + 1] = (w[3 * g] >> 24 | w[3 * g + 1] << 8) & kLimbMask;
    x[4 * g + 2] = (w[3 * g + 1] >> 16 | w[3 * g + 2] << 16) & kLimbMask;
    x[4 * g + 3] = w[3 * g + 2] >> 8;
  }
}

// The modulus, passed to every kernel by value (it lands in the constant
// bank, where the unrolled loops read each limb as an immediate operand).
struct Modulus {
  uint32_t p[kMaxLimbs];
  uint32_t pinv;           // -p^-1 mod 2^24
  uint32_t p32[kFpWords];  // Fp only: p in 32-bit words
  uint32_t pinv32;         // Fp only: -p^-1 mod 2^32
};

inline Modulus make_modulus(const int64_t* limbs, int n, int64_t pinv) {
  Modulus m{};
  for (int j = 0; j < n && j < kMaxLimbs; ++j) m.p[j] = static_cast<uint32_t>(limbs[j]);
  m.pinv = static_cast<uint32_t>(pinv);
  if (n == kFpLimbs) {
    limbs_to_words(m.p, m.p32);
    // p^-1 mod 2^32 by Newton's iteration: an odd p is its own inverse mod
    // 2^3, and each step doubles the low bits that are right (to 48)
    uint32_t inv = m.p32[0];
    for (int k = 0; k < 4; ++k) inv *= 2u - m.p32[0] * inv;
    m.pinv32 = 0u - inv;
  }
  return m;
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

// r = a * b * 2^(-24 N) mod p for reduced a, b < p, on 24-bit limbs.
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

// r = a * b * 2^-384 mod p over Fp for reduced a, b < p, on 32-bit words:
// the same R as mont_mul<16>, so the same result. CIOS with no carry word
// above the top one: p's top word, 0x1a0111ea, is below 2^31 - 1, so for
// a, b < p each step's (t + a b_i + q p) / 2^32 stays below 2p < 2^384 and
// fits t's 12 words, and the two carries A + C that form its top word never
// carry out of it. Each multiply-add of two 32-bit addends fits 64 bits:
// (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1.
__device__ __forceinline__ void mont_mul32(const uint32_t (&a)[kFpLimbs],
                                           const uint32_t (&b)[kFpLimbs],
                                           uint32_t (&r)[kFpLimbs], const Modulus& m) {
  uint32_t x[kFpWords], y[kFpWords], t[kFpWords];
  limbs_to_words(a, x);
  limbs_to_words(b, y);
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kFpWords; ++i) {
    uint64_t s = static_cast<uint64_t>(x[0]) * y[i] + t[0];
    uint32_t A = static_cast<uint32_t>(s >> 32);  // carry of t + x y_i
    const uint32_t q = static_cast<uint32_t>(s) * m.pinv32;
    uint32_t C = static_cast<uint32_t>(
        (static_cast<uint64_t>(q) * m.p32[0] + static_cast<uint32_t>(s)) >> 32);  // of + q p
#pragma unroll
    for (int j = 1; j < kFpWords; ++j) {
      s = static_cast<uint64_t>(x[j]) * y[i] + t[j] + A;
      A = static_cast<uint32_t>(s >> 32);
      const uint64_t c = static_cast<uint64_t>(q) * m.p32[j] + static_cast<uint32_t>(s) + C;
      C = static_cast<uint32_t>(c >> 32);
      t[j - 1] = static_cast<uint32_t>(c);
    }
    t[kFpWords - 1] = A + C;
  }
  // t < 2p: one conditional subtraction
  uint32_t d[kFpWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) {
    const uint64_t v = static_cast<uint64_t>(t[j]) - m.p32[j] - borrow;
    d[j] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) t[j] = borrow ? t[j] : d[j];
  words_to_limbs(t, r);
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
