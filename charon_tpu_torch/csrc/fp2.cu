// K2 and K3: fused Fp2 multiply and square, one thread per Fp2 element.
//
// K2 replaces charon_tpu/ops/pallas_mont.py fp2_mul_pallas ->
// _fp2_mul_kernel_body -> _fp2_mul_math (Karatsuba: v0 = a0 b0,
// v1 = a1 b1, s = (a0 + a1)(b0 + b1); c0 = v0 - v1, c1 = s - (v0 + v1)).
// K3 replaces fp2_sqr_pallas -> _fp2_sqr_kernel_body -> _fp2_sqr_math
// (c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1).
//
// What the TPU kernels buy, and these keep: the prep sums, the three (two)
// Montgomery products and the recombination never reach device memory.
// Each thread loads its operands into registers, runs the whole formula
// there (mont_field.cuh) and writes the two reduced output coordinates.
//
// Bound on the H100 (per Fp2 element, 16-limb Fp in int64 limbs): K2 moves
// 6 x 128 = 768 bytes (0.229 ns at 3.35 TB/s) against 3 x 528 = 1584 limb
// multiply-adds (0.095 ns at 33.5 T int32 ops/s, a multiply-add counted as
// two ops); K3 moves 512 bytes (0.153 ns) against 1056 multiply-adds
// (0.063 ns). Both are bound by bytes, which the fusion already holds to
// one read of each input and one write of each output.

#include "mont_field.cuh"

namespace charon {

template <int N>
__global__ void __launch_bounds__(kThreads)
    fp2_mul_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                   const int64_t* __restrict__ b0, const int64_t* __restrict__ b1,
                   int64_t* __restrict__ c0, int64_t* __restrict__ c1, int64_t rows,
                   Modulus m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  uint32_t x0[N], x1[N], y0[N], y1[N];
  load_limbs<N>(a0, row, x0);
  load_limbs<N>(a1, row, x1);
  load_limbs<N>(b0, row, y0);
  load_limbs<N>(b1, row, y1);
  uint32_t ta[N], tb[N], v0[N], v1[N], s[N], r[N];
  add_mod<N>(x0, x1, ta, m);
  add_mod<N>(y0, y1, tb, m);
  mont_mul<N>(x0, y0, v0, m);
  mont_mul<N>(x1, y1, v1, m);
  mont_mul<N>(ta, tb, s, m);
  sub_mod<N>(v0, v1, r, m);
  store_limbs<N>(c0, row, r);
  add_mod<N>(v0, v1, ta, m);
  sub_mod<N>(s, ta, r, m);
  store_limbs<N>(c1, row, r);
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

extern "C" int charon_fp2_mul(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                              const int64_t* b1, int64_t* c0, int64_t* c1, int64_t rows,
                              int n_limbs, const int64_t* mod_limbs, int64_t pinv,
                              void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (n_limbs != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  fp2_mul_kernel<16><<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, b0, b1, c0, c1, rows, m);
  return static_cast<int>(cudaGetLastError());
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
