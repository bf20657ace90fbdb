// K1: batched Montgomery product a * b * R^-1 mod m over Fp (16 limbs) or
// Fr (11 limbs), one thread per element.
//
// Replaces the TPU kernel charon_tpu/ops/pallas_mont.py mont_mul_pallas ->
// _mont_kernel_body -> _mont_core (separated-operand Montgomery in VMEM:
// t = a b, m = (t mod R)(-m^-1) mod R, s = t + m p, high half with a fused
// conditional subtract). Here the same value comes from a CIOS product
// (mont_field.cuh) — reduced Montgomery values are unique, so the result
// equals the TPU kernel's and the JAX package's limb for limb.
//
// Bound on the H100 (per element, Fp): the int64 interface moves
// 3 x 16 x 8 = 384 bytes (a, b read once, out written once), 0.115 ns at
// 3.35 TB/s; the product needs 2 N^2 + N = 528 limb multiply-adds, 0.032 ns
// at 33.5 T int32 ops/s (64 IMAD/clk/SM, 132 SMs, 1.98 GHz, a multiply-add
// counted as two ops). Fr: 264 bytes (0.079 ns) against 253 multiply-adds
// (0.015 ns). So the kernel is bound by bytes: each thread reads its two
// operands once into registers, keeps every intermediate column in
// registers, and writes the reduced result once — nothing else touches
// device memory. The int64 storage of 24-bit limbs costs 2.7x the bytes of
// packed limbs; that is the interface's price, kept for element-for-element
// parity with the JAX package.

#include "mont_field.cuh"

namespace charon {

template <int N>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                    int64_t* __restrict__ out, int64_t rows, Modulus m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  uint32_t x[N], y[N], r[N];
  load_limbs<N>(a, row, x);
  load_limbs<N>(b, row, y);
  mont_mul<N>(x, y, r, m);
  store_limbs<N>(out, row, r);
}

}  // namespace charon

extern "C" int charon_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int64_t rows,
                               int n_limbs, const int64_t* mod_limbs, int64_t pinv,
                               void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_limbs) {
    case 16:
      mont_mul_kernel<16><<<grid_for(rows), kThreads, 0, s>>>(a, b, out, rows, m);
      break;
    case 11:
      mont_mul_kernel<11><<<grid_for(rows), kThreads, 0, s>>>(a, b, out, rows, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* charon_mont_mul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
