// K4: batched Montgomery product a * b * R^-1 mod m over Fp (16 limbs) or
// Fr (11 limbs), with the two constant convolutions on the int8 tensor
// cores (mont_mxu.cuh), one row a thread, 128 rows a block.
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
// K4, like K1, is bound by bytes. Its design answers what is new about it:
// the constant operands live in shared memory once a block, the pieces
// and column sums move between registers and shared memory, never device
// memory, and the MMA depth of 32 fits the 12-bit split exactly.

#include "mont_mxu.cuh"

namespace charon {

template <int N>
__global__ void __launch_bounds__(kThreads)
    mont_mul_mxu_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                        int64_t* __restrict__ out, const int8_t* __restrict__ tables,
                        int64_t rows, Modulus m) {
  __shared__ MxuShared sm;
  load_tables(tables, sm);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < rows;  // dead rows run the warp's MMAs on zeros
  uint32_t x[N] = {}, y[N] = {}, r[N];
  if (live) {
    load_limbs<N>(a, row, x);
    load_limbs<N>(b, row, y);
  }
  mont_mul_mxu<N>(x, y, r, m, sm);
  if (live) store_limbs<N>(out, row, r);
}

}  // namespace charon

extern "C" int charon_mont_mul_mxu(const int64_t* a, const int64_t* b, int64_t* out,
                                   const int8_t* tables, int64_t rows, int n_limbs,
                                   const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_limbs) {
    case 16:
      mont_mul_mxu_kernel<16><<<grid_for(rows), kThreads, 0, s>>>(a, b, out, tables, rows, m);
      break;
    case 11:
      mont_mul_mxu_kernel<11><<<grid_for(rows), kThreads, 0, s>>>(a, b, out, tables, rows, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* charon_mont_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
