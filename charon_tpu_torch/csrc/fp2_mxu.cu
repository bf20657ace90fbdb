// K5 and K6: fused Fp2 multiply and square with int8 tensor-core
// Montgomery products, one Fp2 element a thread, 128 a block.
//
// K5 replaces charon_tpu/ops/pallas_mont.py fp2_mul_pallas(mxu=True) ->
// _fp2_mul_mxu_kernel_body; K6 replaces fp2_sqr_pallas(mxu=True) ->
// _fp2_sqr_mxu_kernel_body. The formulas are K2's and K3's (fp2.cu):
// Karatsuba prep sums and recombination in registers, with each of the
// three (two) inner products the tensor-core product of mont_mxu.cuh. The
// products run one after another through one set of shared staging
// buffers, so a block's shared memory is K4's.
//
// Bound on the NVIDIA H100 80GB HBM3 at its 700 W power limit, from the
// data sheet's peak rates (per Fp2 element): K5 moves 768 bytes (0.229 ns at
// 3.35 TB/s) against 3 x 256 limb multiply-adds on the CUDA cores
// (0.046 ns) and 3 x 4 x 32 x 96 int8 multiply-adds on the tensor cores
// (0.037 ns); K6 moves 512 bytes (0.153 ns) against two products. Both
// are bound by bytes, which the fusion holds to one read of each input and
// one write of each output.

#include "mont_mxu.cuh"

namespace charon {

template <int N>
__global__ void __launch_bounds__(kThreads)
    fp2_mul_mxu_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                       const int64_t* __restrict__ b0, const int64_t* __restrict__ b1,
                       int64_t* __restrict__ c0, int64_t* __restrict__ c1,
                       const int8_t* __restrict__ tables, int64_t rows, Modulus m) {
  __shared__ MxuShared sm;
  load_tables(tables, sm);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < rows;  // dead rows run the warp's MMAs on zeros
  uint32_t x0[N] = {}, x1[N] = {}, y0[N] = {}, y1[N] = {};
  if (live) {
    load_limbs<N>(a0, row, x0);
    load_limbs<N>(a1, row, x1);
    load_limbs<N>(b0, row, y0);
    load_limbs<N>(b1, row, y1);
  }
  uint32_t ta[N], tb[N], v0[N], v1[N], s[N], r[N];
  add_mod<N>(x0, x1, ta, m);
  add_mod<N>(y0, y1, tb, m);
  mont_mul_mxu<N>(ta, tb, s, m, sm);
  mont_mul_mxu<N>(x0, y0, v0, m, sm);
  mont_mul_mxu<N>(x1, y1, v1, m, sm);
  sub_mod<N>(v0, v1, r, m);
  if (live) store_limbs<N>(c0, row, r);
  add_mod<N>(v0, v1, ta, m);
  sub_mod<N>(s, ta, r, m);
  if (live) store_limbs<N>(c1, row, r);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    fp2_sqr_mxu_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                       int64_t* __restrict__ c0, int64_t* __restrict__ c1,
                       const int8_t* __restrict__ tables, int64_t rows, Modulus m) {
  __shared__ MxuShared sm;
  load_tables(tables, sm);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < rows;
  uint32_t x0[N] = {}, x1[N] = {};
  if (live) {
    load_limbs<N>(a0, row, x0);
    load_limbs<N>(a1, row, x1);
  }
  uint32_t ta[N], ts[N], r[N];
  add_mod<N>(x0, x1, ta, m);
  sub_mod<N>(x0, x1, ts, m);
  mont_mul_mxu<N>(ta, ts, r, m, sm);
  if (live) store_limbs<N>(c0, row, r);
  mont_mul_mxu<N>(x0, x1, ta, m, sm);
  add_mod<N>(ta, ta, r, m);
  if (live) store_limbs<N>(c1, row, r);
}

}  // namespace charon

extern "C" int charon_fp2_mul_mxu(const int64_t* a0, const int64_t* a1, const int64_t* b0,
                                  const int64_t* b1, int64_t* c0, int64_t* c1,
                                  const int8_t* tables, int64_t rows, int n_limbs,
                                  const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (n_limbs != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  fp2_mul_mxu_kernel<16><<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, b0, b1, c0, c1, tables, rows, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int charon_fp2_sqr_mxu(const int64_t* a0, const int64_t* a1, int64_t* c0,
                                  int64_t* c1, const int8_t* tables, int64_t rows, int n_limbs,
                                  const int64_t* mod_limbs, int64_t pinv, void* stream) {
  using namespace charon;
  if (rows <= 0) return 0;
  if (n_limbs != 16) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus m = make_modulus(mod_limbs, n_limbs, pinv);
  fp2_sqr_mxu_kernel<16><<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, c0, c1, tables, rows, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* charon_fp2_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
