"""The yardstick's table of peaks and the least time each hand-written
kernel could take at a row count.

Peaks of the NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, from
NVIDIA's data sheet, dense: the HBM rate; the int32 multiply-add rate,
half the 67 TFLOP/s fp32 rate outside the tensor cores since Hopper
issues IMAD at half the FFMA rate, a multiply-add counted as two
operations; and the int8 tensor-core rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
INT8_TC_OPS_PER_S = 1979e12


def cios(n: int) -> int:
    """Multiply-adds of a CIOS Montgomery product over n words: a b, q p
    and q. K1-K3 take it over Fp's 12 32-bit words, K1 over Fr's 11
    24-bit limbs."""
    return 2 * n * n + n


def tc(n: int) -> int:
    """int8 multiply-adds of K4's two constant convolutions: four piece
    products over 2n 12-bit halves, into 2n and 4n columns."""
    return 4 * (2 * n) * (2 * n + 4 * n)


# kernel (the program's launch-count name) -> (operands in, operands out,
# limbs an operand, multiply-adds an element on the CUDA cores, int8
# multiply-adds an element on the tensor cores); operands are int64 limbs
KERNELS = {
    "mont_mul_fp": (2, 1, 16, cios(12), 0),
    "mont_mul_fr": (2, 1, 11, cios(11), 0),
    "fp2_mul": (4, 2, 16, 3 * cios(12), 0),
    "fp2_sqr": (2, 2, 16, 2 * cios(12), 0),
    "mont_mul_mxu_fp": (2, 1, 16, 16 * 16, tc(16)),
    "mont_mul_mxu_fr": (2, 1, 11, 11 * 11, tc(11)),
    "fp2_mul_mxu": (4, 2, 16, 3 * 16 * 16, 3 * tc(16)),
    "fp2_sqr_mxu": (2, 2, 16, 2 * 16 * 16, 2 * tc(16)),
}


def bound_s(kernel: str, rows: int) -> float:
    """The larger of the bytes term (each input limb read once, each
    output limb written once) and the operations term, in seconds."""
    n_in, n_out, limbs, imad, int8 = KERNELS[kernel]
    t_bytes = rows * (n_in + n_out) * limbs * 8 / HBM_BYTES_PER_S
    t_ops = rows * imad * 2 / INT32_OPS_PER_S + rows * int8 * 2 / INT8_TC_OPS_PER_S
    return max(t_bytes, t_ops)
