"""int8 tensor-core decomposition of the Montgomery product's two constant
convolutions, on the port's 24-bit limbs.

The port of charon_tpu/ops/limb_mxu.py. The separated-operand Montgomery
product (mont_kernels.mont_mul_plain) spends its work in three limb
convolutions; two multiply by constants, t * (-p^-1) mod R and m * p, and a
convolution by a constant c is a matmul against its Toeplitz band matrix:

    conv(x, c)[k] = sum_i x[i] * c[k-i]  =  (x @ T_c)[k],   T_c[i, k] = c[k-i]

With entries cut into 6-bit pieces the matmul is exact in int8 x int8 ->
int32, the mode of the TPU's MXU and of Hopper's int8 tensor cores. Pieces
stay in [0, 63]: an 8-bit piece would overflow signed int8.

Geometry. The reference's tables exist only for its 12-bit limbs
(`_toeplitz_pieces` over FP32/FR32: 32 / 22 limbs). The port keeps them as
they are: each 24-bit limb splits into its two 12-bit halves, each half
into two 6-bit pieces (v = v1 * 64 + v0), and the four int8 matmuls
recombine into 12-bit columns

    c12 = s00 + (s01 + s10) << 6 + s11 << 12     (< 2^30: 32 x 63^2 a term)

which pair up into the port's 24-bit columns, c24[k] = c12[2k] + c12[2k+1]
<< 12 (< 2^42, well inside the int64 normalize). R is 2^384 / 2^264 in both
geometries, so t, m and s are the reference's integers and the product is
K1's, limb for limb. The CUDA kernels K4-K6 (csrc/mont_mxu.cuh) run the
same tables on the tensor cores; mont_mul_mxu below is K4's plain version.

The data-dependent product a * b has no constant matrix and stays a plain
convolution, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.limb import ModCtx

PIECE_BITS = 6
PIECE_MASK = (1 << PIECE_BITS) - 1
HALF_BITS = 12
HALF_MASK = (1 << HALF_BITS) - 1
# The kernels' padded table geometry: the MMA depth (12-bit limbs of an
# operand, Fr's 22 padded to 32) and the output columns of each constant.
K_DEPTH = 32
NINV_COLS = 32
MOD_COLS = 64


def _toeplitz_pieces(c: np.ndarray, n: int, out_cols: int):
    """Constant 12-bit limb vector -> (T0, T1) int8 band matrices
    [n, out_cols] holding the low/high 6-bit pieces of c[k-i]."""
    T0 = np.zeros((n, out_cols), np.int8)
    T1 = np.zeros((n, out_cols), np.int8)
    for i in range(n):
        for k in range(out_cols):
            j = k - i
            if 0 <= j < n:
                v = int(c[j])
                T0[i, k] = v & PIECE_MASK
                T1[i, k] = v >> PIECE_BITS
    return T0, T1


def _halves(ctx: ModCtx) -> int:
    return 2 * ctx.n_limbs


@functools.lru_cache(maxsize=None)
def _ninv_toeplitz(ctx: ModCtx):
    """Low-conv (mod R) Toeplitz of -m^-1 over 12-bit limbs: out_cols = 2n."""
    r = 1 << (ctx.limb_bits * ctx.n_limbs)
    c = limb.int_to_limbs((-pow(ctx.modulus, -1, r)) % r, _halves(ctx), HALF_BITS)
    return _toeplitz_pieces(c, _halves(ctx), _halves(ctx))


@functools.lru_cache(maxsize=None)
def _modulus_toeplitz(ctx: ModCtx):
    """Full-conv Toeplitz of the modulus over 12-bit limbs: out_cols = 4n."""
    c = limb.int_to_limbs(ctx.modulus, _halves(ctx), HALF_BITS)
    return _toeplitz_pieces(c, _halves(ctx), 2 * _halves(ctx))


@functools.lru_cache(maxsize=None)
def _tables(ctx: ModCtx, device: torch.device):
    """The four piece tables as int64 tensors on `device` (plain version)."""
    return tuple(
        torch.as_tensor(T.astype(np.int64), device=device)
        for T in (*_ninv_toeplitz(ctx), *_modulus_toeplitz(ctx))
    )


def kernel_tables_np(ctx: ModCtx) -> np.ndarray:
    """The kernels' table block, int8, 6144 bytes, in the order their
    shared memory holds it, so that they copy it 16 bytes at a time with
    no index arithmetic: nT0 | nT1 (each padded to K_DEPTH x NINV_COLS) |
    pT0 | pT1 (K_DEPTH x MOD_COLS), each table as [k step][column][16
    depths], the 16-deep column-major planes the MMA reads as its B
    operand: element [ks][c][d] is T[16 ks + d, c]. The padding is zeros,
    so padded rows and columns add nothing."""
    parts = []
    for T, cols in zip((*_ninv_toeplitz(ctx), *_modulus_toeplitz(ctx)), (NINV_COLS,) * 2 + (MOD_COLS,) * 2):
        pad = np.zeros((K_DEPTH, cols), np.int8)
        pad[: T.shape[0], : T.shape[1]] = T
        parts.append(pad.reshape(K_DEPTH // 16, 16, cols).transpose(0, 2, 1).ravel())
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def device_tables(ctx: ModCtx, device: torch.device) -> torch.Tensor:
    """kernel_tables_np on `device`, built once per (context, device): the
    kernels read it from device memory into shared memory."""
    return torch.as_tensor(kernel_tables_np(ctx), device=device)


def split_halves(x):
    """24-bit limbs (..., n) -> 12-bit limbs (..., 2n), little-endian."""
    return torch.stack([x & HALF_MASK, x >> HALF_BITS], dim=-1).flatten(-2)


def conv_const_mxu(x, T0, T1):
    """conv(x, c) over 24-bit columns for canonical 24-bit limbs x, with the
    constant c given as 12-bit Toeplitz piece tables: the four piece
    matmuls, written as a broadcast multiply and a sum (CUDA has no int64
    matmul), recombined into 12-bit and then 24-bit columns."""
    x12 = split_halves(x)
    x0, x1 = x12 & PIECE_MASK, x12 >> PIECE_BITS

    def mm(p, T):
        return (p.unsqueeze(-1) * T).sum(-2)

    c12 = mm(x0, T0) + ((mm(x0, T1) + mm(x1, T0)) << PIECE_BITS) + (mm(x1, T1) << (2 * PIECE_BITS))
    return c12[..., 0::2] + (c12[..., 1::2] << HALF_BITS)


def mont_mul_mxu(ctx: ModCtx, a, b):
    """a * b * R^-1 mod m: the same algorithm and tail as K1's plain
    version, with the two constant convolutions lowered to int8 piece
    matmuls (module docstring). K4's plain version."""
    from charon_tpu_torch.ops import mont_kernels as MK

    a, b = torch.broadcast_tensors(a, b)
    n = ctx.n_limbs
    nT0, nT1, pT0, pT1 = _tables(ctx, a.device)
    t = MK._conv(ctx, a, b, 2 * n)  # data-dependent: no constant matrix
    t, _ = limb._normalize(ctx, t)
    m = conv_const_mxu(t[..., :n], nT0, nT1)
    m, _ = limb._normalize(ctx, m)  # mod R: top carry intentionally dropped
    s = t + conv_const_mxu(m, pT0, pT1)
    return MK._mont_tail(ctx, s)
