"""Batched G1/G2 point decompression on the limb engine, in PyTorch.

The port of charon_tpu/ops/decompress.py. Decode splits in two:

  * HOST — `parse_g2_lane`/`parse_g1_lane`: flag bits, the infinity
    encoding, the x < p range check, bytes -> ints; no field arithmetic.
    `pack_parsed_g2`/`pack_parsed_g1` turn the wire bytes into the port's
    24-bit limbs in one numpy pass (limb.bytes_to_limbs_batch).
  * DEVICE — `decompress_g2_graph`/`decompress_g1_graph`: the field work,
    batched over lanes, every product on the kernels K1-K6:
      - y^2 = x^3 + b, then the square root by a fixed-exponent chain:
        p^2 = 9 mod 16, so c = a^((p^2+7)/16) is off from a root by one of
        the four 4th roots of unity; four multiply+compare corrections
        recover the root or prove a non-residue (the compare doubles as
        the on-curve check). G1 uses p = 3 mod 4 and a^((p+1)/4).
      - ZCash sign-bit selection (lexicographically largest y).
      - G2 subgroup membership by the psi endomorphism: P is in G2 iff
        psi(P) == [x]P, a 64-bit ladder in place of the 255-bit [r]P one
        (Scott 2021; host oracle g1g2.g2_in_subgroup_psi). G1 uses the GLV
        twin phi(x, y) = (beta x, y) == [lambda]P, a 128-bit ladder (host
        oracle g1g2.g1_in_subgroup_phi).

The chains and ladders run over static exponents and scalars, so they
branch on the host-known bits (limb.mont_pow, curve.point_mul_static) where
the reference selects on every step; the field elements and verdicts are
the same.

Malformed encodings never raise: every lane carries a validity bit from the
host parse through the device mask, so one forged signature fails its own
lane and not the batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from charon_tpu_torch.crypto import fields as F
from charon_tpu_torch.crypto.g1g2 import G1_BETA, G1_LAMBDA, PSI_CX, PSI_CY
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.limb import ModCtx

P = F.P
X_ABS = F.X_ABS

_COMPRESSED = 0x80
_INFINITY = 0x40
_LEX_LARGEST = 0x20

# -- fixed-exponent sqrt chains ---------------------------------------------
# p^2 = 9 mod 16: the candidate c = a^((p^2+7)/16) satisfies c^2 = a * eta
# with eta^4 == 1; the correction factors r (r^2 = eta^-1) are the four
# values below. p = 3 mod 4 for the G1 chain.
SQRT_EXP_G2 = (P * P + 7) // 16
SQRT_EXP_G1 = (P + 1) // 4
_S1 = F.fp2_sqrt((P - 1, 0))  # sqrt(-1)
ROOTS_OF_UNITY = (
    F.FP2_ONE,
    _S1,
    F.fp2_sqrt(_S1),
    F.fp2_sqrt(F.fp2_neg(_S1)),
)
ROOTS_OF_UNITY_SQ = tuple(F.fp2_sqr(r) for r in ROOTS_OF_UNITY)

_HALF = (P - 1) // 2  # lex-largest threshold


# ---------------------------------------------------------------------------
# Host parse
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParsedPoint:
    """One compressed lane after the host parse. `ok` is the host verdict
    (flags, range, length); the device adds the residue and subgroup bits.
    `raw` keeps the wire bytes for the packing."""

    raw: bytes
    x0: int  # real Fp component (the only one for G1)
    x1: int
    sign: bool  # lexicographically-largest-y flag
    infinity: bool
    ok: bool


def parse_g2_lane(data: bytes) -> ParsedPoint:
    """96-byte compressed G2 -> ParsedPoint. Never raises."""
    sign = infinity = False
    x0 = x1 = 0
    ok = len(data) == 96 and bool(data[0] & _COMPRESSED)
    if ok:
        flags = data[0]
        infinity = bool(flags & _INFINITY)
        sign = bool(flags & _LEX_LARGEST)
        if infinity:
            # infinity is the flag byte alone, zero elsewhere
            ok = not (flags & 0x3F) and not any(data[1:])
            sign = False
        else:
            x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
            x0 = int.from_bytes(data[48:], "big")
            if x0 >= P or x1 >= P:
                ok = False
    if not ok:
        x0 = x1 = 0  # never ship unreduced limbs to the device
        sign = infinity = False
    return ParsedPoint(bytes(data), x0, x1, sign, infinity, ok)


def parse_g1_lane(data: bytes) -> ParsedPoint:
    """48-byte compressed G1 -> ParsedPoint (x1 unused). Never raises."""
    sign = infinity = False
    x0 = 0
    ok = len(data) == 48 and bool(data[0] & _COMPRESSED)
    if ok:
        flags = data[0]
        infinity = bool(flags & _INFINITY)
        sign = bool(flags & _LEX_LARGEST)
        if infinity:
            ok = not (flags & 0x3F) and not any(data[1:])
            sign = False
        else:
            x0 = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
            if x0 >= P:
                ok = False
    if not ok:
        x0 = 0
        sign = infinity = False
    return ParsedPoint(bytes(data), x0, 0, sign, infinity, ok)


def _parsed_raw_matrix(parsed, nbytes: int) -> np.ndarray:
    """[ParsedPoint] -> (N, nbytes) uint8 matrix of the raw wire bytes with
    the 3 flag bits cleared, zero rows for lanes the host parse failed or
    flagged infinity (parse_*_lane's x = 0 blanking, without Python ints)."""
    buf = bytearray(len(parsed) * nbytes)
    for i, p in enumerate(parsed):
        if p.ok and not p.infinity:
            buf[i * nbytes : (i + 1) * nbytes] = p.raw
    arr = np.frombuffer(buf, np.uint8).reshape(len(parsed), nbytes)
    arr[:, 0] &= 0x1F
    return arr


def _masks(parsed, device):
    return tuple(
        torch.as_tensor([getattr(p, k) for p in parsed], dtype=torch.bool, device=device)
        for k in ("sign", "infinity", "ok")
    )


def pack_parsed_g2(ctx: ModCtx, parsed, device="cpu"):
    """[ParsedPoint] -> device inputs (x0, x1 raw limbs, sign, infinity,
    host_ok masks), the limbs from the wire bytes in one vectorized pass."""
    raw = _parsed_raw_matrix(parsed, 96)
    # big-endian wire layout: bytes [0:48) = x1 (flags cleared), [48:96) = x0
    x1 = limb.to_device(limb.bytes_to_limbs_batch(raw[:, :48], ctx.n_limbs), device)
    x0 = limb.to_device(limb.bytes_to_limbs_batch(raw[:, 48:], ctx.n_limbs), device)
    return (x0, x1, *_masks(parsed, device))


def pack_parsed_g1(ctx: ModCtx, parsed, device="cpu"):
    raw = _parsed_raw_matrix(parsed, 48)
    x0 = limb.to_device(limb.bytes_to_limbs_batch(raw, ctx.n_limbs), device)
    return (x0, *_masks(parsed, device))


# ---------------------------------------------------------------------------
# Device graph pieces
# ---------------------------------------------------------------------------


def fp2_pow_const(ctx: ModCtx, a, exponent: int):
    """a^exponent in Fp2 (Montgomery in/out), left-to-right square-and-
    multiply over the static exponent's bits: the Fp2 twin of
    limb.mont_pow, for the fixed sqrt chains."""
    if exponent == 0:
        return T.fp2_one(ctx, a[0].shape[:-1], a[0].device)
    acc = a
    for bit in bin(exponent)[3:]:  # leading 1: start from a
        acc = T.fp2_sqr(ctx, acc)
        if bit == "1":
            acc = T.fp2_mul(ctx, acc, a)
    return acc


def _raw_gt_const(raw, value: int):
    """Per-lane raw-limb comparison raw > value (little-endian limbs): the
    most significant differing limb decides."""
    c = torch.as_tensor(limb.int_to_limbs(value, raw.shape[-1]), device=raw.device)
    gt = torch.flip(raw > c, dims=(-1,))  # most significant first
    eq = torch.flip(raw == c, dims=(-1,))
    # exclusive prefix-AND of eq: a limb decides only if all above agree
    pre = torch.cumprod(torch.cat([torch.ones_like(eq[..., :1]), eq[..., :-1]], dim=-1).long(), dim=-1)
    return torch.any(gt & (pre != 0), dim=-1)


def fp2_is_lex_largest_graph(ctx: ModCtx, y):
    """Device mirror of fields.fp2_is_lex_largest on a Montgomery Fp2
    element: compare (c1, c0) lexicographically against -y."""
    y0r, y1r = limb.from_mont(ctx, torch.stack(torch.broadcast_tensors(y[0], y[1])))
    return torch.where(limb.is_zero(y1r), _raw_gt_const(y0r, _HALF), _raw_gt_const(y1r, _HALF))


def g2_psi_graph(ctx: ModCtx, affine):
    """psi(x, y) = (cx * conj(x), cy * conj(y)) on batched affine G2."""
    x, y = affine
    shape, dev = x[0].shape[:-1], x[0].device
    z = torch.zeros_like(x[1])
    x1n, y1n = limb.sub_mod_many(ctx, [(z, x[1]), (z, y[1])])
    return tuple(
        T.fp2_batch(
            ctx,
            [
                ("mul", (x[0], x1n), T.fp2_const(ctx, PSI_CX, shape, dev)),
                ("mul", (y[0], y1n), T.fp2_const(ctx, PSI_CY, shape, dev)),
            ],
        )
    )


def g2_subgroup_psi_graph(ctx: ModCtx, affine):
    """P in G2 iff psi(P) == [x]P, i.e. psi(P) + [|x|]P == identity (x is
    negative for BLS12-381): one 64-bit static ladder. Identity lanes
    ((0, 0) affine) pass."""
    f = C.g2_ops(ctx)
    xp = C.point_mul_static(f, C.affine_to_point(f, affine), X_ABS)
    psi = C.affine_to_point(f, g2_psi_graph(ctx, affine))
    return C.point_is_identity(f, C.point_add(f, xp, psi))


def four_root_correction(ctx: ModCtx, c, a, shape, dev):
    """The root of `a` among c * r for the four 4th roots of unity r, and
    whether one verified: (c r)^2 == a, tested as c^2 r^2 == a."""
    c2 = T.fp2_sqr(ctx, c)
    prods = T.fp2_batch(
        ctx,
        [("mul", c2, T.fp2_const(ctx, r2, shape, dev)) for r2 in ROOTS_OF_UNITY_SQ]
        + [("mul", c, T.fp2_const(ctx, r, shape, dev)) for r in ROOTS_OF_UNITY],
    )
    y = T.fp2_zero(ctx, shape, dev)
    ok = torch.zeros(shape, dtype=torch.bool, device=dev)
    for k in range(len(ROOTS_OF_UNITY)):
        match = T.fp2_eq(prods[k], a)
        y = T.fp2_select(match & ~ok, prods[len(ROOTS_OF_UNITY) + k], y)
        ok = ok | match
    return y, ok


def _lane_masks(shape, dev, infinity, host_ok):
    if infinity is None:
        infinity = torch.zeros(shape, dtype=torch.bool, device=dev)
    if host_ok is None:
        host_ok = torch.ones(shape, dtype=torch.bool, device=dev)
    return infinity, host_ok


def decompress_g2_graph(ctx: ModCtx, x_raw, sign, infinity=None, host_ok=None, subgroup: bool = True):
    """Batched compressed-G2 field work: raw x limbs (pair of (..., L)
    tensors) + host parse masks -> ((x, y) Montgomery affine, valid).

    Valid lanes: finite on-curve points (subgroup-checked when `subgroup`)
    and well-formed infinity lanes; infinity and invalid lanes both come
    out as the (0, 0) affine identity encoding."""
    shape, dev = x_raw[0].shape[:-1], x_raw[0].device
    infinity, host_ok = _lane_masks(shape, dev, infinity, host_ok)
    x0, x1 = limb.to_mont(ctx, torch.stack([x_raw[0], x_raw[1]]))
    x = (x0, x1)
    b = T.fp2_const(ctx, (4, 4), shape, dev)  # 4(1 + u)
    a = T.fp2_add(ctx, T.fp2_mul(ctx, T.fp2_sqr(ctx, x), x), b)
    y, ok_sqrt = four_root_correction(ctx, fp2_pow_const(ctx, a, SQRT_EXP_G2), a, shape, dev)
    largest = fp2_is_lex_largest_graph(ctx, y)
    y = T.fp2_select(largest != sign, T.fp2_neg(ctx, y), y)
    valid = ok_sqrt & host_ok & ~infinity
    # blank non-valid lanes to the identity encoding BEFORE the subgroup
    # ladder so garbage x never feeds the point formulas
    zero = T.fp2_zero(ctx, shape, dev)
    x = T.fp2_select(valid, x, zero)
    y = T.fp2_select(valid, y, zero)
    if subgroup:
        valid = valid & g2_subgroup_psi_graph(ctx, (x, y))
        x = T.fp2_select(valid, x, zero)
        y = T.fp2_select(valid, y, zero)
    return (x, y), valid | (infinity & host_ok)


def g1_subgroup_phi_graph(ctx: ModCtx, affine):
    """P in G1 iff phi(P) == [lambda]P with phi(x, y) = (beta x, y): one
    128-bit static ladder, the GLV twin of the psi G2 check. Equality is
    checked by cross-multiplying against the projective [lambda]P, so no
    inversion. Identity-blanked lanes fail the compare (Y != 0, y = 0);
    callers AND this into a mask already False there and re-OR the
    infinity lanes after."""
    x, y = affine
    f = C.g1_ops(ctx)
    lx, ly, lz = C.point_mul_static(f, C.affine_to_point(f, affine), G1_LAMBDA)
    beta = limb.const(ctx, G1_BETA, x.shape[:-1], x.device)
    phi_x = limb.mont_mul(ctx, x, beta)
    px, py = limb.mont_mul(ctx, torch.stack([phi_x, y]), lz)
    return torch.all(px == lx, dim=-1) & torch.all(py == ly, dim=-1)


def decompress_g1_graph(ctx: ModCtx, x_raw, sign, infinity=None, host_ok=None, subgroup: bool = True):
    """Batched compressed-G1 field work (Fp chain, p = 3 mod 4), with the
    GLV phi subgroup check."""
    shape, dev = x_raw.shape[:-1], x_raw.device
    infinity, host_ok = _lane_masks(shape, dev, infinity, host_ok)
    x = limb.to_mont(ctx, x_raw)
    a = limb.add_mod(ctx, limb.mont_mul(ctx, limb.mont_sqr(ctx, x), x), limb.const(ctx, 4, shape, dev))
    y = limb.mont_pow(ctx, a, SQRT_EXP_G1)
    ok_sqrt = torch.all(limb.mont_sqr(ctx, y) == a, dim=-1)
    largest = _raw_gt_const(limb.from_mont(ctx, y), _HALF)
    y = limb.select(largest != sign, limb.neg_mod(ctx, y), y)
    valid = ok_sqrt & host_ok & ~infinity
    zero = limb.zeros(ctx, shape, dev)
    x = limb.select(valid, x, zero)
    y = limb.select(valid, y, zero)
    if subgroup:
        valid = valid & g1_subgroup_phi_graph(ctx, (x, y))
        x = limb.select(valid, x, zero)
        y = limb.select(valid, y, zero)
    return (x, y), valid | (infinity & host_ok)
