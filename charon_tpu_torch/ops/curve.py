"""Batched G1/G2 point arithmetic with complete projective formulas.

The port of charon_tpu/ops/curve.py: the complete homogeneous-projective
addition and doubling of Renes-Costello-Batina 2015 (eprint 2015/1060,
algorithms 7 and 9 for a = 0). Complete formulas are branch-free — correct
for identity inputs, equal inputs and inverses — so a whole batch flows
through the same straight-line code.

Points are (X, Y, Z) tuples of field elements; the identity is (0, 1, 0).
G1 uses Fp limb tensors directly, G2 uses fptower Fp2 pairs. Both share the
same code via a small field-ops table.

Curve constants: E1: y^2 = x^3 + 4, E2: y^2 = x^3 + 4(1+u), so
b3 = 12 for G1 and 12*(1+u) = 12*xi for G2.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.limb import ModCtx


@dataclasses.dataclass(frozen=True)
class FieldOps:
    """Table making point formulas generic over Fp (G1) and Fp2 (G2)."""

    add: Callable
    sub: Callable
    double: Callable
    neg: Callable
    small: Callable  # (a, k: static int) -> k*a
    mul_b3: Callable  # multiply by 3*b
    inv: Callable
    is_zero: Callable
    select: Callable
    zero: Callable  # (batch_shape, device) -> 0
    one: Callable  # (batch_shape, device) -> 1
    leaf: Callable  # element -> one of its limb tensors (shape and device)
    batch: Callable  # ops list of ("mul",a,b)/("sqr",a) -> results, one
    # stacked launch per kind (see fptower.fp2_batch)


@functools.lru_cache(maxsize=None)
def g1_ops(ctx: ModCtx) -> FieldOps:
    return FieldOps(
        add=functools.partial(limb.add_mod, ctx),
        sub=functools.partial(limb.sub_mod, ctx),
        double=functools.partial(limb.double_mod, ctx),
        neg=functools.partial(limb.neg_mod, ctx),
        small=lambda a, k: _small_fp(ctx, a, k),
        mul_b3=lambda a: _small_fp(ctx, a, 12),
        inv=functools.partial(limb.inv_mod, ctx),
        is_zero=limb.is_zero,
        select=limb.select,
        zero=lambda shape=(), device="cpu": limb.zeros(ctx, shape, device),
        one=lambda shape=(), device="cpu": limb.const(ctx, 1, shape, device),
        leaf=lambda a: a,
        batch=functools.partial(_fp_batch, ctx),
    )


@functools.lru_cache(maxsize=None)
def g2_ops(ctx: ModCtx) -> FieldOps:
    return FieldOps(
        add=functools.partial(T.fp2_add, ctx),
        sub=functools.partial(T.fp2_sub, ctx),
        double=functools.partial(T.fp2_double, ctx),
        neg=functools.partial(T.fp2_neg, ctx),
        small=functools.partial(T.fp2_small, ctx),
        mul_b3=lambda a: T.fp2_small(ctx, T.fp2_mul_xi(ctx, a), 12),
        inv=functools.partial(T.fp2_inv, ctx),
        is_zero=T.fp2_is_zero,
        select=T.fp2_select,
        zero=lambda shape=(), device="cpu": T.fp2_zero(ctx, shape, device),
        one=lambda shape=(), device="cpu": T.fp2_one(ctx, shape, device),
        leaf=lambda a: a[0],
        batch=functools.partial(T.fp2_batch, ctx),
    )


def _fp_batch(ctx, ops):
    """Stacked base muls for the Fp (G1) field — mirrors fptower.fp2_batch."""
    xs, ys = [], []
    for op in ops:
        if op[0] == "mul":
            xs.append(op[1])
            ys.append(op[2])
        elif op[0] == "sqr":
            xs.append(op[1])
            ys.append(op[1])
        else:
            raise ValueError(op[0])
    parts = torch.broadcast_tensors(*xs, *ys)
    prods = limb.mont_mul(ctx, torch.stack(parts[: len(xs)]), torch.stack(parts[len(xs):]))
    return [prods[i] for i in range(len(ops))]


def _small_fp(ctx, a, k: int):
    if k == 0:
        return torch.zeros_like(a)
    acc = None
    add = a
    while k:
        if k & 1:
            acc = add if acc is None else limb.add_mod(ctx, acc, add)
        k >>= 1
        if k:
            add = limb.double_mod(ctx, add)
    return acc


def _batch_shape(f: FieldOps, p):
    return f.leaf(p[0]).shape[:-1]


def _device(f: FieldOps, p):
    return f.leaf(p[0]).device


# ---------------------------------------------------------------------------
# Complete projective add / double (RCB15 algorithms 7 and 9, a = 0)
# ---------------------------------------------------------------------------


def point_identity(f: FieldOps, batch_shape=(), device="cpu"):
    return (f.zero(batch_shape, device), f.one(batch_shape, device), f.zero(batch_shape, device))


def point_add(f: FieldOps, p, q):
    """Complete addition, RCB15 algorithm 7 (a=0). 12 field muls in two
    stacked levels."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2, a, b, c = f.batch(
        [
            ("mul", x1, x2),
            ("mul", y1, y2),
            ("mul", z1, z2),
            ("mul", f.add(x1, y1), f.add(x2, y2)),
            ("mul", f.add(y1, z1), f.add(y2, z2)),
            ("mul", f.add(x1, z1), f.add(x2, z2)),
        ]
    )
    t3 = f.sub(a, f.add(t0, t1))  # x1y2 + x2y1
    t4 = f.sub(b, f.add(t1, t2))  # y1z2 + y2z1
    y3 = f.sub(c, f.add(t0, t2))  # x1z2 + x2z1
    t0 = f.small(t0, 3)  # 3 x1x2
    t2 = f.mul_b3(t2)  # b3 z1z2
    z3 = f.add(t1, t2)
    t1 = f.sub(t1, t2)
    y3 = f.mul_b3(y3)  # b3 (x1z2 + x2z1)
    m1, m2, m3, m4, m5, m6 = f.batch(
        [
            ("mul", t3, t1),
            ("mul", t4, y3),
            ("mul", y3, t0),
            ("mul", t1, z3),
            ("mul", z3, t4),
            ("mul", t0, t3),
        ]
    )
    return (f.sub(m1, m2), f.add(m3, m4), f.add(m5, m6))


def point_double(f: FieldOps, p):
    """Complete doubling, RCB15 algorithm 9 (a=0). 6 muls + 2 squarings in
    two stacked levels."""
    x, y, z = p
    t0, t1, zz, xy = f.batch([("sqr", y), ("mul", y, z), ("sqr", z), ("mul", x, y)])
    z3c = f.small(t0, 8)
    t2 = f.mul_b3(zz)
    y3 = f.add(t0, t2)
    t0 = f.sub(t0, f.small(t2, 3))
    x3, z3, ty, xyt = f.batch(
        [
            ("mul", t2, z3c),
            ("mul", t1, z3c),
            ("mul", t0, y3),
            ("mul", xy, t0),
        ]
    )
    return (f.double(xyt), f.add(ty, x3), z3)


def point_neg(f: FieldOps, p):
    return (p[0], f.neg(p[1]), p[2])


def point_select(f: FieldOps, mask, p, q):
    return tuple(f.select(mask, a, b) for a, b in zip(p, q))


def point_is_identity(f: FieldOps, p):
    return f.is_zero(p[2])


def point_to_affine(f: FieldOps, p):
    """(X, Y, Z) -> (x, y) with the identity mapping to (0, 0).
    Batched Fermat inversion; Z = 0 lanes produce 0 (inv_mod(0) == 0)."""
    zinv = f.inv(p[2])
    x, y = f.batch([("mul", p[0], zinv), ("mul", p[1], zinv)])
    return (x, y)


def affine_to_point(f: FieldOps, a):
    """(x, y) affine -> projective; (0, 0) is interpreted as the identity
    (safe: y = 0 never occurs on these curves since b != 0)."""
    x, y = a
    is_id = f.is_zero(x) & f.is_zero(y)
    shape, dev = f.leaf(x).shape[:-1], f.leaf(x).device
    one = f.one(shape, dev)
    zero = f.zero(shape, dev)
    return (x, f.select(is_id, one, y), f.select(is_id, zero, one))


def map_point(fn, p):
    """Apply `fn` to every limb tensor of a point (or any nested tuple)."""
    if isinstance(p, tuple):
        return tuple(map_point(fn, x) for x in p)
    return fn(p)


def zip_point(fn, *ps):
    """Combine same-structure points leaf by leaf with fn(*leaves)."""
    if isinstance(ps[0], tuple):
        return tuple(zip_point(fn, *xs) for xs in zip(*ps))
    return fn(*ps)


# ---------------------------------------------------------------------------
# Batched scalar multiplication (dynamic per-element scalars)
# ---------------------------------------------------------------------------


def scalar_bits_msb(fr_ctx: ModCtx, scalars, nbits: int):
    """Raw (non-Montgomery) Fr limb tensor (..., n_limbs) -> (nbits, ...)
    bool bits, MSB first, as the loop schedule."""
    shifts = torch.arange(fr_ctx.limb_bits, device=scalars.device)
    bits = (scalars.unsqueeze(-1) >> shifts) & 1  # (..., n_limbs, lb)
    bits = bits.reshape(*scalars.shape[:-1], -1)[..., :nbits]  # little-endian
    return torch.flip(bits, dims=(-1,)).movedim(-1, 0) != 0


def point_scalar_mul(f: FieldOps, fr_ctx: ModCtx, p, scalars, nbits: int = 255):
    """[k]P for batched projective points and per-element raw Fr scalars.
    Left-to-right double-and-add over the bit schedule with a branch-free
    select — uniform work per step across the batch."""
    bits = scalar_bits_msb(fr_ctx, scalars, nbits)
    acc = point_identity(f, _batch_shape(f, p), _device(f, p))
    for i in range(nbits):
        acc = point_double(f, acc)
        acc = point_select(f, bits[i], point_add(f, acc, p), acc)
    return acc


def point_mul_static(f: FieldOps, p, k: int):
    """[k]P for batched projective points and one static positive scalar:
    left-to-right, doubling every step and adding P only at the host-known
    1-bits (the curve twin of limb.mont_pow). The same group element as
    point_scalar_mul, in another projective representation: compare results
    through the identity test, affine form or a cross-multiplied check."""
    if k <= 0:
        raise ValueError("the static scalar must be positive")
    acc = p
    for bit in bin(k)[3:]:  # leading 1: start from P
        acc = point_double(f, acc)
        if bit == "1":
            acc = point_add(f, acc, p)
    return acc


def point_sum(f: FieldOps, p, axis: int = -1):
    """Reduce-add points over a (small, static) batch axis, as a sequential
    fold of complete adds (callers use it for the threshold axis)."""
    ndim = f.leaf(p[0]).dim()
    ax = axis if axis >= 0 else ndim - 1 + axis
    n = f.leaf(p[0]).shape[ax]
    acc = map_point(lambda a: a.select(ax, 0), p)
    for i in range(1, n):
        acc = point_add(f, acc, map_point(lambda a, i=i: a.select(ax, i), p))
    return acc


# ---------------------------------------------------------------------------
# Host <-> device packing (affine Python-int points, identity = None)
# ---------------------------------------------------------------------------


def g1_pack(ctx: ModCtx, points, device="cpu"):
    """Iterable of affine G1 points ((x, y) ints or None) -> device affine
    pair of Montgomery limb tensors, identity encoded as (0, 0)."""
    pts = [(0, 0) if pt is None else pt for pt in points]
    return (
        limb.to_device(limb.pack_mont_host(ctx, [x for x, _ in pts]), device),
        limb.to_device(limb.pack_mont_host(ctx, [y for _, y in pts]), device),
    )


def g1_unpack(ctx: ModCtx, affine) -> list:
    xs = limb.unpack_mont_host(ctx, affine[0])
    ys = limb.unpack_mont_host(ctx, affine[1])
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def g2_pack(ctx: ModCtx, points, device="cpu"):
    """Iterable of affine G2 points (((x0,x1),(y0,y1)) or None) -> device
    affine pair of Fp2 elements."""
    pts = [((0, 0), (0, 0)) if pt is None else pt for pt in points]
    return (
        T.fp2_pack(ctx, [x for x, _ in pts], device),
        T.fp2_pack(ctx, [y for _, y in pts], device),
    )


def g2_unpack(ctx: ModCtx, affine) -> list:
    xs = T.fp2_unpack(ctx, affine[0])
    ys = T.fp2_unpack(ctx, affine[1])
    return [None if x == (0, 0) and y == (0, 0) else (x, y) for x, y in zip(xs, ys)]


def fr_pack(ctx: ModCtx, scalars, device="cpu"):
    """Raw (non-Montgomery) scalar packing for the bit-schedule loops."""
    return limb.to_device(limb.ctx_pack(ctx, [s % ctx.modulus for s in scalars]), device)
