"""Batched BLS12-381 extension-field towers on the limb engine, in PyTorch.

The port of charon_tpu/ops/fptower.py, mirroring charon_tpu_torch/crypto/
fields.py (the executable specification) with Montgomery limb tensors in
place of Python ints:

    Fp2  = Fp[u]  / (u^2 + 1)        tuple (c0, c1) of (..., n_limbs) tensors
    Fp6  = Fp2[v] / (v^3 - xi)       tuple of three Fp2, xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)        tuple of two Fp6

Every function takes the Fp ModCtx first. Independent operations of one
dependency level are stacked into one call: fp2 muls and squares of a level
go to one launch each of the fused kernels K2/K3 (ops/mont_kernels.py; K5/K6
with the int8 route on), and adds/subs to one stacked normalize
(limb.addsub_mod_many).

Multiplication counts (in Fp Montgomery products): fp2_mul 3 (Karatsuba),
fp2_sqr 2, fp6_mul 18, fp12_mul 54, fp12_cyclotomic_sqr 18 (Granger-Scott).
"""

from __future__ import annotations

import functools

import torch

from charon_tpu_torch.crypto import fields as F
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.ops.limb import ModCtx

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def fp2_zero(ctx: ModCtx, batch_shape=(), device="cpu"):
    return (limb.zeros(ctx, batch_shape, device), limb.zeros(ctx, batch_shape, device))


def fp2_one(ctx: ModCtx, batch_shape=(), device="cpu"):
    return (limb.const(ctx, 1, batch_shape, device), limb.zeros(ctx, batch_shape, device))


def fp2_const(ctx: ModCtx, a, batch_shape=(), device="cpu"):
    """Python-int pair (c0, c1) -> broadcast Montgomery constant."""
    return (
        limb.const(ctx, a[0], batch_shape, device),
        limb.const(ctx, a[1], batch_shape, device),
    )


def fp2_add(ctx, a, b):
    r = limb.add_mod_many(ctx, [(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_sub(ctx, a, b):
    r = limb.sub_mod_many(ctx, [(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_double(ctx, a):
    return fp2_add(ctx, a, a)


def fp2_mul(ctx, a, b):
    return fp2_batch(ctx, [("mul", a, b)])[0]


def fp2_sqr(ctx, a):
    return fp2_batch(ctx, [("sqr", a)])[0]


def fp2_mul_fp(ctx, a, s):
    """Multiply an Fp2 element by a (batched, Montgomery) Fp element."""
    return fp2_batch(ctx, [("mul_fp", a, s)])[0]


def fp2_small(ctx, a, k: int):
    """Multiply by a small static non-negative int via a double/add chain."""
    if k == 0:
        return (torch.zeros_like(a[0]), torch.zeros_like(a[1]))
    acc = None
    add = a
    while k:
        if k & 1:
            acc = add if acc is None else fp2_add(ctx, acc, add)
        k >>= 1
        if k:
            add = fp2_double(ctx, add)
    return acc


def fp2_mul_xi(ctx, a):
    """Multiply by xi = 1 + u: (a0 - a1) + (a0 + a1) u."""
    return fp2_mul_xi_many(ctx, [a])[0]


def fp2_conj(ctx, a):
    return (a[0], limb.neg_mod(ctx, a[1]))


# -- stacked fp2 add/sub levels: one limb normalize per dependency level ----


def fp2_addsub_many(ctx, add_pairs, sub_pairs):
    """Independent fp2 adds + subs in one stacked normalize."""
    fa, fs = [], []
    for a, b in add_pairs:
        fa += [(a[0], b[0]), (a[1], b[1])]
    for a, b in sub_pairs:
        fs += [(a[0], b[0]), (a[1], b[1])]
    ra, rs = limb.addsub_mod_many(ctx, fa, fs)
    return (
        [(ra[2 * i], ra[2 * i + 1]) for i in range(len(add_pairs))],
        [(rs[2 * i], rs[2 * i + 1]) for i in range(len(sub_pairs))],
    )


def fp2_add_many(ctx, pairs):
    return fp2_addsub_many(ctx, pairs, [])[0]


def fp2_sub_many(ctx, pairs):
    return fp2_addsub_many(ctx, [], pairs)[1]


def fp2_mul_xi_many(ctx, xs):
    """xi * x for xi = 1 + u: (x0 - x1, x0 + x1), stacked."""
    pairs = [(x[0], x[1]) for x in xs]
    ra, rs = limb.addsub_mod_many(ctx, pairs, pairs)
    return [(s, a) for s, a in zip(rs, ra)]


def fp2_inv(ctx, a):
    """Batched inverse: conj(a) / norm(a), norm inverted via Fermat.
    0 maps to 0, which keeps identity-point lanes inert."""
    sq = limb.mont_mul(ctx, torch.stack([a[0], a[1]]), torch.stack([a[0], a[1]]))
    ninv = limb.inv_mod(ctx, limb.add_mod(ctx, sq[0], sq[1]))
    r0, r1 = fp2_mul_fp(ctx, a, ninv)
    return (r0, limb.neg_mod(ctx, r1))


def fp2_is_zero(a):
    return limb.is_zero(a[0]) & limb.is_zero(a[1])


def fp2_select(mask, a, b):
    return (limb.select(mask, a[0], b[0]), limb.select(mask, a[1], b[1]))


# ---------------------------------------------------------------------------
# Stacked multiplication: one kernel launch per op kind and dependency level
# ---------------------------------------------------------------------------


def _stacked(operands, width: int):
    """Broadcast every operand of one op kind to a common shape and stack
    each of the `width` operand slots along a new leading axis."""
    parts = torch.broadcast_tensors(*operands)
    return [torch.stack(parts[k::width]) for k in range(width)]


def fp2_batch(ctx, ops):
    """Execute independent fp2 operations, stacked by kind:

      ("mul", a, b)    -> a * b          (K2: fused Karatsuba, 3 base muls)
      ("sqr", a)       -> a^2            (K3: fused square, 2 base muls)
      ("mul_fp", a, s) -> (a0*s, a1*s)   (limb.mont_mul; s is an Fp element)

    With the int8 route on (limb.set_mxu) muls go to K5 and squares to K6,
    and limb.mont_mul takes mul_fp to K4. Each kind runs as ONE launch over
    a new leading stack axis. Returns the fp2 results in order."""
    out = [None] * len(ops)
    muls = [(i, op) for i, op in enumerate(ops) if op[0] == "mul"]
    sqrs = [(i, op) for i, op in enumerate(ops) if op[0] == "sqr"]
    mulfps = [(i, op) for i, op in enumerate(ops) if op[0] == "mul_fp"]
    if len(muls) + len(sqrs) + len(mulfps) != len(ops):
        raise ValueError("unknown fp2_batch op")
    mxu = limb._mxu_active(ctx)
    if muls:
        a0, a1, b0, b1 = _stacked(
            [x for _, (_, a, b) in muls for x in (a[0], a[1], b[0], b[1])], 4
        )
        c0, c1 = (MK.fp2_mul_mxu if mxu else MK.fp2_mul)(ctx, (a0, a1), (b0, b1))
        for j, (i, _) in enumerate(muls):
            out[i] = (c0[j], c1[j])
    if sqrs:
        a0, a1 = _stacked([x for _, (_, a) in sqrs for x in (a[0], a[1])], 2)
        c0, c1 = (MK.fp2_sqr_mxu if mxu else MK.fp2_sqr)(ctx, (a0, a1))
        for j, (i, _) in enumerate(sqrs):
            out[i] = (c0[j], c1[j])
    if mulfps:
        xs, ys = _stacked([x for _, (_, a, s) in mulfps for x in (a[0], s, a[1], s)], 2)
        prods = limb.mont_mul(ctx, xs, ys)
        for j, (i, _) in enumerate(mulfps):
            out[i] = (prods[2 * j], prods[2 * j + 1])
    return out


def fp2_mul_many(ctx, pairs):
    return fp2_batch(ctx, [("mul", a, b) for a, b in pairs])


# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------


def fp6_zero(ctx, batch_shape=(), device="cpu"):
    return tuple(fp2_zero(ctx, batch_shape, device) for _ in range(3))


def fp6_one(ctx, batch_shape=(), device="cpu"):
    return (
        fp2_one(ctx, batch_shape, device),
        fp2_zero(ctx, batch_shape, device),
        fp2_zero(ctx, batch_shape, device),
    )


def fp6_sub(ctx, a, b):
    return tuple(fp2_sub_many(ctx, list(zip(a, b))))


def fp6_neg(ctx, a):
    z = torch.zeros_like(a[0][0])
    r = limb.sub_mod_many(ctx, [(z, c) for x in a for c in x])
    return ((r[0], r[1]), (r[2], r[3]), (r[4], r[5]))


# The 9 cross products one fp6 school-book multiply needs, as (i, j) index
# pairs into the two operands' coefficient triples.
_FP6_PRODS = ((0, 0), (1, 1), (2, 2), (1, 2), (2, 1), (0, 1), (1, 0), (0, 2), (2, 0))


def _fp6_combine_many(ctx, prod_groups):
    """Assemble fp6 products from groups of 9 cross products (in
    _FP6_PRODS order): c0 = p00 + xi(p12 + p21); c1 = p01 + p10 + xi p22;
    c2 = p02 + p20 + p11 — all groups share three stacked add levels."""
    l1_adds = []
    for p00, p11, p22, p12, p21, p01, p10, p02, p20 in prod_groups:
        l1_adds += [(p12, p21), (p01, p10), (p02, p20)]
    l1 = iter(fp2_add_many(ctx, l1_adds))
    xi_in = []
    sums = []
    for g in prod_groups:
        s1221, s0110, s0220 = next(l1), next(l1), next(l1)
        xi_in += [s1221, g[2]]
        sums.append((s0110, s0220))
    xis = iter(fp2_mul_xi_many(ctx, xi_in))
    l3_adds = []
    for g, (s0110, s0220) in zip(prod_groups, sums):
        xi1221, xi22 = next(xis), next(xis)
        l3_adds += [(g[0], xi1221), (s0110, xi22), (s0220, g[1])]
    l3 = iter(fp2_add_many(ctx, l3_adds))
    return [tuple(next(l3) for _ in range(3)) for _ in prod_groups]


def fp6_mul_by_v(ctx, a):
    """v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul_xi(ctx, a[2]), a[0], a[1])


def fp6_inv(ctx, a):
    a0, a1, a2 = a
    sq0, sq1, sq2, m12, m01, m02 = fp2_batch(
        ctx,
        [("sqr", a0), ("sqr", a1), ("sqr", a2), ("mul", a1, a2), ("mul", a0, a1), ("mul", a0, a2)],
    )
    x12, xsq2 = fp2_mul_xi_many(ctx, [m12, sq2])
    t0, t1, t2 = fp2_sub_many(ctx, [(sq0, x12), (xsq2, m01), (sq1, m02)])
    p0, p1, p2 = fp2_mul_many(ctx, [(a0, t0), (a2, t1), (a1, t2)])
    s12 = fp2_add(ctx, p1, p2)
    d = fp2_add(ctx, p0, fp2_mul_xi(ctx, s12))
    dinv = fp2_inv(ctx, d)
    r = fp2_mul_many(ctx, [(t0, dinv), (t1, dinv), (t2, dinv)])
    return (r[0], r[1], r[2])


# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------


def fp12_one(ctx, batch_shape=(), device="cpu"):
    return (fp6_one(ctx, batch_shape, device), fp6_zero(ctx, batch_shape, device))


def fp12_mul(ctx, a, b):
    """Karatsuba over Fp6 with all 27 fp2 cross products in ONE stacked
    launch: t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
    c0 = t0 + v t1, c1 = t2 - t0 - t1."""
    a0, a1 = a
    b0, b1 = b
    sums = iter(fp2_add_many(ctx, list(zip(a0, a1)) + list(zip(b0, b1))))
    sa = tuple(next(sums) for _ in range(3))
    sb = tuple(next(sums) for _ in range(3))
    pairs = []
    for x, y in ((a0, b0), (a1, b1), (sa, sb)):
        pairs.extend((x[i], y[j]) for i, j in _FP6_PRODS)
    prods = fp2_mul_many(ctx, pairs)
    t0, t1, t2 = _fp6_combine_many(ctx, [prods[0:9], prods[9:18], prods[18:27]])
    vt1 = fp6_mul_by_v(ctx, t1)
    ra, rs = fp2_addsub_many(ctx, list(zip(t0, vt1)), list(zip(t2, t0)))
    c0 = tuple(ra)
    c1 = tuple(fp2_sub_many(ctx, list(zip(rs, t1))))
    return (c0, c1)


def fp12_sqr(ctx, a):
    """Generic square (the cyclotomic variant below is 3x cheaper but only
    valid after the easy part of the final exponentiation)."""
    return fp12_mul(ctx, a, a)


def fp12_conj(ctx, a):
    """f^(p^6): negates the w coefficient. Equals f^-1 for unitary f."""
    return (a[0], fp6_neg(ctx, a[1]))


def fp12_inv(ctx, a):
    a0, a1 = a
    prods = fp2_mul_many(
        ctx,
        [(a0[i], a0[j]) for i, j in _FP6_PRODS] + [(a1[i], a1[j]) for i, j in _FP6_PRODS],
    )
    s0, s1 = _fp6_combine_many(ctx, [prods[:9], prods[9:]])
    d = fp6_sub(ctx, s0, fp6_mul_by_v(ctx, s1))
    dinv = fp6_inv(ctx, d)
    prods2 = fp2_mul_many(
        ctx,
        [(a0[i], dinv[j]) for i, j in _FP6_PRODS] + [(a1[i], dinv[j]) for i, j in _FP6_PRODS],
    )
    n0, n1 = _fp6_combine_many(ctx, [prods2[:9], prods2[9:]])
    return (n0, fp6_neg(ctx, n1))


def fp12_is_one(ctx, a):
    """Batch mask: element == 1 (inputs in Montgomery form)."""
    one = limb.ctx_const(ctx, "one", a[0][0][0].device)
    ok = torch.all(a[0][0][0] == one, dim=-1) & limb.is_zero(a[0][0][1])
    for c6 in (a[0][1], a[0][2], a[1][0], a[1][1], a[1][2]):
        ok = ok & fp2_is_zero(c6)
    return ok


# Frobenius: gamma6 = xi^((p-1)/6); the (i, j) coefficient (of v^j w^i) is
# multiplied by gamma6^(2j+i) after Fp2 conjugation (spec: fields.py
# fp12_frobenius).
@functools.lru_cache(maxsize=None)
def _gamma_pows() -> tuple:
    g = F.fp2_pow(F.XI, (F.P - 1) // 6)
    pows = [F.FP2_ONE]
    for _ in range(5):
        pows.append(F.fp2_mul(pows[-1], g))
    return tuple(pows)


def fp12_frobenius(ctx, a):
    pows = _gamma_pows()
    ref = a[0][0][0]
    ops = []
    for i in range(2):
        for j in range(3):
            k = 2 * j + i
            if k:
                ops.append(("mul", fp2_conj(ctx, a[i][j]), fp2_const(ctx, pows[k], (), ref.device)))
    prods = iter(fp2_batch(ctx, ops))
    out6 = []
    for i in range(2):
        coeffs = []
        for j in range(3):
            coeffs.append(fp2_conj(ctx, a[i][j]) if 2 * j + i == 0 else next(prods))
        out6.append(tuple(coeffs))
    return tuple(out6)


def fp12_frobenius_n(ctx, a, n: int):
    for _ in range(n):
        a = fp12_frobenius(ctx, a)
    return a


def fp12_cyclotomic_sqr(ctx, a):
    """Granger-Scott squaring for unitary elements (post easy-part): 9 fp2
    squarings in one K3 launch = 18 base muls vs 54 for fp12_mul."""
    (c0, c1, c2), (c3, c4, c5) = a
    s40, s23, s51 = fp2_add_many(ctx, [(c4, c0), (c2, c3), (c5, c1)])
    sq = fp2_batch(
        ctx,
        [("sqr", x) for x in (c4, c0, s40, c2, c3, s23, c5, c1, s51)],
    )
    t0, t1, t2, t3, t4, t5 = sq[0], sq[1], sq[3], sq[4], sq[6], sq[7]
    s01, s23b, s45 = fp2_add_many(ctx, [(t0, t1), (t2, t3), (t4, t5)])
    xt0, xt2, xt4 = fp2_mul_xi_many(ctx, [t0, t2, t4])
    adds, subs = fp2_addsub_many(
        ctx,
        [(xt0, t1), (xt2, t3), (xt4, t5)],
        [(sq[2], s01), (sq[5], s23b), (sq[8], s45)],
    )
    u0, u2, u4 = adds
    t6, t7, t8pre = subs
    t8 = fp2_mul_xi(ctx, t8pre)
    ts = [u0, u2, u4, t8, t6, t7]
    cs = [c0, c1, c2, c3, c4, c5]
    doubles = fp2_add_many(ctx, [(t, t) for t in ts] + [(c, c) for c in cs])
    t2s, c2s = doubles[:6], doubles[6:]
    t3s = fp2_add_many(ctx, list(zip(t2s, ts)))
    adds2, subs2 = fp2_addsub_many(
        ctx,
        list(zip(t3s[3:], c2s[3:])),  # c1 row: 3t + 2c
        list(zip(t3s[:3], c2s[:3])),  # c0 row: 3t - 2c
    )
    return (tuple(subs2), tuple(adds2))


# ---------------------------------------------------------------------------
# Host <-> device conversion (tower elements <-> Python-int tuples)
# ---------------------------------------------------------------------------


def fp2_pack(ctx, values, device="cpu"):
    """Iterable of Python Fp2 tuples -> batched device Fp2 (Montgomery)."""
    vals = list(values)
    return (
        limb.to_device(limb.pack_mont_host(ctx, [v[0] for v in vals]), device),
        limb.to_device(limb.pack_mont_host(ctx, [v[1] for v in vals]), device),
    )


def fp2_unpack(ctx, a) -> list:
    return list(zip(limb.unpack_mont_host(ctx, a[0]), limb.unpack_mont_host(ctx, a[1])))


def fp12_pack(ctx, values, device="cpu"):
    """Iterable of Python Fp12 tower tuples -> batched device Fp12."""
    vals = list(values)
    return tuple(
        tuple(fp2_pack(ctx, [v[i][j] for v in vals], device) for j in range(3))
        for i in range(2)
    )


def fp12_unpack(ctx, a) -> list:
    per_coeff = [[fp2_unpack(ctx, a[i][j]) for j in range(3)] for i in range(2)]
    n = len(per_coeff[0][0])
    return [
        tuple(tuple(per_coeff[i][j][k] for j in range(3)) for i in range(2))
        for k in range(n)
    ]
