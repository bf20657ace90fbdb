"""BLS12-381 curve groups G1 (over Fp) and G2 (over Fp2).

E1:  y^2 = x^3 + 4        over Fp
E2:  y^2 = x^3 + 4(1+u)   over Fp2   (M-twist of E1)

Points are affine tuples (x, y) with None representing the identity. Affine
arithmetic with Python bigints is fast enough for the reference role; the
batched engine uses projective coordinates (charon_tpu_torch/ops).

Serialization follows the ZCash/eth2 compressed format (48-byte G1, 96-byte
G2, flag bits in the 3 MSBs), matching the reference's wire types
(ref: tbls/tbls.go:16-25 — PublicKey [48]byte, Signature [96]byte).
"""

from __future__ import annotations

from charon_tpu_torch.crypto.fields import (
    FP2_ONE,
    FP2_ZERO,
    P,
    R,
    X_ABS,
    XI,
    fp2_add,
    fp2_conj,
    fp2_inv,
    fp2_is_lex_largest,
    fp2_is_zero,
    fp2_mul,
    fp2_neg,
    fp2_pow,
    fp2_scalar,
    fp2_sqr,
    fp2_sqrt,
    fp2_sub,
    fp_inv,
    fp_sqrt,
)

B1 = 4
B2 = (4, 4)  # 4 * (1 + u)

# Standard generators (from the BLS12-381 specification).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# ---------------------------------------------------------------------------
# G1 (affine over Fp)
# ---------------------------------------------------------------------------


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = 3 * x1 * x1 * fp_inv(2 * y1) % P
    else:
        m = (y2 - y1) * fp_inv(x2 - x1) % P
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(pt):
    return g1_add(pt, pt)


def g1_mul_raw(pt, k: int):
    """Scalar mul WITHOUT reducing k mod r (for cofactor clearing).

    Jacobian double-and-add: one field inversion total, vs one per affine
    add — ~100x faster for 255-bit scalars."""
    return _jac_mul(pt, k, _FP_OPS)


def g1_mul(pt, k: int):
    return g1_mul_raw(pt, k % R)


def g1_in_subgroup(pt) -> bool:
    return g1_is_on_curve(pt) and g1_mul_raw(pt, R) is None


# ---------------------------------------------------------------------------
# G2 (affine over Fp2)
# ---------------------------------------------------------------------------


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    rhs = fp2_add(fp2_mul(fp2_sqr(x), x), B2)
    return fp2_sub(fp2_sqr(y), rhs) == FP2_ZERO


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_is_zero(fp2_add(y1, y2)):
            return None
        m = fp2_mul(fp2_scalar(fp2_sqr(x1), 3), fp2_inv(fp2_scalar(y1, 2)))
    else:
        m = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sqr(m), x1), x2)
    y3 = fp2_sub(fp2_mul(m, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(pt):
    return g2_add(pt, pt)


def g2_mul_raw(pt, k: int):
    return _jac_mul(pt, k, _FP2_OPS)


def g2_mul(pt, k: int):
    return g2_mul_raw(pt, k % R)


def g2_in_subgroup(pt) -> bool:
    return g2_is_on_curve(pt) and g2_mul_raw(pt, R) is None


# psi = twist o Frobenius o untwist on the M-twist: the host oracle for
# the device decompression kernel's fast subgroup check. On G2, psi acts
# as multiplication by the BLS parameter x = -X_ABS mod r. These
# constants are THE definition — ops/decompress.py and the
# SSWU kernels (ops/sswu.py) import them, so kernel and
# oracle can never drift apart.
PSI_CX = fp2_inv(fp2_pow(XI, (P - 1) // 3))
PSI_CY = fp2_inv(fp2_pow(XI, (P - 1) // 2))

# psi^2 collapses to a LINEAR map (no conjugation): psi(psi(x)) =
# cx * conj(cx) * x, and cx * conj(cx) = norm(cx) lands in Fp;
# cy * conj(cy) == -1 exactly. So psi^2(x, y) = (PSI2_CX * x, -y) —
# one Fp scale and a negation, which is what the device cofactor-
# clearing graph uses. Asserted against double-psi at import below.
PSI2_CX = (PSI_CX[0] * PSI_CX[0] + PSI_CX[1] * PSI_CX[1]) % P

# G1 GLV endomorphism phi(x, y) = (BETA * x, y) with BETA a nontrivial
# cube root of unity in Fp; on G1 phi acts as multiplication by
# G1_LAMBDA = X_ABS^2 - 1 (a root of lambda^2 + lambda + 1 mod r, since
# r = x^4 - x^2 + 1 for BLS curves). The 127-bit [lambda]P ladder
# replaces the 255-bit [r]P one in the device G1 subgroup check
# (ops/decompress.py imports these constants). Which of the two
# nontrivial cube roots matches G1_LAMBDA is fixed by the import-time
# assert below — drift between kernel and oracle is impossible.
# (2^((P-1)/3) is the OTHER root, i.e. lambda^2's; hence the square.)
G1_BETA = pow(2, 2 * (P - 1) // 3, P)
G1_LAMBDA = X_ABS * X_ABS - 1


def g1_phi(pt):
    if pt is None:
        return None
    return (pt[0] * G1_BETA % P, pt[1])


def g1_in_subgroup_phi(pt) -> bool:
    """Subgroup test via phi(P) == [lambda]P — equivalent to
    g1_in_subgroup for on-curve points, with a 127-bit ladder instead
    of the 255-bit [r]P one. Cross-checked in tests/test_sswu.py."""
    if pt is None:
        return True
    return g1_is_on_curve(pt) and g1_phi(pt) == g1_mul_raw(pt, G1_LAMBDA)


def g2_psi(pt):
    if pt is None:
        return None
    x, y = pt
    return (fp2_mul(fp2_conj(x), PSI_CX), fp2_mul(fp2_conj(y), PSI_CY))


def g2_psi2(pt):
    """psi applied twice, via the collapsed linear constants."""
    if pt is None:
        return None
    x, y = pt
    return (fp2_scalar(x, PSI2_CX), fp2_neg(y))


def g2_in_subgroup_psi(pt) -> bool:
    """Subgroup test via psi(P) == [x]P (Scott 2021) — equivalent to
    g2_in_subgroup for on-curve points, with a 64-bit ladder instead of
    the 255-bit [r]P one. Cross-checked in tests/test_decompress.py."""
    if pt is None:
        return True
    return g2_is_on_curve(pt) and g2_psi(pt) == g2_neg(
        g2_mul_raw(pt, X_ABS)
    )


def g2_clear_cofactor_psi(pt):
    """Fast G2 cofactor clearing (Budroni–Pintore 2017):

        h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P)

    with x the (negative) BLS parameter. Exactly equal to the RFC 9380
    [h_eff]P ladder on EVERY point of E'(Fp2) — asserted at import by
    crypto/h2c._selfcheck — but costs two 64-bit ladders instead of the
    1253-bit h_eff one (~9x fewer point ops). The host oracle for the
    device cofactor-clearing graph (ops/sswu.py)."""
    if pt is None:
        return None
    x_p = g2_neg(g2_mul_raw(pt, X_ABS))  # [x]P (x negative)
    psi_p = g2_psi(pt)
    t = g2_neg(g2_mul_raw(g2_add(x_p, psi_p), X_ABS))  # [x^2]P + [x]psi(P)
    t = g2_add(t, g2_neg(g2_add(x_p, psi_p)))  # -[x]P - psi(P)
    t = g2_add(t, g2_neg(pt))  # - P
    return g2_add(t, g2_psi2(g2_double(pt)))


# ---------------------------------------------------------------------------
# Jacobian scalar multiplication (host-speed path; affine ops above remain
# the simple correctness oracle)
# ---------------------------------------------------------------------------

# Generic field-op tables: (add, sub, mul, sqr, neg, inv, is_zero, zero)
_FP_OPS = (
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    lambda a: a * a % P,
    lambda a: (-a) % P,
    fp_inv,
    lambda a: a % P == 0,
    0,
)
_FP2_OPS = (
    fp2_add,
    fp2_sub,
    fp2_mul,
    fp2_sqr,
    fp2_neg,
    fp2_inv,
    fp2_is_zero,
    (0, 0),
)


def _jac_double(p, ops):
    add, sub, mul, sqr, neg, _, is_zero, _z = ops
    x, y, z = p
    if is_zero(z):
        return p
    a = sqr(x)
    b = sqr(y)
    c = sqr(b)
    d = sub(sub(sqr(add(x, b)), a), c)
    d = add(d, d)
    e = add(add(a, a), a)
    f = sqr(e)
    x3 = sub(f, add(d, d))
    c8 = add(add(c, c), add(c, c))
    c8 = add(c8, c8)
    y3 = sub(mul(e, sub(d, x3)), c8)
    z3 = mul(add(y, y), z)
    return (x3, y3, z3)


def _jac_add_affine(p, q, ops):
    """Jacobian p + affine q (q != infinity)."""
    add, sub, mul, sqr, neg, _, is_zero, zero = ops
    x1, y1, z1 = p
    x2, y2 = q
    if is_zero(z1):
        one = (1, 0) if isinstance(x2, tuple) else 1
        return (x2, y2, one)
    z1z1 = sqr(z1)
    u2 = mul(x2, z1z1)
    s2 = mul(mul(y2, z1), z1z1)
    if sub(u2, x1) == zero:
        if sub(s2, y1) == zero:
            return _jac_double(p, ops)
        return (zero, zero, zero)  # p + (-p) = infinity (z == 0)
    h = sub(u2, x1)
    hh = sqr(h)
    i = add(add(hh, hh), add(hh, hh))
    j = mul(h, i)
    r = sub(s2, y1)
    r = add(r, r)
    v = mul(x1, i)
    x3 = sub(sub(sqr(r), j), add(v, v))
    y1j = mul(y1, j)
    y3 = sub(mul(r, sub(v, x3)), add(y1j, y1j))
    z3 = mul(add(z1, h), add(z1, h))
    z3 = sub(sub(z3, sqr(z1)), hh)
    return (x3, y3, z3)


def _jac_mul(pt, k: int, ops):
    if pt is None or k == 0:
        return None
    add, sub, mul, sqr, neg, inv, is_zero, _ = ops
    zero = (0, 0) if isinstance(pt[0], tuple) else 0
    acc = (zero, zero, zero)  # infinity: z == 0
    for bit in bin(k)[2:]:
        acc = _jac_double(acc, ops)
        if bit == "1":
            acc = _jac_add_affine(acc, pt, ops)
    x, y, z = acc
    if is_zero(z):
        return None
    zinv = inv(z)
    zinv2 = sqr(zinv)
    return (mul(x, zinv2), mul(mul(y, zinv2), zinv))


# ---------------------------------------------------------------------------
# ZCash-format compressed serialization (the eth2 wire format)
# ---------------------------------------------------------------------------

_COMPRESSED = 0x80
_INFINITY = 0x40
_LEX_LARGEST = 0x20


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(47)
    x, y = pt
    flags = _COMPRESSED | (_LEX_LARGEST if y > (P - 1) // 2 else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_from_bytes(data: bytes, subgroup_check: bool = True):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMPRESSED:
        raise ValueError("uncompressed G1 not supported")
    if flags & _INFINITY:
        if any(data[1:]) or flags & _LEX_LARGEST or data[0] & 0x3F:
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = fp_sqrt((x * x * x + B1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if (y > (P - 1) // 2) != bool(flags & _LEX_LARGEST):
        y = P - y
    pt = (x, y)
    if subgroup_check and not g1_in_subgroup(pt):
        raise ValueError("G1 point not in subgroup")
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(95)
    (x0, x1), y = pt
    flags = _COMPRESSED | (_LEX_LARGEST if fp2_is_lex_largest(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def _endo_selfcheck() -> None:
    """Import-time consistency of the single-sourced endomorphism
    constants (the kernel families in ops/decompress.py and ops/sswu.py
    import them from here — a drifted constant must fail THIS import,
    not a device batch):

      * phi(G1) == [G1_LAMBDA]G1 — the GLV pair actually corresponds
        (BETA has two nontrivial choices; only one matches LAMBDA);
      * psi^2 via the collapsed linear constants == psi applied twice;
      * psi(G2) == [x]G2 — the subgroup-check identity on the generator.
    """
    if pow(G1_BETA, 3, P) != 1 or G1_BETA == 1:
        raise AssertionError("G1_BETA is not a nontrivial cube root of unity")
    if g1_phi(G1_GEN) != g1_mul_raw(G1_GEN, G1_LAMBDA):
        raise AssertionError("G1 GLV constants inconsistent: phi != [lambda]")
    probe = g2_double(G2_GEN)
    if g2_psi2(probe) != g2_psi(g2_psi(probe)):
        raise AssertionError("PSI2 constants inconsistent with double psi")
    if g2_psi(G2_GEN) != g2_neg(g2_mul_raw(G2_GEN, X_ABS)):
        raise AssertionError("psi does not act as [x] on G2")


_endo_selfcheck()


def g2_from_bytes(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMPRESSED:
        raise ValueError("uncompressed G2 not supported")
    if flags & _INFINITY:
        if any(data[1:]) or flags & _LEX_LARGEST or data[0] & 0x3F:
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sqr(x), x), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    if fp2_is_lex_largest(y) != bool(flags & _LEX_LARGEST):
        y = fp2_neg(y)
    pt = (x, y)
    if subgroup_check and not g2_in_subgroup(pt):
        raise ValueError("G2 point not in subgroup")
    return pt
