"""BLS12-381 field towers: Fp, Fp2, Fp6, Fp12, and the scalar field Fr.

Representation is deliberately primitive — Python ints and tuples, module-level
functions — so this file doubles as the executable specification for the
limb-based engine (charon_tpu_torch/ops/limb.py), which must agree with it
bit-for-bit.

Tower construction (standard 2-3-2 for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

An Fp2 element is a tuple (c0, c1) of ints meaning c0 + c1*u.
An Fp6 element is a tuple of three Fp2 elements (coefficients of 1, v, v^2).
An Fp12 element is a tuple of two Fp6 elements (coefficients of 1, w).

Plays the role of herumi's field arithmetic in the reference
(ref: tbls/herumi.go:25-36 links the C++/asm backend).
"""

from __future__ import annotations

# Base field modulus p (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus r (255 bits) — the group order of G1/G2/GT.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x; the curve is parameterised by x = -0xD201000000010000.
X_ABS = 0xD201000000010000
X_IS_NEG = True

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return (-a) % P


def fp_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("fp_inv(0)")
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (p ≡ 3 mod 4), or None if a is not a square."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1)
# ---------------------------------------------------------------------------

Fp2 = tuple  # (c0, c1)

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
# Non-residue xi = 1 + u used to build Fp6.
XI = (1, 1)


def fp2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a: Fp2) -> Fp2:
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a: Fp2, b: Fp2) -> Fp2:
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def fp2_sqr(a: Fp2) -> Fp2:
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a: Fp2) -> Fp2:
    """Frobenius on Fp2: (a0 + a1 u)^p = a0 - a1 u."""
    return (a[0], (-a[1]) % P)


def fp2_inv(a: Fp2) -> Fp2:
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = fp_inv(norm)
    return (a0 * ninv % P, -a1 * ninv % P)


def fp2_is_zero(a: Fp2) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fp2_pow(a: Fp2, e: int) -> Fp2:
    out = FP2_ONE
    base = a
    while e:
        if e & 1:
            out = fp2_mul(out, base)
        base = fp2_sqr(base)
        e >>= 1
    return out


def fp2_is_square(a: Fp2) -> bool:
    """a is a square in Fp2 iff norm(a)^((p-1)/2) == 1 (or a == 0)."""
    if fp2_is_zero(a):
        return True
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return pow(norm, (P - 1) // 2, P) == 1


_SQRT_EXP = (P - 3) // 4


def fp2_sqrt(a: Fp2) -> Fp2 | None:
    """Square root in Fp2 for p ≡ 3 mod 4 (Adj–Rodríguez), or None.

    a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0.
    If alpha == -1: sqrt = u * x0. Else sqrt = (1+alpha)^((p-1)/2) * x0.
    The candidate is verified by squaring, so wrong-path results return None.
    """
    if fp2_is_zero(a):
        return FP2_ZERO
    a1 = fp2_pow(a, _SQRT_EXP)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    if alpha == (P - 1, 0):
        cand = ((-x0[1]) % P, x0[0])  # u * x0
    else:
        b = fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2)
        cand = fp2_mul(b, x0)
    return cand if fp2_sqr(cand) == (a[0] % P, a[1] % P) else None


def fp2_sgn0(a: Fp2) -> int:
    """RFC 9380 sgn0 for Fp2 (m=2)."""
    sign_0 = a[0] % 2
    zero_0 = 1 if a[0] % P == 0 else 0
    sign_1 = a[1] % 2
    return sign_0 | (zero_0 & sign_1)


def fp2_is_lex_largest(a: Fp2) -> bool:
    """ZCash serialization sign: compare (c1, c0) lexicographically vs -a."""
    if a[1] % P != 0:
        return a[1] % P > (P - 1) // 2
    return a[0] % P > (P - 1) // 2


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_by_xi(a: Fp2) -> Fp2:
    """Multiply by xi = 1 + u: (a0 - a1) + (a0 + a1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t00 = fp2_mul(a0, b0)
    t11 = fp2_mul(a1, b1)
    t22 = fp2_mul(a2, b2)
    c0 = fp2_add(t00, _mul_by_xi(fp2_add(fp2_mul(a1, b2), fp2_mul(a2, b1))))
    c1 = fp2_add(fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0)), _mul_by_xi(t22))
    c2 = fp2_add(fp2_add(fp2_mul(a0, b2), fp2_mul(a2, b0)), t11)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2."""
    return (_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    t0 = fp2_sub(fp2_sqr(a0), _mul_by_xi(fp2_mul(a1, a2)))
    t1 = fp2_sub(_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    t2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    d = fp2_add(
        fp2_mul(a0, t0),
        _mul_by_xi(fp2_add(fp2_mul(a2, t1), fp2_mul(a1, t2))),
    )
    dinv = fp2_inv(d)
    return (fp2_mul(t0, dinv), fp2_mul(t1, dinv), fp2_mul(t2, dinv))


def fp6_is_zero(a) -> bool:
    return all(fp2_is_zero(c) for c in a)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_neg(a):
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_add(fp6_mul(a0, b1), fp6_mul(a1, b0))
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """f^(p^6): conjugation, negates the w coefficient."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    d = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    dinv = fp6_inv(d)
    return (fp6_mul(a0, dinv), fp6_neg(fp6_mul(a1, dinv)))


def fp12_pow(a, e: int):
    out = FP12_ONE
    base = a
    while e:
        if e & 1:
            out = fp12_mul(out, base)
        base = fp12_sqr(base)
        e >>= 1
    return out


def fp12_is_one(a) -> bool:
    return a[0] == FP6_ONE and fp6_is_zero(a[1])


# Frobenius: gamma6 = xi^((p-1)/6); (w^k)^p = gamma6^k * w^k, and an Fp12
# element's (i, j) coefficient (of v^j w^i) sits at degree k = 2j + i of w.
_GAMMA6 = fp2_pow(XI, (P - 1) // 6)
_GAMMA_POWS = [FP2_ONE]
for _ in range(5):
    _GAMMA_POWS.append(fp2_mul(_GAMMA_POWS[-1], _GAMMA6))


def fp12_frobenius(a):
    """f^p on the tower representation."""
    out6 = []
    for i in range(2):  # w^i
        coeffs = []
        for j in range(3):  # v^j
            c = fp2_conj(a[i][j])
            coeffs.append(fp2_mul(c, _GAMMA_POWS[2 * j + i]))
        out6.append(tuple(coeffs))
    return tuple(out6)


def fp12_frobenius_n(a, n: int):
    for _ in range(n):
        a = fp12_frobenius(a)
    return a


# ---------------------------------------------------------------------------
# Fr (scalar field)
# ---------------------------------------------------------------------------


def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("fr_inv(0)")
    return pow(a, R - 2, R)
