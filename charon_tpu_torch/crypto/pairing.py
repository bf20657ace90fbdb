"""Optimal ate pairing for BLS12-381.

Strategy (reference implementation — clarity over speed):
  * Untwist G2 points from E'(Fp2) into E(Fp12) using the sextic twist
    isomorphism, then run the Miller loop entirely in affine Fp12
    coordinates with slope-based line functions.
  * Final exponentiation: easy part via conjugation + Frobenius, hard part
    as a plain square-and-multiply by the integer (p^4 - p^2 + 1) / r.

With w^6 = xi the untwist map is (x, y) -> (x / w^2, y / w^3), i.e.
  x12 = x * xi^-1 * v^2          (an Fp6 coefficient at w^0)
  y12 = y * xi^-1 * v  * w       (an Fp6 coefficient at w^1)

The JAX engine implements the production pairing (projective, x-chain final
exp); this module is its correctness oracle.
"""

from __future__ import annotations

from charon_tpu_torch.crypto.fields import (
    FP2_ZERO,
    FP6_ZERO,
    FP12_ONE,
    P,
    R,
    X_ABS,
    X_IS_NEG,
    XI,
    fp2_inv,
    fp2_mul,
    fp12_conj,
    fp12_frobenius_n,
    fp12_inv,
    fp12_mul,
    fp12_pow,
    fp12_sqr,
    fp12_sub,
    fp6_is_zero,
)

_XI_INV = fp2_inv(XI)

# Hard-part exponent of the final exponentiation.
_HARD_EXP = (P**4 - P**2 + 1) // R


def _fp12_from_fp(a: int):
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


_FP12_TWO = _fp12_from_fp(2)
_FP12_THREE = _fp12_from_fp(3)


def untwist(pt):
    """Map an affine E'(Fp2) point to affine E(Fp12)."""
    if pt is None:
        return None
    x, y = pt
    x12 = ((FP2_ZERO, FP2_ZERO, fp2_mul(x, _XI_INV)), FP6_ZERO)
    y12 = (FP6_ZERO, (FP2_ZERO, fp2_mul(y, _XI_INV), FP2_ZERO))
    return (x12, y12)


def _embed_g1(pt):
    """Embed an affine E(Fp) point into E(Fp12)."""
    return (_fp12_from_fp(pt[0]), _fp12_from_fp(pt[1]))


def _fp12_is_zero(a) -> bool:
    return fp6_is_zero(a[0]) and fp6_is_zero(a[1])


def _step(p1, p2, t):
    """One Miller-loop step on E(Fp12): add p1 + p2, evaluating the line
    through them at t. Returns (line_value, p1 + p2).

    Computes the slope once for both the line evaluation and the point
    arithmetic (affine chord-and-tangent).
    """
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    dx = fp12_sub(x2, x1)
    if not _fp12_is_zero(dx):
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(dx))
    elif y1 == y2:
        x1sq = fp12_mul(x1, x1)
        m = fp12_mul(
            fp12_mul(x1sq, _FP12_THREE),
            fp12_inv(fp12_mul(y1, _FP12_TWO)),
        )
    else:
        # Vertical line: p1 + p2 = infinity; line value is xt - x1.
        return fp12_sub(xt, x1), None
    line = fp12_sub(fp12_mul(m, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    x3 = fp12_sub(fp12_sub(fp12_mul(m, m), x1), x2)
    y3 = fp12_sub(fp12_mul(m, fp12_sub(x1, x3)), y1)
    return line, (x3, y3)


def miller_loop(q, p):
    """Miller loop over |x| for untwisted q and embedded p (both E(Fp12))."""
    if q is None or p is None:
        return FP12_ONE
    f = FP12_ONE
    t = q
    for bit in bin(X_ABS)[3:]:  # skip the leading 1
        line, t = _step(t, t, p)
        f = fp12_mul(fp12_sqr(f), line)
        if bit == "1":
            line, t = _step(t, q, p)
            f = fp12_mul(f, line)
    if X_IS_NEG:
        # Conjugation inverts f in the cyclotomic subgroup.
        f = fp12_conj(f)
    return f


def final_exponentiation(f):
    # Easy part: f^((p^6 - 1)(p^2 + 1)).
    f = fp12_mul(fp12_conj(f), fp12_inv(f))
    f = fp12_mul(fp12_frobenius_n(f, 2), f)
    # Hard part: f^((p^4 - p^2 + 1)/r), plain square-and-multiply.
    return fp12_pow(f, _HARD_EXP)


def pairing(q, p):
    """e(P, Q) with P in G1(E/Fp), Q in G2(E'/Fp2). Returns an Fp12 element.

    Argument order note: callers pass (Q, P) — G2 first — matching the
    Miller-loop structure; the bilinear map computed is e: G1 x G2 -> GT.
    """
    if q is None or p is None:
        return FP12_ONE
    return final_exponentiation(miller_loop(untwist(q), _embed_g1(p)))


def multi_miller(pairs):
    """Product of Miller loops for (q, p) pairs, single final exponentiation.

    This is the production verification shape: verify checks
    e(-G1, sig) * e(pk, H(m)) == 1 with one final exponentiation.
    """
    f = FP12_ONE
    for q, p in pairs:
        if q is None or p is None:
            continue
        f = fp12_mul(f, miller_loop(untwist(q), _embed_g1(p)))
    return final_exponentiation(f)
