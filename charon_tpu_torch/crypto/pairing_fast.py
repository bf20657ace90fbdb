"""Production optimal-ate pairing for BLS12-381 (projective, sparse lines).

This is the *algorithmic specification* for the batched JAX engine
(charon_tpu_torch/ops/pairing.py): identical control flow and formulas, scalar
Python ints here, limb arrays there. It is validated against the slow affine
oracle in charon_tpu_torch/crypto/pairing.py.

Differences from the oracle (all standard production techniques):

  * G2 points are homogeneous projective (X, Y, Z) over Fp2 — no inversions
    inside the Miller loop.
  * Line functions are evaluated *unnormalized*: each line may be scaled by
    an arbitrary Fp2 constant, because the final exponentiation
    (p^12-1)/r kills every element of Fp2* (Fp2* has order p^2-1 which
    divides p^6-1 which divides the exponent).
  * Lines are sparse Fp12 elements with nonzero Fp2 coefficients only at
    (w^0 v^0), (w^1 v^1), (w^1 v^2) for the BLS12-381 M-twist with untwist
    x = x' * xi^-1 v^2,  y = y' * xi^-1 v w  (see pairing.py:untwist).
    Derivation of the doubling line at affine T=(x', y') evaluated at
    P=(xP, yP), scaled by 2 y' xi:
        l = 2 y' yP xi  +  (3 x'^3 - 2 y'^2) v w  -  3 x'^2 xP v^2 w
    and the chord line through T and affine Q=(x2, y2), scaled by
    (x_T - x2) xi ... with theta = y_T - y2, lam = x_T - x2:
        l = lam yP xi  +  (theta x2 - lam y2) v w  -  theta xP v^2 w
  * Final exponentiation hard part uses the BLS12 lattice identity
        3 * (p^4 - p^2 + 1)/r = (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3
    i.e. we compute f^(3h) instead of f^h. This is sound for every product-
    of-pairings == 1 check (GT has prime order r, gcd(3, r) = 1), and is
    what the tests assert: fast == oracle^3.

Plays the role of herumi's pairing (ref: tbls/herumi.go:288 Verify).
"""

from __future__ import annotations

from charon_tpu_torch.crypto.fields import (
    FP2_ONE,
    FP2_ZERO,
    FP12_ONE,
    P,
    R,
    X_ABS,
    X_IS_NEG,
    fp2_add,
    fp2_is_zero,
    fp2_mul,
    fp2_neg,
    fp2_scalar,
    fp2_sqr,
    fp2_sub,
    fp12_conj,
    fp12_frobenius_n,
    fp12_inv,
    fp12_mul,
    fp12_sqr,
)

# Hard-part check constant: 3*(p^4-p^2+1)/r == (x-1)^2 (x+p) (x^2+p^2-1) + 3.
_X = -X_ABS if X_IS_NEG else X_ABS
assert (
    3 * ((P**4 - P**2 + 1) // R)
    == (_X - 1) ** 2 * (_X + P) * (_X * _X + P * P - 1) + 3
), "BLS12 final-exponentiation lattice identity"

# Bits of |x| below the leading one, MSB first: the Miller-loop schedule.
X_BITS = [int(b) for b in bin(X_ABS)[3:]]


def _mul_by_xi(a):
    # xi = 1 + u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


# ---------------------------------------------------------------------------
# Sparse Fp12 multiplication by a line l0 + l1 v w + l2 v^2 w
# ---------------------------------------------------------------------------


def fp12_mul_sparse_line(f, l0, l1, l2):
    """f * (l0 + l1*v*w + l2*v^2*w), with l0, l1, l2 in Fp2.

    18 fp2 muls vs 36 for a dense fp12 mul.
    """
    (a0, a1, a2), (b0, b1, b2) = f
    # A * L0 where L0 = (l0, 0, 0): scales each coefficient.
    t0 = (fp2_mul(a0, l0), fp2_mul(a1, l0), fp2_mul(a2, l0))
    # B * L1 where L1 = (0, l1, l2):
    #   c0 = xi*(b1*l2 + b2*l1); c1 = b0*l1 + xi*(b2*l2); c2 = b0*l2 + b1*l1
    t1 = (
        _mul_by_xi(fp2_add(fp2_mul(b1, l2), fp2_mul(b2, l1))),
        fp2_add(fp2_mul(b0, l1), _mul_by_xi(fp2_mul(b2, l2))),
        fp2_add(fp2_mul(b0, l2), fp2_mul(b1, l1)),
    )
    # c0 = t0 + v*t1
    c0 = (
        fp2_add(t0[0], _mul_by_xi(t1[2])),
        fp2_add(t0[1], t1[0]),
        fp2_add(t0[2], t1[1]),
    )
    # c1 = A*L1 + B*L0
    a_l1 = (
        _mul_by_xi(fp2_add(fp2_mul(a1, l2), fp2_mul(a2, l1))),
        fp2_add(fp2_mul(a0, l1), _mul_by_xi(fp2_mul(a2, l2))),
        fp2_add(fp2_mul(a0, l2), fp2_mul(a1, l1)),
    )
    b_l0 = (fp2_mul(b0, l0), fp2_mul(b1, l0), fp2_mul(b2, l0))
    c1 = (
        fp2_add(a_l1[0], b_l0[0]),
        fp2_add(a_l1[1], b_l0[1]),
        fp2_add(a_l1[2], b_l0[2]),
    )
    return (c0, c1)


# ---------------------------------------------------------------------------
# Projective Miller-loop steps (G2 in homogeneous projective over Fp2)
# ---------------------------------------------------------------------------


def _dbl_step(t, xp, yp):
    """Double T=(X,Y,Z) and return the tangent-line coefficients at P=(xp,yp).

    Line (scaled by 2 y_T Z^3 xi for the c00 term / by Z^3 for the rest —
    all Fp2-proportional, killed by the final exponentiation):
        l0 = 2 Y Z^2 yp * xi,  l1 = 3 X^3 - 2 Y^2 Z,  l2 = -(3 X^2 Z) xp
    Point:  W=3X^2, S=YZ, B=XYS, H=W^2-8B
            X' = 2HS,  Y' = W(4B - H) - 8 Y^2 S^2,  Z' = 8 S^3
    """
    x, y, z = t
    w = fp2_scalar(fp2_sqr(x), 3)
    s = fp2_mul(y, z)
    bb = fp2_mul(fp2_mul(x, y), s)
    h = fp2_sub(fp2_sqr(w), fp2_scalar(bb, 8))
    y2 = fp2_sqr(y)

    x3 = fp2_scalar(fp2_mul(h, s), 2)
    y3 = fp2_sub(
        fp2_mul(w, fp2_sub(fp2_scalar(bb, 4), h)),
        fp2_scalar(fp2_mul(y2, fp2_sqr(s)), 8),
    )
    z3 = fp2_scalar(fp2_mul(s, fp2_sqr(s)), 8)

    l0 = _mul_by_xi(fp2_scalar(fp2_mul(s, z), 2 * yp % P))
    l1 = fp2_sub(fp2_mul(w, x), fp2_scalar(fp2_mul(y2, z), 2))
    l2 = fp2_scalar(fp2_mul(w, z), (-xp) % P)
    return (x3, y3, z3), (l0, l1, l2)


def _add_step(t, q, xp, yp):
    """Mixed add T=(X,Y,Z) + affine Q=(x2,y2); chord line at P=(xp,yp).

    theta = Y - y2 Z, lam = X - x2 Z  (so the affine chord slope is
    theta/lam = (y_T - y2)/(x_T - x2)).
        l0 = lam yp * xi,  l1 = theta x2 - lam y2,  l2 = -theta xp
    Point:  W = theta^2 Z + lam^3 - 2 lam^2 X
            X' = lam W,  Y' = theta(lam^2 X - W) - lam^3 Y,  Z' = lam^3 Z
    """
    x, y, z = t
    x2, y2 = q
    theta = fp2_sub(y, fp2_mul(y2, z))
    lam = fp2_sub(x, fp2_mul(x2, z))
    lam2 = fp2_sqr(lam)
    lam3 = fp2_mul(lam2, lam)
    ww = fp2_add(
        fp2_sub(fp2_mul(fp2_sqr(theta), z), fp2_mul(lam2, fp2_scalar(x, 2))),
        lam3,
    )
    x3 = fp2_mul(lam, ww)
    y3 = fp2_sub(
        fp2_mul(theta, fp2_sub(fp2_mul(lam2, x), ww)),
        fp2_mul(lam3, y),
    )
    z3 = fp2_mul(lam3, z)

    l0 = _mul_by_xi(fp2_scalar(lam, yp))
    l1 = fp2_sub(fp2_mul(theta, x2), fp2_mul(lam, y2))
    l2 = fp2_mul(theta, (((-xp) % P), 0))
    return (x3, y3, z3), (l0, l1, l2)


def miller_loop_projective(pairs):
    """Product of Miller loops over (q, p) pairs; q in G2 affine (Fp2),
    p in G1 affine (Fp). Skips pairs with an identity member."""
    live = [
        ((q[0], q[1], FP2_ONE), q, p)
        for q, p in pairs
        if q is not None and p is not None
    ]
    f = FP12_ONE
    ts = [t for t, _, _ in live]
    for i, bit in enumerate(X_BITS):
        if i != 0:
            f = fp12_sqr(f)
        for k, (_, q, p) in enumerate(live):
            ts[k], line = _dbl_step(ts[k], p[0], p[1])
            f = fp12_mul_sparse_line(f, *line)
        if bit:
            for k, (_, q, p) in enumerate(live):
                ts[k], line = _add_step(ts[k], q, p[0], p[1])
                f = fp12_mul_sparse_line(f, *line)
    if X_IS_NEG:
        f = fp12_conj(f)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation: easy part + x-chain hard part (computes f^(3h))
# ---------------------------------------------------------------------------


def _cyc_pow_u(f):
    """f^|x| for f in the cyclotomic subgroup (square-and-multiply, MSB)."""
    out = f
    for bit in X_BITS:
        out = fp12_sqr(out)
        if bit:
            out = fp12_mul(out, f)
    return out


def _cyc_pow_x(f):
    """f^x with x negative: conj(f^|x|) (inverse == conjugate here)."""
    out = _cyc_pow_u(f)
    return fp12_conj(out) if X_IS_NEG else out


def final_exp_fast(f):
    """f^(3 * (p^12-1)/r): easy part then the lattice-identity hard part."""
    # Easy: f <- f^((p^6-1)(p^2+1)). Lands in the cyclotomic subgroup.
    f = fp12_mul(fp12_conj(f), fp12_inv(f))
    m = fp12_mul(fp12_frobenius_n(f, 2), f)
    # Hard: m^(3h) = m^((x-1)^2 (x+p) (x^2+p^2-1)) * m^3.
    # a = m^((x-1)^2) = (m^(u+1))^(u+1)  since x-1 = -(u+1).
    a = fp12_mul(_cyc_pow_u(m), m)
    a = fp12_mul(_cyc_pow_u(a), a)
    # b = a^(x+p) = a^x * frob(a)
    b = fp12_mul(_cyc_pow_x(a), fp12_frobenius_n(a, 1))
    # c = b^(x^2+p^2-1) = (b^x)^x * frob2(b) * b^-1
    c = fp12_mul(
        fp12_mul(_cyc_pow_x(_cyc_pow_x(b)), fp12_frobenius_n(b, 2)),
        fp12_conj(b),
    )
    # result = c * m^3
    return fp12_mul(c, fp12_mul(fp12_sqr(m), m))


def multi_pairing_fast(pairs):
    """Product of pairings raised to the 3rd power: prod e(p_i, q_i)^3.

    Equality/identity checks are unaffected by the cube (GT is prime order
    r, 3 invertible mod r)."""
    return final_exp_fast(miller_loop_projective(pairs))


def is_gt_one(f) -> bool:
    from charon_tpu_torch.crypto.fields import fp12_is_one

    return fp12_is_one(f)
