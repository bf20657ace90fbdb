"""Shamir secret sharing and Lagrange threshold recombination over Fr.

The threshold-BLS core of the framework (ref: tbls/herumi.go:137-223
ThresholdSplit/RecoverSecret, herumi.go:249-286 ThresholdAggregate):

  * split: sample a degree-(t-1) polynomial f with f(0) = secret; share_i =
    f(i) for share indices i in 1..n.
  * recover: Lagrange-interpolate f(0) from any t shares.
  * threshold_aggregate: recombine partial signatures sigma_i = sk_i * H(m)
    into the group signature via the same Lagrange coefficients applied in
    the exponent: sigma = sum_i lambda_i * sigma_i over G2.

Share indices are 1-based, matching the reference convention
(ref: tbls/herumi.go:158 "share IDs are 1-indexed").
"""

from __future__ import annotations

import secrets

from charon_tpu_torch.crypto.fields import R, fr_inv, fr_mul
from charon_tpu_torch.crypto.g1g2 import g1_add, g1_mul, g2_add, g2_mul


def split(secret: int, n: int, t: int, rand=None):
    """Split secret into n shares with threshold t.

    Returns {share_index: share_scalar} with 1-based indices.
    """
    if not 1 < t <= n:
        raise ValueError(f"invalid threshold {t} of {n}")
    if not 0 < secret < R:
        raise ValueError("secret out of range")
    randfn = rand if rand is not None else (lambda: secrets.randbelow(R - 1) + 1)
    coeffs = [secret] + [randfn() % R for _ in range(t - 1)]
    shares = {}
    for idx in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):  # Horner
            acc = (acc * idx + c) % R
        shares[idx] = acc
    return shares


def lagrange_coeffs_at_zero(indices):
    """lambda_i = prod_{j != i} j / (j - i) mod r, for 1-based share indices."""
    out = {}
    for i in indices:
        num, den = 1, 1
        for j in indices:
            if j == i:
                continue
            num = num * j % R
            den = den * (j - i) % R
        out[i] = fr_mul(num, fr_inv(den))
    return out


def recover_secret(shares: dict) -> int:
    """Recover f(0) from a {share_index: scalar} map of >= t shares."""
    coeffs = lagrange_coeffs_at_zero(list(shares))
    out = 0
    for idx, val in shares.items():
        out = (out + coeffs[idx] * val) % R
    return out


def threshold_aggregate_g2(partials: dict):
    """Recombine {share_index: G2 point} partial signatures into the group
    signature (Lagrange in the exponent)."""
    coeffs = lagrange_coeffs_at_zero(list(partials))
    out = None
    for idx, sig in partials.items():
        out = g2_add(out, g2_mul(sig, coeffs[idx]))
    return out


def threshold_aggregate_g1(partials: dict):
    """Same recombination for G1 points (pubkey recovery from pubshares)."""
    coeffs = lagrange_coeffs_at_zero(list(partials))
    out = None
    for idx, pt in partials.items():
        out = g1_add(out, g1_mul(pt, coeffs[idx]))
    return out
