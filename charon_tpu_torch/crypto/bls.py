"""BLS signatures over BLS12-381 (eth2 flavour: pubkeys G1, signatures G2).

Implements the draft-irtf-cfrg-bls-signature operations the reference's tbls
facade exposes (ref: tbls/tbls.go:28-69): KeyGen, SkToPk, Sign, Verify,
Aggregate, FastAggregateVerify — in the proof-of-possession ciphersuite used
by eth2.
"""

from __future__ import annotations

import hashlib
import hmac
import os

from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.crypto.g1g2 import (
    G1_GEN,
    g1_add,
    g1_from_bytes,
    g1_mul,
    g1_neg,
    g1_to_bytes,
    g2_add,
    g2_from_bytes,
    g2_mul,
    g2_to_bytes,
)
from charon_tpu_torch.crypto.h2c import DST_POP, hash_to_g2
from charon_tpu_torch.crypto.pairing import multi_miller
from charon_tpu_torch.crypto.fields import fp12_is_one

KEYGEN_SALT = b"BLS-SIG-KEYGEN-SALT-"


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    block = b""
    i = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + i.to_bytes(1, "big"), hashlib.sha256).digest()
        out += block
        i += 1
    return out[:length]


def keygen(ikm: bytes | None = None, key_info: bytes = b"") -> int:
    """RFC KeyGen: HKDF loop until a nonzero scalar mod r is derived."""
    if ikm is None:
        ikm = os.urandom(32)
    if len(ikm) < 32:
        raise ValueError("IKM must be >= 32 bytes")
    salt = KEYGEN_SALT
    sk = 0
    while sk == 0:
        prk = _hkdf_extract(hashlib.sha256(salt).digest(), ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
        salt = hashlib.sha256(salt).digest()
    return sk


def sk_to_pk(sk: int):
    return g1_mul(G1_GEN, sk)


def sign(sk: int, msg: bytes, dst: bytes = DST_POP):
    return g2_mul(hash_to_g2(msg, dst), sk)


def verify(pk, msg: bytes, sig, dst: bytes = DST_POP) -> bool:
    """e(-G1, sig) * e(pk, H(m)) == 1.

    Uses the production projective pairing with the x-chain final
    exponentiation (pairing_fast) — ~20x faster than the affine oracle and
    validated against it (tests/test_pairing_fast.py)."""
    if pk is None or sig is None:
        return False
    from charon_tpu_torch.crypto.pairing_fast import is_gt_one, multi_pairing_fast

    h = hash_to_g2(msg, dst)
    return is_gt_one(multi_pairing_fast([(sig, g1_neg(G1_GEN)), (h, pk)]))


def aggregate_sigs(sigs):
    out = None
    for s in sigs:
        out = g2_add(out, s)
    return out


def aggregate_pks(pks):
    out = None
    for pk in pks:
        out = g1_add(out, pk)
    return out


def fast_aggregate_verify(pks, msg: bytes, sig, dst: bytes = DST_POP) -> bool:
    """All signers signed the same message (eth2 aggregate attestations)."""
    if not pks:
        return False
    return verify(aggregate_pks(pks), msg, sig, dst)


def aggregate_verify(pks, msgs, sig, dst: bytes = DST_POP) -> bool:
    """Distinct messages: e(-G1, sig) * prod e(pk_i, H(m_i)) == 1."""
    if not pks or len(pks) != len(msgs) or sig is None:
        return False
    from charon_tpu_torch.crypto.pairing_fast import is_gt_one, multi_pairing_fast

    pairs = [(sig, g1_neg(G1_GEN))]
    for pk, msg in zip(pks, msgs):
        if pk is None:
            return False
        pairs.append((hash_to_g2(msg, dst), pk))
    return is_gt_one(multi_pairing_fast(pairs))


# --- byte-level convenience (the tbls wire types) ---


def sk_to_bytes(sk: int) -> bytes:
    return (sk % R).to_bytes(32, "big")


def sk_from_bytes(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("secret key must be 32 bytes")
    sk = int.from_bytes(data, "big")
    if not 0 < sk < R:
        raise ValueError("secret key out of range")
    return sk


pk_to_bytes = g1_to_bytes
pk_from_bytes = g1_from_bytes
sig_to_bytes = g2_to_bytes
sig_from_bytes = g2_from_bytes
