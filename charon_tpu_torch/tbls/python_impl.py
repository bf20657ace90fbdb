"""Pure-Python tbls backend over charon_tpu_torch/crypto (the host reference).

Plays the role the herumi backend plays in the reference
(ref: tbls/herumi.go) — the trusted, simple implementation every other
backend is validated against (ref: tbls/tbls_test.go:209 randomized
cross-impl suite; ours is tests/test_tbls.py).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

from charon_tpu_torch.crypto import bls, g1g2, h2c, shamir
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.tbls import (
    PRIVATE_KEY_LEN,
    PUBLIC_KEY_LEN,
    SIGNATURE_LEN,
    Implementation,
    TblsError,
)


def _check_len(data: bytes, want: int, what: str) -> None:
    if len(data) != want:
        raise TblsError(f"{what} must be {want} bytes, got {len(data)}")


def sk_to_int(secret: bytes) -> int:
    _check_len(secret, PRIVATE_KEY_LEN, "private key")
    sk = int.from_bytes(secret, "big")
    if not 0 < sk < R:
        raise TblsError("private key scalar out of range")
    return sk


def int_to_sk(sk: int) -> bytes:
    return (sk % R).to_bytes(PRIVATE_KEY_LEN, "big")


def pubkey_to_point(pubkey: bytes, subgroup_check: bool = True):
    _check_len(pubkey, PUBLIC_KEY_LEN, "public key")
    try:
        pt = g1g2.g1_from_bytes(pubkey, subgroup_check=subgroup_check)
    except ValueError as e:
        raise TblsError(str(e)) from e
    if pt is None:
        raise TblsError("infinite public key")
    return pt


def sig_to_point(sig: bytes, subgroup_check: bool = True):
    _check_len(sig, SIGNATURE_LEN, "signature")
    try:
        return g1g2.g2_from_bytes(sig, subgroup_check=subgroup_check)
    except ValueError as e:
        raise TblsError(str(e)) from e


class PythonImpl(Implementation):
    def generate_secret_key(self) -> bytes:
        return int_to_sk(bls.keygen(os.urandom(32)))

    def secret_to_public_key(self, secret: bytes) -> bytes:
        return g1g2.g1_to_bytes(bls.sk_to_pk(sk_to_int(secret)))

    def threshold_split(self, secret: bytes, total: int, threshold: int) -> dict[int, bytes]:
        if not 0 < threshold <= total:
            raise TblsError("invalid threshold/total")
        shares = shamir.split(sk_to_int(secret), total, threshold)
        return {i: int_to_sk(v) for i, v in shares.items()}

    def recover_secret(self, shares: Mapping[int, bytes], total: int, threshold: int) -> bytes:
        if len(shares) < threshold:
            raise TblsError("insufficient shares")
        ints = {i: sk_to_int(s) for i, s in shares.items()}
        return int_to_sk(shamir.recover_secret(ints))

    def sign(self, secret: bytes, data: bytes) -> bytes:
        return g1g2.g2_to_bytes(bls.sign(sk_to_int(secret), data))

    def verify(self, pubkey: bytes, data: bytes, sig: bytes) -> None:
        pk = pubkey_to_point(pubkey)
        s = sig_to_point(sig)
        if s is None:
            raise TblsError("infinite signature")
        if not bls.verify(pk, data, s):
            raise TblsError("signature verification failed")

    def verify_aggregate(self, pubkeys: Sequence[bytes], data: bytes, sig: bytes) -> None:
        if not pubkeys:
            raise TblsError("no public keys")
        pts = [pubkey_to_point(pk) for pk in pubkeys]
        s = sig_to_point(sig)
        if s is None:
            raise TblsError("infinite signature")
        if not bls.fast_aggregate_verify(pts, data, s):
            raise TblsError("aggregate signature verification failed")

    def threshold_aggregate(self, partials: Mapping[int, bytes]) -> bytes:
        if not partials:
            raise TblsError("no partial signatures")
        pts = {}
        for idx, sig in partials.items():
            if idx <= 0:
                raise TblsError("share indices are 1-based")
            pt = sig_to_point(sig)
            if pt is None:
                raise TblsError("infinite partial signature")
            pts[idx] = pt
        return g1g2.g2_to_bytes(shamir.threshold_aggregate_g2(pts))

    def aggregate(self, sigs: Sequence[bytes]) -> bytes:
        if not sigs:
            raise TblsError("no signatures")
        pts = []
        for sig in sigs:
            pt = sig_to_point(sig)
            if pt is None:
                raise TblsError("infinite signature")
            pts.append(pt)
        return g1g2.g2_to_bytes(bls.aggregate_sigs(pts))
