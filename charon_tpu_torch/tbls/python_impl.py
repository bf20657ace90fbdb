"""Host half of the pure-Python tbls backend: key generation, Shamir
split/recover, signing, and wire decode (the JAX package's
tbls/python_impl.py without verification — the port verifies on the
device, tbls/torch_impl.py).

Secret material never leaves the host: TorchImpl delegates these
operations here and ships only public points to the device.
"""

from __future__ import annotations

import os
from typing import Mapping

from charon_tpu_torch.crypto import bls, g1g2, shamir
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.tbls import (
    PRIVATE_KEY_LEN,
    PUBLIC_KEY_LEN,
    SIGNATURE_LEN,
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


class PythonHost:
    """The secret-key half of the tbls contract, on host bigints."""

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
