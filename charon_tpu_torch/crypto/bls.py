"""BLS key generation and signing over BLS12-381 (eth2 flavour: pubkeys
G1, signatures G2) — the host half of the JAX package's crypto/bls.py.

Verification is not here: the port verifies on the device
(charon_tpu_torch/ops/pairing.py) and its tests hold it against the JAX
package's pure-Python pairing.
"""

from __future__ import annotations

import hashlib
import hmac
import os

from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.crypto.g1g2 import G1_GEN, g1_mul, g2_mul
from charon_tpu_torch.crypto.h2c import DST_POP, hash_to_g2

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
