"""secp256k1 node identity: sign/verify/serialize.

Mirrors ref: app/k1util — the reference signs QBFT and priority messages
with the node's secp256k1 p2p key. Backed by the `cryptography` library
(ECDSA over SECP256K1, DER signatures normalized to raw 64-byte r||s).
"""

from __future__ import annotations

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    Prehashed,
    decode_dss_signature,
    encode_dss_signature,
)

_CURVE = ec.SECP256K1()
# secp256k1 group order (for low-s normalization).
_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def generate_private_key() -> ec.EllipticCurvePrivateKey:
    return ec.generate_private_key(_CURVE)


def private_key_to_bytes(key: ec.EllipticCurvePrivateKey) -> bytes:
    return key.private_numbers().private_value.to_bytes(32, "big")


def private_key_from_bytes(data: bytes) -> ec.EllipticCurvePrivateKey:
    return ec.derive_private_key(int.from_bytes(data, "big"), _CURVE)


def public_key_to_bytes(pub: ec.EllipticCurvePublicKey) -> bytes:
    """33-byte compressed SEC1 encoding (the reference's wire format)."""
    return pub.public_bytes(
        serialization.Encoding.X962,
        serialization.PublicFormat.CompressedPoint,
    )


def public_key_from_bytes(data: bytes) -> ec.EllipticCurvePublicKey:
    return ec.EllipticCurvePublicKey.from_encoded_point(_CURVE, data)


def sign(key: ec.EllipticCurvePrivateKey, digest: bytes) -> bytes:
    """Sign a 32-byte digest; returns raw 64-byte r||s with low s."""
    if len(digest) != 32:
        raise ValueError("sign expects a 32-byte digest")
    der = key.sign(digest, ec.ECDSA(Prehashed(hashes.SHA256())))
    r, s = decode_dss_signature(der)
    if s > _ORDER // 2:
        s = _ORDER - s
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify(pub: ec.EllipticCurvePublicKey, digest: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(digest) != 32:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    try:
        der = encode_dss_signature(r, s)
        pub.verify(der, digest, ec.ECDSA(Prehashed(hashes.SHA256())))
        return True
    except Exception:
        return False


def verify_bytes(pubkey_bytes: bytes, digest: bytes, sig: bytes) -> bool:
    try:
        return verify(public_key_from_bytes(pubkey_bytes), digest, sig)
    except Exception:
        return False


def ecdh(key: ec.EllipticCurvePrivateKey, peer_pubkey_bytes: bytes) -> bytes:
    """Static-static ECDH shared secret with a peer's compressed pubkey.

    Used to derive per-connection MAC keys in the p2p handshake (the
    reference gets the same property from libp2p-TLS with pinned peer
    identities, ref: p2p/p2p.go security transport)."""
    peer = public_key_from_bytes(peer_pubkey_bytes)
    return key.exchange(ec.ECDH(), peer)
