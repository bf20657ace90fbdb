"""EIP-2335 BLS keystores: encrypt/decrypt share private keys.

Mirrors ref: eth2util/keystore/keystore.go:72-148 — keystore-N.json files
with adjacent password files, pbkdf2 KDF (spec-compliant EIP-2335 crypto
modules: pbkdf2-hmac-sha256 + AES-128-CTR + sha256 checksum).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import uuid as uuidlib
from pathlib import Path

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

_PBKDF2_C = 262144
_DKLEN = 32


def _kdf(password: str, salt: bytes, c: int = _PBKDF2_C) -> bytes:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, c, dklen=_DKLEN
    )


def _aes128ctr(key16: bytes, iv: bytes, data: bytes) -> bytes:
    cipher = Cipher(algorithms.AES(key16), modes.CTR(iv))
    enc = cipher.encryptor()
    return enc.update(data) + enc.finalize()


def encrypt(secret: bytes, password: str, pubkey_hex: str = "", path: str = "") -> dict:
    """Encrypt a 32-byte BLS secret into an EIP-2335 keystore dict."""
    if len(secret) != 32:
        raise ValueError("secret must be 32 bytes")
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    dk = _kdf(password, salt)
    ciphertext = _aes128ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()
    return {
        "crypto": {
            "kdf": {
                "function": "pbkdf2",
                "params": {
                    "dklen": _DKLEN,
                    "c": _PBKDF2_C,
                    "prf": "hmac-sha256",
                    "salt": salt.hex(),
                },
                "message": "",
            },
            "checksum": {
                "function": "sha256",
                "params": {},
                "message": checksum.hex(),
            },
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": ciphertext.hex(),
            },
        },
        "description": "charon-tpu distributed validator key share",
        "pubkey": pubkey_hex.removeprefix("0x"),
        "path": path,
        "uuid": str(uuidlib.uuid4()),
        "version": 4,
    }


def decrypt(keystore: dict, password: str) -> bytes:
    crypto = keystore["crypto"]
    if crypto["kdf"]["function"] != "pbkdf2":
        raise ValueError("unsupported kdf")
    params = crypto["kdf"]["params"]
    dk = _kdf(password, bytes.fromhex(params["salt"]), params["c"])
    ciphertext = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()
    if checksum.hex() != crypto["checksum"]["message"]:
        raise ValueError("keystore checksum mismatch (wrong password?)")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return _aes128ctr(dk[:16], iv, ciphertext)


# -- directory layout (ref: keystore.go StoreKeys / LoadKeys) ----------------


def store_keys(
    secrets_list: list[bytes],
    directory: str | Path,
    pubkeys: list[str] | None = None,
    start_index: int = 0,
) -> None:
    """Write keystore-N.json + keystore-N.txt password files starting at
    N = start_index (non-zero when appending validators to an existing
    dir, ref: cmd/addvalidators.go)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for i, secret in enumerate(secrets_list, start=start_index):
        password = secrets.token_hex(16)
        ks = encrypt(
            secret,
            password,
            pubkey_hex=(pubkeys[i - start_index] if pubkeys else ""),
            path=f"m/12381/3600/{i}/0/0",
        )
        (directory / f"keystore-{i}.json").write_text(json.dumps(ks, indent=2))
        # the EIP-2335 sidecar password file is the keystore format's
        # own contract (ref: keystore.go)  # lint: allow(secret-flow)
        (directory / f"keystore-{i}.txt").write_text(password)


def load_keys(directory: str | Path) -> list[bytes]:
    directory = Path(directory)
    out = []
    i = 0
    while (directory / f"keystore-{i}.json").exists():
        ks = json.loads((directory / f"keystore-{i}.json").read_text())
        password = (directory / f"keystore-{i}.txt").read_text().strip()
        out.append(decrypt(ks, password))
        i += 1
    if not out:
        raise FileNotFoundError(f"no keystores in {directory}")
    return out
