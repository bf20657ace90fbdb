"""Native C++ tbls backend (ctypes over native/libcharon_native.so).

Plays the role of the herumi backend in the reference (ref: tbls/herumi.go
wrapping C++/asm via cgo): the fast host path. Secret-key management
(keygen, Shamir split/recover) stays in Python; signing/verification/
aggregation call into C++. Batch verification fans out with OpenMP.

Build: make -C native. If the library is missing this module raises
ImportError so callers can fall back to the Python backend.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Mapping, Sequence

from charon_tpu_torch.tbls import (
    PRIVATE_KEY_LEN,
    PUBLIC_KEY_LEN,
    SIGNATURE_LEN,
    Implementation,
    TblsError,
)
from charon_tpu_torch.tbls.python_impl import PythonImpl, _check_len

# CHARON_NATIVE_LIB overrides the shared object — the sanitized test
# harness points it at libcharon_native_san.so (ASan/UBSan build) inside
# an LD_PRELOAD=libasan subprocess (tests/test_native_sanitized.py).
_LIB_PATH = Path(
    os.environ.get(
        "CHARON_NATIVE_LIB",
        Path(__file__).resolve().parent.parent.parent
        / "native"
        / "libcharon_native.so",
    )
)


def _load():
    if not _LIB_PATH.exists():
        raise ImportError(
            f"native backend not built: {_LIB_PATH} (run `make -C native`)"
        )
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.ctpu_verify.restype = ctypes.c_int
    lib.ctpu_verify.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ctpu_sign.restype = ctypes.c_int
    lib.ctpu_sign.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ctpu_sk_to_pk.restype = ctypes.c_int
    lib.ctpu_sk_to_pk.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ctpu_aggregate.restype = ctypes.c_int
    lib.ctpu_aggregate.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.ctpu_aggregate_pks.restype = ctypes.c_int
    lib.ctpu_aggregate_pks.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.ctpu_threshold_aggregate.restype = ctypes.c_int
    lib.ctpu_threshold_aggregate.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.ctpu_verify_batch.restype = ctypes.c_int
    lib.ctpu_verify_batch.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.ctpu_hash_to_g2.restype = ctypes.c_int
    lib.ctpu_hash_to_g2.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    return lib


_lib = _load()


class NativeImpl(Implementation):
    def __init__(self) -> None:
        self._host = PythonImpl()

    # secret management stays in Python (host-only, infrequent)
    def generate_secret_key(self) -> bytes:
        return self._host.generate_secret_key()

    def threshold_split(self, secret, total, threshold):
        return self._host.threshold_split(secret, total, threshold)

    def recover_secret(self, shares, total, threshold):
        return self._host.recover_secret(shares, total, threshold)

    def secret_to_public_key(self, secret: bytes) -> bytes:
        _check_len(secret, PRIVATE_KEY_LEN, "private key")
        out = ctypes.create_string_buffer(PUBLIC_KEY_LEN)
        if not _lib.ctpu_sk_to_pk(secret, out):
            raise TblsError("sk_to_pk failed")
        return out.raw

    def sign(self, secret: bytes, data: bytes) -> bytes:
        _check_len(secret, PRIVATE_KEY_LEN, "private key")
        out = ctypes.create_string_buffer(SIGNATURE_LEN)
        if not _lib.ctpu_sign(secret, data, len(data), out):
            raise TblsError("sign failed")
        return out.raw

    def verify(self, pubkey: bytes, data: bytes, sig: bytes) -> None:
        _check_len(pubkey, PUBLIC_KEY_LEN, "public key")
        _check_len(sig, SIGNATURE_LEN, "signature")
        if not _lib.ctpu_verify(pubkey, data, len(data), sig):
            raise TblsError("signature verification failed")

    def verify_aggregate(self, pubkeys: Sequence[bytes], data: bytes, sig: bytes) -> None:
        if not pubkeys:
            raise TblsError("no public keys")
        for pk in pubkeys:
            _check_len(pk, PUBLIC_KEY_LEN, "public key")
        agg = ctypes.create_string_buffer(PUBLIC_KEY_LEN)
        if not _lib.ctpu_aggregate_pks(len(pubkeys), b"".join(pubkeys), agg):
            raise TblsError("pubkey aggregation failed")
        self.verify(agg.raw, data, sig)

    def threshold_aggregate(self, partials: Mapping[int, bytes]) -> bytes:
        if not partials:
            raise TblsError("no partial signatures")
        items = sorted(partials.items())
        for i, s in items:
            if i <= 0:
                raise TblsError("share indices are 1-based")
            _check_len(s, SIGNATURE_LEN, "signature")
        idx = (ctypes.c_uint64 * len(items))(*[i for i, _ in items])
        out = ctypes.create_string_buffer(SIGNATURE_LEN)
        if not _lib.ctpu_threshold_aggregate(
            len(items), idx, b"".join(s for _, s in items), out
        ):
            raise TblsError("threshold aggregation failed")
        return out.raw

    def aggregate(self, sigs: Sequence[bytes]) -> bytes:
        if not sigs:
            raise TblsError("no signatures")
        for s in sigs:
            _check_len(s, SIGNATURE_LEN, "signature")
        out = ctypes.create_string_buffer(SIGNATURE_LEN)
        if not _lib.ctpu_aggregate(len(sigs), b"".join(sigs), out):
            raise TblsError("aggregation failed")
        return out.raw

    def verify_batch(self, items) -> list[bool]:
        if not items:
            return []
        n = len(items)
        pks = []
        sigs = []
        msgs = b""
        offsets = [0]
        ok = [True] * n
        for i, (pk, data, sig) in enumerate(items):
            if len(pk) != PUBLIC_KEY_LEN or len(sig) != SIGNATURE_LEN:
                ok[i] = False
                pk, sig = bytes(PUBLIC_KEY_LEN), bytes(SIGNATURE_LEN)
                data = b""
            pks.append(pk)
            sigs.append(sig)
            msgs += data
            offsets.append(len(msgs))
        off = (ctypes.c_uint64 * (n + 1))(*offsets)
        results = ctypes.create_string_buffer(n)
        _lib.ctpu_verify_batch(
            n, b"".join(pks), msgs, off, b"".join(sigs), results
        )
        return [o and bool(results.raw[i]) for i, o in enumerate(ok)]

    def hash_to_g2_bytes(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(SIGNATURE_LEN)
        _lib.ctpu_hash_to_g2(data, len(data), out)
        return out.raw
