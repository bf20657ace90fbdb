"""Threshold-BLS backend contract for the PyTorch port.

The same plugin boundary as the JAX package's `tbls` (ref:
tbls/tbls.go:28-76): one `Implementation` interface, the `TblsError`
every backend raises, and the package-level functions the node's
workflow calls, which dispatch to the implementation installed with
`set_implementation`. The port keeps its own copy so that it imports
nothing of the JAX package. Backends here:

  * python_impl — PythonImpl, the pure-Python bigint backend
                  (charon_tpu_torch/crypto), the host reference;
  * native_impl — NativeImpl, the C++ host backend (ctypes over
                  native/libcharon_native.so);
  * torch_impl  — TorchImpl, the batched PyTorch/CUDA engine
                  (charon_tpu_torch/ops) behind the batch APIs.

Wire types follow eth2 exactly (ref: tbls/tbls.go:16-25): PrivateKey is 32
bytes, PublicKey 48 bytes (compressed G1), Signature 96 bytes (compressed
G2). All byte values are ZCash-format compressed points.

The default implementation is `TorchImpl()` on the CUDA card, built on
first use; on a host without a card `get_implementation()` raises (there
is no host fallback): a CPU caller installs PythonImpl or NativeImpl
first.
"""

from __future__ import annotations

import abc
from typing import Mapping, Sequence

PRIVATE_KEY_LEN = 32
PUBLIC_KEY_LEN = 48
SIGNATURE_LEN = 96

PrivateKey = bytes
PublicKey = bytes
Signature = bytes


class TblsError(Exception):
    """Raised on malformed inputs or failed verification."""


class Implementation(abc.ABC):
    """The 11-op backend contract (ref: tbls/tbls.go:28-69) plus batch ops."""

    # -- key management ---------------------------------------------------

    @abc.abstractmethod
    def generate_secret_key(self) -> PrivateKey: ...

    @abc.abstractmethod
    def secret_to_public_key(self, secret: PrivateKey) -> PublicKey: ...

    @abc.abstractmethod
    def threshold_split(
        self, secret: PrivateKey, total: int, threshold: int
    ) -> dict[int, PrivateKey]: ...

    @abc.abstractmethod
    def recover_secret(
        self, shares: Mapping[int, PrivateKey], total: int, threshold: int
    ) -> PrivateKey: ...

    # -- signing / verification ------------------------------------------

    @abc.abstractmethod
    def sign(self, secret: PrivateKey, data: bytes) -> Signature: ...

    @abc.abstractmethod
    def verify(self, pubkey: PublicKey, data: bytes, sig: Signature) -> None:
        """Raises TblsError unless `sig` is a valid signature of `data`."""

    @abc.abstractmethod
    def verify_aggregate(
        self, pubkeys: Sequence[PublicKey], data: bytes, sig: Signature
    ) -> None:
        """FastAggregateVerify (ref: tbls/herumi.go:318)."""

    # -- aggregation ------------------------------------------------------

    @abc.abstractmethod
    def threshold_aggregate(
        self, partials: Mapping[int, Signature]
    ) -> Signature: ...

    @abc.abstractmethod
    def aggregate(self, sigs: Sequence[Signature]) -> Signature: ...

    # -- batch extensions (defaults loop; TorchImpl overrides) --------------

    def verify_batch(
        self, items: Sequence[tuple[PublicKey, bytes, Signature]]
    ) -> list[bool]:
        out = []
        for pk, data, sig in items:
            try:
                self.verify(pk, data, sig)
                out.append(True)
            except TblsError:
                out.append(False)
        return out

    def threshold_aggregate_batch(
        self, batch: Sequence[Mapping[int, Signature]]
    ) -> list[Signature]:
        return [self.threshold_aggregate(p) for p in batch]

    def aggregate_batch(
        self, groups: Sequence[Sequence[Signature]]
    ) -> list[Signature]:
        return [self.aggregate(g) for g in groups]



_current: Implementation | None = None


def set_implementation(impl: Implementation) -> None:
    """Swap the global backend (ref: tbls/tbls.go:72 SetImplementation)."""
    global _current
    _current = impl


def get_implementation() -> Implementation:
    """The installed backend; by default `TorchImpl()` on the card, which
    raises RuntimeError when CUDA is not available."""
    global _current
    if _current is None:
        from charon_tpu_torch.tbls.torch_impl import TorchImpl

        _current = TorchImpl()
    return _current


# Package-level functions, mirroring ref tbls/tbls.go's package API.


def generate_secret_key() -> PrivateKey:
    return get_implementation().generate_secret_key()


def secret_to_public_key(secret: PrivateKey) -> PublicKey:
    return get_implementation().secret_to_public_key(secret)


def threshold_split(secret: PrivateKey, total: int, threshold: int) -> dict[int, PrivateKey]:
    return get_implementation().threshold_split(secret, total, threshold)


def recover_secret(shares: Mapping[int, PrivateKey], total: int, threshold: int) -> PrivateKey:
    return get_implementation().recover_secret(shares, total, threshold)


def sign(secret: PrivateKey, data: bytes) -> Signature:
    return get_implementation().sign(secret, data)


def verify(pubkey: PublicKey, data: bytes, sig: Signature) -> None:
    get_implementation().verify(pubkey, data, sig)


def verify_aggregate(pubkeys: Sequence[PublicKey], data: bytes, sig: Signature) -> None:
    get_implementation().verify_aggregate(pubkeys, data, sig)


def threshold_aggregate(partials: Mapping[int, Signature]) -> Signature:
    return get_implementation().threshold_aggregate(partials)


def aggregate(sigs: Sequence[Signature]) -> Signature:
    return get_implementation().aggregate(sigs)


def verify_batch(items: Sequence[tuple[PublicKey, bytes, Signature]]) -> list[bool]:
    return get_implementation().verify_batch(items)


def threshold_aggregate_batch(batch: Sequence[Mapping[int, Signature]]) -> list[Signature]:
    return get_implementation().threshold_aggregate_batch(batch)


def aggregate_batch(groups: Sequence[Sequence[Signature]]) -> list[Signature]:
    return get_implementation().aggregate_batch(groups)
