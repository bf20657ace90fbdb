"""Minimal spec-exact SSZ hash-tree-root (simple serialize subset).

Implements the SSZ merkleization the duty workflow needs — uint64, byte
vectors, fixed containers, lists with limits, bitlists — exactly per the
eth2 simple-serialize spec, so signing roots computed here match any
compliant client. (The reference gets this via go-eth2-client types and a
codegen helper, ref: app/genssz; we implement the spec directly.)

Only hash_tree_root (+ its serialization helpers) is provided: the
framework's wire formats are protobuf/JSON, and SSZ is used for roots.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Any, Sequence

_ZERO_CHUNK = bytes(32)


def _sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def merkleize(chunks: Sequence[bytes], limit: int | None = None) -> bytes:
    """Merkleize 32-byte chunks, padded with zero chunks to the limit (or
    to the next power of two when no limit is given)."""
    count = len(chunks)
    size = _next_pow2(limit if limit is not None else max(count, 1))
    if limit is not None and count > limit:
        raise ValueError("chunk count exceeds limit")
    # Precompute zero-subtree hashes up the levels.
    layer = list(chunks) if chunks else [_ZERO_CHUNK]
    zero = _ZERO_CHUNK
    width = size
    while width > 1:
        if len(layer) % 2:
            layer.append(zero)
        layer = [_sha(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
        zero = _sha(zero, zero)
        width //= 2
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return _sha(root, length.to_bytes(32, "little"))


def pack_bytes(data: bytes) -> list[bytes]:
    """Right-pad bytes into 32-byte chunks."""
    if not data:
        return []
    padded = data + bytes((-len(data)) % 32)
    return [padded[i : i + 32] for i in range(0, len(padded), 32)]


# -- type descriptors --------------------------------------------------------


class SSZType:
    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError


@dataclass(frozen=True)
class Uint64(SSZType):
    def hash_tree_root(self, value: int) -> bytes:
        return int(value).to_bytes(8, "little") + bytes(24)


@dataclass(frozen=True)
class Uint256(SSZType):
    """uint256 basic type (execution-layer base_fee_per_gas)."""

    def hash_tree_root(self, value: int) -> bytes:
        return int(value).to_bytes(32, "little")


@dataclass(frozen=True)
class Boolean(SSZType):
    def hash_tree_root(self, value: bool) -> bytes:
        return bytes([1 if value else 0]) + bytes(31)


@dataclass(frozen=True)
class ByteVector(SSZType):
    length: int

    def hash_tree_root(self, value: bytes) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"expected {self.length} bytes, got {len(value)}")
        return merkleize(pack_bytes(value))


@dataclass(frozen=True)
class ByteList(SSZType):
    limit: int

    def hash_tree_root(self, value: bytes) -> bytes:
        if len(value) > self.limit:
            raise ValueError("byte list exceeds limit")
        chunk_limit = (self.limit + 31) // 32
        return mix_in_length(
            merkleize(pack_bytes(value), chunk_limit), len(value)
        )


@dataclass(frozen=True)
class Vector(SSZType):
    elem: SSZType
    length: int

    def hash_tree_root(self, value: Sequence) -> bytes:
        if len(value) != self.length:
            raise ValueError("vector length mismatch")
        return merkleize([self.elem.hash_tree_root(v) for v in value])


@dataclass(frozen=True)
class List(SSZType):
    elem: SSZType
    limit: int

    def hash_tree_root(self, value: Sequence) -> bytes:
        if isinstance(self.elem, Uint64):
            # basic-type lists pack values into chunks
            data = b"".join(int(v).to_bytes(8, "little") for v in value)
            chunk_limit = (self.limit * 8 + 31) // 32
            root = merkleize(pack_bytes(data), chunk_limit)
        else:
            root = merkleize(
                [self.elem.hash_tree_root(v) for v in value], self.limit
            )
        return mix_in_length(root, len(value))


@dataclass(frozen=True)
class Bitlist(SSZType):
    limit: int

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError("bitlist exceeds limit")
        data = _bitbytes(value, sentinel=False)
        chunk_limit = (self.limit + 255) // 256
        return mix_in_length(
            merkleize(pack_bytes(data), chunk_limit), len(value)
        )


@dataclass(frozen=True)
class Bitvector(SSZType):
    length: int

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError("bitvector length mismatch")
        return merkleize(pack_bytes(_bitbytes(value, sentinel=False)))


@dataclass(frozen=True)
class Nested(SSZType):
    """Field whose value is itself an ssz_fields-bearing dataclass.
    `cls` (optional) names the concrete container class — required by the
    generic JSON codec (eth2util/spec.py) to decode; rooting alone never
    needs it."""

    cls: type | None = None

    def hash_tree_root(self, value) -> bytes:
        return hash_tree_root(value)


@dataclass(frozen=True)
class Container(SSZType):
    field_types: tuple[SSZType, ...]

    def hash_tree_root(self, value: Sequence) -> bytes:
        if len(value) != len(self.field_types):
            raise ValueError("container field count mismatch")
        return merkleize(
            [t.hash_tree_root(v) for t, v in zip(self.field_types, value)]
        )


def hash_tree_root(obj: Any) -> bytes:
    """Root of an object whose dataclass declares `ssz_fields`: a tuple of
    SSZType descriptors aligned with its dataclass fields."""
    types = obj.ssz_fields
    values = [getattr(obj, f.name) for f in fields(obj)][: len(types)]
    return Container(tuple(types)).hash_tree_root(values)


# ---------------------------------------------------------------------------
# Full SSZ serialization (simple-serialize wire encoding)
# ---------------------------------------------------------------------------
#
# The beacon API transports consensus objects as SSZ octet-stream when the
# client asks for it (Lighthouse publishes blocks as SSZ by default in
# some configs); roots alone are not enough for that path. Offsets per
# the spec: fixed parts concatenated with 4-byte little-endian offsets
# standing in for variable-size fields, then variable parts in order.

_OFFSET_SIZE = 4


def _is_variable(t: SSZType) -> bool:
    if isinstance(t, (ByteList, List, Bitlist)):
        return True
    if isinstance(t, Vector):
        return _is_variable(t.elem)
    if isinstance(t, Nested):
        if t.cls is None:
            raise TypeError("Nested descriptor lacks cls; cannot serialize")
        return any(_is_variable(ft) for ft in t.cls.ssz_fields)
    return False


def _bitbytes(value, sentinel: bool) -> bytes:
    n = len(value)
    data = bytearray(n // 8 + 1 if sentinel else (n + 7) // 8)
    for i, bit in enumerate(value):
        if bit:
            data[i // 8] |= 1 << (i % 8)
    if sentinel:
        data[n // 8] |= 1 << (n % 8)
    return bytes(data)


def _encode(t: SSZType, v: Any) -> bytes:
    if isinstance(t, Uint64):
        return int(v).to_bytes(8, "little")
    if isinstance(t, Uint256):
        return int(v).to_bytes(32, "little")
    if isinstance(t, Boolean):
        return bytes([1 if v else 0])
    if isinstance(t, ByteVector):
        if len(v) != t.length:
            raise ValueError(f"expected {t.length} bytes, got {len(v)}")
        return bytes(v)
    if isinstance(t, ByteList):
        if len(v) > t.limit:
            raise ValueError("byte list exceeds limit")
        return bytes(v)
    if isinstance(t, Bitvector):
        if len(v) != t.length:
            raise ValueError("bitvector length mismatch")
        return _bitbytes(v, sentinel=False)
    if isinstance(t, Bitlist):
        if len(v) > t.limit:
            raise ValueError("bitlist exceeds limit")
        return _bitbytes(v, sentinel=True)
    if isinstance(t, Nested):
        return serialize(v)
    if isinstance(t, Vector):
        return _encode_sequence([t.elem] * t.length, list(v))
    if isinstance(t, List):
        if len(v) > t.limit:
            raise ValueError("list exceeds limit")
        return _encode_sequence([t.elem] * len(v), list(v))
    raise TypeError(f"no SSZ encoding for {type(t).__name__}")


def _encode_sequence(types: Sequence[SSZType], values: Sequence[Any]) -> bytes:
    if len(types) != len(values):
        raise ValueError("sequence arity mismatch")
    parts = [_encode(t, v) for t, v in zip(types, values)]
    variable = [_is_variable(t) for t in types]
    fixed_len = sum(
        _OFFSET_SIZE if var else len(p) for p, var in zip(parts, variable)
    )
    out = bytearray()
    var_offset = fixed_len
    for p, var in zip(parts, variable):
        if var:
            out += var_offset.to_bytes(_OFFSET_SIZE, "little")
            var_offset += len(p)
        else:
            out += p
    for p, var in zip(parts, variable):
        if var:
            out += p
    return bytes(out)


def serialize(obj: Any) -> bytes:
    """SSZ wire encoding of an ssz_fields-bearing container."""
    types = obj.ssz_fields
    values = [getattr(obj, f.name) for f in fields(obj)][: len(types)]
    return _encode_sequence(tuple(types), values)


def _fixed_size(t: SSZType) -> int:
    """Byte size of a FIXED-size type."""
    if isinstance(t, Uint64):
        return 8
    if isinstance(t, Uint256):
        return 32
    if isinstance(t, Boolean):
        return 1
    if isinstance(t, ByteVector):
        return t.length
    if isinstance(t, Bitvector):
        return (t.length + 7) // 8
    if isinstance(t, Vector):
        return t.length * _fixed_size(t.elem)
    if isinstance(t, Nested):
        return sum(_fixed_size(ft) for ft in t.cls.ssz_fields)
    raise TypeError(f"{type(t).__name__} is not fixed-size")


def _decode(t: SSZType, data: bytes) -> Any:
    if isinstance(t, Uint64):
        if len(data) != 8:
            raise ValueError("uint64 needs 8 bytes")
        return int.from_bytes(data, "little")
    if isinstance(t, Uint256):
        if len(data) != 32:
            raise ValueError("uint256 needs 32 bytes")
        return int.from_bytes(data, "little")
    if isinstance(t, Boolean):
        if data not in (b"\x00", b"\x01"):
            raise ValueError("invalid boolean byte")
        return data == b"\x01"
    if isinstance(t, ByteVector):
        if len(data) != t.length:
            raise ValueError("byte vector length mismatch")
        return bytes(data)
    if isinstance(t, ByteList):
        if len(data) > t.limit:
            raise ValueError("byte list exceeds limit")
        return bytes(data)
    if isinstance(t, Bitvector):
        if len(data) != (t.length + 7) // 8:
            raise ValueError("bitvector length mismatch")
        # canonical encoding: padding bits above `length` must be zero
        # (two distinct byte strings must not decode to the same value)
        if t.length % 8 and data[-1] >> (t.length % 8):
            raise ValueError("bitvector has nonzero padding bits")
        return tuple(
            bool(data[i // 8] >> (i % 8) & 1) for i in range(t.length)
        )
    if isinstance(t, Bitlist):
        if not data or data[-1] == 0:
            raise ValueError("bitlist missing delimiter bit")
        total = (len(data) - 1) * 8 + data[-1].bit_length() - 1
        if total > t.limit:
            raise ValueError("bitlist exceeds limit")
        return tuple(
            bool(data[i // 8] >> (i % 8) & 1) for i in range(total)
        )
    if isinstance(t, Nested):
        return deserialize(t.cls, data)
    if isinstance(t, Vector):
        return tuple(_decode_sequence([t.elem] * t.length, data))
    if isinstance(t, List):
        if not data:
            return ()
        if _is_variable(t.elem):
            first = int.from_bytes(data[:_OFFSET_SIZE], "little")
            # a zero first offset on non-empty data would decode
            # arbitrary garbage as an empty list — reject it
            if (
                first == 0
                or first % _OFFSET_SIZE
                or first > len(data)
            ):
                raise ValueError("malformed list offsets")
            count = first // _OFFSET_SIZE
        else:
            size = _fixed_size(t.elem)
            if len(data) % size:
                raise ValueError("list size not a multiple of element size")
            count = len(data) // size
        if count > t.limit:
            raise ValueError("list exceeds limit")
        return tuple(_decode_sequence([t.elem] * count, data))
    raise TypeError(f"no SSZ decoding for {type(t).__name__}")


def _decode_sequence(types: Sequence[SSZType], data: bytes) -> list:
    variable = [_is_variable(t) for t in types]
    fixed_sizes = [
        _OFFSET_SIZE if var else _fixed_size(t)
        for t, var in zip(types, variable)
    ]
    fixed_total = sum(fixed_sizes)
    if len(data) < fixed_total:
        raise ValueError("truncated SSZ sequence")
    if not any(variable) and len(data) != fixed_total:
        # no offsets: nothing else may follow the fixed parts
        raise ValueError("trailing bytes after fixed-size SSZ sequence")
    # first pass: slice fixed parts, collect offsets
    offsets: list[int] = []
    pos = 0
    fixed_parts: list[bytes | None] = []
    for size, var in zip(fixed_sizes, variable):
        chunk = data[pos : pos + size]
        pos += size
        if var:
            offsets.append(int.from_bytes(chunk, "little"))
            fixed_parts.append(None)
        else:
            fixed_parts.append(chunk)
    # offsets must be monotonically non-decreasing, start at the end of
    # the fixed part, and stay in bounds
    if offsets:
        if offsets[0] != fixed_total:
            raise ValueError("first offset must equal fixed-part size")
        bounds = offsets + [len(data)]
        for a, b in zip(bounds, bounds[1:]):
            if a > b or a > len(data):
                raise ValueError("malformed SSZ offsets")
    out = []
    var_idx = 0
    for t, var, part in zip(types, variable, fixed_parts):
        if var:
            start = offsets[var_idx]
            end = (
                offsets[var_idx + 1]
                if var_idx + 1 < len(offsets)
                else len(data)
            )
            var_idx += 1
            out.append(_decode(t, data[start:end]))
        else:
            out.append(_decode(t, part))
    return out


def deserialize(cls: type, data: bytes) -> Any:
    """Parse SSZ wire bytes into container `cls` (strict offsets)."""
    types = cls.ssz_fields
    flds = fields(cls)[: len(types)]
    values = _decode_sequence(tuple(types), data)
    return cls(**{f.name: v for f, v in zip(flds, values)})


BYTES32 = ByteVector(32)
BYTES48 = ByteVector(48)
BYTES96 = ByteVector(96)
UINT64 = Uint64()
