"""Minimal RLP (recursive length prefix) encode/decode.

Exactly the subset Ethereum node records need: byte strings and
(possibly nested) lists of byte strings (ref: eth2util/rlp/rlp.go —
the reference implements the same subset for the same reason).
"""

from __future__ import annotations


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    blen = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(blen)]) + blen


def encode(item) -> bytes:
    """item: bytes | int | list of items. Ints encode minimally (no
    leading zeros; 0 is the empty string, per the spec)."""
    if isinstance(item, int):
        item = (
            b""
            if item == 0
            else item.to_bytes((item.bit_length() + 7) // 8, "big")
        )
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def decode(data: bytes):
    """Decode a single RLP item (bytes or nested list of bytes)."""
    item, rest = _decode_one(data)
    if rest:
        raise ValueError("trailing bytes after RLP item")
    return item


def _decode_one(data: bytes):
    if not data:
        raise ValueError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes([b0]), data[1:]
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        _check(data, 1 + n)
        s = data[1 : 1 + n]
        if n == 1 and s[0] < 0x80:
            raise ValueError("non-canonical single byte")
        return s, data[1 + n :]
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        _check(data, 1 + ln)
        n = int.from_bytes(data[1 : 1 + ln], "big")
        if n < 56 or data[1] == 0:
            raise ValueError("non-canonical length")
        _check(data, 1 + ln + n)
        return data[1 + ln : 1 + ln + n], data[1 + ln + n :]
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        _check(data, 1 + n)
        return _decode_list(data[1 : 1 + n]), data[1 + n :]
    ln = b0 - 0xF7  # long list
    _check(data, 1 + ln)
    n = int.from_bytes(data[1 : 1 + ln], "big")
    if n < 56 or data[1] == 0:
        raise ValueError("non-canonical length")
    _check(data, 1 + ln + n)
    return _decode_list(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]


def _decode_list(payload: bytes) -> list:
    out = []
    while payload:
        item, payload = _decode_one(payload)
        out.append(item)
    return out


def _check(data: bytes, need: int) -> None:
    if len(data) < need:
        raise ValueError("truncated RLP input")
