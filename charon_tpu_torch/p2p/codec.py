"""Typed wire codec for the framework's frozen-dataclass messages.

The reference frames delimited protobufs over libp2p streams
(ref: p2p/sender.go protobuf framing). This framework ships TWO codecs
behind one registry:

  * **JSON** (`encode`/`decode`) — the original self-describing encoding
    of registered dataclasses: bytes as hex, enums as ints, tuples as
    lists, nested dataclasses tagged with their registered type name.
    It remains the interop fallback: peers that never negotiated the
    binary wire format (older minors) speak it exclusively.
  * **Binary v1** (`encode_binary`/`decode_binary`) — a schema-compiled
    fixed-layout encoding for the hot frame types: at
    registration time each hot dataclass gets a stable numeric wire id
    and a compiled field-order encoder/decoder, so a ParSigEx set or a
    QBFT message serializes as length-prefixed raw bytes (no hex, no
    per-frame schema introspection) in a single pass over one buffer.
    Decode walks a memoryview without intermediate object graphs —
    payload bytes slice straight out of the transport frame. Cold /
    unregistered-for-binary types (the fork-versioned spec containers
    riding inside Proposal) fall back to an embedded JSON value, so
    nothing that the JSON codec could carry is lost.

Untrusted input is decoded only into *registered* types with field
filtering (never pickle). Every malformed-input failure — bad hex in
`__b`, unknown `__e` enum names, non-list `__l`/`__d` payloads,
truncated or over-long binary frames, unknown wire ids — raises the
typed `CodecError` (a ValueError subclass), which the transport read
loop maps to drop-and-count per frame instead of letting a bare
KeyError kill a connection task.

Binary wire-id tables (`_TYPE_WIRE_IDS`, `_ENUM_WIRE_IDS`) are
APPEND-ONLY: ids and the field ORDER of hot types are frozen once
released — a newer minor may append fields (with defaults) or new ids,
never renumber. Unknown trailing fields are decoded and dropped
(values are self-describing), which is what keeps the cross-minor
window of app/version intact on the binary path too.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import struct
from typing import Any, Type

_REGISTRY: dict[str, Type] = {}


class CodecError(ValueError):
    """Malformed wire input (either codec). Subclasses ValueError so
    pre-existing callers that caught ValueError keep working; the
    transport read loop catches THIS to drop-and-count per frame."""


# ---------------------------------------------------------------------------
# Binary wire ids — stable, append-only (see module docstring)
# ---------------------------------------------------------------------------

_TYPE_WIRE_IDS: dict[str, int] = {
    "Duty": 1,
    "SignedData": 2,
    "ParSignedData": 3,
    "Checkpoint": 4,
    "AttestationData": 5,
    "Attestation": 6,
    "BeaconBlockHeader": 7,
    "Proposal": 8,
    "AggregateAndProof": 9,
    "SyncCommitteeMessage": 10,
    "SyncCommitteeContribution": 11,
    "ContributionAndProof": 12,
    "ValidatorRegistration": 13,
    "VoluntaryExit": 14,
    "AttestationDuty": 15,
    "SyncSelectionData": 16,
    "SyncMessageDuty": 17,
    "Msg": 18,  # qbft.Msg
    "PriorityMsg": 19,
    "TopicResult": 20,
    # remote crypto-plane RPC frames (core/cryptosvc_wire) — appended,
    # never renumbered, like everything above
    "CryptoChallenge": 21,
    "CryptoHello": 22,
    "CryptoHelloAck": 23,
    "CryptoSubmit": 24,
    "CryptoResult": 25,
    "CryptoShed": 26,
    "CryptoHeartbeat": 27,
}

_ENUM_WIRE_IDS: dict[str, int] = {
    "DutyType": 1,
    "MsgType": 2,
}

# single-byte ids keep the encoder's header writes branch-free; 127
# hot types is plenty (cold types ride the JSON-fallback tag)
assert all(
    0 < i < 0x80
    for i in (*_TYPE_WIRE_IDS.values(), *_ENUM_WIRE_IDS.values())
)

# value tags (binary v1)
_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_DICT = 0x08
_T_ENUM = 0x09
_T_DATACLASS = 0x0A
_T_JSON = 0x0B  # cold-type fallback: embedded JSON value
_T_BOOLS = 0x0C  # homogeneous bool sequence as a packed bitmap
# (aggregation bitlists dominate attestation frames: 64 tagged values
# become 8 bytes and ONE decode dispatch)

# envelope markers (first byte of a transport frame body). JSON frames
# start with "{" (0x7B) — anything else must match a known version byte,
# which is how mixed-version interop stays sniffable per frame.
BINARY_V1 = 0x01

_PACK_F64 = struct.Struct(">d")
_VARINT_MAX = (1 << 1031) - 1  # decode loops stop at shift > 1024


@dataclasses.dataclass(frozen=True)
class _Schema:
    """Compiled binary layout of one registered dataclass."""

    cls: Type
    wire_id: int | None  # None = cold type (JSON fallback on the wire)
    field_names: tuple[str, ...]
    n_required: int  # leading fields without declared defaults
    getter: Any  # operator.attrgetter over field_names (C-speed reads)
    # trailing defaulted fields as (value, is_factory), aligned with
    # field_names[n_required:] — decode fills omitted tails from here
    defaults: tuple
    # True when construction may bypass __init__ (object.__new__ +
    # direct __dict__ fill): plain frozen dataclasses burn an
    # object.__setattr__ per field in __init__, which would otherwise
    # dominate hot-frame decode. Classes with __post_init__ or __slots__
    # take the normal constructor.
    fast_new: bool


_OBJ_NEW = object.__new__

_SCHEMAS: dict[str, _Schema] = {}
_WIRE_SCHEMAS: dict[int, _Schema] = {}
_WIRE_ENUMS: dict[int, Type] = {}
# encode dispatch: concrete type -> encoder fn, extended at register time
_ENC_DISPATCH: dict[type, Any] = {}


def _compile_schema(cls: Type) -> _Schema:
    import operator

    flds = dataclasses.fields(cls)
    names = tuple(f.name for f in flds)
    n_required = 0
    for f in flds:
        if (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ):
            n_required += 1
        else:
            break
    getter = operator.attrgetter(*names) if len(names) > 1 else (
        operator.attrgetter(names[0]) if names else None
    )
    defaults = tuple(
        (f.default_factory, True)
        if f.default_factory is not dataclasses.MISSING
        else (f.default, False)
        for f in flds[n_required:]
    )
    schema = _Schema(
        cls=cls,
        wire_id=_TYPE_WIRE_IDS.get(cls.__name__),
        field_names=names,
        n_required=n_required,
        getter=getter,
        defaults=defaults,
        fast_new=(
            getattr(cls, "__post_init__", None) is None
            and "__slots__" not in cls.__dict__
        ),
    )
    return schema


def register(cls: Type) -> Type:
    """Register a dataclass for wire transport (decorator-friendly).
    Hot types (those with a stable wire id) get their binary layout
    compiled here, once, instead of introspected per frame."""
    _REGISTRY[cls.__name__] = cls
    schema = _compile_schema(cls)
    _SCHEMAS[cls.__name__] = schema
    if schema.wire_id is not None:
        _WIRE_SCHEMAS[schema.wire_id] = schema
        _ENC_DISPATCH[cls] = _make_dataclass_encoder(schema)
    else:
        _ENC_DISPATCH[cls] = _enc_dataclass
    return cls


_ENUMS: dict[str, Type] = {}


def register_enum(cls: Type) -> Type:
    _ENUMS[cls.__name__] = cls
    wire_id = _ENUM_WIRE_IDS.get(cls.__name__)
    if wire_id is not None:
        _WIRE_ENUMS[wire_id] = cls
        _ENC_DISPATCH[cls] = _make_enum_encoder(wire_id)
    else:
        _ENC_DISPATCH[cls] = _enc_enum
    return cls


def _make_enum_encoder(wire_id: int):
    """Compiled hot-enum encoder: header precomputed, int values
    (IntEnum — every hot enum) emitted inline."""
    header = bytes([_T_ENUM, wire_id])

    def enc(buf: bytearray, v) -> None:
        buf += header
        x = v.value
        if type(x) is int:
            buf.append(_T_INT)
            z = x << 1 if x >= 0 else ((-x) << 1) - 1
            if z < 0x80:
                buf.append(z)
            else:
                _enc_varint(buf, z)
        else:
            _enc_value(buf, x)

    return enc


# ---------------------------------------------------------------------------
# JSON codec (interop fallback + cold-type carrier)
# ---------------------------------------------------------------------------


def _to_jsonable(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name not in _REGISTRY:
            raise TypeError(f"unregistered dataclass {name}")
        out = {"__t": name}
        for f in dataclasses.fields(v):
            out[f.name] = _to_jsonable(getattr(v, f.name))
        return out
    if isinstance(v, enum.Enum):
        return {"__e": type(v).__name__, "v": v.value}
    if isinstance(v, bytes):
        return {"__b": v.hex()}
    if isinstance(v, (tuple, list)):
        return {"__l": [_to_jsonable(x) for x in v]}
    if isinstance(v, dict):
        return {"__d": [[_to_jsonable(k), _to_jsonable(x)] for k, x in v.items()]}
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    raise TypeError(f"cannot encode {type(v)}")


def _from_jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if "__t" in v:
            cls = _REGISTRY.get(v["__t"])
            if cls is None:
                raise CodecError(f"unknown wire type {v['__t']}")
            # protonil-equivalent guard (ref: app/protonil): REQUIRED
            # fields (those without declared defaults) must be present on
            # the wire — a peer cannot smuggle zero values by omission.
            # Fields with defaults are explicit opt-ins to omissibility,
            # which is what lets a newer minor add fields without
            # breaking the cross-minor window app/version promises.
            missing = [
                f.name
                for f in dataclasses.fields(cls)
                if f.name not in v
                and f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ]
            if missing:
                raise CodecError(
                    f"wire message {v['__t']} missing fields {missing}"
                )
            kwargs = {
                f.name: _from_jsonable(v[f.name])
                for f in dataclasses.fields(cls)
                if f.name in v
            }
            try:
                return cls(**kwargs)
            except (TypeError, ValueError) as e:
                raise CodecError(
                    f"cannot construct wire message {v['__t']}: {e}"
                ) from e
        if "__e" in v:
            cls = _ENUMS.get(v["__e"])
            if cls is None:
                raise CodecError(f"unknown enum {v['__e']}")
            try:
                return cls(v["v"])
            except (ValueError, KeyError, TypeError) as e:
                raise CodecError(f"bad enum value for {v['__e']}") from e
        if "__b" in v:
            try:
                return bytes.fromhex(v["__b"])
            except (ValueError, TypeError) as e:
                raise CodecError("malformed hex in __b payload") from e
        if "__l" in v:
            if not isinstance(v["__l"], list):
                raise CodecError("__l payload must be a list")
            return tuple(_from_jsonable(x) for x in v["__l"])
        if "__d" in v:
            if not isinstance(v["__d"], list):
                raise CodecError("__d payload must be a list of pairs")
            try:
                return {
                    _from_jsonable(k): _from_jsonable(x) for k, x in v["__d"]
                }
            except CodecError:
                raise
            except (ValueError, TypeError) as e:
                raise CodecError("malformed __d pair list") from e
    return v


def encode(msg: Any) -> bytes:
    return json.dumps(_to_jsonable(msg), separators=(",", ":")).encode()


def decode(data: bytes) -> Any:
    """Strict JSON decode: ANY malformed input raises CodecError."""
    try:
        obj = json.loads(bytes(data).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CodecError(f"malformed JSON frame: {e}") from e
    try:
        return _from_jsonable(obj)
    except CodecError:
        raise
    except (ValueError, KeyError, TypeError, RecursionError) as e:
        raise CodecError(f"malformed wire payload: {type(e).__name__}: {e}") from e


def decode_value(obj: Any) -> Any:
    """Strict decode of an already-parsed jsonable payload (the JSON
    envelope's `d` field) — same CodecError mapping as decode()."""
    try:
        return _from_jsonable(obj)
    except CodecError:
        raise
    except (ValueError, KeyError, TypeError, RecursionError) as e:
        raise CodecError(f"malformed wire payload: {type(e).__name__}: {e}") from e


# ---------------------------------------------------------------------------
# Binary codec v1 — encode
# ---------------------------------------------------------------------------


def _enc_varint(buf: bytearray, n: int) -> None:
    """Unsigned LEB128. Capped at the decoders' 1024-bit limit — an
    int no peer can decode must fail at ENCODE time (loud TypeError at
    the sender), not as a silent drop on every receiver."""
    if n > _VARINT_MAX:
        raise TypeError("int exceeds the 1024-bit wire limit")
    while n > 0x7F:
        buf.append((n & 0x7F) | 0x80)
        n >>= 7
    buf.append(n)


def _enc_none(buf: bytearray, v) -> None:
    buf.append(_T_NONE)


def _enc_bool(buf: bytearray, v) -> None:
    buf.append(_T_TRUE if v else _T_FALSE)


def _enc_int(buf: bytearray, v) -> None:
    # zigzag so negatives stay short; arbitrary precision on purpose
    # (uint256 base fees ride spec containers through here)
    buf.append(_T_INT)
    _enc_varint(buf, v << 1 if v >= 0 else ((-v) << 1) - 1)


def _enc_float(buf: bytearray, v) -> None:
    buf.append(_T_FLOAT)
    buf += _PACK_F64.pack(v)


def _enc_str(buf: bytearray, v) -> None:
    raw = v.encode()
    buf.append(_T_STR)
    _enc_varint(buf, len(raw))
    buf += raw


def _enc_bytes(buf: bytearray, v) -> None:
    buf.append(_T_BYTES)
    _enc_varint(buf, len(v))
    buf += v


# byte <-> 8 bools (LSB first): _T_BOOLS packs/expands bitmaps via
# these tables so both directions run at C speed (dict/tuple lookups
# per 8 bits, never a Python loop per bit)
_BYTE_BITS = tuple(
    tuple(bool(b >> i & 1) for i in range(8)) for b in range(256)
)
_BITS_BYTE = {bits: byte for byte, bits in enumerate(_BYTE_BITS)}


def _enc_seq(buf: bytearray, v) -> None:
    n = len(v)
    if n >= 8 and set(map(type, v)) == {bool}:
        # bitlist fast path: LSB-first bitmap (SSZ-style, no sentinel)
        buf.append(_T_BOOLS)
        _enc_varint(buf, n)
        t = tuple(v)
        full = n & ~7
        buf += bytes(
            _BITS_BYTE[t[i : i + 8]] for i in range(0, full, 8)
        )
        if n > full:
            byte = 0
            for i in range(full, n):
                if t[i]:
                    byte |= 1 << (i & 7)
            buf.append(byte)
        return
    buf.append(_T_LIST)
    _enc_varint(buf, n)
    for x in v:
        _enc_value(buf, x)


def _enc_dict(buf: bytearray, v) -> None:
    buf.append(_T_DICT)
    _enc_varint(buf, len(v))
    for k, x in v.items():
        _enc_value(buf, k)
        _enc_value(buf, x)


def _enc_enum(buf: bytearray, v) -> None:
    wire_id = _ENUM_WIRE_IDS.get(type(v).__name__)
    if wire_id is None:
        _enc_json_fallback(buf, v)
        return
    buf.append(_T_ENUM)
    _enc_varint(buf, wire_id)
    _enc_value(buf, v.value)


def _enc_dataclass(buf: bytearray, v) -> None:
    schema = _SCHEMAS.get(type(v).__name__)
    if schema is None or schema.wire_id is None:
        # cold / unregistered-for-binary: embed the JSON encoding (raises
        # TypeError for genuinely unregistered types, same as encode())
        _enc_json_fallback(buf, v)
        return
    # wire ids and field counts are small: single-byte varints inline
    buf.append(_T_DATACLASS)
    buf.append(schema.wire_id)  # table ids are < 0x80 by construction
    names = schema.field_names
    n = len(names)
    if n >= 0x80:
        _enc_varint(buf, n)
    else:
        buf.append(n)
    if n == 1:
        _enc_value(buf, schema.getter(v))
        return
    for x in schema.getter(v):  # attrgetter: one C call for all fields
        _enc_value(buf, x)


def _enc_json_fallback(buf: bytearray, v) -> None:
    raw = json.dumps(_to_jsonable(v), separators=(",", ":")).encode()
    buf.append(_T_JSON)
    _enc_varint(buf, len(raw))
    buf += raw


def _make_dataclass_encoder(schema: _Schema):
    """Compile a hot type's encoder once at registration: header bytes
    precomputed, fields read in one attrgetter call, annotation-typed
    scalar fields emitted inline (type-checked per value — a field
    holding something else falls back to the generic tagged encoder,
    so the wire stays self-describing)."""
    names = schema.field_names
    if not names or len(names) >= 0x80:
        return _enc_dataclass
    header = bytes([_T_DATACLASS, schema.wire_id, len(names)])
    getter = schema.getter
    single = len(names) == 1
    wire_id = schema.wire_id

    def enc(buf: bytearray, v) -> None:
        buf += header
        prog = _PROGS.get(wire_id)
        if prog is None:
            prog = _build_prog(wire_id, schema)
        vals = (getter(v),) if single else getter(v)
        for (kind, _name), x in zip(prog, vals):
            if kind == K_INT and type(x) is int:
                buf.append(_T_INT)
                z = x << 1 if x >= 0 else ((-x) << 1) - 1
                if z < 0x80:
                    buf.append(z)
                else:
                    _enc_varint(buf, z)
            elif kind == K_BYTES and type(x) is bytes:
                buf.append(_T_BYTES)
                n = len(x)
                if n < 0x80:
                    buf.append(n)
                else:
                    _enc_varint(buf, n)
                buf += x
            elif kind == K_STR and type(x) is str:
                raw = x.encode()
                buf.append(_T_STR)
                n = len(raw)
                if n < 0x80:
                    buf.append(n)
                else:
                    _enc_varint(buf, n)
                buf += raw
            else:
                _enc_value(buf, x)

    return enc


_ENC_DISPATCH.update(
    {
        type(None): _enc_none,
        bool: _enc_bool,
        int: _enc_int,
        float: _enc_float,
        str: _enc_str,
        bytes: _enc_bytes,
        tuple: _enc_seq,
        list: _enc_seq,
        dict: _enc_dict,
    }
)


def _enc_value(buf: bytearray, v) -> None:
    # inline hot scalar paths (ints/bytes/strs dominate hot frames);
    # everything else goes through the per-type dispatch table
    t = v.__class__
    if t is int:
        buf.append(_T_INT)
        z = v << 1 if v >= 0 else ((-v) << 1) - 1
        if z < 0x80:
            buf.append(z)
        else:
            _enc_varint(buf, z)
        return
    if t is bytes:
        buf.append(_T_BYTES)
        n = len(v)
        if n < 0x80:
            buf.append(n)
        else:
            _enc_varint(buf, n)
        buf += v
        return
    if t is str:
        raw = v.encode()
        buf.append(_T_STR)
        n = len(raw)
        if n < 0x80:
            buf.append(n)
        else:
            _enc_varint(buf, n)
        buf += raw
        return
    fn = _ENC_DISPATCH.get(t)
    if fn is not None:
        fn(buf, v)
        return
    # subclass / first-seen-type slow path; the resolution is cached so
    # e.g. PubKey (a str NewType at runtime: plain str) or a memoryview
    # costs the isinstance chain exactly once per type
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        fn = _enc_dataclass
    elif isinstance(v, enum.Enum):
        fn = _enc_enum
    elif isinstance(v, bool):
        fn = _enc_bool
    elif isinstance(v, int):
        fn = _enc_int
    elif isinstance(v, float):
        fn = _enc_float
    elif isinstance(v, str):
        fn = _enc_str
    elif isinstance(v, (bytes, bytearray, memoryview)):
        fn = _enc_bytes
    elif isinstance(v, (tuple, list)):
        fn = _enc_seq
    elif isinstance(v, dict):
        fn = _enc_dict
    elif v is None:
        fn = _enc_none
    else:
        raise TypeError(f"cannot encode {type(v)}")
    _ENC_DISPATCH[v.__class__] = fn
    fn(buf, v)


def encode_binary(msg: Any) -> bytes:
    """Binary v1 encoding of a message (no envelope marker — the
    transport prepends its version byte)."""
    buf = bytearray()
    _enc_value(buf, msg)
    return bytes(buf)


# ---------------------------------------------------------------------------
# Binary codec v1 — decode (memoryview walk, bounds-checked throughout)
# ---------------------------------------------------------------------------


def _dec_varint(mv, pos: int, end: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = mv[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        # generous cap: zigzag uint256 values (spec containers) fit in
        # 257 bits; anything past 1024 bits is a malformed frame
        if shift > 1024:
            raise CodecError("oversized varint")


# -- compiled field programs (decode side) ----------------------------------
#
# At first decode of a wire id, the schema's field ANNOTATIONS compile
# to a per-field kind program: (K_INT, K_BYTES, K_STR, K_NESTED schema,
# K_ENUM cls, K_GENERIC). The hot decode loop then PREDICTS each
# field's tag instead of walking the generic tag chain — a mispredicted
# tag (schema evolution, union-typed fields) simply falls back to the
# generic decoder, so the wire format stays fully self-describing.

K_GENERIC, K_INT, K_BYTES, K_STR, K_NESTED, K_ENUM = range(6)

_PROGS: dict[int, tuple] = {}


def _build_prog(wire_id: int, schema: _Schema) -> tuple:
    """(kind, field_name) per field — the decode loop writes
    values straight into the instance __dict__ by name, so there is no
    args list, no zip, no per-field append."""
    flds = dataclasses.fields(schema.cls)
    prog = []
    for f in flds:
        t = f.type if isinstance(f.type, str) else getattr(
            f.type, "__name__", ""
        )
        if t == "int":
            kind = K_INT
        elif t == "bytes":
            kind = K_BYTES
        elif t == "str":
            kind = K_STR
        elif t in _TYPE_WIRE_IDS and t in _SCHEMAS:
            kind = K_NESTED
        elif t in _ENUM_WIRE_IDS and t in _ENUMS:
            kind = K_ENUM
        else:
            kind = K_GENERIC
        prog.append((kind, f.name))
    out = tuple(prog)
    _PROGS[wire_id] = out
    return out


def _dec_many(
    mv,
    pos: int,
    end: int,
    depth: int,
    count: int,
    # hot-loop locals: globals are dict lookups per access in CPython;
    # default-arg binding makes every tag compare an array load
    _int=_T_INT,
    _bytes_t=_T_BYTES,
    _str_t=_T_STR,
    _none=_T_NONE,
    _true=_T_TRUE,
    _false=_T_FALSE,
    _varint=None,
    _bytes=bytes,
) -> tuple:
    """Decode `count` consecutive values into a list. The scalar tags
    (ints, byte blobs, strings, the singletons) that carry nearly every
    value of a hot frame are handled INLINE in this one loop — a
    ParSigEx set decodes with one Python call per CONTAINER, not one
    per value, which is where the 5x over json.loads+_from_jsonable
    comes from on the decode side."""
    out: list = []
    append = out.append
    while count:
        count -= 1
        tag = mv[pos]
        pos += 1
        if tag == _int:
            z = 0
            shift = 0
            while True:
                if pos >= end:
                    raise CodecError("truncated varint")
                b = mv[pos]
                pos += 1
                z |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
                if shift > 1024:
                    raise CodecError("oversized varint")
            append((z >> 1) ^ -(z & 1))
        elif tag == _bytes_t:
            if pos < end and mv[pos] < 0x80:
                n = mv[pos]
                pos += 1
            else:
                n, pos = _dec_varint(mv, pos, end)
            if pos + n > end:
                raise CodecError("truncated bytes")
            # the ONE copy: frame buffer -> final object
            append(mv[pos : pos + n])
            pos += n
        elif tag == _str_t:
            if pos < end and mv[pos] < 0x80:
                n = mv[pos]
                pos += 1
            else:
                n, pos = _dec_varint(mv, pos, end)
            if pos + n > end:
                raise CodecError("truncated string")
            try:
                append(mv[pos : pos + n].decode())
            except UnicodeDecodeError as e:
                raise CodecError("malformed utf-8 string") from e
            pos += n
        elif tag == _none:
            append(None)
        elif tag == _true:
            append(True)
        elif tag == _false:
            append(False)
        else:
            v, pos = _dec_tagged(mv, pos, end, depth, tag)
            append(v)
    return out, pos


def _dec_value(
    mv,
    pos: int,
    end: int,
    depth: int = 0,
    _int=_T_INT,
    _bytes_t=_T_BYTES,
    _str_t=_T_STR,
    _none=_T_NONE,
    _true=_T_TRUE,
    _false=_T_FALSE,
    _bytes=bytes,
):
    """Decode ONE value: inline scalars (the same fast paths as
    _dec_many, duplicated on purpose — a wrapper call per scalar value
    is exactly the overhead this codec exists to remove), containers
    via _dec_tagged."""
    tag = mv[pos]
    pos += 1
    if tag == _int:
        z = 0
        shift = 0
        while True:
            b = mv[pos]
            pos += 1
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 1024:
                raise CodecError("oversized varint")
        return (z >> 1) ^ -(z & 1), pos
    if tag == _bytes_t:
        if pos < end and mv[pos] < 0x80:
            n = mv[pos]
            pos += 1
        else:
            n, pos = _dec_varint(mv, pos, end)
        if pos + n > end:
            raise CodecError("truncated bytes")
        return mv[pos : pos + n], pos + n
    if tag == _str_t:
        if pos < end and mv[pos] < 0x80:
            n = mv[pos]
            pos += 1
        else:
            n, pos = _dec_varint(mv, pos, end)
        if pos + n > end:
            raise CodecError("truncated string")
        try:
            return mv[pos : pos + n].decode(), pos + n
        except UnicodeDecodeError as e:
            raise CodecError("malformed utf-8 string") from e
    if tag == _none:
        return None, pos
    if tag == _true:
        return True, pos
    if tag == _false:
        return False, pos
    return _dec_tagged(mv, pos, end, depth, tag)


def _dec_tagged(
    mv,
    pos: int,
    end: int,
    depth: int,
    tag: int,
    _k_int=K_INT,
    _k_bytes=K_BYTES,
    _k_str=K_STR,
    _k_nested=K_NESTED,
    _k_enum=K_ENUM,
    _k_generic=K_GENERIC,
    _t_int=_T_INT,
    _t_bytes=_T_BYTES,
    _t_str=_T_STR,
    _t_list=_T_LIST,
    _t_dataclass=_T_DATACLASS,
    _t_enum_t=_T_ENUM,
    _bytes=bytes,
):
    """Container / rare tags (the scalar tags live in _dec_many)."""
    if depth > 32:
        raise CodecError("binary payload nests too deep")
    if tag == _t_dataclass:
        # header ints are single-byte in practice (ids < 0x80, small
        # field counts): inline the fast path, fall back for the rest
        if pos < end and mv[pos] < 0x80:
            wire_id = mv[pos]
            pos += 1
        else:
            wire_id, pos = _dec_varint(mv, pos, end)
        schema = _WIRE_SCHEMAS.get(wire_id)
        if schema is None:
            raise CodecError(f"unknown dataclass wire id {wire_id}")
        if pos < end and mv[pos] < 0x80:
            nfields = mv[pos]
            pos += 1
        else:
            nfields, pos = _dec_varint(mv, pos, end)
        if nfields > end - pos:
            raise CodecError("field count exceeds frame")
        names = schema.field_names
        if nfields < schema.n_required:
            raise CodecError(
                f"wire message {schema.cls.__name__} missing fields "
                f"{list(names[nfields:schema.n_required])}"
            )
        prog = _PROGS.get(wire_id)
        if prog is None:
            prog = _build_prog(wire_id, schema)
        n_prog = len(prog)
        d: dict = {}
        depth1 = depth + 1
        extra = 0
        if nfields == n_prog:
            kinds = prog  # exact schema match: no per-field bounds
        elif nfields < n_prog:
            kinds = prog[:nfields]
        else:
            kinds = prog
            extra = nfields - n_prog
        for kind, name in kinds:
            vtag = mv[pos]
            if kind == _k_int and vtag == _t_int:
                pos += 1
                z = 0
                shift = 0
                while True:
                    b = mv[pos]
                    pos += 1
                    z |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                    if shift > 1024:
                        raise CodecError("oversized varint")
                d[name] = (z >> 1) ^ -(z & 1)
            elif kind == _k_bytes and vtag == _t_bytes:
                pos += 1
                if pos < end and mv[pos] < 0x80:
                    n = mv[pos]
                    pos += 1
                else:
                    n, pos = _dec_varint(mv, pos, end)
                if pos + n > end:
                    raise CodecError("truncated bytes")
                d[name] = mv[pos : pos + n]
                pos += n
            elif kind == _k_str and vtag == _t_str:
                pos += 1
                if pos < end and mv[pos] < 0x80:
                    n = mv[pos]
                    pos += 1
                else:
                    n, pos = _dec_varint(mv, pos, end)
                if pos + n > end:
                    raise CodecError("truncated string")
                try:
                    d[name] = mv[pos : pos + n].decode()
                except UnicodeDecodeError as e:
                    raise CodecError("malformed utf-8 string") from e
                pos += n
            elif (kind == _k_nested and vtag == _t_dataclass) or (
                kind == _k_enum and vtag == _t_enum_t
            ) or vtag >= _t_list:
                # containers (predicted or not) skip the scalar chain
                d[name], pos = _dec_tagged(mv, pos + 1, end, depth1, vtag)
            else:
                # mispredicted / generic / evolved field: self-describing
                d[name], pos = _dec_value(mv, pos, end, depth1)
        for _ in range(extra):
            # trailing unknown fields (newer minor): decoded and dropped
            _v, pos = _dec_value(mv, pos, end, depth1)
        if schema.fast_new:
            if nfields < n_prog:
                for name, (dv, isf) in zip(
                    names[nfields:],
                    schema.defaults[nfields - schema.n_required :],
                ):
                    d[name] = dv() if isf else dv
            obj = _OBJ_NEW(schema.cls)
            # one C-level bulk fill (plain `__dict__ = d` would trip the
            # frozen dataclass __setattr__ guard)
            obj.__dict__.update(d)
            return obj, pos
        try:
            # omitted defaulted tails fill from the class defaults
            return schema.cls(**d), pos
        except (TypeError, ValueError) as e:
            raise CodecError(
                f"cannot construct wire message {schema.cls.__name__}: {e}"
            ) from e
    if tag == _T_BOOLS:
        if pos < end and mv[pos] < 0x80:
            n = mv[pos]
            pos += 1
        else:
            n, pos = _dec_varint(mv, pos, end)
        nbytes = (n + 7) // 8
        if pos + nbytes > end:
            raise CodecError("truncated bool bitmap")
        bits: list = []
        extend = bits.extend
        table = _BYTE_BITS
        for i in range(pos, pos + nbytes):
            extend(table[mv[i]])
        return tuple(bits[:n]), pos + nbytes
    if tag == _T_LIST:
        if pos < end and mv[pos] < 0x80:
            n = mv[pos]
            pos += 1
        else:
            n, pos = _dec_varint(mv, pos, end)
        if n > end - pos:
            raise CodecError("list count exceeds frame")
        out, pos = _dec_many(mv, pos, end, depth + 1, n)
        return tuple(out), pos
    if tag == _T_DICT:
        if pos < end and mv[pos] < 0x80:
            n = mv[pos]
            pos += 1
        else:
            n, pos = _dec_varint(mv, pos, end)
        if 2 * n > end - pos:
            raise CodecError("dict count exceeds frame")
        flat, pos = _dec_many(mv, pos, end, depth + 1, 2 * n)
        try:
            return dict(zip(flat[0::2], flat[1::2])), pos
        except TypeError as e:
            raise CodecError("unhashable dict key") from e
    if tag == _T_ENUM:
        wire_id, pos = _dec_varint(mv, pos, end)
        cls = _WIRE_ENUMS.get(wire_id)
        if cls is None:
            raise CodecError(f"unknown enum wire id {wire_id}")
        raw, pos = _dec_value(mv, pos, end, depth + 1)
        try:
            # direct member-map lookup: EnumMeta.__call__ costs ~15x
            # more and this runs per enum field of every hot frame
            return cls._value2member_map_[raw], pos
        except (KeyError, TypeError):
            pass
        try:
            return cls(raw), pos  # non-canonical values (aliases)
        except (ValueError, KeyError, TypeError) as e:
            raise CodecError(f"bad enum value for {cls.__name__}") from e
    if tag == _T_FLOAT:
        if pos + 8 > end:
            raise CodecError("truncated float")
        return _PACK_F64.unpack_from(mv, pos)[0], pos + 8
    if tag == _T_JSON:
        n, pos = _dec_varint(mv, pos, end)
        if pos + n > end:
            raise CodecError("truncated embedded JSON")
        try:
            obj = json.loads(mv[pos : pos + n])
        except (ValueError, UnicodeDecodeError) as e:
            raise CodecError("malformed embedded JSON") from e
        return decode_value(obj), pos + n
    raise CodecError(f"unknown binary tag 0x{tag:02x}")


def decode_binary(data) -> Any:
    """Binary v1 decode of one value. Accepts bytes or any buffer.
    Decodes IN PLACE over the frame buffer (offsets, no intermediate
    object graph; the one copy per bytes field is the slice into the
    final object). Raises CodecError on any malformation, including
    trailing garbage."""
    if not isinstance(data, bytes):
        data = bytes(data)
    try:
        v, pos = _dec_value(data, 0, len(data))
    except IndexError:
        # single-byte reads rely on the buffer's own bounds (slice
        # reads keep explicit guards — slices never raise)
        raise CodecError("truncated binary value") from None
    if pos != len(data):
        raise CodecError("trailing bytes after binary value")
    return v


# ---------------------------------------------------------------------------
# Transport envelope (both codecs behind one surface)
# ---------------------------------------------------------------------------
#
# JSON envelope (wire version 0):   {"p": .., "id": .., "k": "req"|"rsp",
#                                    "d": jsonable payload | null}
# Binary envelope (wire version 1): 0x01 | varint len + protocol utf8
#                                   | varint len + request id utf8
#                                   | kind byte (0 req, 1 rsp)
#                                   | binary value (payload; _T_NONE tag
#                                     for an empty payload)
#
# The first byte discriminates: JSON frames start with "{" (0x7B), a
# binary v1 frame with 0x01 — so a receiver never needs per-connection
# state to parse a frame, only to choose what it SENDS (negotiated in
# the p2p handshake; see transport._Conn.wire).


def encode_envelope(
    protocol: str, req_id: str, kind: str, msg: Any, binary: bool
) -> bytes:
    if not binary:
        return json.dumps(
            {
                "p": protocol,
                "id": req_id,
                "k": kind,
                "d": _to_jsonable(msg) if msg is not None else None,
            }
        ).encode()
    buf = bytearray([BINARY_V1])
    raw_p = protocol.encode()
    _enc_varint(buf, len(raw_p))
    buf += raw_p
    # a peer's envelope may carry no request id (fire-and-forget JSON
    # frames omit it) — the response encoder must not crash on None
    raw_id = req_id.encode() if isinstance(req_id, str) else b""
    _enc_varint(buf, len(raw_id))
    buf += raw_id
    buf.append(1 if kind == "rsp" else 0)
    _enc_value(buf, msg)
    return bytes(buf)


def decode_envelope(frame) -> dict:
    """One decrypted transport frame -> {"p", "id", "k", "d"} with the
    payload fully decoded. Sniffs the leading byte: JSON vs binary v1.
    Raises CodecError on any malformation."""
    if not isinstance(frame, bytes):
        frame = bytes(frame)
    if not frame:
        raise CodecError("empty frame")
    mv = frame
    lead = mv[0]
    if lead == BINARY_V1:
        end = len(mv)
        try:
            n, pos = _dec_varint(mv, 1, end)
            if pos + n > end:
                raise CodecError("truncated envelope protocol")
            try:
                protocol = mv[pos : pos + n].decode()
            except UnicodeDecodeError as e:
                raise CodecError("malformed envelope protocol") from e
            pos += n
            n, pos = _dec_varint(mv, pos, end)
            if pos + n > end:
                raise CodecError("truncated envelope request id")
            try:
                req_id = mv[pos : pos + n].decode()
            except UnicodeDecodeError as e:
                raise CodecError("malformed envelope request id") from e
            pos += n
            if pos >= end:
                raise CodecError("truncated envelope kind")
            kind = "rsp" if mv[pos] else "req"
            pos += 1
            payload, pos = _dec_value(mv, pos, end)
        except IndexError:
            raise CodecError("truncated binary envelope") from None
        if pos != end:
            raise CodecError("trailing bytes after envelope payload")
        return {"p": protocol, "id": req_id, "k": kind, "d": payload}
    if lead != 0x7B:  # "{"
        raise CodecError(f"unknown envelope version byte 0x{lead:02x}")
    try:
        env = json.loads(frame)
    except (ValueError, UnicodeDecodeError) as e:
        raise CodecError(f"malformed JSON envelope: {e}") from e
    if not isinstance(env, dict) or "p" not in env or "k" not in env:
        raise CodecError("JSON envelope missing required keys")
    return {
        "p": env["p"],
        "id": env.get("id"),
        "k": env["k"],
        "d": (
            decode_value(env["d"]) if env.get("d") is not None else None
        ),
    }


def _register_core_types() -> None:
    from charon_tpu_torch.core import eth2data as d
    from charon_tpu_torch.core import qbft
    from charon_tpu_torch.core.types import Duty, DutyType
    from charon_tpu_torch.eth2util import spec

    # fork-versioned spec containers ride inside Proposal values during
    # proposer consensus (ref: corepb carries the full VersionedProposal)
    for cls in (
        spec.Eth1Data,
        spec.SignedBeaconBlockHeader,
        spec.ProposerSlashing,
        spec.IndexedAttestation,
        spec.AttesterSlashing,
        spec.DepositData,
        spec.Deposit,
        spec.SignedVoluntaryExit,
        spec.SyncAggregate,
        spec.BLSToExecutionChange,
        spec.SignedBLSToExecutionChange,
        spec.Withdrawal,
        spec.ExecutionPayloadCapella,
        spec.ExecutionPayloadDeneb,
        spec.ExecutionPayloadHeaderCapella,
        spec.ExecutionPayloadHeaderDeneb,
        spec.BeaconBlockBodyCapella,
        spec.BlindedBeaconBlockBodyCapella,
        spec.BeaconBlockBodyDeneb,
        spec.BlindedBeaconBlockBodyDeneb,
        spec.BeaconBlockCapella,
        spec.BlindedBeaconBlockCapella,
        spec.BeaconBlockDeneb,
        spec.BlindedBeaconBlockDeneb,
    ):
        register(cls)

    for cls in (
        Duty,
        d.Checkpoint,
        d.AttestationData,
        d.Attestation,
        d.BeaconBlockHeader,
        d.Proposal,
        d.AggregateAndProof,
        d.SyncCommitteeMessage,
        d.SyncCommitteeContribution,
        d.ContributionAndProof,
        d.ValidatorRegistration,
        d.VoluntaryExit,
        d.AttestationDuty,
        d.SignedData,
        d.ParSignedData,
        d.SyncSelectionData,
        d.SyncMessageDuty,
        qbft.Msg,
    ):
        register(cls)
    register_enum(DutyType)
    register_enum(qbft.MsgType)

    # priority negotiation rides the p2p mesh and the consensus value
    # set (ref: core/corepb PriorityMsg / PriorityTopicResult)
    from charon_tpu_torch.core import priority

    register(priority.PriorityMsg)
    register(priority.TopicResult)

    # remote crypto-plane RPC frames self-register on import (their
    # wire ids live in _TYPE_WIRE_IDS above; the schema golden check
    # snapshots them through this import)
    from charon_tpu_torch.core import cryptosvc_wire  # noqa: F401


_register_core_types()
