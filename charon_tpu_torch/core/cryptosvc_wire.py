"""Wire frames + framing for the remote crypto-plane service.

The in-process `core/cryptosvc.CryptoPlaneService` becomes dialable: a
physically separate DV cluster submits verify/recombine jobs over a TCP
socket speaking the binary codec of p2p/codec.py. This module is the shared
vocabulary of `cryptosvc_server` and `cryptosvc_client`:

  * the RPC frame dataclasses (append-only wire ids 21..27 in
    `p2p/codec._TYPE_WIRE_IDS`, blessed into the wire-schema golden);
  * length-prefixed framing identical to `p2p/transport._write_frame` /
    `_read_frame` (4-byte big-endian length, 128 MB cap) — reimplemented
    here rather than imported because `p2p/transport` pulls in
    `app.k1util` (the `cryptography` package), which minimal images and
    this service deliberately do not require;
  * envelope version negotiation reusing the transport's convention:
    the handshake frames always ride the JSON envelope (sniffable with
    zero per-connection state), each side advertises its
    `WIRE_VERSION`, and post-handshake frames use
    `min(ours, theirs)` — binary v1 when both sides speak it;
  * challenge/response tenant auth: the server sends a fresh nonce, the
    client proves knowledge of its tenant token with an HMAC-SHA256 over
    it. The token itself NEVER crosses the wire (and never reaches
    logs, reprs, or metrics labels — analysis/rule_secret_flow.py lints
    the `auth_token` name as a secret source).

Deadlines travel RELATIVE (`deadline_rel` = seconds until the wall-clock
duty deadline at send time): absolute `time.time()` values are
meaningless across hosts with skewed clocks, and a wall/monotonic
confusion is exactly the bug class this avoids across machines. FlushStats stage spans ride results the same way
(offsets back from the server's send instant) for the same reason.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
from dataclasses import dataclass

from charon_tpu_torch.p2p.codec import (
    CodecError,
    decode_envelope,
    encode_envelope,
    register,
)

PROTOCOL = "cryptosvc/1"
# Highest binary envelope this build speaks (mirrors
# p2p.transport.WIRE_VERSION; 0 = JSON-only)
WIRE_VERSION = 1
MAX_FRAME = 128 * 1024 * 1024  # same cap as p2p/transport.MAX_FRAME
HELLO_TIMEOUT = 5.0


@register
@dataclass(frozen=True)
class CryptoChallenge:
    """Server -> client, immediately on accept: the auth nonce (public
    by construction) plus the server's wire-version advertisement."""

    nonce: bytes
    wire: int = WIRE_VERSION


@register
@dataclass(frozen=True)
class CryptoHello:
    """Client -> server: tenant identity + HMAC proof over the nonce."""

    tenant_id: str
    proof: bytes
    wire: int = WIRE_VERSION


@register
@dataclass(frozen=True)
class CryptoHelloAck:
    """Server -> client: auth verdict + negotiated wire version + the
    service plane's threshold and heartbeat cadence."""

    ok: bool
    wire: int = 0
    t: int = 0
    heartbeat: float = 1.0
    error: str = ""


@register
@dataclass(frozen=True)
class CryptoSubmit:
    """One verify/recombine job. `args` mirrors
    `CryptoPlaneService.submit` args (lists of bytes/int rows);
    `deadline_rel` is seconds-until-deadline at send time, or None."""

    job_id: int
    kind: str  # "verify" | "recombine"
    args: tuple
    lanes: int
    deadline_rel: float | None = None


@register
@dataclass(frozen=True)
class CryptoResult:
    """Job completion. `value` is the plane result (verify: [bool] per
    lane; recombine: [[sig|None...], [ok...]]). `error_kind` separates
    crypto verdicts ("tbls" — identical on every rung, the client must
    NOT fail over) from infrastructure faults ("error" — the client
    degrades to its local ladder). `stats` is the compact cross-process
    FlushStats attribution dict (see cryptosvc_server._flush_brief)."""

    job_id: int
    value: object = None
    error: str = ""
    error_kind: str = ""  # "" | "tbls" | "error"
    stats: dict | None = None


@register
@dataclass(frozen=True)
class CryptoShed:
    """Server-side admission rejection: the tenant's queue is over
    quota (`core/cryptosvc.PlaneOverloadError` crossing the wire)."""

    job_id: int
    reason: str  # "jobs" | "lanes" | "closed"
    detail: str = ""


@register
@dataclass(frozen=True)
class CryptoHeartbeat:
    """Liveness probe. The client sends seq, the server echoes it back
    with echo=True; the client pins miss detection to time.monotonic."""

    seq: int
    echo: bool = False


def auth_proof(auth_token: bytes, nonce: bytes) -> bytes:
    """HMAC-SHA256 proof of token knowledge over the server's nonce."""
    return hmac.new(auth_token, nonce, hashlib.sha256).digest()


def proof_ok(auth_token: bytes, nonce: bytes, proof: bytes) -> bool:
    """Constant-time proof check (never log either side's inputs)."""
    return hmac.compare_digest(auth_proof(auth_token, nonce), proof)


def send_frame(
    writer: asyncio.StreamWriter, msg, binary: bool
) -> None:
    """Encode + write one service frame. Fully synchronous (two
    buffered writes, no await) so concurrent sender tasks on one
    connection can never interleave a header with another frame's
    payload; callers drain() afterwards."""
    payload = encode_envelope(PROTOCOL, "", "req", msg, binary)
    if len(payload) > MAX_FRAME:
        raise CodecError("service frame exceeds max size")
    writer.write(len(payload).to_bytes(4, "big"))
    writer.write(payload)


async def read_frame(reader: asyncio.StreamReader):
    """Read + decode one service frame. Raises CodecError on any
    malformation (oversize, bad envelope, wrong protocol) and the
    usual ConnectionError/IncompleteReadError on socket death."""
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > MAX_FRAME:
        raise CodecError("oversized service frame")
    payload = await reader.readexactly(length)
    env = decode_envelope(payload)
    if env["p"] != PROTOCOL:
        raise CodecError(f"unexpected service protocol {env['p']!r}")
    return env["d"]
