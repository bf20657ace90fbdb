"""Asyncio TCP peer mesh: authenticated, gated, typed request/response.

Mirrors ref: p2p/ —
  * NewTCPNode (p2p/p2p.go:36): here one asyncio TCP server per node plus
    one outbound connection per peer, lazily dialed with backoff;
  * conn gater (p2p/gater.go:16): the handshake proves possession of the
    peer's registered secp256k1 key; unknown keys are dropped;
  * Sender.SendAsync/SendReceive (p2p/sender.go:90): protocol-tagged
    frames with request ids, send/receive timeouts, per-peer failure
    hysteresis to suppress log storms (sender.go:85-110);
  * RegisterHandler (p2p/receive.go:40): async handler per protocol id;
  * ping (p2p/ping.go): continuous keepalive feeding peer-health state.

Frame format: 4-byte big-endian length, then the sealed
envelope. After decryption the first byte discriminates the codec —
0x01 is a binary v1 envelope (length-prefixed protocol/id fields, raw
payload bytes, decoded by memoryview slices with no intermediate
object graph), "{" is the original JSON envelope {"p": protocol,
"id": reqid, "k": "req"|"rsp", "d": codec payload}. Which format a
node SENDS is negotiated in the handshake ("wire" field, min of both
sides, absent = 0 = JSON) so a binary-speaking node interops with a
JSON-speaking peer frame-for-frame; what it ACCEPTS is sniffed per
frame, so mixed-version clusters never wedge mid-rollout.

A malformed frame of either codec raises the typed codec.CodecError
and is dropped-and-counted per frame (codec_dropped) — decode
strictness must never kill the authenticated connection carrying live
consensus traffic. Max frame 128 MB and 5s/7s recv/send timeouts
follow the reference's envelope (p2p/sender.go:23-29).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from charon_tpu_torch.app import k1util, log
from charon_tpu_torch.app.errors import StructuredError
from charon_tpu_torch.p2p import codec, quarantine

MAX_FRAME = 128 * 1024 * 1024  # ref: p2p/sender.go:26
SEND_TIMEOUT = 7.0  # ref: p2p/sender.go:28
RECV_TIMEOUT = 5.0  # ref: p2p/sender.go:27
HYSTERESIS_FAILS = 3  # suppress errors after this many consecutive fails
# Per-peer codec quarantine: dropping-and-counting
# malformed frames keeps the conn alive, but a peer STREAMING garbage
# (buggy build, fuzzing adversary) still costs a decode attempt + a log
# line per frame. After QUARANTINE_STRIKES CodecErrors inside
# QUARANTINE_WINDOW seconds the peer is temporarily muted — its frames
# drop before decode — for QUARANTINE_BASE seconds, doubling per repeat
# offense up to QUARANTINE_MAX; a clean frame after the mute expires
# forgives the backoff level. (State machine: p2p/quarantine.py —
# cryptography-free so the fast tier exercises it everywhere.)
QUARANTINE_STRIKES = quarantine.QUARANTINE_STRIKES
QUARANTINE_WINDOW = quarantine.QUARANTINE_WINDOW
QUARANTINE_BASE = quarantine.QUARANTINE_BASE
QUARANTINE_MAX = quarantine.QUARANTINE_MAX
# Highest binary wire format this build speaks (0 = JSON only). The
# handshake advertises it; each connection sends min(ours, theirs).
WIRE_VERSION = 1


@dataclass(frozen=True)
class PeerSpec:
    index: int
    pubkey: bytes  # 33-byte compressed secp256k1
    host: str
    port: int


class HandshakeError(StructuredError):
    """Mutual-auth failure; carries peer context fields
    (ref: app/errors structured errors at the p2p boundary)."""


class FrameError(ValueError):
    """Unsendable frame at the transport boundary (oversize payload).
    A ValueError subclass so broadcast()'s payload-bug logging keeps
    seeing it, typed so transport handlers can tell a local framing
    bug from the network errors the hysteresis counters absorb."""


@dataclass
class _Conn:
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    peer_idx: int
    # Per-connection AES-GCM key from static-static ECDH + handshake
    # nonces; every frame is sealed (confidentiality + integrity) with a
    # (direction, counter) nonce so a relay or on-path attacker can
    # neither read, inject, reorder, nor replay frames. Confidentiality
    # matters because DKG secret shares ride this channel (the reference
    # gets both properties from mutual libp2p-TLS, p2p/p2p.go).
    mac_key: bytes = b""
    send_dir: bytes = b"\x01"
    recv_dir: bytes = b"\x02"
    send_ctr: int = 0
    recv_ctr: int = 0
    # negotiated wire format this connection SENDS (min of both sides'
    # advertised versions; 0 = JSON). Inbound frames are sniffed per
    # frame regardless, so this only selects the outbound encoding.
    wire: int = 0
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)

    def _aead(self):
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        return AESGCM(self.mac_key)


def _nonce(direction: bytes, ctr: int) -> bytes:
    return direction * 4 + ctr.to_bytes(8, "big")  # 12 bytes


def _write_sframe(conn: _Conn, body: bytes) -> None:
    sealed = conn._aead().encrypt(
        _nonce(conn.send_dir, conn.send_ctr), body, None
    )
    # Write first, then advance the counter: an oversized-frame ValueError
    # must not desynchronize the nonce counters of a healthy connection.
    _write_frame(conn.writer, sealed)
    conn.send_ctr += 1


async def _read_sframe(conn: _Conn) -> bytes:
    frame = await _read_frame(conn.reader)
    try:
        body = conn._aead().decrypt(
            _nonce(conn.recv_dir, conn.recv_ctr), frame, None
        )
    except Exception as e:
        raise ConnectionError(f"frame decryption failed: {e}") from e
    conn.recv_ctr += 1
    return body


class P2PNode:
    def __init__(
        self,
        index: int,
        privkey,
        peers: list[PeerSpec],
        cluster_hash: bytes,
        relay=None,  # p2p.relay.RelayClient for NAT fallback
        wire_version: int = WIRE_VERSION,  # 0 forces the JSON codec
    ) -> None:
        self.index = index
        self.key = privkey
        self.peers = {p.index: p for p in peers if p.index != index}
        self.self_spec = next(p for p in peers if p.index == index)
        self.cluster_hash = cluster_hash
        self.relay = relay
        self.wire_version = wire_version
        self._server: asyncio.AbstractServer | None = None
        self._conns: dict[int, _Conn] = {}
        self._handlers: dict[str, Callable] = {}
        self._pending: dict[str, asyncio.Future] = {}
        self._fail_counts: dict[int, int] = {}
        self._ping_task: asyncio.Task | None = None
        self.ping_success: dict[int, bool] = {}
        self._recv_tasks: set[asyncio.Task] = set()
        # per-frame typed drops (codec.CodecError on a live connection)
        self.codec_dropped = 0
        # per-peer codec quarantine (see QUARANTINE_* above); module
        # constants are read at construction so tests can shrink them
        self._quarantine = quarantine.PeerQuarantine(
            strikes=QUARANTINE_STRIKES,
            window=QUARANTINE_WINDOW,
            base=QUARANTINE_BASE,
            max_mute=QUARANTINE_MAX,
            observer=self._on_quarantine,
        )
        self.quarantined_frames = 0  # frames dropped undecoded while muted
        # optional quarantine sink: called with (peer_idx, mute_seconds)
        self.quarantine_observer: Callable | None = None
        # optional wire metrics sink: called with (direction "tx"|"rx",
        # codec "binary"|"json", frame_bytes, codec_seconds). Must be
        # cheap and thread-safe (app/metrics.ClusterMetrics.wire_hook).
        self.wire_observer: Callable | None = None

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_inbound, self.self_spec.host, self.self_spec.port
        )
        self.register_handler("ping", self._handle_ping)
        if self.relay is not None:
            # inbound relayed streams get the normal responder handshake.
            # A dead relay degrades to direct-only dialing — a FALLBACK
            # must never make startup depend on it.
            self.relay.set_stream_acceptor(self._on_relay_stream)
            try:
                await self.relay.connect()
            except OSError as e:
                from charon_tpu_torch.app import log

                log.warn(
                    "relay unreachable; direct-only p2p",
                    topic="p2p",
                    err=str(e),
                )
                self.relay = None

    async def _on_relay_stream(self, peer_idx: int, reader, writer) -> None:
        await self._on_inbound(reader, writer)

    async def stop(self) -> None:
        if self.relay is not None:
            await self.relay.close()
        if self._ping_task:
            self._ping_task.cancel()
        for task in list(self._recv_tasks):
            task.cancel()
        for conn in list(self._conns.values()):
            conn.writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    def register_handler(self, protocol: str, handler) -> None:
        """ref: p2p/receive.go:40 RegisterHandler."""
        self._handlers[protocol] = handler

    # -- handshake --------------------------------------------------------
    #
    # Mutual authentication (ref gets this from libp2p-TLS
    # with pinned peer identities, p2p/p2p.go):
    #   1. responder sends nonce_s;
    #   2. dialer sends {idx, nonce_c, sig over transcript(dialer_idx,
    #      responder_idx, nonce_s, nonce_c)} — binding BOTH identities and
    #      BOTH nonces, so the challenge cannot be relayed to a third peer;
    #   3. responder verifies, replies {idx, sig over ack-transcript};
    #      dialer verifies against the pubkey of the peer it dialed.
    # Both sides then derive a per-connection MAC key from static-static
    # ECDH + the nonces; every subsequent frame is HMAC'd with a direction
    # byte and a monotonically increasing counter (no injection/replay).

    def _transcript(self, tag: bytes, dialer: int, responder: int,
                    nonce_s: bytes, nonce_c: bytes) -> bytes:
        return hashlib.sha256(
            tag
            + self.cluster_hash
            + dialer.to_bytes(4, "big")
            + responder.to_bytes(4, "big")
            + nonce_s
            + nonce_c
        ).digest()

    def _session_key(self, peer_pubkey: bytes, dialer: int, responder: int,
                     nonce_s: bytes, nonce_c: bytes) -> bytes:
        shared = k1util.ecdh(self.key, peer_pubkey)
        return hashlib.sha256(
            b"charon-tpu-key-v2"
            + self.cluster_hash
            + shared
            + dialer.to_bytes(4, "big")
            + responder.to_bytes(4, "big")
            + nonce_s
            + nonce_c
        ).digest()

    async def _on_inbound(self, reader, writer) -> None:
        try:
            nonce_s = os.urandom(16)
            writer.write(nonce_s)
            await writer.drain()
            hello = await asyncio.wait_for(_read_frame(reader), RECV_TIMEOUT)
            h = json.loads(hello)
            idx = h["idx"]
            peer = self.peers.get(idx)
            # conn gater: only registered cluster peers may connect
            # (ref: p2p/gater.go:16-77)
            if peer is None:
                raise HandshakeError("unknown peer index", peer=idx)
            nonce_c = bytes.fromhex(h["nonce"])
            sig = bytes.fromhex(h["sig"])
            digest = self._transcript(
                b"charon-tpu-hello-v2", idx, self.index, nonce_s, nonce_c
            )
            if not k1util.verify_bytes(peer.pubkey, digest, sig):
                raise HandshakeError("bad handshake signature", peer=idx)
            # wire negotiation: absent field = version 0 (JSON) — the
            # cross-minor interop floor. Not part of the signed
            # transcript on purpose: a downgrade costs bytes, not auth.
            wire = min(self.wire_version, int(h.get("wire", 0)))
            ack = self._transcript(
                b"charon-tpu-ack-v2", idx, self.index, nonce_s, nonce_c
            )
            _write_frame(
                writer,
                json.dumps(
                    {
                        "idx": self.index,
                        "sig": k1util.sign(self.key, ack).hex(),
                        "wire": self.wire_version,
                    }
                ).encode(),
            )
            await writer.drain()
            key = self._session_key(
                peer.pubkey, idx, self.index, nonce_s, nonce_c
            )
        except Exception:
            writer.close()
            return
        conn = _Conn(
            reader, writer, idx,
            mac_key=key, send_dir=b"\x02", recv_dir=b"\x01",
            wire=wire,
        )
        self._conns.setdefault(idx, conn)
        self._spawn_recv(conn)

    async def _dial(self, peer: PeerSpec) -> _Conn:
        """Direct TCP dial, with relay fallback: when the peer is
        unreachable and a relay is configured, run the SAME mutual
        handshake + MAC'd framing over a relay virtual stream — the
        relay is a blind forwarder, never a trusted party (ref:
        p2p/relay.go circuit-relay-v2; relayed conns stay libp2p-TLS
        end-to-end)."""
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(peer.host, peer.port), SEND_TIMEOUT
            )
        except (OSError, asyncio.TimeoutError):
            if self.relay is None:
                raise
            reader, writer = await self.relay.stream_to(peer.index)
        try:
            return await self._handshake_dialer(reader, writer, peer)
        except BaseException:
            # close on ANY failure (incl. timeout/cancel): a half-done
            # handshake must not leave a stale stream/socket behind
            writer.close()
            raise

    async def _handshake_dialer(self, reader, writer, peer: PeerSpec) -> _Conn:
        nonce_s = await asyncio.wait_for(reader.readexactly(16), RECV_TIMEOUT)
        nonce_c = os.urandom(16)
        digest = self._transcript(
            b"charon-tpu-hello-v2", self.index, peer.index, nonce_s, nonce_c
        )
        _write_frame(
            writer,
            json.dumps(
                {
                    "idx": self.index,
                    "nonce": nonce_c.hex(),
                    "sig": k1util.sign(self.key, digest).hex(),
                    "wire": self.wire_version,
                }
            ).encode(),
        )
        await writer.drain()
        ack_frame = await asyncio.wait_for(_read_frame(reader), RECV_TIMEOUT)
        a = json.loads(ack_frame)
        ack = self._transcript(
            b"charon-tpu-ack-v2", self.index, peer.index, nonce_s, nonce_c
        )
        if a.get("idx") != peer.index or not k1util.verify_bytes(
            peer.pubkey, ack, bytes.fromhex(a["sig"])
        ):
            writer.close()
            raise HandshakeError("responder failed mutual auth", peer=peer.index)
        key = self._session_key(
            peer.pubkey, self.index, peer.index, nonce_s, nonce_c
        )
        conn = _Conn(
            reader, writer, peer.index,
            mac_key=key, send_dir=b"\x01", recv_dir=b"\x02",
            wire=min(self.wire_version, int(a.get("wire", 0))),
        )
        self._spawn_recv(conn)
        return conn

    async def _get_conn(self, peer_idx: int) -> _Conn:
        conn = self._conns.get(peer_idx)
        if conn is not None and not conn.writer.is_closing():
            return conn
        peer = self.peers[peer_idx]
        conn = await self._dial(peer)
        self._conns[peer_idx] = conn
        return conn

    # -- send -------------------------------------------------------------

    def _encode_envelope(
        self, conn: _Conn, protocol: str, req_id: str, kind: str, msg
    ) -> bytes:
        """Envelope bytes in the connection's negotiated codec, feeding
        the wire observer (tx bytes + encode seconds) when wired."""
        binary = conn.wire >= 1
        if self.wire_observer is None:
            return codec.encode_envelope(protocol, req_id, kind, msg, binary)
        t0 = time.perf_counter()
        body = codec.encode_envelope(protocol, req_id, kind, msg, binary)
        self.wire_observer(
            "tx",
            "binary" if binary else "json",
            len(body),
            time.perf_counter() - t0,
        )
        return body

    async def send(self, peer_idx: int, protocol: str, msg, await_response: bool = False):
        """SendAsync / SendReceive (ref: p2p/sender.go:90-95)."""
        req_id = os.urandom(8).hex()
        fut = None
        if await_response:
            fut = asyncio.get_running_loop().create_future()
            self._pending[req_id] = fut
        conn = None
        try:
            conn = await self._get_conn(peer_idx)
            body = self._encode_envelope(conn, protocol, req_id, "req", msg)
            try:
                async with conn.lock:
                    _write_sframe(conn, body)
                    await asyncio.wait_for(conn.writer.drain(), SEND_TIMEOUT)
            except Exception:
                # the write or drain failed: the connection is dead
                self._drop_conn(peer_idx, conn)
                raise
            self._fail_counts[peer_idx] = 0
            if fut is not None:
                return await asyncio.wait_for(fut, RECV_TIMEOUT)
            return None
        except Exception:
            # hysteresis: count every failure. A response timeout leaves
            # the connection up (a stream timeout does not close the
            # shared connection, ref: p2p/sender.go); only a closed
            # stream is dropped with it.
            self._fail_counts[peer_idx] = self._fail_counts.get(peer_idx, 0) + 1
            if conn is not None and conn.writer.is_closing():
                self._drop_conn(peer_idx, conn)
            if fut is not None:
                self._pending.pop(req_id, None)
            raise

    def _drop_conn(self, peer_idx: int, conn: _Conn) -> None:
        if self._conns.get(peer_idx) is conn:
            del self._conns[peer_idx]

    def peer_failing(self, peer_idx: int) -> bool:
        return self._fail_counts.get(peer_idx, 0) >= HYSTERESIS_FAILS

    async def _broadcast_one(
        self, peer_idx: int, protocol: str, req_id: str, msg, cache: dict
    ) -> None:
        """One broadcast delivery: the envelope is encoded ONCE per
        negotiated codec and shared across peers (`cache`) — an n-node
        gossip burst pays one serialization, not n-1. Safe
        because broadcast frames are fire-and-forget: the request id is
        never matched, so peers may share it."""
        try:
            conn = await self._get_conn(peer_idx)
            key = 1 if conn.wire >= 1 else 0
            body = cache.get(key)
            if body is None:
                body = cache[key] = self._encode_envelope(
                    conn, protocol, req_id, "req", msg
                )
            elif self.wire_observer is not None:
                # cache hit: count the wire bytes, no encode timing
                self.wire_observer(
                    "tx", "binary" if key else "json", len(body), None
                )
            async with conn.lock:
                _write_sframe(conn, body)
                await asyncio.wait_for(conn.writer.drain(), SEND_TIMEOUT)
            self._fail_counts[peer_idx] = 0
        except Exception:
            self._fail_counts[peer_idx] = (
                self._fail_counts.get(peer_idx, 0) + 1
            )
            self._conns.pop(peer_idx, None)
            raise

    async def broadcast(self, protocol: str, msg) -> None:
        """Fire-and-forget to every peer; failures are independent.
        Network errors surface via hysteresis state; programming errors
        (unserializable payloads) are logged loudly — silently dropping
        every frame would stall consensus with healthy-looking pings."""
        req_id = os.urandom(8).hex()
        cache: dict = {}
        results = await asyncio.gather(
            *(
                self._broadcast_one(idx, protocol, req_id, msg, cache)
                for idx in self.peers
            ),
            return_exceptions=True,
        )
        for res in results:
            if isinstance(res, (TypeError, ValueError)):
                from charon_tpu_torch.app import log

                log.error(
                    "broadcast payload error",
                    topic="p2p",
                    protocol=protocol,
                    error=repr(res),
                )
                break

    # -- receive ----------------------------------------------------------

    def _spawn_recv(self, conn: _Conn) -> None:
        task = asyncio.create_task(self._recv_loop(conn))
        self._recv_tasks.add(task)
        task.add_done_callback(self._recv_tasks.discard)

    def _decode_envelope(self, frame: bytes) -> dict:
        """Sniff-and-decode one decrypted frame in place (offset walk
        over the frame bytes; payload bytes fields slice straight out
        of the buffer), feeding the wire observer (rx bytes + decode
        seconds)."""
        if self.wire_observer is None:
            return codec.decode_envelope(frame)
        t0 = time.perf_counter()
        env = codec.decode_envelope(frame)
        self.wire_observer(
            "rx",
            "binary" if frame[:1] != b"{" else "json",
            len(frame),
            time.perf_counter() - t0,
        )
        return env

    @property
    def peer_quarantines(self) -> int:
        """Mutes imposed so far (wire_peer_quarantine_total)."""
        return self._quarantine.quarantines

    def peer_quarantined(self, peer_idx: int) -> bool:
        return self._quarantine.muted(peer_idx)

    def _on_quarantine(self, peer_idx: int, mute: float) -> None:
        log.warn(
            "quarantining peer after repeated malformed frames",
            topic="p2p",
            peer=peer_idx,
            mute_seconds=mute,
            strikes=self._quarantine.strikes,
        )
        if self.quarantine_observer is not None:
            self.quarantine_observer(peer_idx, mute)

    async def _recv_loop(self, conn: _Conn) -> None:
        try:
            while True:
                frame = await _read_sframe(conn)
                if self._quarantine.any_history and self._quarantine.muted(
                    conn.peer_idx
                ):
                    # muted peer: drop before decode — a garbage stream
                    # costs a counter bump, not a decode attempt + log
                    # line per frame
                    self.quarantined_frames += 1
                    continue
                # Per-frame fault isolation: a malformed payload or a
                # handler bug drops THAT frame, not the authenticated
                # connection carrying live consensus traffic (frame
                # integrity itself is the MAC's job in _read_sframe).
                try:
                    env = self._decode_envelope(frame)
                    if self._quarantine.any_history:
                        # a clean frame after the mute expired forgives
                        # the peer's exponential-backoff level
                        self._quarantine.forgive(conn.peer_idx)
                    if env["k"] == "rsp":
                        fut = self._pending.pop(env["id"], None)
                        if fut is not None and not fut.done():
                            fut.set_result(env["d"])
                        continue
                    handler = self._handlers.get(env["p"])
                    if handler is None:
                        continue
                    # Source = the connection's authenticated peer index;
                    # a sender-claimed envelope field would allow
                    # impersonation.
                    resp = await handler(conn.peer_idx, env["d"])
                except asyncio.CancelledError:
                    raise
                except codec.CodecError as e:
                    # typed malformed-frame drop:
                    # a sealed-but-malformed payload lands here,
                    # counted, and the transport task lives on. (Raw
                    # pre-AEAD garbage — chaos_p2p_node's corrupt knob
                    # — fails the MAC instead and tears down the conn
                    # by design; see _read_sframe.)
                    self.codec_dropped += 1
                    self._quarantine.strike(conn.peer_idx)
                    log.warn(
                        "dropping malformed frame",
                        topic="p2p",
                        peer=conn.peer_idx,
                        dropped=self.codec_dropped,
                        err=f"CodecError: {e}",
                    )
                    continue
                except Exception as e:
                    log.warn(
                        "dropping bad frame",
                        topic="p2p",
                        peer=conn.peer_idx,
                        err=f"{type(e).__name__}: {e}",
                    )
                    continue
                if resp is not None:
                    body = self._encode_envelope(
                        conn, env["p"], env["id"], "rsp", resp
                    )
                    async with conn.lock:
                        _write_sframe(conn, body)
                        await conn.writer.drain()
        # task-body terminus: cancellation (node stop) ENDS this loop —
        # there is no awaiting canceller to starve, and the conn cleanup
        # it exists for runs in the finally below either way
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):  # lint: allow(no-swallowed-cancellation)
            pass
        finally:
            self._conns.pop(conn.peer_idx, None)
            conn.writer.close()

    # -- ping (ref: p2p/ping.go:35) ---------------------------------------

    async def _handle_ping(self, from_idx: int, msg):
        return {"pong": self.index}

    def start_ping(self, interval: float = 1.0) -> None:
        async def loop():
            while True:
                for idx in self.peers:
                    try:
                        await self.send(idx, "ping", None, await_response=True)
                        self.ping_success[idx] = True
                    except Exception:
                        self.ping_success[idx] = False
                await asyncio.sleep(interval)

        self._ping_task = asyncio.create_task(loop())


def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    if len(payload) > MAX_FRAME:
        raise FrameError("frame exceeds max size")
    # two writes, no header+payload concatenation: the transport never
    # copies a large frame just to prefix 4 bytes
    writer.write(len(payload).to_bytes(4, "big"))
    writer.write(payload)


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > MAX_FRAME:
        raise ConnectionError("oversized frame")
    return await reader.readexactly(length)
