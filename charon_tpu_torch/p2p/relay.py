"""Relay server + client: rendezvous and frame forwarding for NAT'd peers.

Mirrors ref: p2p/relay.go + cmd/relay — the reference uses libp2p
circuit-relay-v2 with reservations refreshed continuously and relay-HTTP
peer discovery (discv5 was removed). Here: an asyncio TCP relay that
registered peers keep a connection to; frames addressed to a peer index
are forwarded over its registered connection. Peers prefer direct dials
and fall back to the relay (ref: ForceDirectConnections upgrades relayed
connections, app/app.go:352-353).

Wire format between peer and relay:
  register:  {"op": "register", "cluster": hex, "idx": n}
  send:      {"op": "send", "to": n} + payload frame follows
  deliver:   {"op": "deliver", "from": n} + payload frame follows
"""

from __future__ import annotations

import asyncio
import json
from collections import defaultdict

from charon_tpu_torch.p2p.transport import MAX_FRAME, _read_frame, _write_frame


class RelayServer:
    """`charon-tpu relay` (ref: cmd/relay/relay.go:46)."""

    def __init__(self) -> None:
        self._server: asyncio.AbstractServer | None = None
        # (cluster, idx) -> writer
        self._peers: dict[tuple[str, int], asyncio.StreamWriter] = {}
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_conn, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        for w in self._peers.values():
            w.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _on_conn(self, reader, writer) -> None:
        key = None
        try:
            hello = json.loads(await _read_frame(reader))
            if hello.get("op") != "register":
                writer.close()
                return
            key = (hello["cluster"], int(hello["idx"]))
            self._peers[key] = writer
            while True:
                header = json.loads(await _read_frame(reader))
                payload = await _read_frame(reader)
                if header.get("op") != "send":
                    continue
                target = self._peers.get((key[0], int(header["to"])))
                if target is None or target.is_closing():
                    continue
                deliver = {"op": "deliver", "from": key[1]}
                if header.get("s"):
                    # virtual-stream frame: forwarded verbatim with the
                    # stream flag so the raw-frame layer never sees it
                    deliver["s"] = 1
                _write_frame(target, json.dumps(deliver).encode())
                _write_frame(target, payload)
                await target.drain()
        except (asyncio.IncompleteReadError, ConnectionError, json.JSONDecodeError):
            pass
        finally:
            if key is not None and self._peers.get(key) is writer:
                del self._peers[key]
            writer.close()


class _VirtualWriter:
    """StreamWriter-shaped façade over relayed frames: written bytes are
    flushed as `VS`-tagged payload frames addressed to one peer."""

    def __init__(self, client: "RelayClient", to_idx: int) -> None:
        self._client = client
        self._to = to_idx
        self._buf = bytearray()
        self._closing = False

    def write(self, data: bytes) -> None:
        self._buf += data

    async def drain(self) -> None:
        if self._closing:
            raise ConnectionError("virtual stream closed")
        if self._buf:
            data, self._buf = bytes(self._buf), bytearray()
            await self._client.send(self._to, b"VS" + data, stream=True)

    def _detach(self) -> bool:
        """Detach from the demux so the next stream_to/inbound VO starts
        FRESH — a stale half-dead pair must never be reused. Returns
        whether the VC close frame still needs sending."""
        if self._client._streams.get(self._to, (None, None))[1] is self:
            self._client._streams.pop(self._to, None)
            self._client._stream_origin.pop(self._to, None)
        if self._closing:
            return False
        self._closing = True
        return True

    def close(self) -> None:
        if self._detach():
            try:
                asyncio.get_running_loop().create_task(
                    self._client.send(self._to, b"VC", stream=True)
                )
            except RuntimeError:
                pass  # no running loop (teardown)

    async def aclose(self) -> None:
        """Inline (awaited) close: the VC frame is on the wire before the
        caller's next send, so a peer can never observe a newer open
        before this close."""
        if self._detach():
            await self._client.send(self._to, b"VC", stream=True)

    def is_closing(self) -> bool:
        return self._closing


class RelayClient:
    """Keeps a registered connection to the relay and exposes two layers:

    * raw frames (`on_frame` / `send`) — rendezvous-style messaging;
    * **virtual streams** (`stream_to` / `set_stream_acceptor`) — a
      StreamReader/Writer pair multiplexed over the relay, over which the
      P2PNode runs its NORMAL mutual handshake + per-frame MACs, so a
      relayed connection is end-to-end authenticated exactly like a
      direct one and the relay stays a blind forwarder (ref: libp2p
      circuit-relay-v2 conns are still libp2p-TLS end-to-end,
      p2p/relay.go).

    One virtual stream per peer pair. Simultaneous dial-via-relay from
    both ends can collide (both sides act as handshake dialer) — the
    handshake times out and the workflow retryer re-dials, mirroring TCP
    simultaneous-connect rarity."""

    def __init__(self, host: str, port: int, cluster_hash: bytes, index: int) -> None:
        self.host = host
        self.port = port
        self.cluster = cluster_hash.hex()
        self.index = index
        self._reader = None
        self._writer = None
        self._handlers = []
        self._recv_task: asyncio.Task | None = None
        self._streams: dict[int, tuple[asyncio.StreamReader, _VirtualWriter]] = {}
        self._stream_origin: dict[int, str] = {}  # "out" (stream_to) | "in"
        self._acceptor = None
        self._accept_tasks: set[asyncio.Task] = set()

    def on_frame(self, handler) -> None:
        """handler(from_idx: int, payload: bytes) — raw, non-stream frames."""
        self._handlers.append(handler)

    def set_stream_acceptor(self, acceptor) -> None:
        """acceptor(peer_idx, reader, writer): awaited when a peer opens
        a virtual stream toward this node (the P2PNode passes its
        responder-handshake entrypoint)."""
        self._acceptor = acceptor

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        _write_frame(
            self._writer,
            json.dumps(
                {"op": "register", "cluster": self.cluster, "idx": self.index}
            ).encode(),
        )
        await self._writer.drain()
        self._recv_task = asyncio.create_task(self._recv_loop())

    def _stream_pair(self, peer_idx: int, origin: str):
        pair = self._streams.get(peer_idx)
        if pair is None:
            pair = (asyncio.StreamReader(), _VirtualWriter(self, peer_idx))
            self._streams[peer_idx] = pair
            self._stream_origin[peer_idx] = origin
        return pair

    async def stream_to(self, peer_idx: int):
        """(reader, writer) virtual stream toward peer_idx (dialer side).
        Sends an explicit open marker: the responder speaks first in the
        node handshake (nonce), so it must learn of the stream before any
        dialer bytes flow. If an INBOUND stream from the same peer is
        already active (both sides fell back simultaneously), refuse —
        the caller's retry path will find the inbound-established
        connection instead of corrupting its handshake."""
        pair = self._streams.get(peer_idx)
        if pair is not None:
            if self._stream_origin.get(peer_idx) == "in":
                raise ConnectionError(
                    f"relay stream to {peer_idx} busy (inbound in progress)"
                )
            # stale dialer-side pair: drop it and start fresh. The close
            # frame is awaited so the peer can never observe the new VO
            # before the stale VC (close() defers its VC via create_task,
            # which could land after our VO and kill the fresh stream).
            await pair[1].aclose()
            # the await may have let a new pair appear — an inbound VO
            # from _recv_loop OR a concurrent stream_to that registered a
            # fresh dialer pair. Either way that stream has an owner;
            # joining it would interleave two handshakes, so refuse and
            # let the caller's retry find the established connection.
            if peer_idx in self._streams:
                raise ConnectionError(
                    f"relay stream to {peer_idx} busy (concurrent open)"
                )
        pair = self._stream_pair(peer_idx, "out")
        await self.send(peer_idx, b"VO", stream=True)
        return pair

    async def _recv_loop(self) -> None:
        try:
            while True:
                header = json.loads(await _read_frame(self._reader))
                payload = await _read_frame(self._reader)
                if header.get("op") != "deliver":
                    continue
                frm = int(header["from"])
                if header.get("s"):
                    # virtual-stream frames live in their own namespace
                    # (the relay forwards the flag) — raw on_frame
                    # payloads can never be hijacked by tag collisions
                    if payload[:2] in (b"VO", b"VS"):
                        existed = frm in self._streams
                        if payload[:2] == b"VS" and not existed:
                            # only VO opens a stream: a VS addressed to no
                            # registered stream is a stale flush from a
                            # torn-down pair — spawning a phantom inbound
                            # stream from it would block re-dials until
                            # its garbage handshake times out
                            continue
                        reader, _writer = self._stream_pair(frm, "in")
                        if payload[2:]:
                            reader.feed_data(payload[2:])
                        if not existed and self._acceptor is not None:
                            task = asyncio.create_task(
                                self._acceptor(frm, *self._streams[frm])
                            )
                            self._accept_tasks.add(task)
                            task.add_done_callback(self._accept_tasks.discard)
                    elif payload[:2] == b"VC":
                        pair = self._streams.pop(frm, None)
                        self._stream_origin.pop(frm, None)
                        if pair is not None:
                            pair[0].feed_eof()
                            pair[1]._closing = True
                    continue
                for h in self._handlers:
                    res = h(frm, payload)
                    if asyncio.iscoroutine(res):
                        await res
        except (asyncio.IncompleteReadError, ConnectionError):
            # relay link died: every virtual stream is dead — detach all
            # so later dials start fresh (after reconnect)
            streams, self._streams = self._streams, {}
            self._stream_origin.clear()
            for reader, vwriter in streams.values():
                reader.feed_eof()
                vwriter._closing = True

    async def send(self, to_idx: int, payload: bytes, stream: bool = False) -> None:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionError("relay connection down")
        header = {"op": "send", "to": to_idx}
        if stream:
            header["s"] = 1
        _write_frame(self._writer, json.dumps(header).encode())
        _write_frame(self._writer, payload)
        await self._writer.drain()

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        for task in list(self._accept_tasks):
            task.cancel()
        if self._writer:
            self._writer.close()
