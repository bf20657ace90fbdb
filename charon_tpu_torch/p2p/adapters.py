"""TCP-backed transports for the workflow components.

These adapt the P2PNode mesh to the transport interfaces the in-memory
simnet fakes implement, so the same ParSigEx / QBFTConsensus components run
over real sockets (ref: the reference's parsigex protocol
/charon/parsigex/2.0.0 — p2p/parsigex.go:23 — and consensus transport
core/consensus/qbft/transport.go).
"""

from __future__ import annotations

from charon_tpu_torch.p2p.transport import P2PNode

PARSIGEX_PROTOCOL = "parsigex/2.0.0"
QBFT_PROTOCOL = "qbft/2.0.0"


class TcpParSigTransport:
    """Drop-in for core.parsigex.MemTransport over the TCP mesh.

    Node indices are 0-based; share indices 1-based (idx = share-1)."""

    def __init__(self, node: P2PNode) -> None:
        self.node = node
        self.local = None
        node.register_handler(PARSIGEX_PROTOCOL, self._on_msg)

    def attach(self, parsigex) -> None:
        self.local = parsigex

    async def send(
        self, from_share_idx: int, duty, signed_set, tctx=None
    ) -> None:
        # trace context rides the frame so peer-node spans join the
        # sender's duty trace (ref: OTel ctx in the p2p envelopes)
        await self.node.broadcast(
            PARSIGEX_PROTOCOL, {"duty": duty, "set": signed_set, "tctx": tctx}
        )

    async def _on_msg(self, from_idx: int, msg):
        if self.local is not None:
            # channel identity: mesh node index -> 1-based share index,
            # so receive() can attribute spoofed/invalid sets to the
            # authenticated peer the frame arrived from
            await self.local.receive(
                msg["duty"],
                msg["set"],
                tctx=msg.get("tctx"),
                sender=from_idx + 1,
            )
        return None


class TcpQbftNet:
    """Drop-in for core.consensus_qbft.MemMsgNet over the TCP mesh."""

    def __init__(self, node: P2PNode) -> None:
        self.node = node
        self.local = None
        node.register_handler(QBFT_PROTOCOL, self._on_msg)

    def attach(self, consensus) -> int:
        self.local = consensus
        return self.node.index

    async def broadcast(
        self, from_idx: int, duty, msg, values, tctx=None
    ) -> None:
        await self.node.broadcast(
            QBFT_PROTOCOL,
            {"duty": duty, "msg": msg, "vals": values, "tctx": tctx},
        )

    async def _on_msg(self, from_idx: int, m):
        if self.local is not None:
            self.local.deliver(
                m["duty"],
                m["msg"],
                m["vals"],
                tctx=m.get("tctx"),
                sender=from_idx,
            )
        return None
