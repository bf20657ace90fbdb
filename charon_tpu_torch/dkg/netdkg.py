"""Networked DKG: the ceremony over the TCP p2p mesh.

Mirrors ref: dkg/ —
  * sync protocol (dkg/sync/client.go:31-60): every node waits until all
    n peers are reachable and agree on (definition hash, version) before
    the ceremony starts;
  * FROST over p2p (dkg/frostp2p.go): round-1 commitment broadcasts are
    published to everyone; Shamir share vectors are addressed privately
    per recipient (served only to that peer; the transport's per-frame
    AES-GCM sealing protects them in transit);
  * signed exchange (dkg/bcast/impl.go:22-49): every published payload
    carries a k1 signature over (definition hash, tag, sender, payload),
    verified against the operator keys from the definition — the
    reliable-broadcast property that a peer cannot later equivocate about
    what it sent.

The transport is PULL-based: each node publishes its tagged payloads
locally and peers poll until they appear — robust to nodes starting at
different times (the reference's sync step exists for the same reason).
"""

from __future__ import annotations

import asyncio
import hashlib
import json

from charon_tpu_torch.app import k1util
from charon_tpu_torch.eth2util import enr
from charon_tpu_torch.dkg.frost import Round1Broadcast, Round1Shares
from charon_tpu_torch.p2p import codec
from charon_tpu_torch.p2p.transport import P2PNode

DKG_PROTOCOL = "dkg/1.0.0"
DKG_VERSION = "ctpu-dkg/1"

codec.register(Round1Broadcast)
codec.register(Round1Shares)


class DkgError(Exception):
    pass


class TcpDkgTransport:
    """Signed tagged-payload exchange over an authenticated P2P mesh."""

    def __init__(
        self,
        node: P2PNode,
        defn,
        privkey,
        poll_interval: float = 0.25,
        timeout: float = 120.0,
    ) -> None:
        self.node = node
        self.defn = defn
        self.idx = node.index  # 0-based operator index
        self.n = len(defn.operators)
        self.def_hash = defn.definition_hash()
        self.privkey = privkey
        self.pubkeys = [
            enr.pubkey_from_string(op.enr) for op in defn.operators
        ]
        self.poll_interval = poll_interval
        self.timeout = timeout
        # tag -> (payload, sig_hex, private_to | None)
        self._local: dict[str, tuple] = {}
        node.register_handler(DKG_PROTOCOL, self._on_req)

    # -- signing -----------------------------------------------------------

    def _digest(self, tag: str, idx: int, payload) -> bytes:
        canon = json.dumps(
            codec._to_jsonable(payload), sort_keys=True, separators=(",", ":")
        ).encode()
        return hashlib.sha256(
            b"charon-tpu-dkg"
            + self.def_hash
            + tag.encode()
            + idx.to_bytes(4, "big")
            + canon
        ).digest()

    def publish(self, tag: str, payload, private_to: int | None = None) -> None:
        sig = k1util.sign(self.privkey, self._digest(tag, self.idx, payload))
        self._local[tag] = (payload, sig.hex(), private_to)

    async def _on_req(self, from_idx: int, msg):
        entry = self._local.get(msg.get("tag", ""))
        if entry is None:
            return {"ok": False}
        payload, sig_hex, private_to = entry
        # private payloads are served ONLY to their addressee (the channel
        # itself is AES-GCM sealed, so nothing leaks in transit either)
        if private_to is not None and from_idx != private_to:
            return {"ok": False}
        return {"ok": True, "payload": payload, "sig": sig_hex}

    # -- pulling -----------------------------------------------------------

    async def _pull(self, peer: int, tag: str, sender: int | None = None):
        """Poll `peer` for `tag` until it appears and its signature
        verifies against operator `sender` (default: the peer itself)."""
        sender = peer if sender is None else sender
        deadline = asyncio.get_running_loop().time() + self.timeout
        while True:
            try:
                resp = await self.node.send(
                    peer, DKG_PROTOCOL, {"tag": tag}, await_response=True
                )
                if resp and resp.get("ok"):
                    payload = resp["payload"]
                    if k1util.verify_bytes(
                        self.pubkeys[sender],
                        self._digest(tag, sender, payload),
                        bytes.fromhex(resp["sig"]),
                    ):
                        return payload
                    raise DkgError(
                        f"bad signature on {tag!r} from operator {sender}"
                    )
            except DkgError:
                raise
            except Exception:
                pass  # peer not up yet / payload not published yet
            if asyncio.get_running_loop().time() > deadline:
                raise DkgError(f"timeout pulling {tag!r} from peer {peer}")
            await asyncio.sleep(self.poll_interval)

    async def gather(self, tag: str, payload) -> dict[int, object]:
        """Publish ours, pull everyone else's. Returns {0-based idx: payload}."""
        self.publish(tag, payload)
        peers = sorted(self.node.peers)
        others = await asyncio.gather(
            *(self._pull(p, tag) for p in peers)
        )
        out = {self.idx: payload}
        out.update(dict(zip(peers, others)))
        return out

    # -- sync protocol (ref: dkg/sync/client.go:31-60) ---------------------

    async def sync(self) -> None:
        """Block until all n peers are reachable and agree on the
        definition hash + DKG version."""
        payload = {"version": DKG_VERSION, "def_hash": self.def_hash.hex()}
        got = await self.gather("sync", payload)
        for idx, p in got.items():
            if p.get("version") != DKG_VERSION:
                raise DkgError(
                    f"operator {idx} runs incompatible version {p.get('version')}"
                )
            if p.get("def_hash") != self.def_hash.hex():
                raise DkgError(f"operator {idx} has a different definition")


class TcpFrostPort:
    """frost.run_frost_parallel transport over TcpDkgTransport
    (ref: dkg/frostp2p.go fTransport)."""

    def __init__(self, tx: TcpDkgTransport) -> None:
        self.tx = tx

    async def round1(self, broadcasts, shares):
        tx = self.tx
        # publish per-recipient private share vectors first so peers'
        # pulls can succeed as soon as they reach us
        for share_idx_1b, sh in shares.items():
            to0 = share_idx_1b - 1
            if to0 != tx.idx:
                # THE sealed share channel: served only to its addressee
                # (_on_req private_to gate) over the per-frame AES-GCM
                # transport, mirroring the reference's private libp2p
                # share streams (frostp2p.go)
                # lint: allow(secret-flow)
                tx.publish(f"frost-r1-shares:{to0}", sh, private_to=to0)
        all_b = await tx.gather("frost-r1-bcast", list(broadcasts))
        my_shares = {tx.idx + 1: shares[tx.idx + 1]}
        pulled = await asyncio.gather(
            *(
                tx._pull(p, f"frost-r1-shares:{tx.idx}")
                for p in sorted(tx.node.peers)
            )
        )
        for p, sh in zip(sorted(tx.node.peers), pulled):
            my_shares[p + 1] = sh
        all_bcasts = {
            idx + 1: list(blist) for idx, blist in all_b.items()
        }
        return all_bcasts, my_shares


class TcpExchangePort:
    """ceremony.run_dkg exchange transport (ref: dkg/exchanger.go)."""

    def __init__(self, tx: TcpDkgTransport) -> None:
        self.tx = tx

    async def exchange(self, tag: str, payload) -> dict[int, object]:
        return await self.tx.gather(f"x:{tag}", payload)


async def run_networked_dkg(
    defn,
    node_idx: int,
    k1_privkey,
    peer_addrs: list[tuple[str, int]],
    data_dir=None,
    engine=None,
    timeout: float = 120.0,
):
    """Full networked ceremony: mesh up -> sync -> FROST -> lock
    (ref: dkg/dkg.go:82 Run). peer_addrs: (host, port) per operator in
    index order. Returns ceremony.DKGResult."""
    from charon_tpu_torch.dkg.ceremony import run_dkg
    from charon_tpu_torch.p2p.transport import PeerSpec

    pubkeys = [
        enr.pubkey_from_string(op.enr) for op in defn.operators
    ]
    # refuse to run a ceremony for a definition the operators didn't sign
    defn.verify_signatures(pubkeys)

    specs = [
        PeerSpec(index=i, pubkey=pubkeys[i], host=h, port=p)
        for i, (h, p) in enumerate(peer_addrs)
    ]
    node = P2PNode(node_idx, k1_privkey, specs, defn.definition_hash())
    await node.start()
    try:
        tx = TcpDkgTransport(node, defn, k1_privkey, timeout=timeout)
        await tx.sync()
        return await run_dkg(
            defn,
            node_idx,
            k1_privkey,
            TcpFrostPort(tx),
            TcpExchangePort(tx),
            engine=engine,
            data_dir=data_dir,
        )
    finally:
        await node.stop()
