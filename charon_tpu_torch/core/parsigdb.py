"""ParSigDB: partial-signature store with threshold grouping.

Mirrors ref: core/parsigdb/memory.go — keyed by (duty, pubkey): internal
stores fan out to the exchange component, incoming shares are deduped by
share index with conflict detection (memory.go:145-177), grouped by message
root, and exactly when the t-th matching signature arrives the batch is
emitted to the threshold subscribers (memory.go:198-225).

Batch-first addition: the store emits *duty-level* threshold batches — all
pubkeys of a duty that crossed the threshold in this store call are
delivered together, so sigagg can recombine them in one device program.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Awaitable, Callable

from charon_tpu_torch.core.eth2data import ParSignedData
from charon_tpu_torch.core.types import Duty, PubKey


class SigConflictError(Exception):
    """Same share index submitted two different signatures for one duty —
    byzantine behaviour worth surfacing (ref: memory.go conflict errors).

    The store no longer raises this: a raise mid-batch
    aborted the remaining (honest) pubkeys of the same store call, so one
    double-signed lane could take down a whole peer set. Conflicts are now
    recorded as evidence (first signature wins, `conflicts` counter +
    EvidenceRegistry), and the class stays importable for callers that
    still reference it."""


InternalSub = Callable[[Duty, dict[PubKey, ParSignedData]], Awaitable[None]]
ThresholdSub = Callable[
    [Duty, dict[PubKey, list[ParSignedData]]], Awaitable[None]
]


class ParSigDB:
    def __init__(
        self,
        threshold: int,
        evidence=None,  # core/evidence.EvidenceRegistry; None = unrecorded
        max_pending_per_peer: int = 512,
    ) -> None:
        self.threshold = threshold
        self.evidence = evidence
        # Cap on distinct un-emitted (duty, pubkey) keys ONE share index
        # may hold partials for: without it a byzantine peer streaming
        # valid-format partials for fabricated keys grows the store
        # without limit between trims. Honest peers hold at most
        # (live duties x validators) pending keys at once.
        self.max_pending_per_peer = max_pending_per_peer
        self.conflicts = 0  # double-signed lanes (first wins)
        self.flood_dropped = 0  # partials refused at the pending cap
        # (duty, pubkey) -> share_idx -> ParSignedData
        self._store: dict[tuple[Duty, PubKey], dict[int, ParSignedData]] = (
            defaultdict(dict)
        )
        self._pending_per_peer: dict[int, set[tuple[Duty, PubKey]]] = (
            defaultdict(set)
        )
        self._emitted: set[tuple[Duty, PubKey]] = set()
        self._internal_subs: list[InternalSub] = []
        self._threshold_subs: list[ThresholdSub] = []

    def subscribe_internal(self, sub: InternalSub) -> None:
        self._internal_subs.append(sub)

    def subscribe_threshold(self, sub: ThresholdSub) -> None:
        self._threshold_subs.append(sub)

    # -- stores -----------------------------------------------------------

    async def store_internal(
        self, duty: Duty, signed_set: dict[PubKey, ParSignedData]
    ) -> None:
        """Store our own partial signatures and fan them out to the peers
        via the subscribed exchange (ref: memory.go:57-77).

        Local store FIRST: the node's own partial must survive a failing
        peer exchange (it is one of the t the cluster needs), so the
        store cannot sit downstream of the network call. Exchange
        failures are isolated per sub — they are attributed at their own
        wire() edge and must not erase the completed local store."""
        await self.store_external(duty, signed_set)
        for sub in self._internal_subs:
            try:
                await sub(duty, signed_set)
            except Exception as e:  # noqa: BLE001 — exchange is best-effort
                from charon_tpu_torch.app import log

                log.warn(
                    "partial-signature exchange failed",
                    topic="parsigdb",
                    duty=str(duty),
                    err=f"{type(e).__name__}: {e}",
                )

    async def store_external(
        self, duty: Duty, signed_set: dict[PubKey, ParSignedData]
    ) -> None:
        """Store peer (or local) partials; emit one duty-level batch for
        every pubkey that reached the threshold in this call."""
        ready: dict[PubKey, list[ParSignedData]] = {}
        for pubkey, psig in signed_set.items():
            batch = self._put(duty, pubkey, psig)
            if batch is not None:
                ready[pubkey] = batch
        if ready:
            for sub in self._threshold_subs:
                # isolate: this store may be running inside a PEER's
                # send chain (mem transport); a local aggregation
                # failure is attributed at its own wire() edge and must
                # not cascade back into the sender's pipeline
                try:
                    await sub(duty, ready)
                except Exception as e:  # noqa: BLE001
                    from charon_tpu_torch.app import log

                    log.warn(
                        "threshold subscriber failed",
                        topic="parsigdb",
                        duty=str(duty),
                        err=f"{type(e).__name__}: {e}",
                    )

    def _put(
        self, duty: Duty, pubkey: PubKey, psig: ParSignedData
    ) -> list[ParSignedData] | None:
        key = (duty, pubkey)
        sigs = self._store[key]
        prev = sigs.get(psig.share_idx)
        if prev is not None:
            if prev.data.signature != psig.data.signature:
                # Byzantine double-sign: the share equivocated for this
                # duty/validator. First signature wins; record evidence
                # and CONTINUE — raising here would let one adversarial
                # lane abort the remaining honest pubkeys of the batch.
                self.conflicts += 1
                if self.evidence is not None:
                    self.evidence.record(
                        psig.share_idx,
                        "parsig_conflict",
                        detail=f"{duty}/{pubkey}",
                    )
            return None  # duplicate or conflicting (first wins)
        pending = self._pending_per_peer[psig.share_idx]
        if key not in self._emitted and key not in pending:
            if len(pending) >= self.max_pending_per_peer:
                self.flood_dropped += 1
                if self.evidence is not None:
                    self.evidence.record(
                        psig.share_idx, "parsig_flood"
                    )
                return None
            pending.add(key)
        sigs[psig.share_idx] = psig

        if key in self._emitted:
            return None
        # Group by message root; emit exactly when some root hits t
        # (ref: memory.go:198-225 emits when len == threshold).
        by_root: dict[bytes, list[ParSignedData]] = defaultdict(list)
        for s in sigs.values():
            by_root[s.message_root()].append(s)
        batch = by_root.get(psig.message_root())
        if batch is not None and len(batch) == self.threshold:
            self._emitted.add(key)
            # emitted keys stop counting against every contributor's
            # pending budget
            for peer_pending in self._pending_per_peer.values():
                peer_pending.discard(key)
            return sorted(batch, key=lambda s: s.share_idx)
        return None

    # -- trimming ---------------------------------------------------------

    def trim(self, expired: Duty) -> None:
        self._store = defaultdict(
            dict,
            {k: v for k, v in self._store.items() if k[0] != expired},
        )
        self._emitted = {k for k in self._emitted if k[0] != expired}
        for pending in self._pending_per_peer.values():
            for key in [k for k in pending if k[0] == expired]:
                pending.discard(key)
