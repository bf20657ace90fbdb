"""SigAgg: threshold aggregation of partial signatures — the hot path.

Mirrors ref: core/sigagg/sigagg.go:84-122 (Lagrange recombination via
tbls.ThresholdAggregate, then verification of the recovered group
signature, sigagg.go:117) — but batch-first: a whole duty's pubkeys are
recombined in ONE device program and verified in ONE device program via
the tbls batch API, instead of the reference's per-pubkey herumi calls.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Awaitable, Callable, Mapping

from charon_tpu_torch import tbls
from charon_tpu_torch.core.eth2data import ParSignedData, SignedData
from charon_tpu_torch.core.types import Duty, PubKey, pubkey_to_bytes
from charon_tpu_torch.eth2util.signing import ForkInfo

AggSub = Callable[[Duty, dict[PubKey, SignedData]], Awaitable[None]]


class AggregationError(Exception):
    pass


@dataclass
class SigAgg:
    """threshold: cluster threshold t; fork/epoch context for signing roots.

    plane + pubshares_by_idx (both or neither): route recombination AND
    group verification through the core.cryptoplane.SlotCoalescer — one
    sharded device program per coalescing window, merged with every other
    duty's concurrent work. Without a plane, the tbls batch API executes
    this duty's batch alone (still one program per duty, the round-2
    design)."""

    threshold: int
    fork: ForkInfo
    slots_per_epoch: int = 32
    plane: object | None = None  # core.cryptoplane.SlotCoalescer
    pubshares_by_idx: Mapping[int, Mapping[PubKey, bytes]] | None = None
    # optional core.deadline.SlotClock: plane submissions carry the
    # duty's expiry so the coalescer's adaptive window shrinks instead
    # of overshooting a near-deadline aggregation
    clock: object | None = None
    # optional core/evidence.EvidenceRegistry: lanes from peers with
    # equivocation-class evidence (EXCLUSION_KINDS) are excluded from
    # recombination while >= threshold clean lanes remain — the per-peer
    # quarantine primitive applied to the aggregation path
    evidence: object | None = None

    def __post_init__(self) -> None:
        self._subs: list[AggSub] = []
        self.excluded_lanes = 0  # partials dropped on evidence
        self.exclusion_fallbacks = 0  # exclusions waived for liveness

    def subscribe(self, sub: AggSub) -> None:
        self._subs.append(sub)

    async def aggregate(
        self, duty: Duty, batch: Mapping[PubKey, list[ParSignedData]]
    ) -> None:
        if not batch:
            return
        epoch = duty.slot // self.slots_per_epoch

        excluded = (
            self.evidence.excluded_shares()
            if self.evidence is not None
            else ()
        )

        pubkeys: list[PubKey] = []
        partial_maps: list[dict[int, bytes]] = []
        templates: list[ParSignedData] = []
        for pubkey, psigs in batch.items():
            if len(psigs) < self.threshold:
                raise AggregationError(
                    f"insufficient partial signatures for {duty}/{pubkey}"
                )
            use = psigs
            if excluded:
                clean = [
                    p for p in psigs if p.share_idx not in excluded
                ]
                if len(clean) >= self.threshold:
                    self.excluded_lanes += len(psigs) - len(clean)
                    use = clean
                else:
                    # liveness over suspicion: with fewer than t clean
                    # lanes the duty would fail outright — recombine from
                    # what arrived and let group verification arbitrate
                    # (>= t honest peers always supply t clean lanes when
                    # adversaries <= f, so this fires only under extra
                    # crash/partition faults)
                    self.exclusion_fallbacks += 1
            use = use[: self.threshold]
            pubkeys.append(pubkey)
            partial_maps.append(
                {p.share_idx: p.data.signature for p in use}
            )
            templates.append(use[0])

        if self.plane is not None and self.pubshares_by_idx is not None:
            group_sigs = await self._aggregate_via_plane(
                duty, epoch, pubkeys, partial_maps, templates
            )
        else:
            # plane-less rung: deliberately INLINE (see ValidatorAPI.
            # _check_batch — the executor hop GIL-convoys the loop and
            # distorts duty timing); production wires the plane, and
            # the overload-shed branch in _aggregate_via_plane runs
            # off-loop where it matters
            group_sigs = self._aggregate_via_tbls(  # lint: allow(event-loop-blocking)
                epoch, pubkeys, partial_maps, templates
            )

        out = {
            pk: tmpl.data.with_signature(sig)
            for pk, tmpl, sig in zip(pubkeys, templates, group_sigs)
        }
        for sub in self._subs:
            await sub(duty, out)

    def _aggregate_via_tbls(
        self, epoch, pubkeys, partial_maps, templates
    ) -> list[bytes]:
        # ONE device program recombines every pubkey's partials
        # (ref equivalent: sigagg.go:104 per-pubkey tbls.ThresholdAggregate).
        group_sigs = tbls.threshold_aggregate_batch(partial_maps)

        # ONE device program verifies all recovered signatures
        # (ref equivalent: sigagg.go:117 per-pubkey verify).
        items = []
        for pubkey, template, sig in zip(pubkeys, templates, group_sigs):
            root = template.data.signing_root(self.fork, epoch)
            items.append((pubkey_to_bytes(pubkey), root, sig))
        ok = tbls.verify_batch(items)
        bad = [str(pk) for pk, o in zip(pubkeys, ok) if not o]
        if bad:
            raise AggregationError(
                f"recovered group signature failed verification for {bad}"
            )
        return group_sigs

    async def _aggregate_via_plane(
        self, duty, epoch, pubkeys, partial_maps, templates
    ) -> list[bytes]:
        # One [V, t] recombine+verify job; the coalescer merges it with
        # any other duty's job in the same window into ONE sharded
        # program (recombination, per-partial verify against pubshares,
        # and group-sig verify all inside — SlotCryptoPlane.local_step).
        ps_rows, roots, sig_rows, gpks, idx_rows = [], [], [], [], []
        for pubkey, template, pmap in zip(pubkeys, templates, partial_maps):
            idx = sorted(pmap)
            try:
                ps_rows.append(
                    [self.pubshares_by_idx[i][pubkey] for i in idx]
                )
            except KeyError as e:
                raise AggregationError(
                    f"no pubshare for {pubkey} share {e}"
                ) from e
            roots.append(template.data.signing_root(self.fork, epoch))
            sig_rows.append([pmap[i] for i in idx])
            gpks.append(pubkey_to_bytes(pubkey))
            idx_rows.append(idx)
        kwargs = {}
        if self.clock is not None:
            kwargs["deadline"] = self.clock.duty_deadline(duty)
        from charon_tpu_torch.core.cryptosvc import PlaneOverloadError

        try:
            group_sigs, ok = await self.plane.recombine(
                ps_rows, roots, sig_rows, gpks, idx_rows, **kwargs
            )
        except PlaneOverloadError:
            # admission shed (core/cryptosvc backpressure): recombine
            # THIS duty on the host tbls rung, on an executor thread —
            # the aggregation ladder absorbs shed load instead of
            # failing the duty, and the host pairing math never stalls
            # the event loop
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None,
                self._aggregate_via_tbls,
                epoch, pubkeys, partial_maps, templates,
            )
        bad = [str(pk) for pk, o in zip(pubkeys, ok) if not o]
        if bad:
            raise AggregationError(
                f"recovered group signature failed verification for {bad}"
            )
        return group_sigs
