"""Tracker: per-duty failure detection, partial-signature consistency,
and peer participation.

Mirrors ref: core/tracker — every workflow component emits an event per
duty step (step enum tracker.go:20-34); when the Deadliner expires a duty
the tracker determines the first failing step and a reason
(tracker.go:154, reasons reason.go), groups the observed partial
signatures by message root per pubkey to detect inconsistent partials
(tracker.go:59-71 parsigsByMsg + MsgRootsConsistent, metrics.go:85
inconsistent_parsigs_total), and reports per-peer participation counts
plus UNEXPECTED peers — shares that submitted partials for a duty that
was never scheduled for that validator (tracker.go:539-573
analyseParticipation).

Wiring: `tracking(tracker)` is a wire() option that wraps every
subscription edge (ref: core/tracking.go wraps via core.WithTracking).
"""

from __future__ import annotations

import enum
import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from charon_tpu_torch.core.types import Duty, DutyType, PubKey


class Step(enum.IntEnum):
    """Workflow steps in pipeline order (ref: core/tracker/tracker.go:20)."""

    SCHEDULER = 0
    FETCHER = 1
    CONSENSUS = 2
    DUTY_DB = 3
    VALIDATOR_API = 4
    PARSIG_DB_INTERNAL = 5
    PARSIG_EX = 6
    PARSIG_DB_THRESHOLD = 7
    SIG_AGG = 8
    AGG_SIG_DB = 9
    BCAST = 10
    # post-broadcast on-chain verification, fed by the InclusionChecker
    # (ref: tracker.go chainInclusion step + InclusionChecked input)
    CHAIN_INCLUSION = 11

    def __str__(self) -> str:
        return self.name.lower()


# Map wire() edge names to the steps their completion proves. An edge
# firing proves the *previous* step delivered (e.g. fetcher.fetch being
# invoked proves the scheduler emitted the duty).
_EDGE_STEPS: dict[str, tuple[Step, ...]] = {
    "fetcher.fetch": (Step.SCHEDULER, Step.FETCHER),
    "consensus.propose": (Step.CONSENSUS,),
    "dutydb.store": (Step.DUTY_DB,),
    "parsigdb.store_internal": (Step.VALIDATOR_API, Step.PARSIG_DB_INTERNAL),
    "parsigex.broadcast": (Step.PARSIG_EX,),
    "parsigdb.store_external": (Step.PARSIG_EX,),
    "sigagg.aggregate": (Step.PARSIG_DB_THRESHOLD, Step.SIG_AGG),
    "aggsigdb.store": (Step.AGG_SIG_DB,),
    "broadcaster.broadcast": (Step.BCAST,),
}


class Reason(str, enum.Enum):
    """Failure reasons with ref-parity codes (ref: core/tracker/reason.go
    — each reason there carries Code/Short/Long; the enum VALUE here is
    the code, `describe()` the operator-facing text)."""

    NOT_SCHEDULED = "not_scheduled"
    FETCH_BN_ERROR = "fetch_bn_error"
    FETCH_FAILED = "bug_fetch_error"
    RANDAO_FAILED = "randao_failed"
    PREPARE_AGGREGATOR_FAILED = "prepare_aggregator_failed"
    PREPARE_SYNC_CONTRIBUTION_FAILED = "prepare_sync_contribution_failed"
    NO_CONSENSUS = "no_consensus"
    NO_LOCAL_PARTIAL = "no_local_vc_signature"
    NO_PEER_SIGNATURES = "no_peer_signatures"
    INSUFFICIENT_PARTIALS = "insufficient_peer_signatures"
    PARSIG_INCONSISTENT = "bug_par_sig_db_inconsistent"
    PARSIG_INCONSISTENT_SYNC = "par_sig_db_inconsistent_sync"
    AGGREGATION_FAILED = "bug_sig_agg"
    BROADCAST_FAILED = "broadcast_bn_error"
    NOT_INCLUDED = "not_included_onchain"
    UNKNOWN = "unknown"

    def describe(self) -> str:
        return _REASON_TEXT[self]


_REASON_TEXT = {
    Reason.NOT_SCHEDULED: "duty was never scheduled",
    Reason.FETCH_BN_ERROR: "the beacon node returned an error fetching duty data",
    Reason.FETCH_FAILED: "failed to fetch duty data from the beacon node",
    Reason.RANDAO_FAILED: "the proposal could not be fetched because the randao duty failed",
    Reason.PREPARE_AGGREGATOR_FAILED: "the aggregation could not start because the prepare-aggregator duty failed",
    Reason.PREPARE_SYNC_CONTRIBUTION_FAILED: "the contribution could not start because the prepare-sync-contribution duty failed",
    Reason.NO_CONSENSUS: "consensus was not reached",
    Reason.NO_LOCAL_PARTIAL: "validator client did not submit a partial signature",
    Reason.NO_PEER_SIGNATURES: "no partial signatures received from peers",
    Reason.INSUFFICIENT_PARTIALS: "insufficient partial signatures from peers",
    Reason.PARSIG_INCONSISTENT: "bug: inconsistent partial signatures received",
    Reason.PARSIG_INCONSISTENT_SYNC: "known limitation: inconsistent sync committee signatures received",
    Reason.AGGREGATION_FAILED: "threshold aggregation or verification failed",
    Reason.BROADCAST_FAILED: "failed to broadcast to the beacon node",
    Reason.NOT_INCLUDED: "broadcast duty was never included on-chain",
    Reason.UNKNOWN: "unexpected failure",
}


_FAIL_REASONS = {
    Step.SCHEDULER: Reason.NOT_SCHEDULED,
    Step.FETCHER: Reason.FETCH_FAILED,
    Step.CONSENSUS: Reason.NO_CONSENSUS,
    Step.DUTY_DB: Reason.NO_LOCAL_PARTIAL,
    Step.VALIDATOR_API: Reason.NO_LOCAL_PARTIAL,
    Step.PARSIG_DB_INTERNAL: Reason.INSUFFICIENT_PARTIALS,
    Step.PARSIG_EX: Reason.NO_PEER_SIGNATURES,
    Step.PARSIG_DB_THRESHOLD: Reason.INSUFFICIENT_PARTIALS,
    Step.SIG_AGG: Reason.AGGREGATION_FAILED,
    Step.AGG_SIG_DB: Reason.AGGREGATION_FAILED,
    Step.BCAST: Reason.BROADCAST_FAILED,
    Step.CHAIN_INCLUSION: Reason.NOT_INCLUDED,
}

# Duty types whose partial signatures legitimately disagree across peers
# (each sync-committee member may see a different head — ref: tracker.go
# expectInconsistentParSigs).
_EXPECT_INCONSISTENT = {DutyType.SYNC_MESSAGE, DutyType.SYNC_CONTRIBUTION}

# VC-triggered duties with no locally scheduled definition — their
# partials can never be classified unexpected (ref: tracker.go
# isParSigEventExpected: DutyExit / DutyBuilderRegistration).
_UNSCHEDULED_TYPES = {
    DutyType.EXIT,
    DutyType.BUILDER_REGISTRATION,
    DutyType.SIGNATURE,
}

# Terminal step per duty type: most duties end at broadcast, but the
# internal aggregate-only duties (randao, the two selection-proof
# prepares) complete at the aggregate store and never broadcast
# (ref: tracker.go step expectations per duty type).
_TERMINAL_STEPS = {
    DutyType.RANDAO: Step.AGG_SIG_DB,
    DutyType.PREPARE_AGGREGATOR: Step.AGG_SIG_DB,
    DutyType.PREPARE_SYNC_CONTRIBUTION: Step.AGG_SIG_DB,
    # protocol-internal negotiation completes at consensus decision
    # (its value never enters the signing pipeline)
    DutyType.INFO_SYNC: Step.CONSENSUS,
}

# Duties whose fetch depends on a prerequisite duty in the same slot
# (ref: tracker.go analyseFetcherFailedProposer/-Aggregator/-SyncContribution).
_FETCH_PREREQ = {
    DutyType.PROPOSER: (DutyType.RANDAO, Reason.RANDAO_FAILED),
    DutyType.AGGREGATOR: (
        DutyType.PREPARE_AGGREGATOR,
        Reason.PREPARE_AGGREGATOR_FAILED,
    ),
    DutyType.SYNC_CONTRIBUTION: (
        DutyType.PREPARE_SYNC_CONTRIBUTION,
        Reason.PREPARE_SYNC_CONTRIBUTION_FAILED,
    ),
}
_PREREQ_TYPES = frozenset(p for p, _ in _FETCH_PREREQ.values())


@dataclass
class DutyReport:
    duty: Duty
    success: bool
    failed_step: Step | None
    reason: Reason | None
    participation: dict[int, bool]  # share_idx -> partial sig seen
    errors: list[str] = field(default_factory=list)
    # per-share dedup'd (pubkey, share) participation counts and the
    # expected count per peer (== number of scheduled validators)
    participation_counts: dict[int, int] = field(default_factory=dict)
    expected_per_peer: int = 0
    # share_idx -> number of partials for validators with no scheduled
    # duty (ref: analyseParticipation unexpectedShares)
    unexpected_shares: dict[int, int] = field(default_factory=dict)
    # pubkeys whose partials arrived under more than one message root
    inconsistent_pubkeys: list[PubKey] = field(default_factory=list)
    # per-validator attribution (ref: the reference tracks events per
    # (duty, pubkey) and reports each validator's failure separately):
    # expected pubkeys whose partial signatures never reached the
    # cluster threshold — populated even when the duty as a whole
    # succeeded for the other validators (partial success)
    failed_pubkeys: dict[PubKey, Reason] = field(default_factory=dict)
    # the duty's deterministic trace id (app/tracer.duty_trace_id):
    # the report's handle into /debug/traces and /debug/duty/<slot>
    trace_id: str = ""


ReportSub = Callable[[DutyReport], Awaitable[None] | None]


def _parsig_root(psig) -> bytes:
    """Message root of a ParSignedData for consistency grouping —
    delegates to the object's own message_root() (also used by parsigdb
    when grouping the same partial). The fallback digests ONLY the kind
    and payload: hashing anything containing the per-share signature
    would give every peer a unique root and flag consistent duties as
    inconsistent."""
    try:
        return psig.message_root()
    except Exception:  # noqa: BLE001 — never let tracking break the flow
        import hashlib

        sd = getattr(psig, "data", psig)
        return hashlib.sha256(
            repr((getattr(sd, "kind", None), getattr(sd, "payload", sd))).encode()
        ).digest()


class Tracker:
    """threshold/peers: for participation accounting."""

    def __init__(
        self, peer_share_indices: list[int], threshold: int | None = None
    ) -> None:
        self.peer_share_indices = list(peer_share_indices)
        # partial-signature count an expected validator needs; defaults
        # to the BFT quorum of the peer count
        self.threshold = threshold or math.ceil(
            2 * len(peer_share_indices) / 3
        )
        self._steps: dict[Duty, set[Step]] = defaultdict(set)
        self._errors: dict[Duty, list[str]] = defaultdict(list)
        # duty -> pubkey -> msg root -> set of share indices
        # (ref: tracker.go parsigsByMsg)
        self._parsigs: dict[Duty, dict[PubKey, dict[bytes, set[int]]]] = (
            defaultdict(lambda: defaultdict(lambda: defaultdict(set)))
        )
        # duty -> pubkeys with a locally scheduled definition
        self._expected: dict[Duty, set[PubKey]] = defaultdict(set)
        # outcome memory for prerequisite analysis (randao -> proposer):
        # expiry order within a slot is not guaranteed, so both failure
        # AND success of already-analysed prerequisites are remembered
        self._failed_steps: dict[Duty, Step] = {}
        self._completed: dict[Duty, None] = {}  # insertion-ordered set
        self._subs: list[ReportSub] = []
        # counters (exported through app/metrics + monitoring endpoint)
        self.failed_total: dict[tuple, int] = defaultdict(int)
        self.success_total: dict[Duty, int] = {}
        self.participation_total: dict[int, int] = defaultdict(int)
        self.inconsistent_total: dict[DutyType, int] = defaultdict(int)
        self.unexpected_total: dict[int, int] = defaultdict(int)
        self.inclusion_included_total: dict[DutyType, int] = defaultdict(int)
        self.inclusion_missed_total: dict[DutyType, int] = defaultdict(int)
        self.pubkey_failures_total: dict[DutyType, int] = defaultdict(int)

    def subscribe(self, sub: ReportSub) -> None:
        self._subs.append(sub)

    # -- event intake -----------------------------------------------------

    def step_event(self, duty: Duty, step: Step) -> None:
        self._steps[duty].add(step)

    def step_failed(self, duty: Duty, step: Step, err: Exception) -> None:
        self._errors[duty].append(f"{step}: {err}")

    def duty_scheduled(self, duty: Duty, pubkeys) -> None:
        """Record which validators this duty was scheduled for — the
        baseline for unexpected-peer detection."""
        self._expected[duty].update(pubkeys)

    def partial_observed(
        self, duty: Duty, share_idx: int, pubkey=None, root: bytes | None = None
    ) -> None:
        self._parsigs[duty][pubkey][root or b""].add(share_idx)

    def inclusion_checked(self, duty: Duty, pubkey, included: bool) -> None:
        """Post-broadcast on-chain result from the InclusionChecker.

        Arrives up to INCL_MISSED_LAG slots after the duty — long past its
        deadline analysis — so it feeds the standalone chain-inclusion
        counters rather than the per-duty report (ref: tracker.go:815
        InclusionChecked feeds a chainInclusion step event).
        """
        if included:
            self.inclusion_included_total[duty.type] += 1
        else:
            self.inclusion_missed_total[duty.type] += 1
            # same (type, step) key shape as every other failed_total
            # write — consumers unpack 2-tuples (app/run.py health
            # sampler); the reason is implied by the step
            self.failed_total[(duty.type, Step.CHAIN_INCLUSION)] += 1

    # -- analysis at duty expiry (ref: tracker.go:147-163) ----------------

    def _prereq_failed(self, prereq: Duty) -> bool:
        """Whether a prerequisite duty failed, robust to expiry ORDER:
        duties in a slot share one deadline and the proposer can expire
        before its randao — so when the prerequisite hasn't been analysed
        yet, judge its LIVE event set (events are final by now: both
        duties' deadlines have passed)."""
        if prereq in self._completed:
            return False
        if prereq in self._failed_steps:
            return True
        steps = self._steps.get(prereq)
        terminal = _TERMINAL_STEPS.get(prereq.type, Step.BCAST)
        if steps is not None:
            return terminal not in steps
        # no events at all: the prerequisite never even started — that IS
        # a prerequisite failure (ref: dutyFailedStep(empty) == failed)
        return True

    async def duty_expired(self, duty: Duty) -> DutyReport:
        steps = self._steps.pop(duty, set())
        parsigs = self._parsigs.pop(duty, {})
        expected = self._expected.pop(duty, set())
        errors = self._errors.pop(duty, [])
        terminal = _TERMINAL_STEPS.get(duty.type, Step.BCAST)
        success = terminal in steps

        # parsig consistency: more than one message root for one pubkey
        # (ref: parsigsByMsg.MsgRootsConsistent)
        inconsistent = [
            pk for pk, roots in parsigs.items() if len(roots) > 1
        ]
        if inconsistent:
            self.inconsistent_total[duty.type] += 1

        # participation + unexpected peers (ref: analyseParticipation):
        # dedup by (pubkey, share); a partial for a pubkey with no
        # scheduled definition is unexpected rather than participation
        counts: dict[int, int] = defaultdict(int)
        unexpected: dict[int, int] = defaultdict(int)
        check_unexpected = (
            duty.type not in _UNSCHEDULED_TYPES and expected
        )
        for pk, roots in parsigs.items():
            shares = set().union(*roots.values())
            if check_unexpected and pk is not None and pk not in expected:
                for idx in shares:
                    unexpected[idx] += 1
                    self.unexpected_total[idx] += 1
                continue
            for idx in shares:
                counts[idx] += 1
        participation = set(counts)

        failed_step = None
        reason = None
        if not success:
            # first pipeline step (up to this duty type's terminal step)
            # that never happened
            for step in Step:
                if step > terminal:
                    break
                if step not in steps:
                    failed_step = step
                    reason = _FAIL_REASONS.get(step, Reason.UNKNOWN)
                    break
            # refinement: threshold/aggregation failures with
            # inconsistent partials are a distinct (bug-class) reason —
            # except sync-committee duties where disagreement is expected
            if (
                failed_step
                in (Step.PARSIG_DB_THRESHOLD, Step.SIG_AGG)
                and inconsistent
            ):
                reason = (
                    Reason.PARSIG_INCONSISTENT_SYNC
                    if duty.type in _EXPECT_INCONSISTENT
                    else Reason.PARSIG_INCONSISTENT
                )
            # refinement: an error recorded at the fetch step is the
            # beacon node failing us (infrastructure), a silent stall is
            # the bug-class reason (ref: analyseFetcherFailed)
            if failed_step == Step.FETCHER and any(
                e.startswith(str(Step.FETCHER)) for e in errors
            ):
                reason = Reason.FETCH_BN_ERROR
            # refinement: a fetch-stage failure of a dependent duty is
            # attributed to its failed prerequisite (randao -> proposer);
            # takes precedence over the BN-error classification, matching
            # ref analyseFetcherFailedProposer
            if failed_step == Step.FETCHER and duty.type in _FETCH_PREREQ:
                prereq_type, prereq_reason = _FETCH_PREREQ[duty.type]
                if self._prereq_failed(Duty(duty.slot, prereq_type)):
                    reason = prereq_reason
            self.failed_total[(duty.type, failed_step)] += 1
            self._failed_steps[duty] = failed_step
            # bounded memory: only same-slot prerequisites consult this
            if len(self._failed_steps) > 1024:
                for k in list(self._failed_steps)[:512]:
                    self._failed_steps.pop(k, None)
        elif duty.type in _PREREQ_TYPES:
            self._completed[duty] = None
            # FIFO eviction, mirroring _failed_steps above
            if len(self._completed) > 1024:
                for k in list(self._completed)[:512]:
                    self._completed.pop(k, None)

        part_map = {
            idx: idx in participation for idx in self.peer_share_indices
        }
        for idx in participation:
            self.participation_total[idx] += 1

        # per-validator attribution: once the signing phase started
        # (duty data stored), every expected pubkey should assemble a
        # threshold of partials — those that did not are reported
        # individually, including under a duty-level success (partial
        # success: some validators signed, this one did not)
        pubkey_failures: dict[PubKey, Reason] = {}
        if expected and Step.DUTY_DB in steps:
            for pk in expected:
                roots = parsigs.get(pk)
                if not roots:
                    pubkey_failures[pk] = Reason.NO_LOCAL_PARTIAL
                    continue
                # aggregation needs a threshold of shares on ONE message
                # root — a union across conflicting roots can never
                # aggregate, so count per root
                best = max(len(s) for s in roots.values())
                total = len(set().union(*roots.values()))
                if best >= self.threshold:
                    continue
                if total >= self.threshold:
                    # enough shares overall but split across roots
                    pubkey_failures[pk] = (
                        Reason.PARSIG_INCONSISTENT_SYNC
                        if duty.type in _EXPECT_INCONSISTENT
                        else Reason.PARSIG_INCONSISTENT
                    )
                else:
                    pubkey_failures[pk] = Reason.INSUFFICIENT_PARTIALS
        if pubkey_failures:
            self.pubkey_failures_total[duty.type] += len(pubkey_failures)

        from charon_tpu_torch.app.tracer import duty_trace_id  # lazy: core !-> app

        report = DutyReport(
            duty=duty,
            success=success,
            failed_step=failed_step,
            reason=reason,
            participation=part_map,
            errors=errors,
            participation_counts=dict(counts),
            expected_per_peer=len(expected),
            unexpected_shares=dict(unexpected),
            inconsistent_pubkeys=inconsistent,
            failed_pubkeys=pubkey_failures,
            trace_id=duty_trace_id(duty),
        )
        for sub in self._subs:
            res = sub(report)
            if hasattr(res, "__await__"):
                await res
        return report


def tracking(tracker: Tracker):
    """wire() option emitting tracker events around every edge
    (ref: core/tracking.go + core.WithTracking)."""

    def option(name: str, fn):
        steps = _EDGE_STEPS.get(name)
        if steps is None:
            return fn

        async def wrapped(duty, *args, **kwargs):
            try:
                result = await fn(duty, *args, **kwargs)
            except Exception as e:
                tracker.step_failed(duty, steps[-1], e)
                # The edge being INVOKED already proves its input-side
                # steps (e.g. a VC submitting partials proves
                # VALIDATOR_API even when the store's downstream fan-out
                # raises) — without this, one transient peer error
                # cascades back through the awaited chain and the
                # tracker misattributes the duty one step too early.
                for step in steps[:-1]:
                    tracker.step_event(duty, step)
                raise
            for step in steps:
                tracker.step_event(duty, step)
            if name == "fetcher.fetch" and args and hasattr(args[0], "keys"):
                tracker.duty_scheduled(duty, args[0].keys())
            if name in ("parsigdb.store_external", "parsigdb.store_internal") and args:
                for pubkey, psig in args[0].items():
                    tracker.partial_observed(
                        duty,
                        psig.share_idx,
                        pubkey=pubkey,
                        root=_parsig_root(psig),
                    )
            return result

        return wrapped

    return option
