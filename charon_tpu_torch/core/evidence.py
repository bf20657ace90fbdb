"""Attributable Byzantine-behaviour evidence.

One registry per node collects every Byzantine detection made by the
protocol components (qbft equivocation/floods, forged justifications,
conflicting or spoofed partial signatures), keyed by the offending
peer and an evidence kind. Evidence must name ONLY the adversary, so every recording site authenticates
the peer it attributes (message signature or channel identity) before
calling `record`.

The registry feeds two sinks:
  * `app/metrics.py byzantine_hook()` — the `byzantine_evidence_total
    {peer,kind}` counter family, the operator-facing damage ledger;
  * `sigagg` lane exclusion — peers with equivocation-class evidence
    (EXCLUSION_KINDS) are dropped from recombination lanes while enough
    clean partials remain, the per-peer quarantine primitive applied to
    the aggregation path.

Kind strings are shared constants; `core/qbft.py` deliberately emits
the same literals without importing this module (the engine stays
dependency-free — its Definition carries a plain `on_evidence`
callback).
"""

from __future__ import annotations

from typing import Callable, Iterable

# QBFT engine / adapter detections
QBFT_EQUIVOCATION = "qbft_equivocation"  # two msgs in one (type, round) slot
QBFT_FLOOD = "qbft_flood"  # per-sender stored-message bound hit
QBFT_REPLAY = "qbft_replay"  # cross-instance / spoofed-channel delivery
QBFT_MALFORMED = "qbft_malformed"  # structural protocol violation
QBFT_FORGED_JUSTIFICATION = "qbft_forged_justification"  # bad piggybacked sigs

# Partial-signature path detections
PARSIG_CONFLICT = "parsig_conflict"  # double-signed duty/validator
PARSIG_FLOOD = "parsig_flood"  # per-peer pending-set cap hit
PARSIG_INVALID = "parsig_invalid"  # signature verification failed
PARSIG_SPOOF = "parsig_spoof"  # set claiming another peer's share index

# Evidence kinds that prove the peer actively equivocated (not merely
# flooded or delivered garbage): these exclude the peer's lanes from
# sigagg recombination while enough clean partials remain.
EXCLUSION_KINDS = frozenset(
    {QBFT_EQUIVOCATION, PARSIG_CONFLICT, PARSIG_SPOOF}
)

# hook(peer, kind) or hook(peer, kind, detail) — the registry detects
# the arity once at construction (the flight recorder wants
# the free-text detail; the metrics counter hook never did, and every
# existing 2-arg hook keeps working unchanged)
EvidenceHook = Callable[..., None]


def _accepts_detail(hook) -> bool:
    import inspect

    try:
        params = list(inspect.signature(hook).parameters.values())
    except (TypeError, ValueError):
        return False
    positional = [
        p
        for p in params
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len(positional) >= 3


class EvidenceRegistry:
    """Per-node ledger of attributed Byzantine detections.

    `peer` is an opaque identity — the cluster convention is the
    1-based share index everywhere a share index exists (parsig path,
    consensus adapter), and the raw 0-based engine index in pure-qbft
    harnesses. Peers come from authenticated identities, so the key
    space is bounded by the cluster size times the kind catalogue; the
    `max_keys` cap is a defensive backstop, never hit by honest wiring.
    """

    def __init__(
        self, hook: EvidenceHook | None = None, max_keys: int = 4096
    ) -> None:
        self._hook = hook
        self._hook_detail = hook is not None and _accepts_detail(hook)
        self._max_keys = max_keys
        self._counts: dict[tuple[object, str], int] = {}

    def record(self, peer: object, kind: str, detail: str = "") -> None:
        key = (peer, kind)
        n = self._counts.get(key)
        if n is None and len(self._counts) >= self._max_keys:
            return
        self._counts[key] = (n or 0) + 1
        if self._hook is not None:
            if self._hook_detail:
                self._hook(peer, kind, detail)
            else:
                self._hook(peer, kind)

    def count(self, peer: object = None, kind: str | None = None) -> int:
        return sum(
            n
            for (p, k), n in self._counts.items()
            if (peer is None or p == peer) and (kind is None or k == kind)
        )

    def peers(self, kinds: Iterable[str] | None = None) -> set:
        """Peers with any recorded evidence (optionally of given kinds)."""
        wanted = None if kinds is None else set(kinds)
        return {
            p
            for (p, k), n in self._counts.items()
            if n and (wanted is None or k in wanted)
        }

    def excluded_shares(self) -> set:
        """Peers whose lanes sigagg must exclude before recombination."""
        return self.peers(EXCLUSION_KINDS)

    def snapshot(self) -> dict[tuple[object, str], int]:
        return dict(self._counts)
