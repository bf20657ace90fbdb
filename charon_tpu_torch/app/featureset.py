"""Feature flags with rollout statuses.

Mirrors ref: app/featureset/featureset.go:12-40 — features register with a
minimum rollout status (alpha/beta/stable); the configured status enables
every feature at or above it, with explicit enable/disable overrides.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    ALPHA = 0
    BETA = 1
    STABLE = 2


class Feature(str, enum.Enum):
    # Current framework features (the reference's set evolves per release;
    # these are ours).
    AGG_SIG_DB_V2 = "agg_sigdb_v2"
    # Eager-double-linear consensus round timer (ref:
    # app/featureset/featureset.go:32 EagerDoubleLinear; timer semantics
    # in core/qbft.py DoubleEagerLinearRoundTimer).
    EAGER_DOUBLE_LINEAR = "eager_double_linear"
    QBFT_CONSENSUS = "qbft_consensus"
    TPU_BATCH_VERIFY = "tpu_batch_verify"
    JSON_REQUESTS = "json_requests"
    SYNTHETIC_DUTIES = "synthetic_duties"


_STATUSES: dict[Feature, Status] = {
    Feature.AGG_SIG_DB_V2: Status.ALPHA,
    # stable = cluster default, matching ref featureset.go:53
    Feature.EAGER_DOUBLE_LINEAR: Status.STABLE,
    Feature.QBFT_CONSENSUS: Status.STABLE,
    Feature.TPU_BATCH_VERIFY: Status.STABLE,
    Feature.JSON_REQUESTS: Status.BETA,
    # ref: app/eth2wrap/synthproposer.go is test-path-only; alpha here
    Feature.SYNTHETIC_DUTIES: Status.ALPHA,
}

_min_status = Status.STABLE
_enabled: set[Feature] = set()
_disabled: set[Feature] = set()


def init(min_status: Status = Status.STABLE, enable: list[Feature] = (), disable: list[Feature] = ()) -> None:
    """ref: featureset.Init (app/app.go:136)."""
    global _min_status, _enabled, _disabled
    _min_status = min_status
    _enabled = set(enable)
    _disabled = set(disable)


def enabled(feature: Feature) -> bool:
    if feature in _disabled:
        return False
    if feature in _enabled:
        return True
    return _STATUSES.get(feature, Status.ALPHA) >= _min_status
