"""Byzantine adversary harness: seeded attack strategies against the
consensus and partial-signature planes, with differential device-vs-
oracle conformance checking and attributable evidence assertions.

The chaos plane (`testutil/chaos.py`) injects *accidental* faults —
drops, delays, crashes. This module injects *adversarial* behaviour:
equivocation, forged justifications, replay, floods, double-signing,
selective sends — the f-bounded Byzantine model the protocol claims to
tolerate (QBFT, arXiv:2002.03613: safety and liveness with up to
floor((n-1)/3) arbitrary faults). Three layers:

  * **Pure-QBFT harness** — `HarnessSigner` (seeded symmetric MACs
    standing in for the k1 message signatures, so `is_valid` /
    `verify_sender` semantics are real without the `cryptography`
    dependency), `ByzantineNet` (honest-node transports + adversarial
    injection + full broadcast capture), and `run_with_adversary`
    driving `core/qbft.run` engines for the honest set while an attack
    coroutine plays the adversary nodes. Everything derives from one
    `AdversaryParams.seed`.
  * **Differential conformance** — `DifferentialTbls` wraps the active
    tbls backend and re-checks every verify / recombine verdict
    lane-by-lane against the pure-python oracle (`PythonImpl`), so a
    device-plane bug that only manifests under adversarial inputs
    (forged G2 encodings, mixed valid/invalid lanes) is caught as a
    mismatch, not silently absorbed. Zero mismatches is a gate.
  * **Invariant helpers** — `assert_agreement` (safety: no two honest
    nodes decide different values), `assert_evidence_only` (every
    evidence entry names an adversary, never an honest peer), and
    `assert_no_mismatches`.

Determinism: adversary schedules draw from `Random(f"byz:{seed}:…")`
substreams; leader election uses `deterministic_leader` (sha256-based —
`hash()` is PYTHONHASHSEED-dependent and must not pick leaders in a
seeded battery).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import hmac
import random
from dataclasses import dataclass, replace

from charon_tpu_torch import tbls
from charon_tpu_torch.core import qbft
from charon_tpu_torch.core.evidence import EvidenceRegistry
from charon_tpu_torch.core.qbft import Definition, Msg, MsgType, Transport

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdversaryParams:
    """One seed drives the whole scenario: adversary identity, message
    schedules, and payload contents. `f` adversaries are the HIGHEST
    node indices (0-based) so round-1 leadership of a given instance
    stays searchable via `find_instance` without excluding seeds."""

    seed: int
    n: int = 4
    t: int = 3
    f: int = 1

    @property
    def adversaries(self) -> tuple[int, ...]:
        return tuple(range(self.n - self.f, self.n))

    @property
    def honest(self) -> tuple[int, ...]:
        return tuple(range(self.n - self.f))

    def stream(self, label: str) -> random.Random:
        """Deterministic substream per (seed, label), mirroring
        ChaosConfig.stream — injectors never perturb each other."""
        return random.Random(f"byz:{self.seed}:{label}")


def deterministic_leader(n: int):
    """Round-robin leader seeded by a *stable* hash of the instance.
    `hash()` would vary per process (PYTHONHASHSEED), silently changing
    which node leads and voiding seed-reproducibility."""

    def leader(instance, rnd: int) -> int:
        h = int.from_bytes(
            hashlib.sha256(repr(instance).encode()).digest()[:8], "big"
        )
        return (h + rnd) % n

    return leader


def find_instance(
    n: int, rnd: int, want_leader: int, prefix: str = "inst", limit: int = 512
) -> str:
    """Smallest `f"{prefix}-{i}"` whose round-`rnd` leader under
    `deterministic_leader(n)` is `want_leader` — lets a scenario cast a
    specific node (usually the adversary) as leader without touching
    the election rule itself."""
    leader = deterministic_leader(n)
    for i in range(limit):
        inst = f"{prefix}-{i}"
        if leader(inst, rnd) == want_leader:
            return inst
    raise AssertionError(
        f"no instance with leader {want_leader} at round {rnd} in {limit} tries"
    )


# ---------------------------------------------------------------------------
# Message authentication for the pure harness
# ---------------------------------------------------------------------------


class HarnessSigner:
    """Seeded per-node MAC keys standing in for the production k1
    message signatures (p2p path needs `cryptography`, absent here).
    The *semantics* match: `verify_sender` checks only the outer
    signature; `is_valid` additionally recurses into piggybacked
    justifications — exactly the split `_Engine._accept` relies on to
    attribute evidence safely. The harness knows every key, so an
    adversary can sign its OWN messages but can only `forge` garbage
    for another node's identity (tests never sign as honest nodes)."""

    def __init__(self, n: int, seed: int) -> None:
        self._keys = [
            hashlib.sha256(f"byz-key:{seed}:{i}".encode()).digest()
            for i in range(n)
        ]

    def _mac(self, source: int, digest: bytes) -> bytes:
        return hmac.new(self._keys[source], digest, hashlib.sha256).digest()

    def sign(self, msg: Msg) -> Msg:
        return replace(
            msg, signature=self._mac(msg.source, qbft.msg_digest(msg))
        )

    def verify_sender(self, msg: Msg) -> bool:
        if not (0 <= msg.source < len(self._keys)):
            return False
        return hmac.compare_digest(
            msg.signature, self._mac(msg.source, qbft.msg_digest(msg))
        )

    def is_valid(self, msg: Msg) -> bool:
        if not self.verify_sender(msg):
            return False
        return all(self.is_valid(j) for j in msg.justification)

    def forge(self, msg: Msg, rng: random.Random) -> Msg:
        """Claimed-source message with a garbage signature: fails both
        checks — the building block for framing attempts (which must
        produce NO evidence against the claimed source)."""
        return replace(msg, signature=rng.randbytes(32))


# ---------------------------------------------------------------------------
# Network fabric
# ---------------------------------------------------------------------------


class ByzantineNet:
    """Honest-node transports plus adversarial injection. Honest
    broadcasts deliver to every other honest transport and are captured
    in `log` (replay scenarios re-inject them verbatim). Adversary
    nodes run no engine: attacks inject crafted messages directly, with
    per-destination control (`inject`) for selective-send/split attacks
    or `inject_all` for symmetric ones."""

    def __init__(
        self,
        params: AdversaryParams,
        max_buffered_per_source: int = 128,
    ) -> None:
        self.params = params
        self.log: list[Msg] = []
        self.transports: dict[int, Transport] = {
            i: Transport(
                self._make_broadcast(i),
                max_buffered_per_source=max_buffered_per_source,
            )
            for i in params.honest
        }

    def _make_broadcast(self, src: int):
        async def broadcast(msg: Msg) -> None:
            self.log.append(msg)
            for dst, tr in self.transports.items():
                if dst != src:
                    tr.receive(msg)

        return broadcast

    def inject(self, dst: int, msg: Msg) -> bool:
        """Deliver one adversarial message to one honest node; False =
        refused at the transport bound."""
        return self.transports[dst].receive(msg)

    def inject_all(self, msg: Msg, exclude: tuple[int, ...] = ()) -> None:
        for dst, tr in self.transports.items():
            if dst not in exclude:
                tr.receive(msg)

    def drops(self) -> dict:
        """Merged typed transport-drop counters across honest nodes."""
        out: dict = {}
        for tr in self.transports.values():
            for key, cnt in tr.drops.items():
                out[key] = out.get(key, 0) + cnt
        return out


# ---------------------------------------------------------------------------
# Scenario runner
# ---------------------------------------------------------------------------


@dataclass
class ByzantineResult:
    decisions: dict[int, object]
    stats: dict[int, dict]
    evidence: EvidenceRegistry
    net: ByzantineNet
    signer: HarnessSigner

    def merged_drops(self) -> dict[str, int]:
        """Engine drop counters summed across honest nodes."""
        out: dict[str, int] = {}
        for s in self.stats.values():
            for k, v in s.get("drops", {}).items():
                out[k] = out.get(k, 0) + v
        return out


async def run_with_adversary(
    params: AdversaryParams,
    instance,
    attack=None,
    *,
    values: dict[int, object] | None = None,
    round_timeout: float = 0.15,
    max_stored_per_source: int = 128,
    max_buffered_per_source: int = 128,
    timeout_s: float = 20.0,
) -> ByzantineResult:
    """Run one QBFT instance with engines on the honest nodes only and
    `attack(net, signer, params)` playing the adversaries concurrently.

    All honest engines share ONE EvidenceRegistry (the battery asserts
    on the union — any single honest node mis-attributing would fail),
    and each gets its own stats dict so drop counters stay per-node.
    Raises asyncio.TimeoutError when liveness fails — the liveness
    assertion IS this await completing."""
    signer = HarnessSigner(params.n, params.seed)
    evidence = EvidenceRegistry()
    net = ByzantineNet(
        params, max_buffered_per_source=max_buffered_per_source
    )
    leader = deterministic_leader(params.n)
    stats: dict[int, dict] = {i: {} for i in params.honest}

    def make_defn() -> Definition:
        return Definition(
            nodes=params.n,
            leader=leader,
            timeout=lambda r: round_timeout * (1 + r / 4),
            is_valid=signer.is_valid,
            sign_msg=signer.sign,
            verify_sender=signer.verify_sender,
            max_stored_per_source=max_stored_per_source,
            on_evidence=evidence.record,
        )

    async def run_node(i: int):
        return await qbft.run(
            make_defn(),
            net.transports[i],
            instance,
            i,
            values[i] if values else f"value-{i}",
            stats=stats[i],
        )

    tasks = {
        i: asyncio.create_task(run_node(i)) for i in params.honest
    }
    attack_task = (
        asyncio.create_task(attack(net, signer, params))
        if attack is not None
        else None
    )
    try:
        done = await asyncio.wait_for(
            asyncio.gather(*tasks.values()), timeout_s
        )
    finally:
        for t in tasks.values():
            t.cancel()
        if attack_task is not None:
            attack_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await attack_task
    decisions = dict(zip(tasks.keys(), done))
    return ByzantineResult(decisions, stats, evidence, net, signer)


# ---------------------------------------------------------------------------
# Differential device-vs-oracle conformance
# ---------------------------------------------------------------------------

_RAISED = object()  # sentinel: the operation raised TblsError


class DifferentialTbls(tbls.Implementation):
    """Wraps the active tbls backend; every *verdict* operation is
    re-executed on the pure-python oracle and compared lane-by-lane.
    Mismatches are recorded (never raised mid-run — the scenario must
    finish so the report shows every divergent lane), and the inner
    backend's result/exception is passed through unchanged so the
    system under test behaves identically to an unwrapped run.

    Verdict caching: the oracle costs ~0.3 s per pairing on CPU, and
    adversarial floods repeat the same forged lanes — `(pk, data, sig)`
    keyed memoisation keeps scenario wall-time bounded without skipping
    any distinct lane. Key-generation/signing delegate uncompared
    (deterministic data-plane ops, covered by tbls conformance tests).
    """

    def __init__(self, inner=None, oracle=None) -> None:
        if inner is None:
            inner = tbls.get_implementation()
        if oracle is None:
            from charon_tpu_torch.tbls.python_impl import PythonImpl

            oracle = PythonImpl()
        self.inner = inner
        self.oracle = oracle
        self.mismatches: list[dict] = []
        self.lanes_checked = 0
        self._verify_cache: dict[tuple, bool] = {}

    # -- uncompared delegation (key/signing data plane) -------------------

    def generate_secret_key(self):
        return self.inner.generate_secret_key()

    def secret_to_public_key(self, secret):
        return self.inner.secret_to_public_key(secret)

    def threshold_split(self, secret, total, threshold):
        return self.inner.threshold_split(secret, total, threshold)

    def recover_secret(self, shares, total, threshold):
        return self.inner.recover_secret(shares, total, threshold)

    def sign(self, secret, data):
        return self.inner.sign(secret, data)

    # -- compared verdicts ------------------------------------------------

    def _oracle_verify(self, pk, data, sig) -> bool:
        key = (pk, data, sig)
        got = self._verify_cache.get(key)
        if got is None:
            try:
                self.oracle.verify(pk, data, sig)
                got = True
            except tbls.TblsError:
                got = False
            self._verify_cache[key] = got
        return got

    def _mismatch(self, op: str, device, oracle, **ctx) -> None:
        self.mismatches.append(
            {"op": op, "device": device, "oracle": oracle, **ctx}
        )

    def verify(self, pubkey, data, sig) -> None:
        self.lanes_checked += 1
        err = None
        try:
            self.inner.verify(pubkey, data, sig)
            device_ok = True
        except tbls.TblsError as e:
            device_ok, err = False, e
        if device_ok != self._oracle_verify(pubkey, data, sig):
            self._mismatch("verify", device_ok, not device_ok)
        if err is not None:
            raise err

    def verify_batch(self, items) -> list:
        out = self.inner.verify_batch(items)
        for (pk, data, sig), device_ok in zip(items, out):
            self.lanes_checked += 1
            if bool(device_ok) != self._oracle_verify(pk, data, sig):
                self._mismatch(
                    "verify_batch", bool(device_ok), not device_ok
                )
        return out

    def verify_aggregate(self, pubkeys, data, sig) -> None:
        self.lanes_checked += 1
        err = None
        try:
            self.inner.verify_aggregate(pubkeys, data, sig)
            device_ok = True
        except tbls.TblsError as e:
            device_ok, err = False, e
        try:
            self.oracle.verify_aggregate(pubkeys, data, sig)
            oracle_ok = True
        except tbls.TblsError:
            oracle_ok = False
        if device_ok != oracle_ok:
            self._mismatch("verify_aggregate", device_ok, oracle_ok)
        if err is not None:
            raise err

    def _compare_recombine(self, op: str, partials, device) -> None:
        try:
            oracle = self.oracle.threshold_aggregate(partials)
        except tbls.TblsError:
            oracle = _RAISED
        if device != oracle:
            self._mismatch(
                op,
                device if device is _RAISED else device.hex(),
                oracle if oracle is _RAISED else oracle.hex(),
                indices=sorted(partials),
            )

    def threshold_aggregate(self, partials):
        self.lanes_checked += 1
        err, device = None, _RAISED
        try:
            device = self.inner.threshold_aggregate(partials)
        except tbls.TblsError as e:
            err = e
        self._compare_recombine("threshold_aggregate", partials, device)
        if err is not None:
            raise err
        return device

    def threshold_aggregate_batch(self, batch):
        out = self.inner.threshold_aggregate_batch(batch)
        for partials, device in zip(batch, out):
            self.lanes_checked += 1
            self._compare_recombine(
                "threshold_aggregate_batch", partials, device
            )
        return out

    def aggregate(self, sigs):
        self.lanes_checked += 1
        device = self.inner.aggregate(sigs)
        oracle = self.oracle.aggregate(sigs)
        if device != oracle:
            self._mismatch("aggregate", device.hex(), oracle.hex())
        return device

    def aggregate_batch(self, groups):
        return [self.aggregate(g) for g in groups]


@contextlib.contextmanager
def differential_backend():
    """Install DifferentialTbls over the active backend for the scope;
    yields it so the caller asserts `assert_no_mismatches(diff)` at the
    end. Always restores the previous backend (the conftest global-
    state fixture would also catch a leak, but scenarios should not
    rely on it)."""
    prev = tbls.get_implementation()
    diff = DifferentialTbls(inner=prev)
    tbls.set_implementation(diff)
    try:
        yield diff
    finally:
        tbls.set_implementation(prev)


# ---------------------------------------------------------------------------
# Invariant assertions
# ---------------------------------------------------------------------------


def assert_agreement(decisions: dict[int, object]) -> object:
    """Safety: every honest node decided, and decided the SAME value.
    Returns the agreed value."""
    assert decisions, "no honest decisions recorded"
    got = set(decisions.values())
    assert None not in got, f"undecided honest node: {decisions}"
    assert len(got) == 1, f"honest nodes disagree: {decisions}"
    return got.pop()


def assert_evidence_only(
    evidence: EvidenceRegistry, allowed
) -> None:
    """Attribution: every peer named in evidence is an allowed
    (adversary) identity — an honest peer appearing here is the
    failure mode the ledger exists to rule out (blaming the victim)."""
    named = evidence.peers()
    extra = named - set(allowed)
    assert not extra, (
        f"evidence names non-adversary peers {extra}: "
        f"{evidence.snapshot()}"
    )


def assert_no_mismatches(diff: DifferentialTbls) -> None:
    assert not diff.mismatches, (
        f"device-vs-oracle divergence on {len(diff.mismatches)} lanes "
        f"(of {diff.lanes_checked} checked): {diff.mismatches[:5]}"
    )
