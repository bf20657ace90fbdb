"""PyTorch port: observability (charon_tpu_torch/app/{metrics,flightrec,
health,planeprof,peerinfo,stacksnipe,obolapi}.py and
testutil/obolapimock.py), held against the JAX package.

  * The JAX package's cases run on the port's modules (`reference_cases`):
    test_flightrec.py, test_obs_endpoint.py, test_slo_planeprof.py,
    test_obolapi_stacksnipe.py, test_tracer.py, test_app_infra.py but its
    lifecycle and fork-join cases (bound in tests/test_torch_identity.py),
    test_version_codec_guard's `test_peerinfo_flags_incompatible_peer`
    and test_qbft's `test_consensus_sniffer_and_debug_endpoint`, which
    builds its cluster with `build_cluster(flightrec=True)`.
  * Parity: the same observations fed to both packages' ClusterMetrics
    render equal Prometheus text, but the compile-cache gauges (the
    reference reads its jit cache, the port its nvcc build cache, ROADMAP
    section 3); the same events recorded by both packages'
    FlightRecorder dump equal JSONL, and both merge and render the
    per-node dumps to equal timelines.

Tolerance: exact (text and bytes).
"""

from __future__ import annotations

import json
import re

import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu.app import flightrec as ref_flightrec
from charon_tpu.app import metrics as ref_metrics
from charon_tpu.core import types as ref_types
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.app import flightrec as port_flightrec
from charon_tpu_torch.app import metrics as port_metrics
from charon_tpu_torch.core import types as port_types
from charon_tpu_torch.tbls.python_impl import PythonImpl

FLIGHTREC_CASES = export_cases(reference_cases("test_flightrec"), globals())
OBS_ENDPOINT_CASES = export_cases(reference_cases("test_obs_endpoint"), globals())
SLO_CASES = export_cases(reference_cases("test_slo_planeprof"), globals())
OBOLAPI_CASES = export_cases(reference_cases("test_obolapi_stacksnipe"), globals())
TRACER_CASES = export_cases(reference_cases("test_tracer"), globals())
APP_INFRA_CASES = export_cases(
    reference_cases("test_app_infra"),
    globals(),
    skip=("test_lifecycle_order_and_shutdown", "test_forkjoin_bounded_order_and_failures"),
)
PEERINFO_CASES = export_cases(
    reference_cases("test_version_codec_guard"), globals(), only=("test_peerinfo_flags_incompatible_peer",)
)
SNIFFER_CASES = export_cases(
    reference_cases("test_qbft"), globals(), only=("test_consensus_sniffer_and_debug_endpoint",)
)


@pytest.fixture(autouse=True)
def port_host_tbls():
    """The port's PythonImpl in the port's registry, where the reference
    cases find the reference's by default."""
    port_tbls.set_implementation(PythonImpl())


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    cases = (
        FLIGHTREC_CASES + OBS_ENDPOINT_CASES + SLO_CASES + OBOLAPI_CASES + TRACER_CASES + APP_INFRA_CASES
        + PEERINFO_CASES + SNIFFER_CASES
    )
    assert [len(c) for c in (FLIGHTREC_CASES, OBS_ENDPOINT_CASES, SLO_CASES, OBOLAPI_CASES, TRACER_CASES,
                             APP_INFRA_CASES, PEERINFO_CASES, SNIFFER_CASES)] == [15, 5, 12, 6, 6, 17, 1, 1]
    for name in cases:
        assert not reference_modules(globals()[name]), name


# -- parity: Prometheus text -------------------------------------------------

# Polled process-wide gauges: the compile cache (the reference's jit cache,
# the port's nvcc build cache) and the point caches (the reference's
# module-level caches, the port's registry TorchImpl's), held below apart.
_POLLED = re.compile(r"^tpu_(compile_cache_(hits|misses|entries|bytes)|point_cache_(hits|misses|entries))\{")


def _observe(mod, types_mod) -> bytes:
    """One fixed set of observations through every hook of a ClusterMetrics."""
    m = mod.ClusterMetrics(cluster_hash="0x00c0ffee00c0ffee", cluster_name="parity", peer="node0")
    duty = types_mod.Duty(3, types_mod.DutyType.ATTESTER)
    m.labels(m.plane_flushes).inc(3)
    m.labels(m.plane_lanes).inc(96)
    m.labels(m.plane_flush_seconds).observe(4.5)
    m.labels(m.plane_decode_lanes, "device").inc(32)
    m.labels(m.tracker_failed, "attester", "sigagg").inc()
    m.labels(m.consensus_decided_rounds, "attester", "inc").set(2)
    m.observe_warmup({"pubkey": {"device": 128, "cached": 4}, "message": {"python": 2}, "seconds": 2.75})
    m.observe_dkg_verify("round2", "device", 35)
    m.observe_reshare("rotate", "ok", seconds=12.0, validators=16)
    wire = m.wire_hook()
    wire("tx", "binary", 512, 0.0004)
    wire("rx", "json", 2048, None)
    tenant = m.tenant_hook()
    tenant("shed", "node1", reason="queue_full")
    tenant("queue", "node1", lanes=64)
    tenant("breaker", "node2", state="open")
    tenant("complete", "node1", seconds=0.25, quarantined=True)
    remote = m.remote_hook("node4-remote")
    for kind, fields in (("connect", {}), ("state", {"state": "up"}), ("failover", {"reason": "timeout", "lanes": 7}),
                         ("shed", {"reason": "deadline"}), ("remote_shed", {"reason": "quota"}),
                         ("disconnect", {"reason": "heartbeat"})):
        remote(kind, **fields)
    tune = m.autotune_hook()
    tune("profile", event="hit")
    tune("decision", axis="mxu_mont", choice="False", source="profile")
    tune("bench", axis="msm", choice="True", seconds=0.012)
    tune("prewarm", axis="msm", seconds=3.5)
    m.byzantine_hook()(3, "equivocation")
    m.peer_quarantine_hook()(2, 1.5)
    m.flightrec_hook()("plane", "flush")
    on_sample, on_tenant, on_util = m.profiler_hooks()
    on_sample("pairing", 1.25)
    on_tenant("node1", 0.5)
    on_util(0.375)
    m.stacksnipe_hook()({"lighthouse": [101, 102]})
    m.labels(m.tracker_participation, "attester", "1").inc(16)
    del duty
    return m.render()


def _text(raw: bytes) -> list[str]:
    """The sample lines but the polled gauges', with each counter's
    `_created` wall stamp blanked."""
    return [
        re.sub(r"^(\w+_created\{.*\}) \S+$", r"\1 T", line)
        for line in raw.decode().splitlines()
        if not _POLLED.match(line)
    ]


def test_metrics_render_equal_prometheus_text():
    """The same observations through both packages' ClusterMetrics render
    the same Prometheus text, family names, help texts, labels and values,
    but the polled cache gauges."""
    port_tbls.set_implementation(PythonImpl())
    ref = _text(_observe(ref_metrics, ref_types))
    port = _text(_observe(port_metrics, port_types))
    assert len(port) > 300
    assert port == ref


def test_metrics_point_cache_gauges_read_the_registry_torchimpl():
    """The port's point-cache gauges read the PointCache counters of the
    TorchImpl in the tbls registry (the reference reads its module-level
    caches), and the build-cache gauges count the nvcc libraries in
    _build/ (entries and bytes; no hit or miss counts)."""
    from charon_tpu_torch.crypto import bls
    from charon_tpu_torch.ops import mont_kernels
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    impl = TorchImpl(device="cpu")
    port_tbls.set_implementation(impl)
    sk = (7).to_bytes(32, "big")
    pk = bls.sk_to_pk(int.from_bytes(sk, "big"))
    from charon_tpu_torch.crypto.g1g2 import g1_to_bytes

    pk_bytes = g1_to_bytes(pk)
    impl.pubkey_points(pk_bytes)
    impl.pubkey_points(pk_bytes)
    text = port_metrics.ClusterMetrics(cluster_hash="0x1", cluster_name="c", peer="node0").render().decode()
    node = 'cluster_hash="0x1",cluster_name="c",peer="node0"'
    assert f'tpu_point_cache_hits{{cache="pubkey",{node}}} 1.0' in text
    assert f'tpu_point_cache_misses{{cache="pubkey",{node}}} 1.0' in text
    assert f'tpu_point_cache_entries{{cache="pubkey",{node}}} 1.0' in text
    libs = list(mont_kernels.BUILD_DIR.glob("*.so"))
    assert f"tpu_compile_cache_entries{{{node}}} {float(len(libs))}" in text
    assert not re.search(r"^tpu_compile_cache_(hits|misses)\{", text, re.M)
    port_tbls.set_implementation(PythonImpl())
    text = port_metrics.ClusterMetrics(cluster_hash="0x1", cluster_name="c", peer="node0").render().decode()
    assert not re.search(r"^tpu_point_cache_hits\{", text, re.M)


# -- parity: the flight recorder ---------------------------------------------


class _Clock:
    """time.time and time.monotonic stepping by a fixed amount a call."""

    def __init__(self, start: float):
        self.t = start

    def time(self) -> float:
        self.t += 0.125
        return self.t

    def monotonic(self) -> float:
        return self.t


def _record(mod, node: str, start: float, monkeypatch) -> object:
    monkeypatch.setattr(mod, "time", _Clock(start))
    rec = mod.FlightRecorder(capacity=4, node=node)
    rec.record("lifecycle", "start", node_index=int(node[-1]))
    mod.tenant_hook(rec)("shed", "node1", reason="queue_full")
    mod.remote_hook(rec, "node4-remote", addr="127.0.0.1:9000")("failover", reason="timeout", lanes=7)
    mod.byzantine_hook(rec)(3, "equivocation", "two values in round 1")
    mod.quarantine_hook(rec)(2, 1.5)
    mod.autotune_hook(rec)("decision", axis="msm", choice="True", source="profile")
    for slot in range(6):  # more than the ring holds: drops counted
        rec.record("duty", "outcome", tenant="parity", slot=slot, success=slot != 4, duty="attester")
    rec.record("plane", "flush", jobs=3, lanes=96, seconds=4.5, blob=b"\x00\x01")
    return rec


def test_flight_recorder_dumps_and_timelines_equal(tmp_path, monkeypatch):
    """The same events recorded by both packages' FlightRecorder dump equal
    JSONL; both merge the per-node dumps into the same events and render
    the same timeline."""
    dumps = {}
    for pkg, mod in (("ref", ref_flightrec), ("port", port_flightrec)):
        paths = []
        for i, start in ((0, 1_700_000_000.0), (1, 1_700_000_000.0625)):
            rec = _record(mod, f"node{i}", start, monkeypatch)
            path = tmp_path / f"{pkg}-node{i}.jsonl"
            assert rec.dump_jsonl(str(path), trigger="stop") == len(rec.events())
            paths.append(str(path))
        dumps[pkg] = paths
    for ref_path, port_path in zip(dumps["ref"], dumps["port"]):
        assert open(port_path).read() == open(ref_path).read()
    ref_events = ref_flightrec.merge_jsonl(dumps["ref"])
    port_events = port_flightrec.merge_jsonl(dumps["port"])
    assert port_events == ref_events and len(port_events) > 10
    assert port_flightrec.render_timeline(port_events) == ref_flightrec.render_timeline(ref_events)
    assert json.loads(open(dumps["port"][0]).readline())["dropped"] == {"duty": 2}
