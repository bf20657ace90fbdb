"""PyTorch port: the HTTP edges, the node and the CLI
(charon_tpu_torch/core/vapi_http.py, app/eth2http.py, app/faultinject.py,
app/run.py, cmd/cli.py and testutil/{schemas,vapiclient,waiting,compose}.py),
held against the JAX package.

  * The JAX package's cases run on the port's modules (`reference_cases`):
    test_vapi_http.py, test_vapi_http_e2e.py, test_eth2http.py,
    test_schema_conformance.py, test_cli_app.py, test_cli_tools.py,
    test_cluster_dkg's `test_cli_reshare_roundtrip`,
    test_spec_blocks' `test_router_keys_proposer_by_pubkey`, and, `slow`
    as in the reference, test_compose_smoke.py (nodes as `python -m
    charon_tpu_torch.cmd.cli run` processes) and test_netdkg_proc.py;
    test_manifest.py, whose `cluster` fixture differs from
    test_cli_tools', runs in tests/test_torch_identity.py.
    test_cli_app's multi-device case is a port case of the same name:
    `build_node(Config(device="cpu", crypto_plane="on"))` installs the
    coalescer behind the tenant service on a one-shard CPU plane.
  * The node binary: `python -m charon_tpu_torch.cmd.cli` and
    `charon_tpu_torch.app.run` import neither jax, nor `charon_tpu`, nor
    torch; `build_node(Config(use_tpu_tbls=True))` without a card raises
    and installs no host backend; `cli run --fault-injection` (or
    CHARON_TPU_FAULT_INJECTION) builds the chaos wrappers around the
    node's beacon, p2p node and tbls backend, and an injected backend
    fault reaches the first tbls caller.
  * Parity: both packages' VapiRouters answer the same `/eth/v1/...`
    requests over the same duty data with byte-equal JSON; a lock written
    by the port's `create-cluster` verifies under the reference's
    ClusterLock and PythonImpl and one written by the reference's under
    the port's; both packages' `build_node` wire the same components from
    the same data directory (`use_tpu_tbls=False`).

Tolerance: exact (bytes, verdicts).
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.tbls.python_impl import PythonImpl

# one autouse backend fixture for the file: test_vapi_http_e2e's
# host_tbls (NativeImpl where the library loads, else PythonImpl); the
# other modules' copies of it, and their python_tbls, are left out
VAPI_HTTP_CASES = export_cases(reference_cases("test_vapi_http"), globals(), skip=("python_tbls",))
VAPI_E2E_CASES = export_cases(reference_cases("test_vapi_http_e2e"), globals())
ETH2HTTP_CASES = export_cases(reference_cases("test_eth2http"), globals())
SCHEMA_CASES = export_cases(
    reference_cases("test_schema_conformance", test_modules=("test_vapi_http_e2e",)), globals(), skip=("host_tbls",)
)
CLI_APP_CASES = export_cases(
    reference_cases("test_cli_app"), globals(), skip=("test_app_wires_crypto_plane_on_multidevice", "python_tbls")
)
CLI_TOOLS_CASES = export_cases(reference_cases("test_cli_tools"), globals(), skip=("host_tbls",))
RESHARE_CLI_CASES = export_cases(
    reference_cases("test_cluster_dkg"), globals(), only=("test_cli_reshare_roundtrip",), skip=("python_tbls",)
)
ROUTER_CASES = export_cases(
    reference_cases("test_spec_blocks"), globals(), only=("test_router_keys_proposer_by_pubkey",)
)
COMPOSE_CASES = export_cases(reference_cases("test_compose_smoke"), globals())
NETDKG_PROC_CASES = export_cases(reference_cases("test_netdkg_proc"), globals())


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    groups = (VAPI_HTTP_CASES, VAPI_E2E_CASES, ETH2HTTP_CASES, SCHEMA_CASES, CLI_APP_CASES, CLI_TOOLS_CASES,
              RESHARE_CLI_CASES, ROUTER_CASES, COMPOSE_CASES, NETDKG_PROC_CASES)
    assert [len(g) for g in groups] == [3, 3, 4, 2, 2, 14, 1, 1, 2, 1]
    for group in groups:
        for name in group:
            assert not reference_modules(globals()[name]), name


def _create_cluster(cli_main, out, nodes: int = 3, threshold: int = 2, validators: int = 1) -> None:
    assert cli_main([
        "create-cluster", "--nodes", str(nodes), "--threshold", str(threshold),
        "--validators", str(validators), "--output-dir", str(out),
    ]) == 0


def test_app_wires_crypto_plane_on_multidevice(tmp_path):
    """The reference case holds build_node's plane wiring on an 8-device
    CPU mesh; the port's plane is asked for by device. With
    `Config(device="cpu", crypto_plane="on")` build_node installs the
    SlotCoalescer over a one-shard CPU plane behind the multi-tenant
    service, routes SigAgg / ParSigEx / ValidatorAPI through the tenant
    handle, and the coalescer shares the registry's TorchImpl (one set of
    point caches); "auto" installs no plane on one device, and
    crypto_plane="off" opts out."""
    from charon_tpu_torch.app.run import Config, build_node
    from charon_tpu_torch.cmd.cli import main as cli
    from charon_tpu_torch.core.cryptoplane import SlotCoalescer
    from charon_tpu_torch.core.cryptosvc import TenantPlane
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    out = tmp_path / "c"
    _create_cluster(cli, out, nodes=2, threshold=2)

    async def run():
        node = await build_node(
            Config(data_dir=str(out / "node0"), node_index=0, simnet=True, use_tpu_tbls=True, device="cpu",
                   crypto_plane="on", flight_capacity=0)
        )
        handle = node.sigagg.plane
        assert isinstance(handle, TenantPlane)
        assert node.vapi.plane is handle
        assert node.sigagg.pubshares_by_idx is not None
        coal = node.crypto_plane
        assert isinstance(coal, SlotCoalescer)
        assert node.crypto_svc is not None and node.crypto_svc.coalescer is coal
        assert handle.t == coal.t
        assert node.crypto_svc.tenant(handle.tenant_id) is not None
        assert coal.plane.shard_count() == 1 and str(coal.plane.device) == "cpu"
        assert coal.stats_hook is not None and coal.plane.on_program is not None
        impl = port_tbls.get_implementation()
        assert isinstance(impl, TorchImpl) and coal.impl is impl and str(impl.engine.device) == "cpu"
        coal.close()

        for index, plane in ((1, "off"), (1, "auto")):
            node_off = await build_node(
                Config(data_dir=str(out / f"node{index}"), node_index=index, simnet=True, use_tpu_tbls=True,
                       device="cpu", crypto_plane=plane, flight_capacity=0)
            )
            assert node_off.sigagg.plane is None and node_off.crypto_plane is None

    asyncio.run(run())


def test_node_binary_imports_without_jax_torch_or_reference_package():
    """`python -m charon_tpu_torch.cmd.cli` and app/run.py import with jax
    and charon_tpu made unimportable, and load no torch: a host-only node
    (`--no-tpu`) never loads it, and a scrape of its metrics neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['charon_tpu'] = None\n"
        "import charon_tpu_torch.cmd.cli, charon_tpu_torch.app.run\n"
        "from charon_tpu_torch.app.metrics import ClusterMetrics\n"
        "ClusterMetrics(cluster_hash='0x1', cluster_name='c', peer='node0').render()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'torch', 'charon_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('IMPORT-OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and "IMPORT-OK" in out.stdout, out.stderr[-2000:]


def test_build_node_on_the_card_raises_without_one(tmp_path):
    """`use_tpu_tbls=True` means TorchImpl on the card: without one,
    build_node raises and installs no host backend in its place."""
    import torch

    from charon_tpu_torch.app.run import Config, build_node
    from charon_tpu_torch.cmd.cli import main as cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: build_node runs on it")
    out = tmp_path / "c"
    _create_cluster(cli, out, nodes=2, threshold=2)
    sentinel = PythonImpl()
    port_tbls.set_implementation(sentinel)
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(build_node(Config(data_dir=str(out / "node0"), node_index=0, simnet=True, use_tpu_tbls=True)))
    assert port_tbls._current is sentinel


def test_fault_injection_inert_without_a_spec(tmp_path, monkeypatch):
    """Without a spec the fault-injection plane constructs nothing: the
    node's backend and beacon are the plain ones."""
    from charon_tpu_torch.app import faultinject
    from charon_tpu_torch.app.run import Config, build_node
    from charon_tpu_torch.cmd.cli import main as cli
    from charon_tpu_torch.testutil import chaos

    out = tmp_path / "c"
    _create_cluster(cli, out, nodes=2, threshold=2)
    monkeypatch.delenv(faultinject.ENV_VAR, raising=False)
    faultinject.uninstall()
    node = asyncio.run(build_node(Config(data_dir=str(out / "node0"), node_index=0, simnet=True, use_tpu_tbls=False,
                                         flight_capacity=0)))
    assert not faultinject.active()
    assert not isinstance(port_tbls.get_implementation(), chaos.FlakyBackend)
    assert not isinstance(node.beacon, chaos.ChaosBeacon)


@pytest.mark.parametrize("via", ["flag", "env"])
def test_fault_injection_builds_the_wrappers_and_the_first_tbls_call_raises(tmp_path, monkeypatch, via):
    """`cli run --fault-injection seed=1,crypto_fail_after=0` (or the same
    spec in CHARON_TPU_FAULT_INJECTION) builds the node on the port's
    fault plane: a FlakyBackend around the host tbls backend and a
    ChaosBeacon around the beacon. With crypto_fail_after=0 the first tbls
    call raises the injected fault to its caller; there is no ladder to
    hide it, and the registry keeps the wrapper."""
    from charon_tpu_torch.app import faultinject
    from charon_tpu_torch.app.run import build_node
    from charon_tpu_torch.cmd.cli import build_parser, run_config
    from charon_tpu_torch.cmd.cli import main as cli
    from charon_tpu_torch.tbls.native_impl import NativeImpl
    from charon_tpu_torch.tbls.python_impl import PythonImpl
    from charon_tpu_torch.testutil import chaos

    spec = "seed=1,crypto_fail_after=0"
    out = tmp_path / "c"
    _create_cluster(cli, out, nodes=2, threshold=2)
    monkeypatch.delenv(faultinject.ENV_VAR, raising=False)
    faultinject.uninstall()
    argv = ["run", "--data-dir", str(out / "node0"), "--no-tpu", "--simnet"]
    if via == "flag":
        argv += ["--fault-injection", spec]
    else:
        monkeypatch.setenv(faultinject.ENV_VAR, spec)
    rc, config = run_config(build_parser().parse_args(argv))
    assert rc == 0
    try:
        node = asyncio.run(build_node(config))
        plane = faultinject.plane()
        assert plane is not None and plane.config == chaos.config_from_spec(spec)
        impl = port_tbls.get_implementation()
        assert isinstance(impl, chaos.FlakyBackend) and isinstance(impl._inner, (NativeImpl, PythonImpl))
        assert isinstance(node.beacon, chaos.ChaosBeacon)
        with pytest.raises(RuntimeError, match="chaos: crypto backend lost") as err:
            port_tbls.sign(b"\x01" * 32, b"m" * 32)
        assert not isinstance(err.value, port_tbls.TblsError)
        assert impl.injected_failures == 1 and port_tbls.get_implementation() is impl
    finally:
        faultinject.uninstall()


def test_fault_injection_rejects_a_typo_before_the_node_starts(tmp_path, capsys):
    """A spec with an unknown key exits 2 with the chaos module's
    diagnostic, before anything is built."""
    from charon_tpu_torch.app import faultinject
    from charon_tpu_torch.cmd.cli import main as cli

    assert cli(["run", "--data-dir", str(tmp_path), "--no-tpu", "--simnet", "--fault-injection", "seed=1,dorp=0.1"]) == 2
    assert "unknown fault-injection key 'dorp'" in capsys.readouterr().err
    assert not faultinject.active()


# -- parity: the validator API over HTTP ----------------------------------------


def _vapi_pkg(pkg: str):
    if pkg == "ref":
        from charon_tpu.core import dutydb, eth2data, validatorapi, vapi_http
        from charon_tpu.core import types as ty
        from charon_tpu.core.scheduler import DutyDefinition
        from charon_tpu.testutil import beaconmock
        from charon_tpu.testutil.simnet import SIMNET_FORK
    else:
        from charon_tpu_torch.core import dutydb, eth2data, validatorapi, vapi_http
        from charon_tpu_torch.core import types as ty
        from charon_tpu_torch.core.scheduler import DutyDefinition
        from charon_tpu_torch.testutil import beaconmock
        from charon_tpu_torch.testutil.simnet import SIMNET_FORK
    return dutydb, eth2data, validatorapi, vapi_http, ty, DutyDefinition, beaconmock, SIMNET_FORK


_GETS = (
    "/eth/v1/validator/attestation_data?slot=5&committee_index=1",
    "/eth/v1/node/version", "/eth/v1/node/syncing", "/eth/v1/node/health", "/eth/v1/beacon/genesis",
    "/eth/v1/config/spec", "/eth/v1/config/fork_schedule", "/eth/v1/beacon/states/head/fork",
    "/eth/v1/validator/duties/proposer/0", "/eth/v1/beacon/states/head/validators",
    "/eth/v1/beacon/states/head/validators/0", "/eth/v1/validator/duties/proposer/x",
)
_POSTS = (("/eth/v1/validator/duties/attester/0", ["0", "1"]), ("/eth/v1/validator/duties/sync/0", ["0"]))


async def _vapi_answers(pkg: str, pubkeys: list[bytes], pubshares: list[bytes]) -> list:
    """Every answer of one package's VapiRouter over the same duty data:
    two validators, an attester duty stored at slot 5."""
    import aiohttp

    dutydb, eth2data, validatorapi, vapi_http, ty, DutyDefinition, beaconmock, fork = _vapi_pkg(pkg)
    gpks = [ty.pubkey_from_bytes(pk) for pk in pubkeys]
    validators = {gpk: i for i, gpk in enumerate(gpks)}
    db = dutydb.DutyDB()
    vapi = validatorapi.ValidatorAPI(share_idx=1, pubshares=dict(zip(gpks, pubshares)), fork=fork, slots_per_epoch=8)
    vapi.register_await_attestation(db.await_attestation)
    vapi.register_pubkey_by_attestation(db.pubkey_by_attestation)
    vapi.register_get_duty_definition(lambda duty: {
        gpk: DutyDefinition(pubkey=gpk, validator_index=i, committee_index=1, committee_length=2)
        for gpk, i in validators.items()
    })
    beacon = beaconmock.BeaconMock(validators=validators, genesis_time=1_700_000_000.0, slot_duration=12.0,
                                   slots_per_epoch=8)
    data = await beacon.attestation_data(5, 1)
    await db.store(ty.Duty(5, ty.DutyType.ATTESTER), {
        gpks[0]: eth2data.AttestationDuty(data=data, committee_length=2, committee_index=1,
                                          validator_committee_index=0),
    })
    router = vapi_http.VapiRouter(vapi, beacon=beacon, validators=validators, genesis_time=1_700_000_000.0,
                                  slots_per_epoch=8, slot_duration=12.0, clock=beacon.clock())
    port = await router.start("127.0.0.1", 0)
    answers = []
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=20)) as sess:
            url = f"http://127.0.0.1:{port}"
            for path in _GETS:
                async with sess.get(url + path) as resp:
                    answers.append((path, resp.status, await resp.read()))
            for path, body in _POSTS:
                async with sess.post(url + path, json=body) as resp:
                    answers.append((path, resp.status, await resp.read()))
    finally:
        await router.stop()
    return answers


def test_vapi_routers_answer_byte_equal_json():
    """Both packages' VapiRouters answer the same `/eth/v1/...` requests
    over the same duty data (validators, pubshares, a stored attester
    duty, the beacon mock's chain) with the same status and byte-equal
    JSON, an error answer included."""
    from charon_tpu_torch.crypto import bls
    from charon_tpu_torch.crypto.g1g2 import g1_to_bytes

    pubkeys = [g1_to_bytes(bls.sk_to_pk(sk)) for sk in (11, 12)]
    pubshares = [g1_to_bytes(bls.sk_to_pk(sk)) for sk in (21, 22)]
    ref = asyncio.run(_vapi_answers("ref", pubkeys, pubshares))
    port = asyncio.run(_vapi_answers("port", pubkeys, pubshares))
    assert [(p, s) for p, s, _ in port][:2] == [(_GETS[0], 200), (_GETS[1], 200)]
    assert any(s >= 400 for _, s, _ in port)
    assert port == ref


# -- parity: the cluster lock of create-cluster --------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_create_cluster_lock_verifies_in_both_packages(tmp_path, writer):
    """A lock written by one package's `create-cluster` (3 operators,
    threshold 2, 2 validators) verifies under both packages' ClusterLock
    with their own PythonImpl, node signatures included; both give it the
    same lock hash; a flipped byte of its aggregate is refused by both."""
    from charon_tpu import tbls as ref_tbls
    from charon_tpu.cluster.lock import ClusterLock as RefLock
    from charon_tpu.cmd.cli import main as ref_cli
    from charon_tpu.eth2util import enr as ref_enr
    from charon_tpu.tbls.python_impl import PythonImpl as RefPythonImpl
    from charon_tpu_torch.cluster.lock import ClusterLock as PortLock
    from charon_tpu_torch.cmd.cli import main as port_cli

    ref_tbls.set_implementation(RefPythonImpl())
    port_tbls.set_implementation(PythonImpl())
    _create_cluster(port_cli if writer == "port" else ref_cli, tmp_path, nodes=3, threshold=2, validators=2)
    data = json.loads((tmp_path / "node0" / "cluster-lock.json").read_text())
    for lock_cls in (RefLock, PortLock):
        lock = lock_cls.from_json(data)
        ops = [ref_enr.pubkey_from_string(op.enr) for op in lock.definition.operators]
        lock.verify(ops)
        assert "0x" + lock.lock_hash().hex() == data["lock_hash"]
        bad = dict(data, signature_aggregate=data["signature_aggregate"][:-2]
                   + ("00" if data["signature_aggregate"][-2:] != "00" else "01"))
        with pytest.raises(Exception):
            lock_cls.from_json(bad).verify(ops)


# -- parity: build_node's wiring ------------------------------------------------


def _wiring(node) -> dict:
    """What build_node wired: each component's type, the lock, the key
    maps, the lifecycle's hooks and the metric families."""
    fields = ("scheduler", "vapi", "vapi_router", "p2p", "bcast", "tracker", "metrics", "beacon", "sigagg",
              "crypto_plane", "crypto_svc", "crypto_remote_plane", "crypto_server", "inclusion", "flightrec",
              "profiler", "slo")
    families = sorted({line.split()[2] for line in node.metrics.render().decode().splitlines()
                       if line.startswith("# TYPE")})
    return {
        "types": {f: type(getattr(node, f)).__name__ for f in fields},
        "lock": node.lock.lock_hash().hex(),
        "pubshares": {i: sorted(str(k) + v.hex() for k, v in m.items())
                      for i, m in node.pubshares_by_idx.items()},
        "share_idx": node.vapi.share_idx,
        "threshold": node.sigagg.threshold,
        "start": [(h.order, h.name, h.background) for h in node.life._start_hooks],
        "stop": [(h.order, h.name) for h in node.life._stop_hooks],
        "families": families,
    }


def test_build_node_wires_the_same_components(tmp_path):
    """Both packages' build_node, given the same data directory and
    `use_tpu_tbls=False`, wire the same components: the same types, lock,
    pubshare maps, share index and threshold, the same lifecycle hooks in
    the same order, and the same metric families."""
    from charon_tpu import tbls as ref_tbls
    from charon_tpu.app import run as ref_run
    from charon_tpu.tbls.python_impl import PythonImpl as RefPythonImpl
    from charon_tpu_torch.app import run as port_run
    from charon_tpu_torch.cmd.cli import main as port_cli

    _create_cluster(port_cli, tmp_path, nodes=3, threshold=2)
    saved = ref_tbls.get_implementation()

    async def wire(mod):
        cfg = mod.Config(data_dir=str(tmp_path / "node1"), node_index=1, simnet=True, slot_duration=1.0,
                         slots_per_epoch=8, use_tpu_tbls=False, genesis_time=1_700_000_000.0,
                         flight_dump_dir=str(tmp_path / f"flight-{mod.__name__}"))
        node = await mod.build_node(cfg)
        try:
            return _wiring(node)
        finally:
            await node.life.shutdown()

    try:
        ref = asyncio.run(wire(ref_run))
        port = asyncio.run(wire(port_run))
    finally:
        ref_tbls.set_implementation(saved if saved is not None else RefPythonImpl())
    assert port["types"]["flightrec"] == "FlightRecorder" and port["start"]
    assert port == ref


# -- a fault of the reference, repaired: the node's validator mock proposes --


async def _tcp_cluster_broadcasts(run_mod, cli_mod, out, seconds: float) -> list:
    """A 4-node, 2-validator cluster of `build_node` nodes (k1 TCP p2p,
    QBFT, the simnet validator mock) from `create-cluster`, run for
    `seconds` from genesis: each node's (attested slots, proposed slots)."""
    import time

    from charon_tpu_torch.testutil.compose import _free_ports

    assert cli_mod.main(["create-cluster", "--nodes", "4", "--threshold", "3", "--validators", "2",
                         "--output-dir", str(out)]) == 0
    ports = _free_ports(4)
    genesis = time.time() + 1.0
    nodes = []
    for i in range(4):
        nodes.append(await run_mod.build_node(run_mod.Config(
            data_dir=str(out / f"node{i}"), node_index=i, p2p_port=ports[i],
            peer_addrs=[("127.0.0.1", p) for p in ports], simnet=True, slot_duration=1.0, slots_per_epoch=8,
            genesis_time=genesis, use_tpu_tbls=False, flight_capacity=0, stacksnipe_interval=0,
        )))
    stop = asyncio.Event()
    tasks = [asyncio.create_task(n.life.run(stop)) for n in nodes]
    await asyncio.sleep(genesis + seconds - time.time())
    stop.set()
    await asyncio.gather(*tasks, return_exceptions=True)
    return [(sorted({a.data.slot for a in n.beacon.attestations}), sorted({p.slot for p, _ in n.beacon.proposals}))
            for n in nodes]


def test_build_node_validator_mock_proposes_blocks(tmp_path):
    """The port's build_node runs the fetcher as its own retried task
    (`with_async_retry`, as the Go reference's core.WithAsyncRetry and the
    simnet do), so a node's simnet validator mock signs its randao and the
    block follows. The reference's build_node awaits the fetcher before the
    validator mock's subscriber: a proposer fetch waits for a randao that
    is never signed, and its nodes attest but never propose (ROADMAP
    section 3)."""
    from charon_tpu import tbls as ref_tbls
    from charon_tpu.app import run as ref_run
    from charon_tpu.cmd import cli as ref_cli
    from charon_tpu.tbls.python_impl import PythonImpl as RefPythonImpl
    from charon_tpu_torch.app import run as port_run
    from charon_tpu_torch.cmd import cli as port_cli

    saved = ref_tbls.get_implementation()
    try:
        port = asyncio.run(asyncio.wait_for(_tcp_cluster_broadcasts(port_run, port_cli, tmp_path / "port", 4.5), 60))
        ref = asyncio.run(asyncio.wait_for(_tcp_cluster_broadcasts(ref_run, ref_cli, tmp_path / "ref", 4.5), 60))
    finally:
        ref_tbls.set_implementation(saved if saved is not None else RefPythonImpl())
    for attested, proposed in port:
        assert attested and proposed and proposed[0] == 0
    for attested, proposed in ref:
        assert attested and not proposed
