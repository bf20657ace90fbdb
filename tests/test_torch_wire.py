"""PyTorch port: the wire (charon_tpu_torch/p2p, core/priority.py,
core/cryptosvc_{wire,server,client}.py and dkg/netdkg.py), held against
the JAX package.

  * The JAX package's tests/test_wire_codec.py, test_priority.py,
    test_p2p.py, test_relay_fallback.py and test_cryptosvc_remote.py run
    on the port's modules (`reference_cases`); so do test_golden's `test_wire_envelope_golden`, test_spec_blocks'
    `test_proposal_wire_codec_roundtrip` and test_version_codec_guard but
    `test_peerinfo_flags_incompatible_peer` (bound with the observability
    cases in tests/test_torch_obs.py).
    `test_peer_codec_quarantine_exponential_backoff` passes here: the
    port's `P2PNode.send` keeps the connection on a response timeout
    (ROADMAP section 3), where the reference's drops it.
  * Codec parity: seeded instances of every type in the codec's registry
    (numpy `default_rng`) give byte-equal JSON and binary envelopes in
    both packages, each package decodes the other's frames to its own
    instance, and the wire-id tables and the schema snapshot are equal.
  * Interop over loopback TCP: a reference CryptoServiceServer with a
    port RemotePlane and a port server with a reference RemotePlane, over
    a host stub service, give the stub's verdicts and signature bytes;
    the HMAC tenant proofs are equal; a reference P2PNode and a port
    P2PNode complete the k1 handshake both ways and exchange a ping and
    a partial-signature set.
  * The remote service does not hide the device: a flush that raises
    reaches the RemotePlane caller as TblsError, with no local retry.
  * A 3-node `run_networked_dkg` over loopback on the port's host
    backend writes a lock that both packages' PythonImpl verify.

Every listener binds port 0 but the networked ceremony's, whose peers
must know each other's ports before they listen; every async case runs
under its own `asyncio.wait_for` limit. Tolerance: exact (bytes,
verdicts).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import importlib
import json
import socket
import types
import typing

import numpy as np
import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu import tbls as ref_tbls
from charon_tpu.analysis import schema_check
from charon_tpu.app import k1util as ref_k1
from charon_tpu.cluster.lock import ClusterLock as RefLock
from charon_tpu.core import cryptosvc_client as ref_client
from charon_tpu.core import cryptosvc_server as ref_server
from charon_tpu.core import cryptosvc_wire as ref_wire
from charon_tpu.dkg import netdkg as ref_netdkg  # noqa: F401 — registers the ceremony's wire types
from charon_tpu.p2p import codec as ref_codec
from charon_tpu.tbls.python_impl import PythonImpl as RefPythonImpl
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.app import k1util as port_k1
from charon_tpu_torch.cluster import definition as port_def
from charon_tpu_torch.cluster.lock import ClusterLock as PortLock
from charon_tpu_torch.core import cryptosvc_client as port_client
from charon_tpu_torch.core import cryptosvc_server as port_server
from charon_tpu_torch.core import cryptosvc_wire as port_wire
from charon_tpu_torch.core.cryptoplane import SlotCoalescer
from charon_tpu_torch.core.cryptosvc import CryptoPlaneService
from charon_tpu_torch.dkg import netdkg as port_netdkg
from charon_tpu_torch.eth2util import enr as port_enr
from charon_tpu_torch.p2p import codec as port_codec
from charon_tpu_torch.p2p import transport as port_transport
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls.torch_impl import TorchImpl

WIRE_CODEC_CASES = export_cases(reference_cases("test_wire_codec"), globals())
PRIORITY_CASES = export_cases(reference_cases("test_priority"), globals())
P2P_CASES = export_cases(reference_cases("test_p2p"), globals())
RELAY_CASES = export_cases(reference_cases("test_relay_fallback"), globals())
REMOTE_CASES = export_cases(reference_cases("test_cryptosvc_remote"), globals())
GOLDEN_CASES = export_cases(reference_cases("test_golden"), globals(), only=("test_wire_envelope_golden",))
SPEC_CASES = export_cases(reference_cases("test_spec_blocks"), globals(), only=("test_proposal_wire_codec_roundtrip",))
VERSION_CASES = export_cases(
    reference_cases("test_version_codec_guard"), globals(), skip=("test_peerinfo_flags_incompatible_peer",)
)
REBOUND = (
    WIRE_CODEC_CASES + PRIORITY_CASES + P2P_CASES + RELAY_CASES + REMOTE_CASES + GOLDEN_CASES + SPEC_CASES
    + VERSION_CASES
)

LIMIT = 30.0  # seconds: every async case's own wait_for limit
HOST = "127.0.0.1"


def _run(coro, limit: float = LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    assert [len(c) for c in (
        WIRE_CODEC_CASES, PRIORITY_CASES, P2P_CASES, RELAY_CASES, REMOTE_CASES, GOLDEN_CASES, SPEC_CASES,
        VERSION_CASES,
    )] == [23, 6, 5, 2, 18, 1, 1, 5]
    for name in REBOUND:
        case = globals()[name]
        if name.startswith(("test_", "Test")):
            assert not reference_modules(case), name


# -- codec parity: every registered type, seeded ------------------------------

PACKAGES = {"port": port_codec, "ref": ref_codec}
SEEDS = (0, 1, 2)


def _int(rng) -> int:
    n = int.from_bytes(rng.bytes(int(rng.integers(0, 34))), "big")
    return -n if rng.integers(4) == 0 else n


def _str(rng) -> str:
    return "".join(chr(int(c)) for c in rng.choice([0x61, 0x7A, 0x2F, 0x22, 0xE9, 0x4E2D], int(rng.integers(0, 9))))


def _any(codec, rng, depth: int):
    """A seeded value for a field typed `object`, `Hashable` or a bare
    `tuple`: hashable, and the same in both packages for one seed."""
    pick = int(rng.integers(5 if depth < 3 else 3))
    if pick == 0:
        return rng.bytes(int(rng.integers(0, 50)))
    if pick == 1:
        return _int(rng)
    if pick == 2:
        return _str(rng)
    if pick == 3:
        return tuple(_any(codec, rng, depth + 1) for _ in range(int(rng.integers(0, 4))))
    return _instance(codec, codec._REGISTRY["Checkpoint"], rng, depth + 1)


_LENGTHS = {"pubkey": 48, "fee_recipient": 20}


def _value(codec, tp, rng, depth: int, name: str = ""):
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is bool:
        return bool(rng.integers(2))
    if tp is int:
        return _int(rng)
    if tp is float:
        return float(rng.standard_normal())
    if tp is str:
        return _str(rng)
    if tp is bytes:
        return rng.bytes(_LENGTHS.get(name) or int(rng.integers(0, 50)))
    if origin in (typing.Union, types.UnionType):
        return _value(codec, args[int(rng.integers(len(args)))], rng, depth, name)
    if tp is type(None):
        return None
    if origin is tuple and len(args) == 2 and args[1] is Ellipsis:
        n = int(rng.integers(0, 12 if args[0] is bool else 4 if depth < 3 else 2))
        return tuple(_value(codec, args[0], rng, depth + 1) for _ in range(n))
    if origin is tuple:
        return tuple(_value(codec, a, rng, depth + 1) for a in args)
    if tp is dict or origin is dict:
        return {_str(rng) + str(i): _int(rng) for i in range(int(rng.integers(0, 4)))}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return list(tp)[int(rng.integers(len(tp)))]
    if dataclasses.is_dataclass(tp):
        return _instance(codec, tp, rng, depth + 1)
    if tp in (object, tuple, typing.Hashable, typing.Any):
        return _any(codec, rng, depth)
    raise TypeError(f"no generator for {tp!r}")


def _instance(codec, cls, rng, depth: int = 0):
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _value(codec, hints[f.name], rng, depth, f.name) for f in dataclasses.fields(cls)})


def _registered() -> list[str]:
    return sorted(ref_codec._REGISTRY)


def test_registries_and_wire_ids_are_equal():
    """The same registered types, the same append-only wire-id tables and
    the same schema snapshot (field programs, required counts, enum
    members) in both packages; the port's holds the committed golden."""
    assert set(port_codec._REGISTRY) == set(ref_codec._REGISTRY)
    assert port_codec._TYPE_WIRE_IDS == ref_codec._TYPE_WIRE_IDS
    assert list(port_codec._TYPE_WIRE_IDS) == list(ref_codec._TYPE_WIRE_IDS)
    assert port_codec._ENUM_WIRE_IDS == ref_codec._ENUM_WIRE_IDS

    def snapshot(codec):
        snap = {
            name: (codec._SCHEMAS[name].field_names, codec._SCHEMAS[name].n_required, codec._SCHEMAS[name].wire_id)
            for name in codec._REGISTRY
        }
        enums = {name: {m.name: int(m.value) for m in cls} for name, cls in codec._ENUMS.items()}
        return snap, enums

    assert snapshot(port_codec) == snapshot(ref_codec)
    golden = json.loads(schema_check.GOLDEN.read_text())
    port_snapshot = {
        "version": 1,
        "types": {
            name: {
                "id": wid,
                "fields": list(port_codec._SCHEMAS[name].field_names),
                "n_required": port_codec._SCHEMAS[name].n_required,
            }
            for name, wid in port_codec._TYPE_WIRE_IDS.items()
        },
        "enums": {
            name: {"id": wid, "members": {m.name: int(m.value) for m in port_codec._ENUMS[name]}}
            for name, wid in port_codec._ENUM_WIRE_IDS.items()
        },
    }
    assert port_snapshot == schema_check.current_snapshot()
    assert schema_check.compare(golden, port_snapshot) == []


@pytest.mark.parametrize("name", _registered())
def test_codec_frames_byte_equal_across_packages(name):
    """Seeded instances of one registered type: the JSON and binary
    payloads and envelopes are byte-equal in both packages, and each
    package decodes the other's frames to its own instance."""
    for seed in SEEDS:
        made = {}
        for pkg, codec in PACKAGES.items():
            made[pkg] = _instance(codec, codec._REGISTRY[name], np.random.default_rng([seed, len(name)]))
        frames = {
            pkg: (
                codec.encode(made[pkg]),
                codec.encode_binary(made[pkg]),
                codec.encode_envelope("parsigex/2.0.0", f"id{seed}", "req", made[pkg], False),
                codec.encode_envelope("parsigex/2.0.0", f"id{seed}", "rsp", made[pkg], True),
            )
            for pkg, codec in PACKAGES.items()
        }
        assert frames["port"] == frames["ref"], (name, seed)
        for pkg, other in (("port", "ref"), ("ref", "port")):
            codec, (js, binary, env_js, env_bin) = PACKAGES[pkg], frames[other]
            assert codec.decode(js) == made[pkg], (name, seed, pkg)
            assert codec.decode_binary(binary) == made[pkg], (name, seed, pkg)
            for env in (env_js, env_bin):
                assert codec.decode_envelope(env)["d"] == made[pkg], (name, seed, pkg)


def test_codec_refuses_the_same_malformed_frames():
    """Truncations and single-byte corruptions of a binary frame: both
    packages refuse or accept each one alike, and decode the accepted
    ones to equal re-encodings."""
    rng = np.random.default_rng(7)
    for name in ("ParSignedData", "Msg", "CryptoSubmit", "CryptoResult", "Proposal"):
        port_msg = _instance(port_codec, port_codec._REGISTRY[name], rng)
        frame = port_codec.encode_binary(port_msg)
        variants = [frame[:k] for k in range(0, len(frame), max(1, len(frame) // 16))]
        for _ in range(24):
            mutated = bytearray(frame)
            mutated[int(rng.integers(len(frame)))] ^= 1 << int(rng.integers(8))
            variants.append(bytes(mutated))
        for blob in variants:
            out = {}
            for pkg, codec in PACKAGES.items():
                try:
                    out[pkg] = codec.encode_binary(codec.decode_binary(blob))
                except codec.CodecError as e:
                    out[pkg] = ("refused", str(e))
            assert out["port"] == out["ref"], (name, blob.hex())


# -- the remote crypto-plane service across packages --------------------------

RPC_T, RPC_N = 2, 3
TENANT, TOKEN = "tenant-x", "interop-token"


def _host_impl(package: str = "charon_tpu_torch"):
    try:
        return importlib.import_module(f"{package}.tbls.native_impl").NativeImpl()
    except ImportError:
        return importlib.import_module(f"{package}.tbls.python_impl").PythonImpl()


class HostService:
    """A host stub of CryptoPlaneService: verify and recombine on a host
    tbls backend, one call at a time."""

    t = RPC_T
    coalescer = None

    def __init__(self, impl):
        self.impl = impl
        self.submits: list = []
        self._tenants: dict = {}

    def register(self, tenant_id):
        self._tenants[tenant_id] = object()

    def _ok(self, pk, msg, sig) -> bool:
        try:
            self.impl.verify(pk, msg, sig)
        except Exception:  # noqa: BLE001 — a refused signature is a False verdict
            return False
        return True

    async def submit(self, tenant_id, kind, args, lanes, deadline):
        self.submits.append((tenant_id, kind, lanes))
        if kind == "verify":
            return [self._ok(*item) for item in args[0]]
        _, roots, partials, group_pks, indices = args
        sigs = [self.impl.threshold_aggregate(dict(zip(idx, parts))) for parts, idx in zip(partials, indices)]
        return sigs, [self._ok(pk, root, sig) for pk, root, sig in zip(group_pks, roots, sigs)]


def _rpc_workload(seed: int):
    """Verify items (a good, a wrong-message and a foreign-key lane) and a
    2-validator recombine (the second with a corrupt partial) of one
    seeded 2-of-3 split, with the expected answers."""
    impl = PythonImpl()
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(2):
        sk = (int.from_bytes(rng.bytes(32), "big") % (2**250) + 1).to_bytes(32, "big")
        shares = impl.threshold_split(sk, RPC_N, RPC_T)
        root = rng.bytes(32)
        idx = (1, 3)
        parts = [impl.sign(shares[i], root) for i in idx]
        if v == 1:
            parts[1] = impl.sign(shares[2], root)  # share 2's partial claimed as share 3's
        rows.append((sk, shares, root, idx, parts))
    sk, shares, root, _, _ = rows[0]
    pk = impl.secret_to_public_key(sk)
    other = impl.secret_to_public_key(rows[1][0])
    items = [(pk, root, impl.sign(sk, root)), (pk, rng.bytes(32), impl.sign(sk, root)), (other, root, impl.sign(sk, root))]
    recombine = (
        [[impl.secret_to_public_key(shares[i]) for i in idx] for _, shares, _, idx, _ in rows],
        [root for _, _, root, _, _ in rows],
        [parts for *_, parts in rows],
        [impl.secret_to_public_key(sk) for sk, *_ in rows],
        [list(idx) for *_, idx, _ in rows],
    )
    want_sig = impl.sign(rows[0][0], rows[0][2])
    return items, recombine, [True, False, False], want_sig


class Local:
    """The local rung: every job landing here is a failover."""

    t = RPC_T

    def __init__(self):
        self.jobs = 0

    async def verify(self, items, deadline=None):
        self.jobs += 1
        return [False] * len(items)

    async def recombine(self, *args, deadline=None):
        self.jobs += 1
        return [None] * len(args[1]), [False] * len(args[1])


@pytest.mark.parametrize("server_pkg,client_pkg", [("ref", "port"), ("port", "ref")])
def test_crypto_rpc_interop_across_packages(server_pkg, client_pkg):
    """A CryptoServiceServer of one package and a RemotePlane of the
    other, over a host stub service: the handshake, a probe and the
    workload's verdicts and signature bytes, all remote."""
    server_mod = {"ref": ref_server, "port": port_server}[server_pkg]
    client_mod = {"ref": ref_client, "port": port_client}[client_pkg]
    items, recombine, want_oks, want_sig = _rpc_workload(11)
    svc = HostService(_host_impl())

    async def run():
        server = server_mod.CryptoServiceServer(svc, {TENANT: TOKEN}, HOST, 0, register_tenants=True)
        await server.start()
        local = Local()
        client = client_mod.RemotePlane(HOST, server.port, TENANT, TOKEN, local=local)
        await client.start()
        try:
            while client.state == "down":
                await asyncio.sleep(0.005)
            assert client.remote_t == RPC_T
            assert await client.verify(items[:1]) == [True]  # the probe
            assert client.state == "up"
            oks = await client.verify(items)
            sigs, sig_oks = await client.recombine(*recombine)
            return oks, sigs, sig_oks, local.jobs, client.remote_jobs, client.failovers, server.served_jobs
        finally:
            await client.close()
            await server.close()

    oks, sigs, sig_oks, local_jobs, remote_jobs, failovers, served = _run(run())
    assert oks == want_oks
    assert sigs[0] == want_sig and sig_oks == [True, False]
    assert (local_jobs, remote_jobs, failovers, served) == (0, 3, {}, 3)
    assert [kind for _, kind, _ in svc.submits] == ["verify", "verify", "recombine"]
    assert {tid for tid, _, _ in svc.submits} == {TENANT}


def test_crypto_rpc_wrong_token_is_refused_by_both_servers():
    """A client with another token is refused at the handshake by either
    package's server, and stays down with every job local."""

    async def run(server_mod, client_mod):
        svc = HostService(_host_impl())
        server = server_mod.CryptoServiceServer(svc, {TENANT: TOKEN}, HOST, 0, register_tenants=True)
        await server.start()
        local = Local()
        client = client_mod.RemotePlane(HOST, server.port, TENANT, "not-the-token", local=local)
        await client.start()
        try:
            while server.auth_failures < 2:
                await asyncio.sleep(0.005)
            assert client.state == "down" and client.connects == 0
            assert await client.verify([(b"pk", b"m", b"s")]) == [False]
            return local.jobs, client.failovers, svc.submits
        finally:
            await client.close()
            await server.close()

    for server_mod, client_mod in ((ref_server, port_client), (port_server, ref_client), (port_server, port_client)):
        assert _run(run(server_mod, client_mod)) == (1, {"down": 1}, [])


@pytest.mark.parametrize("seed", range(4))
def test_auth_proof_equal_across_packages(seed):
    rng = np.random.default_rng(seed)
    token, nonce = rng.bytes(int(rng.integers(1, 40))), rng.bytes(32)
    proof = ref_wire.auth_proof(token, nonce)
    assert port_wire.auth_proof(token, nonce) == proof
    assert port_wire.proof_ok(token, nonce, proof) and ref_wire.proof_ok(token, nonce, proof)
    assert not port_wire.proof_ok(token + b"x", nonce, proof)


class _FailingPlane:
    """A plane whose programs raise, as a device fault does."""

    t = RPC_T

    def verify_host(self, pks, msgs, sigs, rng=None):
        raise RuntimeError("device fault")

    def recombine_host(self, *args, rng=None):
        raise RuntimeError("device fault")


def test_device_error_reaches_the_remote_caller_as_tbls_error():
    """The port's service over a coalescer whose plane raises in a flush:
    the coalescer fails the flush's waiters with TblsError, the server
    sends it as a "tbls" result and the RemotePlane raises it to its
    caller with no local retry and no failover."""
    items, _, _, _ = _rpc_workload(3)
    coal = SlotCoalescer(_FailingPlane(), window=0.005, decode_mode="python", impl=TorchImpl(device="cpu"))
    svc = CryptoPlaneService(coal, round_interval=0.001)

    async def run():
        server = port_server.CryptoServiceServer(svc, {TENANT: TOKEN}, HOST, 0, register_tenants=True)
        await server.start()
        local = Local()
        client = port_client.RemotePlane(HOST, server.port, TENANT, TOKEN, local=local)
        await client.start()
        try:
            while client.state == "down":
                await asyncio.sleep(0.005)
            for _ in range(2):  # the probe, then a job of the settled connection
                with pytest.raises(TblsError, match="crypto plane flush failed: RuntimeError: device fault"):
                    await client.verify(items)
            return local.jobs, client.local_jobs, client.failovers, client.state
        finally:
            await client.close()
            await server.close()

    try:
        assert _run(run()) == (0, 0, {}, "up")
    finally:
        svc.close()
        coal.close()
    assert coal.failed_flushes == 2


# -- the p2p transport ----------------------------------------------------------

TRANSPORTS = {"ref": importlib.import_module("charon_tpu.p2p.transport"), "port": port_transport}
ADAPTERS = {"ref": importlib.import_module("charon_tpu.p2p.adapters"), "port": importlib.import_module("charon_tpu_torch.p2p.adapters")}
CLUSTER = b"\x5a" * 32


async def _pair(pkg_a: str, pkg_b: str):
    """Node 0 of package a and node 1 of package b, each listening on a
    port the kernel chose, each knowing the other's."""
    keys = [ref_k1.generate_private_key(), port_k1.generate_private_key()]
    pubs = [port_k1.public_key_to_bytes(k.public_key()) for k in keys]
    ta, tb = TRANSPORTS[pkg_a], TRANSPORTS[pkg_b]
    a = ta.P2PNode(0, keys[0], [ta.PeerSpec(0, pubs[0], HOST, 0), ta.PeerSpec(1, pubs[1], HOST, 0)], CLUSTER)
    await a.start()
    port_a = a._server.sockets[0].getsockname()[1]
    b = tb.P2PNode(1, keys[1], [tb.PeerSpec(0, pubs[0], HOST, port_a), tb.PeerSpec(1, pubs[1], HOST, 0)], CLUSTER)
    await b.start()
    a.peers[1] = ta.PeerSpec(1, pubs[1], HOST, b._server.sockets[0].getsockname()[1])
    return a, b


def _parsig(pkg: str):
    root = "charon_tpu" if pkg == "ref" else "charon_tpu_torch"
    d = importlib.import_module(f"{root}.core.eth2data")
    t = importlib.import_module(f"{root}.core.types")
    duty = t.Duty(9, t.DutyType.ATTESTER)
    psig = d.ParSignedData(data=d.SignedData("randao", 0, b"\x07" * 96), share_idx=2)
    return duty, {t.PubKey("0x" + "ab" * 48): psig}


@pytest.mark.parametrize("pkg_a,pkg_b", [("ref", "port"), ("port", "ref")])
def test_p2p_handshake_ping_and_parsig_across_packages(pkg_a, pkg_b):
    """The two packages' nodes authenticate each other with k1 in both
    dial directions, answer each other's pings, and deliver a partial
    signature set that decodes to the receiver's own containers."""

    async def run():
        a, b = await _pair(pkg_a, pkg_b)
        got = {0: [], 1: []}
        try:
            transports = []
            for node, pkg in ((a, pkg_a), (b, pkg_b)):
                tr = ADAPTERS[pkg].TcpParSigTransport(node)

                class Receiver:
                    async def receive(self, duty, sset, tctx=None, sender=None, _i=node.index):
                        got[_i].append((duty, sset, sender))

                tr.attach(Receiver())
                transports.append((tr, pkg))
            assert await a.send(1, "ping", None, await_response=True) == {"pong": 1}
            assert await b.send(0, "ping", None, await_response=True) == {"pong": 0}
            for tr, pkg in transports:
                duty, sset = _parsig(pkg)
                await tr.send(tr.node.index + 1, duty, sset)
            while not (got[0] and got[1]):
                await asyncio.sleep(0.01)
            return got
        finally:
            await a.stop()
            await b.stop()

    got = _run(run())
    for idx, pkg in ((0, pkg_a), (1, pkg_b)):
        duty, sset = _parsig(pkg)
        assert got[idx] == [(duty, sset, 2 - idx)]


@pytest.mark.parametrize("wire", [0, 1], ids=["json", "binary"])
def test_response_timeout_keeps_the_connection_and_a_failed_write_drops_it(monkeypatch, wire):
    """The port's send: a response that never comes in time counts
    toward hysteresis and leaves the connection up (the next request
    rides it), a failed write drops it, and the next send dials anew."""
    monkeypatch.setattr(port_transport, "RECV_TIMEOUT", 0.3)

    async def run():
        a, b = await _pair("port", "port")
        a.wire_version = b.wire_version = wire
        gate = asyncio.Event()

        async def mute(from_idx, msg):  # answers only once the gate opens
            await gate.wait()
            return {"late": True}

        b.register_handler("mute", mute)
        try:
            with pytest.raises(asyncio.TimeoutError):
                await a.send(1, "mute", {}, await_response=True)
            conn = a._conns[1]
            assert not conn.writer.is_closing() and a._fail_counts[1] == 1
            gate.set()
            assert await a.send(1, "ping", None, await_response=True) == {"pong": 1}
            assert a._conns[1] is conn and a._fail_counts[1] == 0

            def broken(c, body):
                raise ConnectionResetError("write failed")

            monkeypatch.setattr(port_transport, "_write_sframe", broken)
            with pytest.raises(ConnectionResetError):
                await a.send(1, "ping", None, await_response=True)
            assert 1 not in a._conns and a._fail_counts[1] == 1
            monkeypatch.undo()
            monkeypatch.setattr(port_transport, "RECV_TIMEOUT", 0.3)
            assert await a.send(1, "ping", None, await_response=True) == {"pong": 1}
            assert a._conns[1] is not conn
        finally:
            await a.stop()
            await b.stop()

    _run(run())


def test_response_timeout_drops_the_reference_connection(monkeypatch):
    """The reference's fault the port does not copy (ROADMAP section 3):
    its send pops the connection on a response timeout, so a caller
    holding the muted peer's connection loses it."""
    ref_transport = TRANSPORTS["ref"]
    monkeypatch.setattr(ref_transport, "RECV_TIMEOUT", 0.3)

    async def run():
        a, b = await _pair("ref", "port")
        gate = asyncio.Event()

        async def mute(from_idx, msg):
            await gate.wait()

        b.register_handler("mute", mute)
        try:
            with pytest.raises(asyncio.TimeoutError):
                await a.send(1, "mute", {}, await_response=True)
            return 1 in a._conns
        finally:
            gate.set()
            await a.stop()
            await b.stop()

    assert _run(run()) is False


# -- the networked ceremony -------------------------------------------------------

DKG_N, DKG_T, DKG_V = 3, 2, 1


def _reserved_ports(n: int) -> list[int]:
    """Ports the kernel hands out now, released for the ceremony's nodes
    to listen on (each node must know its peers' before any listens)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind((HOST, 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_networked_dkg_lock_verifies_in_both_packages(tmp_path):
    """Three operators' run_networked_dkg over loopback TCP on the port's
    host backend: every node writes the same lock, and the lock verifies
    in both packages under their PythonImpl."""
    port_tbls.set_implementation(_host_impl())
    keys = [port_k1.private_key_from_bytes(bytes([0x31 + i]) * 32) for i in range(DKG_N)]
    defn = port_def.ClusterDefinition(
        name="wire-ceremony",
        num_validators=DKG_V,
        threshold=DKG_T,
        fork_version="0x00000000",
        operators=tuple(
            port_def.Operator(address=f"0xop{i}", enr=port_enr.new(k).to_string()) for i, k in enumerate(keys)
        ),
        uuid="00000000-0000-0000-0000-00000000d13d",
        timestamp="2026-10-17T00:00:00Z",
    )
    for i, key in enumerate(keys):
        defn = defn.sign_operator(i, key)
    addrs = [(HOST, p) for p in _reserved_ports(DKG_N)]

    async def run():
        return await asyncio.gather(*(
            port_netdkg.run_networked_dkg(defn, i, keys[i], addrs, data_dir=tmp_path / f"node{i}", timeout=60.0)
            for i in range(DKG_N)
        ))

    results = _run(run(), 90.0)
    assert len({r.lock.lock_hash() for r in results}) == 1
    pubs = [port_k1.public_key_to_bytes(k.public_key()) for k in keys]
    data = json.loads((tmp_path / "node0" / "cluster-lock.json").read_text())
    port_tbls.set_implementation(PythonImpl())
    ref_tbls.set_implementation(RefPythonImpl())
    port_lock, ref_lock = PortLock.from_json(data), RefLock.from_json(data)
    assert port_lock.lock_hash() == ref_lock.lock_hash() == results[0].lock.lock_hash()
    port_lock.verify(pubs)
    ref_lock.verify(pubs)


# -- the simnet's remote tenants ----------------------------------------------------


def test_cluster_with_remote_tenants_runs_their_jobs_over_tcp():
    """build_cluster(crypto_service=, crypto_remote=) on the CPU, as
    chip_smoke.py's node phase runs it on the card: nodes 3 and 4 of a
    3-of-4 cluster hold a RemotePlane dialled to a port CryptoServiceServer
    over the same service (their TenantPlane the local rung), nodes 1 and
    2 their TenantPlane. After one probe each, every remote node's job of
    the slot runs remote (none local, no failover, shed or disconnect),
    the remote tenants' lanes ride the service's flushes, and all four
    nodes broadcast the same group signatures."""
    from test_torch_simnet import OraclePlane, SeededKeys, _completed_by_all, _host_backend

    from charon_tpu_torch.testutil import simnet as port_simnet

    backend = SeededKeys(_host_backend(), seed=5)
    port_tbls.set_implementation(backend)
    stats: list = []
    tokens = {f"node{i}-remote": f"token-{i}" for i in (3, 4)}

    async def run():
        coal = SlotCoalescer(OraclePlane(3), window=0.02, stats_hook=stats.append, impl=TorchImpl(device="cpu"))
        svc = CryptoPlaneService(coal)
        server = port_server.CryptoServiceServer(svc, tokens, HOST, 0, register_tenants=True)
        await server.start()
        remotes = {}

        def crypto_remote(idx, tenant_plane):
            if idx < 3:
                return tenant_plane
            tid = f"node{idx}-remote"
            remotes[idx] = port_client.RemotePlane(HOST, server.port, tid, tokens[tid], local=tenant_plane)
            return remotes[idx]

        cluster = port_simnet.build_cluster(
            n=4, t=3, num_validators=1, slot_duration=3.0, crypto_service=svc, crypto_remote=crypto_remote
        )
        for node in cluster.nodes:
            held = remotes.get(node.share_idx) or node.tenant_plane
            assert node.tenant_plane is held and node.sigagg.plane is held and node.vapi.plane is held
        gpk = cluster.group_pubkeys[0]
        root = b"\x42" * 32
        for idx, rp in remotes.items():
            await rp.start()
            while rp.state == "down":
                await asyncio.sleep(0.005)
            share = cluster.share_keys[idx - 1][gpk]
            assert await rp.verify([(cluster.pubshares_by_idx[idx][gpk], root, backend.sign(share, root))]) == [True]
        stats.clear()
        run = {}

        def slot_done():
            atts, props = _completed_by_all(cluster)
            done = set(atts) & set(props)
            if done and not run:
                run.update({i: (rp.remote_jobs, rp.local_jobs, dict(rp.failovers), dict(rp.sheds), dict(rp.disconnects))
                            for i, rp in remotes.items()})
            return done

        try:
            await _drive_cluster(cluster, slot_done)
        finally:
            for rp in remotes.values():
                await rp.close()
            await server.close()
            svc.close()
            coal.close()
        slot = min(slot_done())
        atts, props = _completed_by_all(cluster)
        assert len({a.signature for a in atts[slot]}) == 1 and len({sig for _, sig in props[slot]}) == 1
        return run

    run = _run(run(), 90.0)
    assert backend.inline == 0
    for idx, (remote_jobs, local_jobs, failovers, sheds, disconnects) in run.items():
        assert remote_jobs > 1 and local_jobs == 0 and not (failovers or sheds or disconnects), idx
    tenants = {t for s in stats for t, n in s.tenant_lanes if n}
    assert {"node3-remote", "node4-remote"} <= tenants and {"node1", "node2"} <= tenants


async def _drive_cluster(cluster, done) -> None:
    tasks = [asyncio.create_task(node.scheduler.run()) for node in cluster.nodes]
    try:
        while not done():
            await asyncio.sleep(0.05)
    finally:
        for node in cluster.nodes:
            node.scheduler.stop()
        await asyncio.gather(*tasks, return_exceptions=True)
