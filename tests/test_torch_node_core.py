"""PyTorch port: the node's duty workflow (charon_tpu_torch/core,
eth2util, app and testutil copies), held against the JAX package.

The cases of the JAX package's tests/test_core.py, test_ssz_roundtrip.py,
test_spec_blocks.py, test_inclusion.py and test_qbft.py run here on the
port's modules: `reference_cases` loads a reference test file with every
import of `charon_tpu` rebound to `charon_tpu_torch`, the host tbls
backends and the golden-file helper included (the tests install the
port's PythonImpl into the port's tbls registry, as the reference
simnet's own fixture does with the reference's). Bound in other files:
test_qbft's consensus-sniffer case (tests/test_torch_obs.py), test_spec_blocks'
HTTP-router case (tests/test_torch_node_app.py) and its wire-codec case
(tests/test_torch_wire.py).

Parity: the same seeded containers (attestation data, attestations,
deneb blocks, builder registrations, sync messages, exits, aggregates)
give byte-equal SSZ encodings, hash-tree roots and signing roots in both
packages. Tolerance: exact.

`port_globals` is the registry hygiene every port node test file uses:
tests/conftest.py restores only the JAX package's tbls backend and
feature flags, so this restores the port's.
"""

from __future__ import annotations

import asyncio
import pathlib
import random
import re
import sys
import types

import pytest

from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.app import featureset as port_featureset

_TESTS = pathlib.Path(__file__).parent
# modules of the JAX package a rebound reference test may keep: none, every
# module it imports is the port's
_REFERENCE_ONLY = ()


def reference_cases(
    name: str, drop_imports: tuple[str, ...] = (), test_modules: tuple[str, ...] = ()
) -> types.ModuleType:
    """The JAX package's tests/{name}.py, executed with every import of
    `charon_tpu` rebound to `charon_tpu_torch`.
    `drop_imports` names port modules the port does not have yet: their
    module-level `from ... import` lines become blank, and the cases that
    use them must stay out of `export_cases`. `test_modules` names other
    reference test modules it imports from (as `test_x` or `tests.test_x`):
    each import is rebound to that module's rebound copy, `port_<name>`,
    made first. The module
    keeps the reference file's path, so tracebacks and golden files
    resolve there."""
    path = _TESTS / f"{name}.py"
    src = re.sub(r"\bcharon_tpu\b", "charon_tpu_torch", path.read_text())
    for mod in test_modules:
        if f"port_{mod}" not in sys.modules:
            reference_cases(mod)
        src = re.sub(rf"(?m)^from (tests\.)?{mod} import ", f"from port_{mod} import ", src)
    for mod in drop_imports:
        src, dropped = re.subn(rf"(?m)^from {re.escape(mod)} import [^\n(]*$", "", src)
        if dropped != 1:
            raise ValueError(f"{name}: no single module-level import of {mod}")
    module = types.ModuleType(f"port_{name}")
    module.__file__ = str(path)
    sys.modules[module.__name__] = module  # dataclasses resolve it there
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


def reference_modules(case) -> set[str]:
    """The JAX package's modules (but _REFERENCE_ONLY) that a rebound
    case's globals hold: a function's or fixture's, or a `Test*` class's
    methods'."""
    if isinstance(case, type):
        fns = [v for k, v in vars(case).items() if k.startswith("test_")]
    else:
        fns = [getattr(case, "__wrapped__", case)]
    found = set()
    for fn in fns:
        for value in fn.__globals__.values():
            mod = value.__name__ if isinstance(value, types.ModuleType) else getattr(value, "__module__", None)
            if isinstance(mod, str) and re.match(r"charon_tpu(\.|$)", mod) and not mod.startswith(_REFERENCE_ONLY):
                found.add(mod)
    return found


def _is_fixture(obj) -> bool:
    return hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ == "FixtureFunctionDefinition"


def export_cases(
    module: types.ModuleType, into: dict, skip: tuple[str, ...] = (), only: tuple[str, ...] | None = None
) -> list[str]:
    """Bind the module's test functions, `Test*` classes and fixtures into
    a test file's namespace (where pytest collects them), but those in
    `skip` or, given `only`, the tests not in it; returns the names."""
    names = []
    if only is not None and not set(only) <= set(vars(module)):
        raise NameError(f"{module.__name__} has no {sorted(set(only) - set(vars(module)))}")
    for name, obj in vars(module).items():
        if name in skip or only is not None and name.startswith(("test_", "Test")) and name not in only:
            continue
        if name.startswith("test_") and callable(obj) or name.startswith("Test") and isinstance(obj, type) or _is_fixture(obj):
            if name in into and into[name] is not obj:
                raise NameError(f"{module.__name__}.{name} shadows {name}")
            into[name] = obj
            names.append(name)
    return names


@pytest.fixture(autouse=True)
def port_globals():
    """Restore the port's tbls backend and feature flags after each test."""
    impl = port_tbls._current
    fs_state = (port_featureset._min_status, set(port_featureset._enabled), set(port_featureset._disabled))
    yield
    port_tbls._current = impl
    port_featureset._min_status, port_featureset._enabled, port_featureset._disabled = fs_state


CORE_CASES = export_cases(reference_cases("test_core"), globals())
SSZ_CASES = export_cases(reference_cases("test_ssz_roundtrip"), globals())
SPEC_CASES = export_cases(
    reference_cases("test_spec_blocks"),
    globals(),
    skip=("test_proposal_wire_codec_roundtrip", "test_router_keys_proposer_by_pubkey"),
)
INCLUSION_CASES = export_cases(reference_cases("test_inclusion"), globals())
QBFT_CASES = export_cases(reference_cases("test_qbft"), globals(), skip=("test_consensus_sniffer_and_debug_endpoint",))


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's: their functions' globals hold port modules only."""
    assert (len(CORE_CASES), len(SSZ_CASES), len(SPEC_CASES), len(INCLUSION_CASES), len(QBFT_CASES)) == (
        16,
        9,
        8,
        7,
        8,
    )
    for name in CORE_CASES + INCLUSION_CASES + QBFT_CASES + SPEC_CASES:
        assert not reference_modules(globals()[name]), name


# -- parity: the same seeded containers in both packages ---------------------


def _packages():
    from charon_tpu.core import eth2data as ref_d
    from charon_tpu.eth2util import registration as ref_reg
    from charon_tpu.eth2util import signing as ref_signing
    from charon_tpu.eth2util import ssz as ref_ssz
    from charon_tpu.testutil import beaconmock as ref_bm
    from charon_tpu_torch.core import eth2data as port_d
    from charon_tpu_torch.eth2util import registration as port_reg
    from charon_tpu_torch.eth2util import signing as port_signing
    from charon_tpu_torch.eth2util import ssz as port_ssz
    from charon_tpu_torch.testutil import beaconmock as port_bm

    return (ref_d, ref_reg, ref_signing, ref_bm, ref_ssz), (port_d, port_reg, port_signing, port_bm, port_ssz)


def _containers(pkg, seed: int) -> dict[str, tuple[str, object]]:
    """Seeded duty containers of one package: name -> (signed kind, payload)."""
    d, reg, _, bm, _ = pkg
    rng = random.Random(seed)

    def b(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    slot = rng.randrange(1, 1 << 20)
    data = d.AttestationData(
        slot=slot,
        index=rng.randrange(64),
        beacon_block_root=b(32),
        source=d.Checkpoint(rng.randrange(1 << 16), b(32)),
        target=d.Checkpoint(rng.randrange(1 << 16), b(32)),
    )
    bits = tuple(rng.random() < 0.5 for _ in range(rng.randrange(1, 40)))
    att = d.Attestation(aggregation_bits=bits, data=data)
    beacon = bm.BeaconMock(validators={}, genesis_time=1_700_000_000.0 + seed)
    proposal = asyncio.run(beacon.block_proposal(slot, rng.randrange(1 << 20), b(96)))
    registration = reg.ValidatorRegistration(
        fee_recipient=b(20), gas_limit=rng.randrange(1 << 30), timestamp=rng.randrange(1 << 32), pubkey=b(48)
    )
    sync = d.SyncCommitteeMessage(slot=slot, beacon_block_root=b(32), validator_index=rng.randrange(1 << 20))
    exit_ = d.VoluntaryExit(epoch=rng.randrange(1 << 16), validator_index=rng.randrange(1 << 20))
    aggregate = d.AggregateAndProof(aggregator_index=rng.randrange(1 << 20), aggregate=att, selection_proof=b(96))
    return {
        "attestation": ("attestation", att),
        "block": ("block", proposal),
        "registration": ("registration", registration),
        "sync_message": ("sync_message", sync),
        "exit": ("exit", exit_),
        "aggregate_and_proof": ("aggregate_and_proof", aggregate),
        "randao": ("randao", slot // 32),
        "selection_proof": ("selection_proof", slot),
    }


# the containers with an SSZ wire form in both packages (the aggregate's
# nested attestation and the sync message are only ever hashed)
_WIRE_FORMS = ("attestation", "block", "registration", "exit")


@pytest.mark.parametrize("seed", range(6))
def test_seeded_containers_have_the_reference_roots(seed):
    ref, port = _packages()
    fork_args = dict(
        genesis_validators_root=bytes([seed]) * 32, fork_version=b"\x01\x02\x03\x04", genesis_fork_version=bytes(4)
    )
    ref_fork, port_fork = ref[2].ForkInfo(**fork_args), port[2].ForkInfo(**fork_args)
    ref_c, port_c = _containers(ref, seed), _containers(port, seed)
    assert ref_c.keys() == port_c.keys()
    for name in ref_c:
        kind, ref_obj = ref_c[name]
        _, port_obj = port_c[name]
        if hasattr(ref_obj, "hash_tree_root"):
            assert port_obj.hash_tree_root() == ref_obj.hash_tree_root(), name
        if name in _WIRE_FORMS:
            # a proposal's wire form is its block's
            ref_ssz_obj, port_ssz_obj = getattr(ref_obj, "block", ref_obj), getattr(port_obj, "block", port_obj)
            wire = ref[4].serialize(ref_ssz_obj)
            assert port[4].serialize(port_ssz_obj) == wire, name
            assert port[4].deserialize(type(port_ssz_obj), wire) == port_ssz_obj, name
        for epoch in (0, seed + 1):
            want = ref[0].SignedData(kind, ref_obj).signing_root(ref_fork, epoch)
            assert port[0].SignedData(kind, port_obj).signing_root(port_fork, epoch) == want, name
    assert port[1].signing_root(port_c["registration"][1], port_fork) == ref[1].signing_root(
        ref_c["registration"][1], ref_fork
    )


def test_registry_delegates_to_the_installed_backend():
    """The port's package functions dispatch to set_implementation's
    backend, as the reference's do."""
    from charon_tpu_torch.tbls.python_impl import PythonImpl

    impl = PythonImpl()
    port_tbls.set_implementation(impl)
    assert port_tbls.get_implementation() is impl
    sk = port_tbls.generate_secret_key()
    pk = port_tbls.secret_to_public_key(sk)
    assert pk == impl.secret_to_public_key(sk)
    shares = port_tbls.threshold_split(sk, 4, 3)
    root = b"\x07" * 32
    partials = {i: port_tbls.sign(shares[i], root) for i in (1, 2, 4)}
    group = port_tbls.threshold_aggregate(partials)
    assert group == impl.sign(sk, root)
    assert port_tbls.threshold_aggregate_batch([partials]) == [group]
    port_tbls.verify(pk, root, group)
    assert port_tbls.verify_batch([(pk, root, group), (pk, b"\x08" * 32, group)]) == [True, False]
    assert port_tbls.recover_secret({i: shares[i] for i in (1, 2, 3)}, 4, 3) == sk


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_qbft_round_change_survives_a_suspending_broadcast(pkg):
    """A round change must reach the peers when the broadcast suspends, as a
    TCP send does (the in-memory fabric never suspends). The engine's
    timer task restarts the timer when it fires, and the reference's
    restart cancels that very task, so its round change is cancelled at
    the broadcast's first suspension and an instance whose round-1 leader
    is absent never decides. The port's restart spares the running timer
    task: 3 of 4 nodes decide in round 2 (ROADMAP section 3)."""
    if pkg == "port":
        from charon_tpu_torch.core import qbft
    else:
        from charon_tpu.core import qbft

    n, live = 4, (1, 2, 3)  # node 0, round 1's leader, never runs
    transports: list = []

    def make_bcast(i):
        async def bcast(msg):
            await asyncio.sleep(0.001)  # a socket write's suspension
            for j in live:
                if j != i:
                    transports[j].receive(msg)

        return bcast

    transports.extend(qbft.Transport(make_bcast(i)) for i in range(n))
    defn = qbft.Definition(nodes=n, leader=lambda inst, rnd: (rnd - 1) % n, timeout=lambda rnd: 0.1 * rnd)

    async def main():
        runs = [asyncio.create_task(qbft.run(defn, transports[i], "d", i, f"v{i}")) for i in live]
        done, pending = await asyncio.wait(runs, timeout=3.0)
        for task in pending:
            task.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        return [t.result() for t in done]

    decided = asyncio.run(main())
    if pkg == "port":
        assert decided == ["v1"] * 3
    else:
        assert decided == []
