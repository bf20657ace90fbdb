"""PyTorch port: the in-memory DKG ceremony (charon_tpu_torch/dkg/ceremony.py:
a signed cluster definition through FROST and three threshold-signature
rounds to a cluster lock, keystores and deposit data) and the reshare
key hand-off (dkg/reshare.write_reshare_outputs), held against the JAX
package.

  * The JAX package's tests/test_cluster_dkg.py cases run on the port's
    modules (`reference_cases`), but `test_cli_reshare_roundtrip`, bound
    with the CLI's cases in tests/test_torch_node_app.py; and
    test_dkg_reshare.py::test_write_reshare_outputs_atomic_swap.
  * Cross-checks: a lock made by the port's run_dkg (3 nodes, t = 2, 2
    validators, the port's PythonImpl in the registry, no engine) loads
    and verifies in the reference's ClusterLock with the reference's
    backend, and a lock made by the reference's run_dkg in the port's;
    each validator's deposit signature verifies under its group key in
    both packages; a flipped byte of the aggregate signature, a changed
    deposit amount (with the stale lock hash, and resealed with a new
    one, so that the aggregate signature refuses it) and swapped node
    signatures are refused by both, with the same error.
  * The ceremony with the port's CPU BlsEngine as `engine=` (FROST's
    verification waves on the engine, the kernels' plain versions) gives
    a lock that the reference verifies.

Tolerance: exact (hashes, bytes, verdicts, error texts).
"""

from __future__ import annotations

import asyncio
import copy
import json

import pytest
import torch
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu import tbls as ref_tbls
from charon_tpu.app import k1util as ref_k1
from charon_tpu.cluster import definition as ref_def
from charon_tpu.cluster.lock import ClusterLock as RefLock
from charon_tpu.dkg import ceremony as ref_ceremony
from charon_tpu.dkg import frost as ref_frost
from charon_tpu.eth2util import deposit as ref_deposit
from charon_tpu.tbls.python_impl import PythonImpl as RefPythonImpl
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.app import k1util as port_k1
from charon_tpu_torch.cluster import definition as port_def
from charon_tpu_torch.cluster.lock import ClusterLock as PortLock
from charon_tpu_torch.dkg import ceremony as port_ceremony
from charon_tpu_torch.dkg import frost as port_frost
from charon_tpu_torch.eth2util import deposit as port_deposit
from charon_tpu_torch.eth2util import keystore
from charon_tpu_torch.tbls.python_impl import PythonImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CLUSTER_DKG_CASES = export_cases(
    reference_cases("test_cluster_dkg"), globals(), skip=("test_cli_reshare_roundtrip",)
)
RESHARE_CASES = export_cases(
    reference_cases("test_dkg_reshare"), globals(), only=("test_write_reshare_outputs_atomic_swap",)
)


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's (test_cluster_dkg's 5 cases and its backend fixture)."""
    assert (len(CLUSTER_DKG_CASES), len(RESHARE_CASES)) == (6, 1)
    for name in CLUSTER_DKG_CASES + RESHARE_CASES:
        assert not reference_modules(globals()[name]), name


N, T, V = 3, 2, 2
PACKAGES = {
    "port": (port_k1, port_def, port_frost, port_ceremony, port_tbls, PythonImpl),
    "ref": (ref_k1, ref_def, ref_frost, ref_ceremony, ref_tbls, RefPythonImpl),
}


def run_ceremony(pkg: str, data_root, engine=None):
    """The whole ceremony in one package: each operator signs the
    definition (fixed k1 keys, mainnet's fork version), then the N nodes
    run run_dkg together. Returns the operators' k1 pubkeys and each
    node's DKGResult."""
    k1, def_mod, frost, ceremony, tbls, impl = PACKAGES[pkg]
    tbls.set_implementation(impl())
    keys = [k1.private_key_from_bytes(bytes([0x20 + i]) * 32) for i in range(N)]
    defn = def_mod.ClusterDefinition(
        name=f"{pkg}-ceremony",
        num_validators=V,
        threshold=T,
        fork_version="0x00000000",
        operators=tuple(def_mod.Operator(address=f"0xop{i}", enr=f"enr:-node-{i}") for i in range(N)),
        uuid="00000000-0000-0000-0000-0000000000dc",
        timestamp="2026-10-17T00:00:00Z",
    )
    for i, key in enumerate(keys):
        defn = defn.sign_operator(i, key)
    pubs = [k1.public_key_to_bytes(k.public_key()) for k in keys]
    defn.verify_signatures(pubs)

    async def run():
        fnet, xnet = frost.MemFrostTransport(N), ceremony.MemExchangeNet(N)
        return await asyncio.gather(*(
            ceremony.run_dkg(defn, i, keys[i], fnet.participant(i + 1), xnet.port(i), engine=engine,
                             data_dir=data_root / f"node{i}")
            for i in range(N)
        ))

    return pubs, asyncio.run(run())


def _lock_json(data_root) -> dict:
    return json.loads((data_root / "node0" / "cluster-lock.json").read_text())


def _tampered(lock_json: dict) -> dict[str, dict]:
    sig = bytearray(bytes.fromhex(lock_json["signature_aggregate"][2:]))
    sig[40] ^= 1
    flipped = dict(lock_json, signature_aggregate="0x" + sig.hex())
    amount = copy.deepcopy(lock_json)
    amount["distributed_validators"][1]["deposit_data"]["amount"] = "31000000000"
    resealed = {k: v for k, v in amount.items() if k != "lock_hash"}
    resealed["lock_hash"] = "0x" + PortLock.from_json(resealed).lock_hash().hex()
    swapped = dict(lock_json, node_signatures=lock_json["node_signatures"][::-1])
    return {"signature": flipped, "amount": amount, "resealed_amount": resealed, "node_signatures": swapped}


def _refusal(lock_cls, data: dict, pubs) -> str:
    with pytest.raises((ValueError, port_tbls.TblsError, ref_tbls.TblsError)) as err:
        lock_cls.from_json(data).verify(pubs)
    return f"{type(err.value).__name__}: {err.value}"


def _check_lock_across(maker: str, pubs, results, data_root) -> None:
    """The maker's lock verifies in both packages, its deposits verify
    under the group keys in both, each node's keystores hold its shares,
    and both packages refuse each tampering with the same error."""
    port_tbls.set_implementation(PythonImpl())
    ref_tbls.set_implementation(RefPythonImpl())
    assert len({r.lock.lock_hash() for r in results}) == 1
    assert len({r.lock.signature_aggregate for r in results}) == 1
    data = _lock_json(data_root)
    port_lock, ref_lock = PortLock.from_json(data), RefLock.from_json(data)
    assert port_lock.lock_hash() == ref_lock.lock_hash() == results[0].lock.lock_hash()
    port_lock.verify(pubs)
    ref_lock.verify(pubs)
    deposits = json.loads((data_root / "node0" / "deposit-data.json").read_text())
    assert [d["pubkey"] for d in deposits] == [v.distributed_public_key[2:] for v in port_lock.validators]
    for d in deposits:
        pubkey, sig = bytes.fromhex(d["pubkey"]), bytes.fromhex(d["signature"])
        for dep, tbls in ((port_deposit, port_tbls), (ref_deposit, ref_tbls)):
            msg = dep.DepositMessage(pubkey, bytes.fromhex(d["withdrawal_credentials"]), int(d["amount"]))
            assert msg.hash_tree_root().hex() == d["deposit_message_root"]
            tbls.verify(pubkey, dep.signing_root(msg, bytes(4)), sig)
    for i, r in enumerate(results):
        assert keystore.load_keys(data_root / f"node{i}" / "validator_keys") == r.share_secrets
    for name, bad in _tampered(data).items():
        port_err, ref_err = _refusal(PortLock, bad, pubs), _refusal(RefLock, bad, pubs)
        assert port_err == ref_err, (maker, name)
        assert port_err == {
            # the secrets are random: the flipped point is off the curve or off the subgroup
            "signature": port_err if port_err.startswith("TblsError: G2 ") else "a G2 decode error",
            "amount": "ValueError: lock hash mismatch",
            "resealed_amount": "TblsError: aggregate signature verification failed",
            "node_signatures": "ValueError: bad node signature from operator 0",
        }[name], (maker, name)


@pytest.mark.parametrize("maker", ["port", "ref"])
def test_ceremony_lock_verifies_in_both_packages(maker, tmp_path):
    pubs, results = run_ceremony(maker, tmp_path)
    _check_lock_across(maker, pubs, results, tmp_path)


def test_ceremony_on_the_cpu_engine(tmp_path):
    """run_dkg with the port's BlsEngine(device="cpu") as `engine=`: the
    FROST waves on the engine, the same checks."""
    from charon_tpu_torch.ops.blsops import BlsEngine

    pubs, results = run_ceremony("port", tmp_path, engine=BlsEngine(device="cpu"))
    _check_lock_across("port", pubs, results, tmp_path)
