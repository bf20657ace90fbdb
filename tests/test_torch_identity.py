"""PyTorch port: node identity, keys and cluster configuration
(charon_tpu_torch/app/k1util.py, eth2util/{keccak,rlp,enr,eip712,keystore,
deposit,network,keymanager}.py, cluster/{definition,lock,manifest}.py, the
process helpers app/{lifecycle,forkjoin}.py, testutil/golden.py and the
signed QBFT of core/consensus_qbft.py), held against the JAX package.

  * The JAX package's cases run on the port's modules (`reference_cases`):
    test_eth2util_ext.py; test_golden.py but `test_wire_envelope_golden`
    (bound in tests/test_torch_wire.py), against the same committed golden
    files; test_app_infra.py's lifecycle and fork-join cases (its other
    cases are bound in tests/test_torch_obs.py); the whole of
    test_security.py, whose signed-QBFT cases run over the port's k1util;
    and the whole of test_manifest.py, whose clusters the port's
    `create-cluster` writes (cmd/cli.py).
  * Parity: for the same operators and settings both packages give equal
    config and definition hashes, lock hashes, EIP-712 digests, ENR
    records and deposit-data JSON; a definition, a lock or an ENR signed by
    one package verifies in the other; each package's keystore decrypts the
    other's, and with the same salt, IV and uuid the JSON is byte-equal; a
    k1 signature made by either verifies under the other, and ECDH agrees.
  * Manifests: besides the rebound cases, direct parity: the same chain of
    mutations gives equal heads and materialised lock hashes in both
    packages, each loads the other's manifest file, and both refuse a
    non-operator approval and a broken chain with the same error.

k1 signatures are randomized (ECDSA with random nonces, as the
reference's), so a parity over signed bytes signs once and hands the
result to the other package. Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import json
import secrets
import uuid

import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu.app import k1util as ref_k1
from charon_tpu.cluster import definition as ref_def
from charon_tpu.cluster import lock as ref_lock
from charon_tpu.cluster import manifest as ref_manifest
from charon_tpu.eth2util import deposit as ref_deposit
from charon_tpu.eth2util import eip712 as ref_eip712
from charon_tpu.eth2util import enr as ref_enr
from charon_tpu.eth2util import keystore as ref_keystore
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.app import k1util as port_k1
from charon_tpu_torch.cluster import definition as port_def
from charon_tpu_torch.cluster import lock as port_lock
from charon_tpu_torch.cluster import manifest as port_manifest
from charon_tpu_torch.eth2util import deposit as port_deposit
from charon_tpu_torch.eth2util import eip712 as port_eip712
from charon_tpu_torch.eth2util import enr as port_enr
from charon_tpu_torch.eth2util import keystore as port_keystore
from charon_tpu_torch.tbls.python_impl import PythonImpl

ETH2UTIL_CASES = export_cases(reference_cases("test_eth2util_ext"), globals())
GOLDEN_CASES = export_cases(reference_cases("test_golden"), globals(), skip=("test_wire_envelope_golden",))
APP_INFRA_CASES = export_cases(
    reference_cases("test_app_infra"),
    globals(),
    only=("test_lifecycle_order_and_shutdown", "test_forkjoin_bounded_order_and_failures"),
)
SECURITY_CASES = export_cases(reference_cases("test_security"), globals())
# its host_tbls is this file's own, below
MANIFEST_CASES = export_cases(reference_cases("test_manifest"), globals(), skip=("host_tbls",))


@pytest.fixture(autouse=True)
def host_tbls():
    """The port's PythonImpl in the port's registry, where the reference
    cases find the reference's by default."""
    port_tbls.set_implementation(PythonImpl())


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    assert (len(ETH2UTIL_CASES), len(GOLDEN_CASES), len(APP_INFRA_CASES), len(SECURITY_CASES), len(MANIFEST_CASES)) == (
        15, 4, 2, 12, 7
    )
    for name in ETH2UTIL_CASES + GOLDEN_CASES + APP_INFRA_CASES + SECURITY_CASES + MANIFEST_CASES:
        assert not reference_modules(globals()[name]), name


N_OPS = 4
PACKAGES = {
    "port": (port_k1, port_enr, port_def, port_lock, port_manifest),
    "ref": (ref_k1, ref_enr, ref_def, ref_lock, ref_manifest),
}


def _key_bytes(i: int) -> bytes:
    return bytes([0x40 + i]) * 32


def _operators(pkg: str, signed_enrs: list[str] | None = None):
    """The operators' k1 keys and a definition naming them by ENR."""
    k1, enr, defn_mod, _, _ = PACKAGES[pkg]
    keys = [k1.private_key_from_bytes(_key_bytes(i)) for i in range(N_OPS)]
    enrs = signed_enrs or [enr.new(k, ip="10.0.0.1", tcp=3610 + i).to_string() for i, k in enumerate(keys)]
    defn = defn_mod.ClusterDefinition(
        name="parity",
        num_validators=2,
        threshold=3,
        fork_version="0x00000000",
        operators=tuple(defn_mod.Operator(address=f"0x{i:040x}", enr=e) for i, e in enumerate(enrs)),
        uuid="00000000-0000-0000-0000-00000000c0de",
        timestamp="2026-10-17T00:00:00Z",
        fee_recipient_address="0x" + "ab" * 20,
        withdrawal_address="0x" + "cd" * 20,
    )
    return keys, defn


def _validators(lock_mod, count: int = 2, tag: int = 0):
    return tuple(
        lock_mod.DistributedValidator(
            distributed_public_key="0x" + bytes([tag + v + 1] * 48).hex(),
            public_shares=tuple("0x" + bytes([tag + v + 1, j]).hex() * 24 for j in range(N_OPS)),
            deposit_data={"amount": "32000000000", "signature": "0x" + "5a" * 96},
            builder_registration={"message": {"gas_limit": 30_000_000}, "signature": "0x" + "a5" * 96},
        )
        for v in range(count)
    )


def test_definition_and_lock_hashes_are_equal():
    port_keys, port_defn = _operators("port")
    enrs = [op.enr for op in port_defn.operators]
    _, ref_defn = _operators("ref", signed_enrs=enrs)
    assert port_defn.config_hash() == ref_defn.config_hash()
    assert port_defn.definition_hash() == ref_defn.definition_hash()
    assert port_defn.config_signature_digest() == ref_defn.config_signature_digest()
    for e in enrs:
        assert port_defn.enr_signature_digest(e) == ref_defn.enr_signature_digest(e)
    # signed by the port: the reference reads the same hashes and accepts the signatures
    for i, key in enumerate(port_keys):
        port_defn = port_defn.sign_operator(i, key)
    pubs = [port_k1.public_key_to_bytes(k.public_key()) for k in port_keys]
    loaded = ref_def.ClusterDefinition.from_json(json.loads(json.dumps(port_defn.to_json())))
    loaded.verify_signatures(pubs)
    assert loaded.definition_hash() == port_defn.definition_hash()
    assert loaded.to_json() == port_defn.to_json()
    # and the other way round
    ref_keys = [ref_k1.private_key_from_bytes(_key_bytes(i)) for i in range(N_OPS)]
    for i, key in enumerate(ref_keys):
        ref_defn = ref_defn.sign_operator(i, key)
    back = port_def.ClusterDefinition.from_json(ref_defn.to_json())
    back.verify_signatures(pubs)
    assert back.definition_hash() == ref_defn.definition_hash()
    with pytest.raises(ValueError, match="bad config signature") as port_err:
        back.verify_signatures(pubs[::-1])
    with pytest.raises(ValueError, match="bad config signature") as ref_err:
        ref_defn.verify_signatures(pubs[::-1])
    assert str(port_err.value) == str(ref_err.value)
    # the lock over that definition
    port_l = port_lock.ClusterLock(definition=back, validators=_validators(port_lock), signature_aggregate="0x00")
    ref_l = ref_lock.ClusterLock(definition=ref_defn, validators=_validators(ref_lock), signature_aggregate="0x00")
    assert port_l.lock_hash() == ref_l.lock_hash()
    assert port_l.to_json() == ref_l.to_json()
    assert ref_lock.ClusterLock.from_json(port_l.to_json()).lock_hash() == port_l.lock_hash()
    assert port_l.fork_info() == port_lock.ClusterLock.from_json(ref_l.to_json()).fork_info()


def test_eip712_digests_are_equal():
    for mod_fields in (
        [("config_hash", "bytes32", b"\x11" * 32)],
        [("enr", "string", "enr:-abc"), ("amount", "uint256", 32 * 10**9), ("to", "address", "0x" + "12" * 20)],
    ):
        digests = []
        for mod in (port_eip712, ref_eip712):
            dom = mod.Domain(name="charon-tpu", version="1.0", chain_id=1)
            data = mod.TypedData(primary_type="Parity", fields=tuple(mod.Field(*f) for f in mod_fields))
            digests.append((dom.separator(), mod.hash_struct(data), mod.hash_typed_data(dom, data)))
        assert digests[0] == digests[1]


def test_enr_records_are_equal_and_verify_across():
    for i in range(N_OPS):
        port_key = port_k1.private_key_from_bytes(_key_bytes(i))
        ref_key = ref_k1.private_key_from_bytes(_key_bytes(i))
        kw = dict(seq=i + 1, ip=f"192.168.0.{i}", tcp=9000 + i, extra={"eth2": bytes([i]) * 16})
        port_rec, ref_rec = port_enr.new(port_key, **kw), ref_enr.new(ref_key, **kw)
        assert port_rec.kvs == ref_rec.kvs and port_rec.signing_digest() == ref_rec.signing_digest()
        # the same signature: the same string
        same = ref_enr.Record(signature=port_rec.signature, seq=ref_rec.seq, kvs=ref_rec.kvs)
        assert same.to_string() == port_rec.to_string()
        for text in (port_rec.to_string(), ref_rec.to_string()):
            assert port_enr.parse(text).to_string() == ref_enr.parse(text).to_string() == text
            assert port_enr.pubkey_from_string(text) == ref_enr.pubkey_from_string(text)
        tampered = port_rec.to_string()[:-4] + ("AAAA" if not port_rec.to_string().endswith("AAAA") else "BBBB")
        errors = []
        for mod in (port_enr, ref_enr):
            with pytest.raises(ValueError) as err:
                mod.parse(tampered)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def test_k1_signatures_verify_across_packages():
    digest = bytes(range(32))
    for i in range(N_OPS):
        port_key = port_k1.private_key_from_bytes(_key_bytes(i))
        ref_key = ref_k1.private_key_from_bytes(_key_bytes(i))
        pub = port_k1.public_key_to_bytes(port_key.public_key())
        assert pub == ref_k1.public_key_to_bytes(ref_key.public_key())
        assert port_k1.private_key_to_bytes(port_key) == ref_k1.private_key_to_bytes(ref_key) == _key_bytes(i)
        port_sig, ref_sig = port_k1.sign(port_key, digest), ref_k1.sign(ref_key, digest)
        assert ref_k1.verify_bytes(pub, digest, port_sig) and port_k1.verify_bytes(pub, digest, ref_sig)
        assert not ref_k1.verify_bytes(pub, digest[::-1], port_sig)
        assert not port_k1.verify_bytes(pub, digest[::-1], ref_sig)
        peer = port_k1.public_key_to_bytes(port_k1.private_key_from_bytes(_key_bytes(i + 1)).public_key())
        assert port_k1.ecdh(port_key, peer) == ref_k1.ecdh(ref_key, peer)


def test_deposit_data_json_is_equal():
    out = []
    for mod in (port_deposit, ref_deposit):
        datas = []
        for v in range(2):
            pubkey = bytes([0x80 + v]) + bytes([v]) * 47
            for creds in (mod.withdrawal_credentials_bls(pubkey), mod.withdrawal_credentials_eth1("0x" + "ab" * 20)):
                msg = mod.DepositMessage(pubkey, creds, mod.DEFAULT_AMOUNT_GWEI)
                datas.append(mod.DepositData(pubkey, creds, msg.amount, bytes([v]) * 96))
                out.append(("root", mod.signing_root(msg, b"\x00\x00\x00\x00"), msg.hash_tree_root()))
        out.append(("json", mod.deposit_data_json(datas, b"\x00\x00\x00\x00", "mainnet")))
    half = len(out) // 2
    assert out[:half] == out[half:]


def test_keystores_decrypt_across_and_match_with_the_same_randomness(monkeypatch, tmp_path):
    secret = bytes(range(1, 33))
    draws: list[bytes] = []

    def token_bytes(n):
        draws.append(bytes([len(draws) + 1]) * n)
        return draws[-1]

    monkeypatch.setattr(secrets, "token_bytes", token_bytes)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=len(draws)))
    stores = []
    for mod in (port_keystore, ref_keystore):
        draws.clear()
        stores.append(mod.encrypt(secret, "correct horse", pubkey_hex="0x" + "aa" * 48, path="m/12381/3600/0/0/0"))
    assert json.dumps(stores[0]) == json.dumps(stores[1])
    monkeypatch.undo()
    port_ks = port_keystore.encrypt(secret, "pw")
    ref_ks = ref_keystore.encrypt(secret, "pw")
    assert port_ks != ref_ks  # fresh salt, IV and uuid
    assert ref_keystore.decrypt(port_ks, "pw") == port_keystore.decrypt(ref_ks, "pw") == secret
    errors = []
    for mod, ks in ((port_keystore, ref_ks), (ref_keystore, port_ks)):
        with pytest.raises(ValueError) as err:
            mod.decrypt(ks, "wrong")
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    # a directory stored by the port loads in the reference, and back
    port_keystore.store_keys([secret, secret[::-1]], tmp_path / "port")
    ref_keystore.store_keys([secret[::-1], secret], tmp_path / "ref")
    assert ref_keystore.load_keys(tmp_path / "port") == [secret, secret[::-1]]
    assert port_keystore.load_keys(tmp_path / "ref") == [secret[::-1], secret]


def _chain(pkg: str, stranger: bool = False):
    """A genesis from the parity lock, an add_validators mutation and every
    operator's approval (or a stranger's first), built by one package."""
    k1, _, _, lock_mod, man = PACKAGES[pkg]
    keys, defn = _operators(pkg)
    for i, key in enumerate(keys):
        defn = defn.sign_operator(i, key)
    lock = lock_mod.ClusterLock(definition=defn, validators=_validators(lock_mod), signature_aggregate="0x00")
    genesis = man.SignedMutation(
        parent=man.GENESIS_PARENT, type=man.TYPE_LEGACY_LOCK, timestamp=1, data={"lock": lock.to_json()}
    )
    manifest = man.Manifest(mutations=(genesis,))
    add = dataclasses.replace(manifest.propose_add_validators(list(_validators(lock_mod, 1, tag=9))), timestamp=2)
    manifest = manifest.append(add)
    signers = ([k1.private_key_from_bytes(b"\x7f" * 32)] if stranger else []) + keys
    for key in signers:
        manifest = manifest.append(manifest.approve(add.hash(), key))
    return manifest


@pytest.mark.parametrize("maker", ["port", "ref"])
def test_manifest_chains_are_equal_and_load_across(maker, tmp_path):
    manifest = _chain(maker)
    other = "ref" if maker == "port" else "port"
    path = tmp_path / "cluster-manifest.json"
    manifest.save(str(path))
    loaded = PACKAGES[other][4].Manifest.load(str(path))
    assert loaded.head() == manifest.head()
    assert [m.hash() for m in loaded.mutations] == [m.hash() for m in manifest.mutations]
    # each prefix materialises to the same lock: the new validator only after every approval
    for k in range(1, len(manifest.mutations) + 1):
        mine = dataclasses.replace(manifest, mutations=manifest.mutations[:k]).materialise()
        theirs = dataclasses.replace(loaded, mutations=loaded.mutations[:k]).materialise()
        assert mine.lock_hash() == theirs.lock_hash()
        assert len(mine.validators) == (3 if k == len(manifest.mutations) else 2)
    # the genesis lock loads and equals the lock it was made from
    lock_path = tmp_path / "cluster-lock.json"
    manifest.materialise().save(str(lock_path))
    assert PACKAGES[other][3].ClusterLock.load(str(lock_path)).lock_hash() == manifest.materialise().lock_hash()
    assert PACKAGES[other][4].load_cluster_state(tmp_path).lock_hash() == manifest.materialise().lock_hash()


def test_manifest_refusals_are_equal():
    errors = []
    for pkg in ("port", "ref"):
        man = PACKAGES[pkg][4]
        stray = _chain(pkg, stranger=True)
        with pytest.raises(ValueError) as non_operator:
            stray.materialise()
        good = _chain(pkg)
        orphan = man.SignedMutation(parent=b"\x13" * 32, type="add_validators", timestamp=0, data={"validators": []})
        with pytest.raises(ValueError) as bad_parent:
            good.append(orphan)
        with pytest.raises(ValueError) as broken:
            man.Manifest(mutations=good.mutations + (orphan,)).materialise()
        errors.append((str(non_operator.value), str(bad_parent.value), str(broken.value)))
    assert errors[0] == errors[1]
    assert errors[0] == (
        "approval from non-operator",
        "mutation parent does not match manifest head",
        "broken mutation chain",
    )
