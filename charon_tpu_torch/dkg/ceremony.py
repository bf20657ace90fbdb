"""DKG ceremony orchestration: definition -> FROST -> signed lock + keys.

Mirrors ref: dkg/dkg.go:82-200 — load + verify the signed definition, run
the sync protocol, execute FROST, exchange partial signatures over the
lock hash (ref: dkg/exchanger.go, sigTypes dkg.go:190-194), aggregate +
verify, emit cluster-lock.json + EIP-2335 keystores + per-node k1
signatures (ref: dkg/nodesigs.go, outputs dkg/disk.go).
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass, field
from pathlib import Path

from charon_tpu_torch import tbls
from charon_tpu_torch.app import k1util
from charon_tpu_torch.cluster.definition import ClusterDefinition
from charon_tpu_torch.cluster.lock import ClusterLock, DistributedValidator
from charon_tpu_torch.crypto.g1g2 import g1_to_bytes
from charon_tpu_torch.dkg import frost
from charon_tpu_torch.eth2util import keystore


@dataclass
class DKGResult:
    lock: ClusterLock
    # repr=False: the auto-repr would dump every validator's share key
    # into any log/traceback formatting the result (secret-flow lint)
    share_secrets: list[bytes] = field(repr=False)  # per validator (32B)
    deposits: list = None  # eth2util.deposit.DepositData per validator


class MemExchangeNet:
    """Lockstep all-to-all exchange rounds keyed by tag (in-process DKG;
    the TCP ceremony uses the p2p mesh with the same interface)."""

    def __init__(self, n: int) -> None:
        self.n = n
        self._rounds: dict[str, dict[int, object]] = {}
        self._events: dict[str, asyncio.Event] = {}

    def port(self, idx: int) -> "_Port":
        return _Port(self, idx)


class _Port:
    def __init__(self, net: MemExchangeNet, idx: int) -> None:
        self.net = net
        self.idx = idx

    async def exchange(self, tag: str, payload) -> dict[int, object]:
        net = self.net
        rnd = net._rounds.setdefault(tag, {})
        ev = net._events.setdefault(tag, asyncio.Event())
        rnd[self.idx] = payload
        if len(rnd) == net.n:
            ev.set()
        await ev.wait()
        return dict(rnd)


async def run_dkg(
    defn: ClusterDefinition,
    node_idx: int,  # 0-based operator index
    k1_privkey,
    frost_port,
    exchange_port,
    engine=None,
    data_dir: str | Path | None = None,
) -> DKGResult:
    """One node's side of the ceremony."""
    n = len(defn.operators)
    t = defn.threshold
    v = defn.num_validators
    share_idx = node_idx + 1  # 1-based

    # 1. FROST: parallel ceremonies over two transport rounds
    # (ceremony context binds to the definition, ref: dkg.go def hash use).
    ctx = defn.definition_hash()
    results = await frost.run_frost_parallel(
        frost_port, share_idx, n, t, v, ctx, engine=engine
    )

    # 2. Build the (to-be-sealed) validator entries. Deposits and builder
    # registrations are signed and patched in BEFORE the lock hash is
    # computed — the lock hash covers them (ref: dkg.go runs the
    # exchanger's deposit/registration sig rounds first and the lock-hash
    # sig round last, dkg.go:190-194).
    validators = tuple(
        DistributedValidator(
            distributed_public_key="0x" + g1_to_bytes(r.group_pubkey).hex(),
            public_shares=tuple(
                "0x" + g1_to_bytes(r.pubshares[j]).hex()
                for j in range(1, n + 1)
            ),
        )
        for r in results
    )
    share_secrets = [
        (r.secret_share % (1 << 256)).to_bytes(32, "big") for r in results
    ]

    # 2b. Deposit data: threshold-sign each validator's deposit message
    # (ref: dkg/exchanger.go sigDepositData — partials exchanged and
    # aggregated exactly like the lock signature).
    from charon_tpu_torch.eth2util import deposit as dep

    fork_version = bytes.fromhex(defn.fork_version[2:])
    deposit_msgs = [
        dep.DepositMessage(
            pubkey=bytes.fromhex(dv.distributed_public_key[2:]),
            withdrawal_credentials=dep.withdrawal_credentials_bls(
                bytes.fromhex(dv.distributed_public_key[2:])
            ),
            amount=dep.DEFAULT_AMOUNT_GWEI,
        )
        for dv in validators
    ]
    deposit_roots = [
        dep.signing_root(m, fork_version) for m in deposit_msgs
    ]
    my_dep_partials = [
        tbls.sign(share_secrets[i], deposit_roots[i]) for i in range(v)
    ]
    all_dep = await exchange_port.exchange(
        "deposit-sig", [s.hex() for s in my_dep_partials]
    )
    deposit_sigs = tbls.threshold_aggregate_batch(
        [
            {
                peer + 1: bytes.fromhex(all_dep[peer][i])
                for peer in sorted(all_dep)
            }
            for i in range(v)
        ]
    )
    deposits = []
    for msg, sig, root, dv in zip(
        deposit_msgs, deposit_sigs, deposit_roots, validators
    ):
        tbls.verify(
            bytes.fromhex(dv.distributed_public_key[2:]), root, sig
        )
        deposits.append(
            dep.DepositData(
                pubkey=msg.pubkey,
                withdrawal_credentials=msg.withdrawal_credentials,
                amount=msg.amount,
                signature=sig,
            )
        )

    import json as _json
    from dataclasses import replace as _replace

    validators = tuple(
        _replace(
            dv,
            deposit_data=_json.loads(
                dep.deposit_data_json([d], fork_version, defn.name)
            )[0],
        )
        for dv, d in zip(validators, deposits)
    )

    # 2c. Pre-generated builder registrations: threshold-sign a default
    # ValidatorRegistration per validator so the node can re-broadcast
    # them every epoch without a VC (ref: dkg.go:190-194 sigTypes include
    # registrations; core/bcast/recast.go consumes them from the lock).
    from charon_tpu_torch.eth2util import network as networks
    from charon_tpu_torch.eth2util import registration as regmod
    from charon_tpu_torch.eth2util.signing import ForkInfo as _ForkInfo

    fee_recipient = bytes(20)
    if getattr(defn, "fee_recipient_address", ""):
        raw = defn.fee_recipient_address
        fee_recipient = bytes.fromhex(raw[2:] if raw.startswith("0x") else raw)
    reg_fork = _ForkInfo(
        genesis_validators_root=bytes(32),
        fork_version=fork_version,
        genesis_fork_version=fork_version,
    )
    reg_msgs = [
        regmod.ValidatorRegistration(
            fee_recipient=fee_recipient,
            gas_limit=regmod.DEFAULT_GAS_LIMIT,
            timestamp=networks.genesis_time(fork_version, default=0),
            pubkey=bytes.fromhex(dv.distributed_public_key[2:]),
        )
        for dv in validators
    ]
    reg_roots = [regmod.signing_root(m, reg_fork) for m in reg_msgs]
    my_reg_partials = [
        tbls.sign(share_secrets[i], reg_roots[i]) for i in range(v)
    ]
    all_reg = await exchange_port.exchange(
        "registration-sig", [s.hex() for s in my_reg_partials]
    )
    reg_sigs = tbls.threshold_aggregate_batch(
        [
            {
                peer + 1: bytes.fromhex(all_reg[peer][i])
                for peer in sorted(all_reg)
            }
            for i in range(v)
        ]
    )
    patched = []
    for dv, msg, sig, root in zip(validators, reg_msgs, reg_sigs, reg_roots):
        tbls.verify(
            bytes.fromhex(dv.distributed_public_key[2:]), root, sig
        )
        patched.append(
            _replace(
                dv, builder_registration=regmod.to_lock_json(msg, sig)
            )
        )
    validators = tuple(patched)

    # 3. The lock hash seals everything above. Exchange partial
    # signatures over it: every node signs with each validator's share
    # key (ref: dkg/exchanger.go sigLock — the LAST sig round).
    lock_hash = ClusterLock(definition=defn, validators=validators).lock_hash()
    my_partials = [
        tbls.sign(share_secrets[i], lock_hash) for i in range(v)
    ]
    all_partials = await exchange_port.exchange(
        "lock-sig", [s.hex() for s in my_partials]
    )

    # 4. Threshold-aggregate each validator's group signature, then
    # BLS-aggregate across validators (ref: lock signature_aggregate).
    group_sigs = tbls.threshold_aggregate_batch(
        [
            {
                peer + 1: bytes.fromhex(all_partials[peer][i])
                for peer in sorted(all_partials)
            }
            for i in range(v)
        ]
    )
    sig_agg = tbls.aggregate(group_sigs)
    tbls.verify_aggregate(
        [bytes.fromhex(dv.distributed_public_key[2:]) for dv in validators],
        lock_hash,
        sig_agg,
    )

    # 5. Per-node k1 signatures over the lock hash
    # (ref: dkg/nodesigs.go via the reliable-broadcast component).
    my_node_sig = k1util.sign(k1_privkey, lock_hash)
    all_node_sigs = await exchange_port.exchange(
        "node-sig", my_node_sig.hex()
    )
    lock = ClusterLock(
        definition=defn,
        validators=validators,
        signature_aggregate="0x" + sig_agg.hex(),
        node_signatures=tuple(
            all_node_sigs[i] for i in sorted(all_node_sigs)
        ),
    )

    # 6. Outputs (ref: dkg/disk.go — lock, keystores, passwords,
    # deposit-data.json).
    if data_dir is not None:
        data_dir = Path(data_dir)
        data_dir.mkdir(parents=True, exist_ok=True)
        lock.save(str(data_dir / "cluster-lock.json"))
        # keystore I/O IS the ceremony's output: shares leave only as
        # EIP-2335-encrypted keystores
        # lint: allow(secret-flow)
        keystore.store_keys(
            share_secrets,
            data_dir / "validator_keys",
            pubkeys=[
                dv.public_shares[node_idx] for dv in validators
            ],
        )
        (data_dir / "deposit-data.json").write_text(
            dep.deposit_data_json(deposits, fork_version, defn.name)
        )
    return DKGResult(
        lock=lock, share_secrets=share_secrets, deposits=deposits
    )
