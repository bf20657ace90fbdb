"""PyTorch port: the FROST and resharing ceremonies (charon_tpu_torch/dkg/).

The cases of tests/test_dkg_frost.py and tests/test_dkg_reshare.py, copied
onto the port's modules (the keystore hand-off is not ported, and a
signature is checked by equality with the group secret's, as the port's
crypto copy has no pairing); then the same round-1 messages, built once, go
to the JAX package's host round 2 and to the port's round 2 with
`BlsEngine(device="cpu")`, whose results must be equal field by field, and
a tampered share, proof of knowledge and sub-share must raise the
reference's message on both.
"""

from __future__ import annotations

import asyncio
import random

import pytest
import torch

from charon_tpu.dkg import frost as ref_frost
from charon_tpu.dkg import reshare as ref_reshare
from charon_tpu_torch.crypto import bls, shamir
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.crypto.g1g2 import G1_GEN, g1_mul, g1_to_bytes
from charon_tpu_torch.dkg import frost, reshare
from charon_tpu_torch.ops.blsops import BlsEngine

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX = b"cluster-def-hash"


# -- FROST: the reference's cases on the port's module ------------------------------


def run_frost(n=4, t=3, v=2, engine=None):
    async def run():
        net = frost.MemFrostTransport(n)
        tasks = [frost.run_frost_parallel(net.participant(i), i, n, t, v, CTX, engine=engine) for i in range(1, n + 1)]
        return await asyncio.gather(*tasks)

    return asyncio.run(run())


def check_frost(results, n, t, v):
    for val in range(v):
        # every node derived the same group pubkey and pubshares
        assert len({g1_to_bytes(results[i][val].group_pubkey) for i in range(n)}) == 1
        pubshares = results[0][val].pubshares
        for i in range(1, n):
            assert results[i][val].pubshares == pubshares
        # each node's secret share matches its pubshare
        for i in range(n):
            assert bls.sk_to_pk(results[i][val].secret_share) == pubshares[i + 1]
        # any t shares recover a secret matching the group pubkey
        group_secret = shamir.recover_secret({i + 1: results[i][val].secret_share for i in range(t)})
        assert bls.sk_to_pk(group_secret) == results[0][val].group_pubkey
        # threshold signing: t partials recombine to the group key's signature
        msg = b"frost validator %d" % val
        partials = {i + 1: bls.sign(results[i][val].secret_share, msg) for i in range(1, 1 + t)}
        assert shamir.threshold_aggregate_g2(partials) == bls.sign(group_secret, msg)


def test_frost_outputs_consistent_threshold_keys():
    n, t, v = 4, 3, 2
    check_frost(run_frost(n, t, v), n, t, v)


def test_frost_rejects_bad_share():
    n, t, v = 3, 2, 1
    parts = {i: frost.FrostParticipant(i, n, t, v, CTX) for i in range(1, n + 1)}
    r1 = {i: parts[i].round1() for i in parts}
    all_bcasts = {i: r1[i][0] for i in parts}
    shares_to_1 = {i: r1[i][1][1] for i in parts}
    shares_to_1[2] = frost.Round1Shares(shares=tuple((s + 1) % R for s in shares_to_1[2].shares))
    with pytest.raises(ValueError, match="invalid share from peer 2"):
        parts[1].round2(all_bcasts, shares_to_1)


def test_round1_shares_repr_never_shows_share_scalars():
    sh = frost.Round1Shares(shares=(0xDEADBEEFCAFE, 0x1234567890AB))
    for rendered in (repr(sh), str(sh), f"{sh}"):
        assert "deadbeefcafe" not in rendered.lower()
        assert str(0xDEADBEEFCAFE) not in rendered
    assert rendered.startswith("Round1Shares(")


def test_frost_result_repr_hides_secret_share_keeps_public_half():
    r = run_frost(n=4, t=3, v=1)[0][0]
    rendered = repr(r)
    assert str(r.secret_share) not in rendered
    assert hex(r.secret_share)[2:] not in rendered.lower()
    assert "group_pubkey" in rendered and "pubshares" in rendered


# -- resharing: the reference's cases on the port's module ---------------------------


def make_old_cluster(n=4, t=3, v=2, seed=1234):
    rng = random.Random(seed)
    secrets, shares_by_idx, old_pubshares, group_pks = [], {}, [], []
    for _ in range(v):
        secret = rng.randrange(1, R)
        shares = shamir.split(secret, n, t, rand=lambda: rng.randrange(1, R))
        secrets.append(secret)
        for i, s in shares.items():
            shares_by_idx.setdefault(i, []).append(s)
        old_pubshares.append({i: g1_mul(G1_GEN, s) for i, s in shares.items()})
        group_pks.append(g1_mul(G1_GEN, secret))
    return secrets, shares_by_idx, old_pubshares, group_pks


def run_reshare(cfg, shares_by_idx, old_pubshares, group_pks, dealers=None, crash=(), engine=None, timeout=5.0):
    dealers = tuple(dealers if dealers is not None else cfg.old_indices)
    participants = sorted(set(dealers) | set(cfg.new_indices))
    net = reshare.MemReshareTransport(dealers, timeout=timeout, crash=crash)

    async def run():
        return await asyncio.gather(
            *(
                reshare.run_reshare_parallel(
                    net.participant(i), i, cfg, old_pubshares, group_pks,
                    share_secrets=shares_by_idx[i] if i in dealers else None, engine=engine,
                )
                for i in participants
            ),
            return_exceptions=True,
        )

    return dict(zip(participants, asyncio.run(run())))


def check_reshare(cfg, results, secrets, group_pks):
    receivers = list(cfg.new_indices)
    for val in range(cfg.num_validators):
        ref = results[receivers[0]][val]
        assert ref.group_pubkey == group_pks[val]
        for j in receivers[1:]:
            assert results[j][val].group_pubkey == group_pks[val]
            assert results[j][val].pubshares == ref.pubshares
        for j in receivers:
            assert g1_mul(G1_GEN, results[j][val].secret_share) == results[j][val].pubshares[j]
        subset = receivers[: cfg.t_new]
        assert shamir.recover_secret({j: results[j][val].secret_share for j in subset}) == secrets[val]


def _rotation(v=1, **kw):
    return reshare.ReshareConfig(old_indices=(1, 2, 3, 4), new_indices=(1, 2, 3, 4), t_old=3, t_new=3,
                                 num_validators=v, **kw)


def test_reshare_threshold_change_4of7_to_5of9():
    secrets, shares, old_pubs, gpks = make_old_cluster(n=7, t=4, v=2)
    cfg = reshare.ReshareConfig(old_indices=tuple(range(1, 8)), new_indices=tuple(range(1, 10)), t_old=4, t_new=5,
                                num_validators=2, ctx=CTX)
    check_reshare(cfg, run_reshare(cfg, shares, old_pubs, gpks), secrets, gpks)


def test_reshare_join_and_leave():
    secrets, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = reshare.ReshareConfig(old_indices=(2, 3, 4), new_indices=(2, 3, 4, 5, 6), t_old=3, t_new=4,
                                num_validators=1, ctx=CTX)
    results = run_reshare(cfg, shares, old_pubs, gpks)
    check_reshare(cfg, results, secrets, gpks)
    # the leaving node's old share is not a share of the new polynomial
    pts = {1: shares[1][0]}
    for j in (2, 3, 4):
        pts[j] = results[j][0].secret_share
    assert shamir.recover_secret(pts) != secrets[0]


def test_reshare_proactive_rotation_changes_every_share():
    secrets, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation(ctx=CTX)
    results = run_reshare(cfg, shares, old_pubs, gpks)
    check_reshare(cfg, results, secrets, gpks)
    for j in (1, 2, 3, 4):
        assert results[j][0].secret_share != shares[j][0]
        assert results[j][0].pubshares[j] != old_pubs[0][j]


def test_reshare_repr_never_leaks_shares():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation()
    results = run_reshare(cfg, shares, old_pubs, gpks)
    _, dealt = reshare.ReshareDealer(1, cfg, shares[1]).round1()
    for obj in (results[1][0], dealt[2]):
        text = repr(obj)
        for blob in (results[1][0].secret_share, dealt[2].shares[0]):
            assert str(blob) not in text


def _dealt(cfg, shares, rogue=None):
    bcasts, dealt = {}, {}
    for i in cfg.old_indices:
        b, s = reshare.ReshareDealer(i, cfg, rogue if i == 1 and rogue else shares[i]).round1()
        bcasts[i], dealt[i] = b, s
    return bcasts, dealt


def test_reshare_rejects_tampered_subshare():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation()
    bcasts, dealt = _dealt(cfg, shares)
    my = {i: dealt[i][2] for i in dealt}
    my[3] = reshare.ReshareShares(shares=tuple((s + 1) % R for s in my[3].shares))
    with pytest.raises(reshare.ReshareError, match="sub-share"):
        reshare.ReshareReceiver(2, cfg).round2(bcasts, my, old_pubs, gpks)


def test_reshare_rejects_unbound_commitment():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation()
    bcasts, dealt = _dealt(cfg, shares, rogue=[shares[1][0] + 1])
    with pytest.raises(reshare.ReshareError, match="bind"):
        reshare.ReshareReceiver(2, cfg).round2(bcasts, {i: dealt[i][2] for i in dealt}, old_pubs, gpks)


def test_reshare_requires_dealer_quorum():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation()
    results = run_reshare(cfg, shares, old_pubs, gpks, dealers=(1, 2), timeout=1.0)
    assert all(isinstance(results[j], reshare.ReshareError) for j in cfg.new_indices)


def test_reshare_dealer_crash_aborts_everyone():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    results = run_reshare(_rotation(), shares, old_pubs, gpks, crash=(3,), timeout=1.0)
    assert all(isinstance(r, reshare.ReshareError) for r in results.values())


def test_reshare_config_validation():
    for args in (((1, 1, 2), (1, 2, 3), 2, 2, 1), ((0, 1, 2), (1, 2, 3), 2, 2, 1), ((1, 2, 3), (1, 2, 3), 4, 2, 1),
                 ((1, 2, 3), (1, 2), 2, 3, 1), ((1, 2, 3), (1, 2, 3), 2, 2, 0)):
        with pytest.raises(reshare.ReshareError):
            reshare.ReshareConfig(*args)


def test_reshare_keeps_the_metrics_hook():
    _, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=1)
    cfg = _rotation()
    bcasts, dealt = _dealt(cfg, shares)
    seen = []

    class Metrics:
        def observe_dkg_verify(self, kind, path, lanes):
            seen.append((kind, path, lanes))

    reshare.ReshareReceiver(2, cfg).round2(bcasts, {i: dealt[i][2] for i in dealt}, old_pubs, gpks, metrics=Metrics())
    assert seen == [("reshare_share", "host", 4), ("reshare_pubshare", "host", 5 * 4 * 3)]


@pytest.mark.slow
def test_reshare_device_engine_matches_host():
    secrets, shares, old_pubs, gpks = make_old_cluster(n=4, t=3, v=2)
    cfg = reshare.ReshareConfig(old_indices=(1, 2, 3, 4), new_indices=(1, 2, 3, 4, 5), t_old=3, t_new=3,
                                num_validators=2, ctx=CTX)
    check_reshare(cfg, run_reshare(cfg, shares, old_pubs, gpks, engine=BlsEngine(device="cpu")), secrets, gpks)


@pytest.mark.slow
def test_frost_ceremony_on_the_cpu_engine():
    n, t, v = 3, 2, 2
    check_frost(run_frost(n, t, v, engine=BlsEngine(device="cpu")), n, t, v)


# -- the port's round 2 on the engine against the reference's host round 2 -----------


@pytest.fixture(scope="module")
def engine():
    return BlsEngine(device="cpu")


def _frost_round1(n=3, t=2, v=2, seed=5):
    rng = random.Random(seed)
    parts = {i: frost.FrostParticipant(i, n, t, v, CTX, rand=lambda: rng.randrange(1, R)) for i in range(1, n + 1)}
    return {i: p.round1() for i, p in parts.items()}


def _to_ref_frost(bcasts, shares):
    b = {i: [ref_frost.Round1Broadcast(x.commitments, x.pok_r, x.pok_mu) for x in bl] for i, bl in bcasts.items()}
    return b, {i: ref_frost.Round1Shares(shares=s.shares) for i, s in shares.items()}


def _fields(res):
    return [(r.group_pubkey, r.secret_share, r.pubshares) for r in res]


def _frost_both(r1, me, n=3, t=2, v=2, engine=None):
    """(port round 2 on the engine, reference host round 2) for node `me`;
    each is a result list or the ValueError it raised."""
    bcasts = {i: r1[i][0] for i in r1}
    shares = {i: r1[i][1][me] for i in r1}
    out = []
    for round2 in (
        lambda: frost.FrostParticipant(me, n, t, v, CTX).round2(bcasts, shares, engine=engine),
        lambda: ref_frost.FrostParticipant(me, n, t, v, CTX).round2(*_to_ref_frost(bcasts, shares)),
    ):
        try:
            out.append(_fields(round2()))
        except ValueError as e:
            out.append(e)
    return out


def test_frost_round2_on_the_engine_equals_the_reference(engine):
    r1 = _frost_round1()
    port, ref = _frost_both(r1, 2, engine=engine)
    assert port == ref and len(port) == 2
    assert all(set(ps) == {1, 2, 3} for _, _, ps in port)


@pytest.mark.parametrize("what", ["share", "pok"])
def test_frost_round2_on_the_engine_raises_the_reference_error(engine, what):
    r1 = _frost_round1(seed=6)
    bl, sh = r1[3]
    if what == "share":  # peer 3's share to node 1, validator 1
        bad = list(sh[1].shares)
        bad[1] = (bad[1] + 1) % R
        sh = {**sh, 1: frost.Round1Shares(shares=tuple(bad))}
    else:  # peer 3's proof of knowledge, validator 0
        b0 = bl[0]
        bl = [frost.Round1Broadcast(b0.commitments, b0.pok_r, (b0.pok_mu + 1) % R)] + bl[1:]
    r1 = {**r1, 3: (bl, sh)}
    port, ref = _frost_both(r1, 1, engine=engine)
    assert isinstance(port, ValueError) and isinstance(ref, ValueError)
    assert str(port) == str(ref) == (
        "invalid share from peer 3 (validator 1)" if what == "share" else "invalid proof of knowledge from peer 3 (validator 0)"
    )


def _reshare_dealt(n=3, t=2, v=2):
    secrets, shares, old_pubs, gpks = make_old_cluster(n=n, t=t, v=v, seed=77)
    cfg = reshare.ReshareConfig(old_indices=tuple(range(1, n + 1)), new_indices=tuple(range(1, n + 1)), t_old=t,
                                t_new=t, num_validators=v, ctx=CTX)
    rng = random.Random(78)
    bcasts, dealt = {}, {}
    for i in cfg.old_indices:
        bcasts[i], dealt[i] = reshare.ReshareDealer(i, cfg, shares[i], rand=lambda: rng.randrange(1, R)).round1()
    return cfg, bcasts, dealt, old_pubs, gpks, secrets


def _reshare_both(cfg, bcasts, my, old_pubs, gpks, me, engine):
    ref_cfg = ref_reshare.ReshareConfig(cfg.old_indices, cfg.new_indices, cfg.t_old, cfg.t_new, cfg.num_validators,
                                        cfg.ctx)
    ref_b = {i: [ref_reshare.ReshareBroadcast(x.commitments) for x in bl] for i, bl in bcasts.items()}
    ref_my = {i: ref_reshare.ReshareShares(shares=s.shares) for i, s in my.items()}
    out = []
    for round2 in (
        lambda: reshare.ReshareReceiver(me, cfg).round2(bcasts, my, old_pubs, gpks, engine=engine),
        lambda: ref_reshare.ReshareReceiver(me, ref_cfg).round2(ref_b, ref_my, old_pubs, gpks),
    ):
        try:
            out.append(_fields(round2()))
        except (reshare.ReshareError, ref_reshare.ReshareError) as e:
            out.append(e)
    return out


def test_reshare_round2_on_the_engine_equals_the_reference(engine):
    cfg, bcasts, dealt, old_pubs, gpks, secrets = _reshare_dealt()
    port, ref = _reshare_both(cfg, bcasts, {i: dealt[i][3] for i in dealt}, old_pubs, gpks, 3, engine)
    assert port == ref and len(port) == 2
    assert [gpk for gpk, _, _ in port] == gpks


def test_reshare_round2_on_the_engine_raises_the_reference_error(engine):
    cfg, bcasts, dealt, old_pubs, gpks, _ = _reshare_dealt()
    my = {i: dealt[i][1] for i in dealt}
    bad = list(my[2].shares)
    bad[1] = (bad[1] + 1) % R
    my[2] = reshare.ReshareShares(shares=tuple(bad))
    port, ref = _reshare_both(cfg, bcasts, my, old_pubs, gpks, 1, engine)
    assert isinstance(port, reshare.ReshareError) and isinstance(ref, ref_reshare.ReshareError)
    assert str(port) == str(ref) == "invalid sub-share from dealer 2 (validator 1)"
