"""The frozen generator and the plain reference at a tiny size: RFC 9380's
hash-to-G2 vectors; keys, partials and group signatures against the
port's host BLS (an independent witness: pairings); a forged lane that
the reference calls invalid; the same seed giving the same inputs."""

import pytest

from portbench import bls381, gen, reference, work

RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
# RFC 9380 appendix J.10.1: (msg, P.x = (c0, c1), P.y = (c0, c1))
RFC_VECTORS = [
    (
        b"",
        (0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
         0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D),
        (0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
         0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6),
    ),
    (
        b"abc",
        (0x02C2D18E033B960562AAE3CAB37A27CE00D80CCD5BA4B7FE0E7A210245129DBEC7780CCC7954725F4168AFF2787776E6,
         0x139CDDBCCDC5E91B9623EFD38C49F81A6F83F175E80B06FC374DE9EB4B41DFE4CA3A230ED250FBE3A2ACF73A41177FD8),
        (0x1787327B68159716A37440985269CF584BCB1E621D3A7202BE6EA05C4CFE244AEB197642555A0645FB87BF7466B2BA48,
         0x00AA65DAE3C8D732D10ECD2C50F8A1BAF3001578F71C694E03866E9F3D49AC1E1CE70DD94A733534F106D4CEC0EDDD16),
    ),
    (
        b"a512_" + b"a" * 512,
        (0x01A6BA2F9A11FA5598B2D8ACE0FBE0A0EACB65DECEB476FBBCB64FD24557C2F4B18ECFC5663E54AE16A84F5AB7F62534,
         0x11FCA2FF525572795A801EED17EB12785887C7B63FB77A42BE46CE4A34131D71F7A73E95FEE3F812AEA3DE78B4D01569),
        (0x0B6798718C8AED24BC19CB27F866F1C9EFFCDBF92397AD6448B5C9DB90D2B9DA6CBABF48ADC1ADF59A1A28344E79D57E,
         0x03A47F8E6D1763BA0CAD63D6114C0ACCBEF65707825A511B251A660A9B3994249AE4E63FAC38B23DA0C398689EE2AB52),
    ),
]

CFG = {"name": "tiny", "validators": 4, "nodes": 7, "threshold": 4, "roots_per_slot": 2, "signers": 4}
TRAFFIC = {"ring_slots": 1, "untimed_slots": 1, "spread_s": 0.0, "forged_per_slot": 1}
SEED = 2**33 + 17


@pytest.fixture(scope="module")
def inputs():
    return gen.generate(CFG, TRAFFIC, SEED, workers=2)


@pytest.mark.parametrize("msg,x,y", RFC_VECTORS)
def test_hash_to_g2_matches_rfc9380(msg, x, y):
    assert bls381.hash_to_g2(msg, RFC_DST) == (x, y)


def test_fixed_base_equals_double_and_add():
    h = bls381.hash_to_g2(b"root")
    ks = [1, 2, bls381.R - 1, 2**200 + 3] + [(7**k) % bls381.R for k in range(1, 30)]
    assert bls381.fixed_base(h, ks, bls381.FP2) == [bls381.mul_affine(h, k % bls381.R, bls381.FP2) for k in ks]
    assert bls381.fixed_base(bls381.G1_GEN, ks, bls381.FP) == [bls381.mul_affine(bls381.G1_GEN, k, bls381.FP) for k in ks]


def test_the_same_seed_gives_the_same_inputs_and_every_seed_the_same_sizes(inputs):
    again = gen.generate(CFG, TRAFFIC, SEED, workers=3)
    assert again.group_pks == inputs.group_pks and again.pubshares == inputs.pubshares
    assert [s.partials for s in again.slots] == [s.partials for s in inputs.slots]
    other = gen.generate(CFG, {**TRAFFIC, "forged_per_slot": 0}, SEED + 1, workers=1)
    assert other.group_pks != inputs.group_pks
    assert [len(s.roots) for s in other.slots] == [len(s.roots) for s in inputs.slots]
    assert [sorted(map(len, s.partials)) for s in other.slots] == [sorted(map(len, s.partials)) for s in inputs.slots]


def test_every_root_is_fresh(inputs):
    roots = [r for s in inputs.slots for r in s.roots]
    assert len(roots) == len(set(roots)) == gen.slot_count(TRAFFIC) * CFG["roots_per_slot"]


def test_the_check_slot_holds_one_more_partial_over_a_stale_root(inputs):
    """The slot a run answers after its window: each forged partial is one
    its row recombines, and the reference turns down it and its row."""
    c = gen.check_slot(TRAFFIC)
    assert c == len(inputs.slots) - 1 == TRAFFIC["untimed_slots"] + TRAFFIC["ring_slots"]
    check = inputs.slots[c]
    assert len(check.forged) == TRAFFIC["forged_per_slot"] + gen.CHECK_FORGED
    assert [len(s.forged) for s in inputs.slots[:c]] == [TRAFFIC["forged_per_slot"]] * c
    [exp] = reference.expected(inputs, [c], CFG, workers=2)
    assert sorted(k for k, ok in exp.verdicts.items() if not ok) == sorted(check.forged)
    for v, i in check.forged:
        assert i in gen.recombine_indices(check, v, CFG["threshold"]) and exp.rows[v] == (False, None)
    assert sum(ok for ok, _ in exp.rows.values()) == CFG["validators"] - len({v for v, _ in check.forged})


def test_keys_partials_and_group_signatures_against_the_ports_host_bls(inputs):
    from charon_tpu_torch.crypto import bls, g1g2, shamir

    slot = inputs.slots[1]
    [(fv, fi)] = slot.forged
    exp = reference.expected(inputs, [1], CFG, workers=2)[0]
    for v in range(CFG["validators"]):
        assert inputs.group_pks[v] == g1g2.g1_to_bytes(g1g2.g1_mul(g1g2.G1_GEN, inputs.secrets[v]))
        assert shamir.recover_secret({i: inputs.shares[v][i] for i in (2, 3, 5, 7)}) == inputs.secrets[v]
        root = slot.roots[slot.root_of[v]]
        ok, sig = exp.rows[v]
        assert ok == (v != fv)
        if ok:
            parts = {i: g1g2.g2_from_bytes(slot.partials[v][i]) for i in gen.recombine_indices(slot, v, 4)}
            assert sig == g1g2.g2_to_bytes(shamir.threshold_aggregate_g2(parts))
            assert sig == g1g2.g2_to_bytes(bls.sign(inputs.secrets[v], root))
        for i in slot.signers[v]:
            assert exp.verdicts[v, i] == ((v, i) != (fv, fi))
    # the pairing's word on one valid lane and on the forged one
    v = (fv + 1) % CFG["validators"]
    i = slot.signers[v][0]
    root = slot.roots[slot.root_of[v]]
    pk, sig = g1g2.g1_from_bytes(inputs.pubshares[v][i]), g1g2.g2_from_bytes(slot.partials[v][i])
    assert bls.verify(pk, root, sig)
    pk, sig = g1g2.g1_from_bytes(inputs.pubshares[fv][fi]), g1g2.g2_from_bytes(slot.partials[fv][fi])
    assert not bls.verify(pk, slot.roots[slot.root_of[fv]], sig)


def test_submissions_cover_every_partial_once(inputs):
    slot = inputs.slots[1]
    subs = gen.submissions(inputs, slot, CFG, TRAFFIC, SEED, 1)
    keys = [k for _, ks in subs.verify for k in ks]
    assert sorted(keys) == sorted((v, i) for v in range(4) for i in slot.signers[v])
    assert len(subs.verify) <= CFG["nodes"] and len(subs.recombine) == CFG["roots_per_slot"]
    assert sorted(v for _, rows in subs.recombine for v in rows) == list(range(4))
    for (args, rows) in subs.recombine:
        for ps, root, parts, gpk, idx, v in zip(*args, rows):
            assert idx == slot.signers[v][:4] and gpk == inputs.group_pks[v] and root == slot.roots[slot.root_of[v]]
            assert parts == [slot.partials[v][i] for i in idx] and ps == [inputs.pubshares[v][i] for i in idx]


def test_worker_results_do_not_depend_on_the_split():
    tasks = [("g1", list(range(1, 40))), ("g2", b"r", list(range(5, 9)))]
    assert work.run_tasks(tasks, 1) == work.run_tasks(tasks, 3)


def test_spread_draws_each_submissions_delay_from_the_seed(inputs):
    slot = inputs.slots[1]
    spread = {**TRAFFIC, "spread_s": 4.0}
    subs = gen.submissions(inputs, slot, CFG, spread, SEED, 1)
    assert len(subs.delays) == len(subs.verify) + len(subs.recombine)
    assert all(0.0 <= d <= 4.0 for d in subs.delays) and len(set(subs.delays)) > 1
    assert subs.delays == gen.submissions(inputs, slot, CFG, spread, SEED, 1).delays
    assert set(gen.submissions(inputs, slot, CFG, TRAFFIC, SEED, 1).delays) == {0.0}
