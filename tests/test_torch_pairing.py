"""PyTorch port: pairing (Miller loop, final exponentiation, the batched
verify checks) and MSM, held against the JAX package's pure-Python
oracles (charon_tpu/crypto: pairing_fast, g1g2, shamir, bls). XLA:CPU
takes minutes to compile the JAX engine's pairing and MSM programs, so
those stay out of this tier; the oracles pin the same algebra."""

from __future__ import annotations

import random

import pytest
import torch

from charon_tpu.crypto import bls, g1g2, h2c, pairing_fast, shamir
from charon_tpu.crypto import fields as F
from charon_tpu_torch.ops import blsops
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.tbls.torch_impl import TorchImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX, FR = L.FP, L.FR
ENGINE = blsops.BlsEngine(device="cpu")


def _signed(n, msgs, seed):
    """n (pk, H(m), sig) lanes over the given messages."""
    rng = random.Random(seed)
    hs = {m: h2c.hash_to_g2(m) for m in msgs}
    out = []
    for i in range(n):
        sk = rng.randrange(1, F.R)
        m = msgs[i % len(msgs)]
        out.append((g1g2.g1_mul(g1g2.G1_GEN, sk), hs[m], g1g2.g2_mul(hs[m], sk)))
    return out


def _off_subgroup_points():
    """On-curve points outside the prime-order subgroups (no cofactor
    clearing), found by incrementing x."""
    x = 1
    while (y := F.fp_sqrt((x**3 + 4) % F.P)) is None:
        x += 1
    g1 = (x, y)
    x0 = 1
    while True:
        x2 = (x0, 1)
        y2 = F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x2), x2), (4, 4)))
        if y2 is not None:
            break
        x0 += 1
    g2 = (x2, y2)
    assert g1g2.g1_is_on_curve(g1) and not g1g2.g1_in_subgroup(g1)
    assert g1g2.g2_is_on_curve(g2) and not g1g2.g2_in_subgroup(g2)
    return g1, g2


def test_miller_loop_and_final_exp_equal_pairing_fast():
    """Per lane, final_exp(miller_loop(P, Q)) is the same Fp12 element as
    the oracle's e(P, Q)^3 — identity lanes give 1."""
    (pk, h, _), (pk2, _, sig2) = _signed(2, [b"pairing"], 1)
    ps, qs = [pk, pk2, None], [h, sig2, h]
    f = DP.final_exp(CTX, DP.miller_loop(CTX, [(C.g1_pack(CTX, ps), C.g2_pack(CTX, qs))]))
    want = [pairing_fast.multi_pairing_fast([(q, p)]) for p, q in zip(ps[:2], qs[:2])] + [F.FP12_ONE]
    assert T.fp12_unpack(CTX, f) == want


def test_batched_verify_lanes_match_bls_oracle():
    lanes = _signed(4, [b"a", b"b"], 2)
    pks, hs, sigs = map(list, zip(*lanes))
    sigs[1] = lanes[0][2]  # another key's signature
    pks[3] = None  # identity public key never verifies
    got = ENGINE.verify_batch(pks, hs, sigs)
    want = [
        pk is not None and pairing_fast.is_gt_one(
            pairing_fast.multi_pairing_fast([(s, g1g2.g1_neg(g1g2.G1_GEN)), (h, pk)])
        )
        for pk, h, s in zip(pks, hs, sigs)
    ]
    assert got == want == [True, False, True, False]


@pytest.mark.parametrize("forged", [False, True])
def test_batched_verify_rlc(forged):
    lanes = _signed(6, [b"x", b"y", b"z"], 3)
    pks, hs, sigs = map(list, zip(*lanes))
    if forged:
        sigs[4] = g1g2.g2_mul(hs[4], 12345)
    assert ENGINE.verify_batch_rlc(pks, hs, sigs, rng=random.Random(4)) is (not forged)


def test_grouped_rlc_with_msm_off_accepts_valid_groups():
    """The per-lane double-and-add branch of the grouped check (MSM off);
    the MSM branch, and rejection, run in the tbls slice tests."""
    lanes = _signed(6, [b"g1", b"g2"], 5)
    groups = [(lanes[j][1], [(pk, s) for pk, _, s in lanes[j::2]]) for j in (0, 1)]
    MSM.set_msm(False)
    try:
        assert ENGINE.verify_batch_grouped_rlc(groups, rng=random.Random(6)) is True
    finally:
        MSM.set_msm(None)


@pytest.mark.parametrize("window", [4, 8])
def test_msm_segmented_matches_oracle(window):
    rng = random.Random(7)
    pts = [g1g2.g1_mul(g1g2.G1_GEN, rng.randrange(1, F.R)) for _ in range(7)] + [None]
    ks = [rng.randrange(1 << 64) for _ in range(6)] + [0, 5]
    seg = [0, 2, 1, 0, 2, 2, 1, 0]
    f = C.g1_ops(CTX)
    out = MSM.msm_segmented(
        f, FR, C.affine_to_point(f, C.g1_pack(CTX, pts)), C.fr_pack(FR, ks),
        torch.tensor(seg), 3, nbits=64, window=window,
    )
    want = [None, None, None]
    for p, k, s in zip(pts, ks, seg):
        want[s] = g1g2.g1_add(want[s], None if p is None else g1g2.g1_mul(p, k))
    assert C.g1_unpack(CTX, C.point_to_affine(f, out)) == want


def test_msm_single_segment_g2_matches_oracle():
    rng = random.Random(8)
    pts = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, F.R)) for _ in range(5)]
    ks = [rng.randrange(1 << 16) for _ in range(5)]
    f = C.g2_ops(CTX)
    out = MSM.msm(f, FR, C.affine_to_point(f, C.g2_pack(CTX, pts)), C.fr_pack(FR, ks), nbits=16, window=4)
    want = None
    for p, k in zip(pts, ks):
        want = g1g2.g2_add(want, g1g2.g2_mul(p, k))
    assert C.g2_unpack(CTX, C.point_to_affine(f, C.map_point(lambda a: a.unsqueeze(0), out))) == [want]


def test_lagrange_coefficients_match_shamir():
    idx = [[1, 3, 4, 7], [2, 5, 6, 7]]
    got = blsops.lagrange_coeffs_at_zero(FR, torch.tensor(idx), 4)
    want = [shamir.lagrange_coeffs_at_zero(row)[i] for row in idx for i in row]
    assert L.ctx_unpack(FR, got) == want


@pytest.mark.parametrize("msm", [True, False])
def test_threshold_recombine_matches_shamir(msm):
    """Straus joint windowed mul (MSM on) and per-lane double-and-add (off)
    recombine 2-of-3 partials like the host oracle."""
    rng = random.Random(9)
    h = h2c.hash_to_g2(b"recombine")
    batch, want = [], []
    for _ in range(2):
        shares = shamir.split(rng.randrange(1, F.R), 3, 2, rand=lambda: rng.randrange(1, F.R))
        subset = dict(rng.sample(sorted(shares.items()), 2))
        partials = {i: g1g2.g2_mul(h, s) for i, s in subset.items()}
        batch.append(partials)
        want.append(shamir.threshold_aggregate_g2(partials))
    MSM.set_msm(msm)
    try:
        assert ENGINE.threshold_aggregate_batch(batch) == want
    finally:
        MSM.set_msm(None)


def test_subgroup_checks_reject_off_subgroup_points():
    g1_bad, g2_bad = _off_subgroup_points()
    assert ENGINE.subgroup_check_g1_batch([g1g2.G1_GEN, g1_bad, None]) == [True, False, True]
    assert ENGINE.subgroup_check_g2_batch([g1g2.G2_GEN, g2_bad]) == [True, False]


def test_aggregate_batches_match_oracle():
    lanes = _signed(3, [b"agg"], 10)
    pks, _, sigs = zip(*lanes)
    assert ENGINE.aggregate_sigs_batch([list(sigs), list(sigs[:1])]) == [bls.aggregate_sigs(sigs), sigs[0]]
    assert ENGINE.aggregate_pks_batch([list(pks)]) == [bls.aggregate_pks(pks)]


@pytest.mark.parametrize("multiple", [1, 8])
def test_bucket_ladder_matches_reference(multiple):
    from charon_tpu.ops import blsops as JB

    sizes = list(range(1, 70)) + [255, 256, 257, 4096, 4097]
    assert [blsops.bucket_lanes(n, multiple) for n in sizes] == [JB.bucket_lanes(n, multiple) for n in sizes]
    assert [blsops.next_pow2(n) for n in sizes] == [JB.next_pow2(n) for n in sizes]


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        blsops.BlsEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchImpl()
    assert blsops.BlsEngine(device="cpu").device == torch.device("cpu")
