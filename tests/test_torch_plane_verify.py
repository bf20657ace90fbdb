"""PyTorch port: the slot crypto plane's point-input verify programs
(`verify_rlc`, `verify`), its warm-up programs (`h2c`, `g1dec`) and the
ungrouped branch of `step_rlc` (MSM off), on one and two CPU shards,
held against the oracles charon_tpu.crypto.bls, h2c and g1g2. Workload
and helpers: test_torch_plane.py. Tolerance: exact (points, verdicts).
"""

from __future__ import annotations

import random

import pytest
import torch
from test_decompress import _g1_on_curve_not_in_subgroup
from test_torch_plane import BAD, T, V, WL, forged_partials, memo, oracle_sigs, plane, recording, rows

from charon_tpu.crypto import g1g2, h2c
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.ops import sswu as SSWU

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin


def lanes(sigs=None):
    """V verify lanes: row v's share v partial under its pubshare."""
    ps, msgs, parts, _, _ = WL
    pks = [ps[v][v] for v in range(V)]
    return pks, [msgs[v] for v in range(V)], sigs or [parts[v][v] for v in range(V)]


def forged_verify(shards: int):
    """verify_host on V lanes with lane 1 forged: verify_rlc says False,
    then `verify` attributes. Returns (oks, families, raw verify output)."""

    def run():
        pl = plane(shards)
        sigs = lanes()[2]
        sigs[1] = BAD
        with recording(pl, "_verify") as (fams, raw):
            oks = pl.verify_host(*lanes(sigs), rng=random.Random(11))
        return oks, fams, raw["_verify"]

    return memo(("forged_verify", shards), run)


def test_verify_rlc_all_valid_with_corrupt_padding():
    pl = plane(1)
    pk, msg, sig, live = pl.pack_verify_inputs(*lanes())
    assert live.tolist() == [True] * V + [False]
    bad = C.g2_pack(pl.ctx, [BAD])
    sig = C.zip_point(lambda a, b: torch.cat((a[:V], b)), sig, bad)
    assert pl._verify_rlc(pk, msg, sig, live, pl.make_lane_rand(V, random.Random(2))) is True


@pytest.mark.parametrize("shards", [1, 2])
def test_verify_host_forged_lane_fails_rlc_then_verify_attributes(shards):
    oks, fams, [raw] = forged_verify(shards)
    assert fams == [("mesh/verify_rlc", V), ("mesh/verify", V)]
    assert oks == [True, False, True]
    assert raw.tolist() == [True, False, True, False]  # lane 3: padding


@pytest.mark.parametrize("shards", [1, 2])
def test_hash_to_g2_host_matches_h2c(shards):
    pl = plane(shards)
    dst = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
    msgs = [b"mesh-duty-0", b"mesh-duty-1", SSWU.hash_to_field_lane(b"abc", dst)]
    with recording(pl, "_h2c") as (fams, raw):
        pts, valid = pl.hash_to_g2_host(msgs)
    assert valid == [True] * 3
    assert pts == [WL[1][0], WL[1][1], h2c.hash_to_g2(b"abc", dst)]
    assert fams == [("mesh/h2c", 3)]
    assert raw["_h2c"][0][1].tolist() == [True, True, True, False]  # padding masked
    assert pl.hash_to_g2_host([]) == ([], [])


@pytest.mark.parametrize("shards", [1, 2])
def test_decompress_g1_host_matches_the_host_decode(shards):
    pl = plane(shards)
    enc = [
        g1g2.g1_to_bytes(WL[3][0]),
        g1g2.g1_to_bytes(g1g2.g1_neg(WL[3][1])),  # the other sign
        g1g2.g1_to_bytes(_g1_on_curve_not_in_subgroup()),
        g1g2.g1_to_bytes(None),  # infinity: valid, no point
        b"\x00" * 48,  # no compression flag
    ]
    pts, valid = pl.decompress_g1_host(enc)

    def oracle(data):
        try:
            return g1g2.g1_from_bytes(data, subgroup_check=True), True
        except ValueError:
            return None, False

    assert list(zip(pts, valid)) == [oracle(e) for e in enc]
    assert valid == [True, True, False, True, False]


def test_step_rlc_without_msm_takes_the_ungrouped_rlc_check(monkeypatch):
    monkeypatch.setattr(MSM, "_MSM_MODE", False)
    calls = []
    real = DP.batched_verify_rlc

    def counted(*args):
        calls.append(args[2][0].shape[0])
        return real(*args)

    monkeypatch.setattr(DP, "batched_verify_rlc", counted)
    pl = plane(1)
    for partials, want in ((WL[2], True), (forged_partials(), False)):
        args = pl.pack_inputs(*rows(partials=partials))
        group_sig, all_ok = pl.step_rlc(*args, pl.make_rand(V, random.Random(3)))
        assert all_ok is want
        assert C.g2_unpack(pl.ctx, group_sig)[:V] == oracle_sigs(partials)
    assert calls == [4 * (T + 1)] * 2  # every verify lane of the padded batch
