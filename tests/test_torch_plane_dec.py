"""PyTorch port: the slot crypto plane's decode-fused programs
(`step_rlc_dec`, `step_dec`, `verify_rlc_dec`, `verify_dec`) on one CPU
shard, on parsed compressed signatures with forged, undecodable and
padding lanes, held against the oracles charon_tpu.crypto.shamir and bls.
Undecodable lanes pass the host parse and fail on the device: a
non-residue x (recombine) and an on-curve point off the subgroup
(verify). The two-shard runs are in test_torch_plane_dec_shards.py and
test_torch_plane_shards.py. Tolerance: exact (points, verdicts, counts).
"""

from __future__ import annotations

import random

import torch
from test_decompress import _g2_nonresidue_x_bytes
from test_torch_aggregate import _off_subgroup_sig
from test_torch_plane import BAD, V, WL, forged_partials, memo, oracle_sigs, plane, recording, rows
from test_torch_plane_verify import lanes

from charon_tpu.crypto import g1g2
from charon_tpu_torch.ops import decompress as DEC

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

NON_RESIDUE = _g2_nonresidue_x_bytes()
OFF_SUBGROUP = _off_subgroup_sig()


def parse(sig) -> DEC.ParsedPoint:
    p = DEC.parse_g2_lane(sig if isinstance(sig, bytes) else g1g2.g2_to_bytes(sig))
    assert p.ok and not p.infinity  # what the coalescer ships
    return p


def recombine_dec(shards: int, forged: bool):
    """recombine_packed_parsed on V rows whose row 2 has an undecodable
    partial (and, if `forged`, row 1 a forged one). Returns (sigs, oks,
    families, raw step_dec outputs)."""

    def run():
        pl = plane(shards)
        parts = forged_partials() if forged else [list(r) for r in WL[2]]
        grid = [[parse(s) for s in row] for row in parts[:V]]
        grid[2][0] = parse(NON_RESIDUE)
        ps, msgs, _, gpks, idx = rows()
        args = pl.pack_inputs_parsed(ps, msgs, grid, gpks, idx)
        with recording(pl, "_step_dec") as (fams, raw):
            sigs, oks = pl.recombine_packed_parsed(args, pl.make_rand(V, random.Random(13)), V)
        return sigs, oks, fams, raw["_step_dec"], parts

    return memo(("recombine_dec", shards, forged), run)


def verify_dec(shards: int, forged: bool):
    """verify_packed_parsed on V lanes whose lane 2 is off the subgroup
    (and, if `forged`, lane 1 forged). Returns (oks, families, raw
    verify_dec output)."""

    def run():
        pl = plane(shards)
        pks, msgs, sigs = lanes()
        if forged:
            sigs[1] = BAD
        parsed = [parse(s) for s in sigs]
        parsed[2] = parse(OFF_SUBGROUP)
        arrays = pl.pack_verify_inputs_parsed(pks, msgs, parsed)
        with recording(pl, "_verify_dec") as (fams, raw):
            oks = pl.verify_packed_parsed(arrays, pl.make_lane_rand(V, random.Random(17)), V)
        return oks, fams, raw["_verify_dec"]

    return memo(("verify_dec", shards, forged), run)


def check_forged_recombine_dec(shards: int) -> None:
    sigs, oks, fams, [(group_sig, ok, total)], parts = recombine_dec(shards, forged=True)
    assert fams == [("mesh/step_rlc_dec", V), ("mesh/step_dec", V)]
    assert oks == [True, False, False]
    assert sigs[:2] == oracle_sigs(parts)[:2]
    assert ok.tolist() == [True, False, False, False] and total == 1  # lane 3: padding


def check_forged_verify_dec(shards: int) -> None:
    oks, fams, [raw] = verify_dec(shards, forged=True)
    assert fams == [("mesh/verify_rlc_dec", V), ("mesh/verify_dec", V)]
    assert oks == [True, False, False]
    assert raw.tolist() == [True, False, False, False]


def test_step_rlc_dec_leaves_undecodable_rows_out_of_a_valid_slot():
    """The decode-fused RLC path accepts: the undecodable row leaves the
    shared product and comes back False in the per-row mask; the others'
    recombinations equal the oracle's."""
    sigs, oks, fams, raw, parts = recombine_dec(1, forged=False)
    assert fams == [("mesh/step_rlc_dec", V)] and raw == []
    assert oks == [True, True, False]
    assert sigs[:2] == oracle_sigs(parts)[:2]


def test_step_dec_attributes_forged_and_undecodable_rows():
    check_forged_recombine_dec(1)


def test_verify_rlc_dec_answers_with_the_decode_mask():
    oks, fams, raw = verify_dec(1, forged=False)
    assert fams == [("mesh/verify_rlc_dec", V)] and raw == []
    assert oks == [True, True, False]


def test_verify_dec_attributes_forged_and_undecodable_lanes():
    check_forged_verify_dec(1)
