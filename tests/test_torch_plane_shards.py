"""PyTorch port: the slot crypto plane split over two CPU shards
(make_mesh(["cpu", "cpu"])): `step_rlc` and `step` on a forged row, and
`verify_rlc_dec` and `verify_dec` on forged and undecodable lanes, with a
padding lane in the second shard. The answers are the one-shard plane's
(test_torch_plane.py, test_torch_plane_dec.py): the oracles' points and
verdicts, and the count summed over the shards. Tolerance: exact.
"""

from __future__ import annotations

import torch
from test_torch_plane import V, forged_partials, forged_recombine, oracle_sigs
from test_torch_plane_dec import check_forged_verify_dec

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin


def test_recombine_host_forged_row_on_two_shards():
    sigs, oks, fams, [(group_sig, ok, total)] = forged_recombine(2)
    assert fams == [("mesh/step_rlc", V), ("mesh/step", V)]
    assert oks == [True, False, True]
    assert sigs == oracle_sigs(forged_partials())
    assert ok.tolist() == [True, False, True, False]
    assert total == 2  # 1 + 1: the host sum of the shards' counts


def test_verify_dec_forged_and_undecodable_on_two_shards():
    check_forged_verify_dec(2)
