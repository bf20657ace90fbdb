"""PyTorch port: `step_rlc_dec` and `step_dec` split over two CPU shards,
on a parsed batch with a forged row, an undecodable row and a padding
lane in the second shard: the one-shard answers (test_torch_plane_dec.py)
and the oracle's points. Tolerance: exact (points, verdicts, counts).
"""

from __future__ import annotations

import torch
from test_torch_plane_dec import check_forged_recombine_dec

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin


def test_step_dec_forged_and_undecodable_rows_on_two_shards():
    check_forged_recombine_dec(2)
