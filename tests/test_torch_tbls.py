"""PyTorch port, the slice as a whole: TorchImpl(device="cpu") verifies
partial signatures of a small 3-of-5 cluster like the JAX package's
PythonImpl — through the grouped random-linear-combination check when
the batch is valid, and through the per-lane re-check when a lane is
forged or malformed."""

from __future__ import annotations

import pytest
import torch

from charon_tpu.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls.torch_impl import TorchImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

N, T = 5, 3
MSGS = [b"duty root a", b"duty root b"]


@pytest.fixture(scope="module")
def cluster():
    """4 validators, each split 3-of-5; 4 shares of each sign the
    validator's message (validator v signs MSGS[v % 2]): 16 lanes."""
    py = PythonImpl()
    lanes, secrets = [], []
    for v in range(4):
        shares = py.threshold_split(py.generate_secret_key(), N, T)
        msg = MSGS[v % 2]
        for i in (1, 2, 4, 5):
            lanes.append((py.secret_to_public_key(shares[i]), msg, py.sign(shares[i], msg)))
            secrets.append(shares[i])
    return dict(py=py, lanes=lanes, secrets=secrets)


@pytest.fixture(scope="module")
def trusting():
    """Skips the device subgroup check of signature inputs; the two tests
    above run it."""
    return TorchImpl(device="cpu", verify_inputs=False)


@pytest.fixture(scope="module")
def impl():
    impl = TorchImpl(device="cpu")
    impl.grouped_calls = []
    inner = impl.engine.verify_batch_grouped_rlc

    def counting(groups, rng=None):
        impl.grouped_calls.append(len(groups))
        return inner(groups, rng)

    impl.engine.verify_batch_grouped_rlc = counting
    return impl


def test_valid_partials_verify_through_grouped_rlc(cluster, impl):
    impl.grouped_calls.clear()
    assert len(cluster["lanes"]) >= impl.RLC_MIN_BATCH
    assert impl.verify_batch(cluster["lanes"]) == [True] * len(cluster["lanes"])
    assert impl.grouped_calls == [len(MSGS)]


def test_forged_and_malformed_lanes_match_python_impl(cluster, impl):
    """One partial over the wrong message and one flipped-byte encoding:
    the grouped check rejects the batch, the per-lane re-check pins
    exactly those lanes, and every verdict equals PythonImpl's."""
    lanes = list(cluster["lanes"])
    pk, msg, _ = lanes[5]
    lanes[5] = (pk, msg, cluster["py"].sign(cluster["secrets"][5], b"another duty"))
    pk, msg, sig = lanes[10]
    lanes[10] = (pk, msg, sig[:7] + bytes([sig[7] ^ 0x01]) + sig[8:])
    impl.grouped_calls.clear()
    got = impl.verify_batch(lanes)
    assert impl.grouped_calls == [len(MSGS)]
    assert got == cluster["py"].verify_batch(lanes)
    assert [i for i, ok in enumerate(got) if not ok] == [5, 10]


def test_small_mixed_batch_takes_the_per_lane_check(cluster, trusting):
    """Below RLC_MIN_BATCH the per-lane check answers directly (the mixed
    case of tests/test_tbls.py): wrong share and wrong key go False."""
    lanes = cluster["lanes"]
    items = [
        lanes[0],
        (lanes[1][0], lanes[0][1], lanes[0][2]),  # another share's partial
        lanes[2],
        (lanes[4][0], lanes[0][1], lanes[0][2]),  # another validator's key
    ]
    calls = []
    inner = trusting.engine.verify_batch_grouped_rlc
    trusting.engine.verify_batch_grouped_rlc = lambda groups, rng=None: calls.append(groups) or inner(groups, rng)
    assert trusting.verify_batch(items) == [True, False, True, False]
    assert calls == []
