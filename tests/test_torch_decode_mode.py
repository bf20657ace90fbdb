"""PyTorch port: TorchImpl's decode_mode (the device decode of signatures on
the main path) and warm_point_caches (the boot warm-up of the pubkey and
message caches), held against decode_mode="python", the JAX package's
TPUImpl(decode_mode="device") and the host oracles."""

from __future__ import annotations

import pytest
import torch
from test_decompress import _g1_on_curve_not_in_subgroup
from test_torch_aggregate import INFINITE, MSG, T, _bad_batch, _off_subgroup_sig, cluster  # noqa: F401

from charon_tpu.crypto import fields as F
from charon_tpu.crypto import g1g2, h2c
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.torch_impl import PointCache, TorchImpl, _decode_msg_point, warm_point_caches

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

P = F.P


# -- TorchImpl(decode_mode=...) ---------------------------------------------------


@pytest.fixture(scope="module")
def device_impl():
    return TorchImpl(device="cpu", decode_mode="device")


@pytest.fixture(scope="module")
def device_trusting():
    return TorchImpl(device="cpu", decode_mode="device", verify_inputs=False)


def test_decode_mode_resolves_to_the_device_only_on_cuda():
    assert not TorchImpl(device="cpu")._device_decode()
    assert TorchImpl(device="cpu", decode_mode="device")._device_decode()
    assert not TorchImpl(device="cpu", decode_mode="python")._device_decode()
    with pytest.raises(ValueError):
        TorchImpl(device="cpu", decode_mode="gpu")


def _bad_lanes(v):
    """(label, item) lanes: a good partial, then every kind of bad one."""
    good = v["partials"][1]
    forged = v["partials"][2]
    x_ge_p = bytearray(P.to_bytes(48, "big") + (1).to_bytes(48, "big"))
    x_ge_p[0] |= 0x80
    return [
        ("good", (v["pubshares"][1], MSG, good)),
        ("forged", (v["pubshares"][1], MSG, forged)),
        ("truncated", (v["pubshares"][1], MSG, good[:-1])),
        ("no-flag", (v["pubshares"][1], MSG, bytes([good[0] & 0x7F]) + good[1:])),
        ("x-ge-p", (v["pubshares"][1], MSG, bytes(x_ge_p))),
        ("infinite", (v["pubshares"][1], MSG, INFINITE)),
        ("off-subgroup", (v["pubshares"][1], MSG, _off_subgroup_sig())),
        ("bad-pubkey", (bytes(48), MSG, good)),
    ]


def test_device_decode_verdicts_equal_python_decode(cluster, device_impl, monkeypatch):
    """Forged, malformed, infinite and off-subgroup lanes: the same verdicts
    from both decodes, and the device decode never calls the separate
    [r]P subgroup check."""
    lanes = _bad_lanes(cluster["vals"][0])
    items = [item for _, item in lanes]
    want = TorchImpl(device="cpu", decode_mode="python").verify_batch(items)
    assert want == [label == "good" for label, _ in lanes]

    def forbidden(*_):
        raise AssertionError("subgroup_check_g2_batch ran under device decode")

    monkeypatch.setattr(device_impl.engine, "subgroup_check_g2_batch", forbidden)
    assert device_impl.verify_batch(items) == want
    with pytest.raises(TblsError, match="failed decompression or subgroup check"):
        device_impl.verify_aggregate([cluster["vals"][0]["pubkey"]], MSG, _off_subgroup_sig())


def test_device_decode_aggregates_equal_the_host(cluster, device_impl):
    py = cluster["py"]
    vals = cluster["vals"]
    batch = [{i: v["partials"][i] for i in list(v["partials"])[:T]} for v in vals]
    assert device_impl.threshold_aggregate_batch(batch) == [py.threshold_aggregate(p) for p in batch]
    groups = [[v["partials"][1], v["partials"][2]] for v in vals]
    assert device_impl.aggregate_batch(groups) == [py.aggregate(g) for g in groups]


def _message(call):
    with pytest.raises(Exception) as err:
        call()
    assert type(err.value).__name__ == "TblsError"
    return str(err.value)


@pytest.fixture(scope="module")
def reference_device():
    from charon_tpu.tbls.tpu_impl import TPUImpl

    return {
        True: TPUImpl(decode_mode="device"),
        False: TPUImpl(decode_mode="device", verify_inputs=False),
    }


HOST_CASES = [
    "infinite_then_index_0", "index_0_then_empty", "empty_then_index_0", "thresholds_then_infinite",
    "inconsistent_thresholds", "truncated_then_index_0", "thresholds_then_truncated",
]
SUBGROUP_CASES = ["off_subgroup_then_index_0", "infinite_then_off_subgroup", "thresholds_then_off_subgroup"]


@pytest.mark.parametrize("case", HOST_CASES + SUBGROUP_CASES)
def test_threshold_aggregate_errors_equal_the_reference_device_decode(
    cluster, device_impl, device_trusting, reference_device, case
):
    """One device decode covers every validator before the first host
    error; the error raised is the one TPUImpl(decode_mode="device")'s
    validator-by-validator walk raises first."""
    check = case in SUBGROUP_CASES
    batch = _bad_batch(cluster["vals"], case)
    want = _message(lambda: reference_device[check].threshold_aggregate_batch(batch))
    impl = device_impl if check else device_trusting
    assert _message(lambda: impl.threshold_aggregate_batch(batch)) == want
    if case in ("off_subgroup_then_index_0", "truncated_then_index_0"):
        assert want == "partial signature failed decompression or subgroup check"


@pytest.mark.parametrize("case", ["infinite_then_empty", "empty_then_malformed", "malformed_then_infinite"])
def test_aggregate_errors_equal_the_reference_device_decode(cluster, device_impl, reference_device, case):
    p = cluster["vals"][0]["partials"]
    groups = {
        "infinite_then_empty": [[p[1], INFINITE], []],
        "empty_then_malformed": [[p[1]], [], [p[2][:-1]]],
        "malformed_then_infinite": [[p[1], _off_subgroup_sig(), INFINITE]],
    }[case]
    want = _message(lambda: reference_device[True].aggregate_batch(groups))
    assert _message(lambda: device_impl.aggregate_batch(groups)) == want


# -- warm_point_caches ------------------------------------------------------------


class _FakeEngine:
    """Engine stand-in recording the bulk calls; a lane whose first byte is
    0xFF is invalid."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def decompress_g1_batch(self, batch, subgroup_check=True):
        self.calls.append(("g1", len(batch)))
        return [b"pt" + b[:2] for b in batch], [b[0] != 0xFF for b in batch]

    def hash_to_g2_batch(self, batch):
        self.calls.append(("h2c", len(batch)))
        return [b"h2c" + b[:2] for b in batch], [True] * len(batch)


def test_warm_point_caches_device_decode_fills_the_caches(cluster):
    """Real device programs (on the CPU): valid unique pubkeys and every
    message land in the impl's own caches with the host decode's points;
    invalid lanes are counted and not inserted; a re-warm counts cached."""
    impl = TorchImpl(device="cpu", decode_mode="device")
    vals = cluster["vals"]
    off_subgroup = g1g2.g1_to_bytes(_g1_on_curve_not_in_subgroup())
    pubkeys = [vals[0]["pubkey"], vals[1]["pubkey"], vals[0]["pubkey"], bytes(48), off_subgroup]
    msgs = [MSG, b"another root"]
    stats = warm_point_caches(impl, pubkeys, msgs)
    assert stats["pubkey"] == {"device": 2, "python": 0, "cached": 0, "invalid": 2}
    assert stats["message"] == {"device": 2, "python": 0, "cached": 0, "invalid": 0}
    assert stats["seconds"] >= 0
    assert impl.pubkey_points.cache_info().currsize == 2 and bytes(48) not in impl.pubkey_points
    for v in vals[:2]:
        assert impl.pubkey_points(v["pubkey"]) == g1g2.g1_from_bytes(v["pubkey"])
    assert [impl.msg_points(m) for m in msgs] == [h2c.hash_to_g2(m) for m in msgs]
    again = warm_point_caches(impl, pubkeys[:2], [MSG, b"third root"], device=False)
    assert again["pubkey"] == {"device": 0, "python": 0, "cached": 2, "invalid": 0}
    assert again["message"] == {"device": 0, "python": 1, "cached": 1, "invalid": 0}


def test_warm_point_caches_resolves_device_as_decode_mode_and_chunks():
    keys = [bytes([i]) * 48 for i in (1, 2, 0xFF)]
    msgs = [bytes([i]) * 32 for i in (5, 6, 7)]
    impl = TorchImpl(device="cpu", decode_mode="device")
    impl.engine = _FakeEngine()
    stats = warm_point_caches(impl, keys, msgs, chunk=2)
    assert stats["pubkey"] == {"device": 2, "python": 0, "cached": 0, "invalid": 1}
    assert stats["message"]["device"] == 3
    assert impl.engine.calls == [("g1", 2), ("g1", 1), ("h2c", 2), ("h2c", 1)]
    assert keys[2] not in impl.pubkey_points
    python = TorchImpl(device="cpu")  # auto on the CPU: the host decode
    python.engine = _FakeEngine()
    stats = warm_point_caches(python, [], [MSG])
    assert stats["message"]["python"] == 1 and python.engine.calls == []


def test_warm_point_caches_caps_at_capacity():
    impl = TorchImpl(device="cpu")
    impl.msg_points = PointCache(_decode_msg_point, 2)
    msgs = [b"m%d" % i for i in range(5)]
    stats = warm_point_caches(impl, messages=msgs)
    assert stats["message"]["python"] == 2 and stats["message"]["overflow"] == 3
    assert msgs[-1] in impl.msg_points and msgs[-2] in impl.msg_points
    assert all(m not in impl.msg_points for m in msgs[:3])


def test_warm_point_caches_raises_a_device_failure():
    class DyingEngine:
        def hash_to_g2_batch(self, batch):
            raise RuntimeError("injected device failure")

        decompress_g1_batch = hash_to_g2_batch

    impl = TorchImpl(device="cpu", decode_mode="device")
    impl.engine = DyingEngine()
    with pytest.raises(RuntimeError, match="injected device failure"):
        warm_point_caches(impl, messages=[b"a" * 32])
    assert b"a" * 32 not in impl.msg_points
