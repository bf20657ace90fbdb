"""PyTorch port, the slice as a whole: threshold aggregation, aggregation
and the rest of tests/test_tbls.py's case list, TorchImpl(device="cpu")
against the JAX package's PythonImpl, byte for byte."""

from __future__ import annotations

import itertools

import pytest
import torch

from charon_tpu.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.torch_impl import TorchImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

N, T = 5, 3
MSG = b"test duty signing root"


@pytest.fixture(scope="module")
def cluster():
    py = PythonImpl()
    vals = []
    for _ in range(3):
        secret = py.generate_secret_key()
        shares = py.threshold_split(secret, N, T)
        vals.append(dict(
            secret=secret,
            shares=shares,
            pubkey=py.secret_to_public_key(secret),
            pubshares={i: py.secret_to_public_key(s) for i, s in shares.items()},
            partials={i: py.sign(s, MSG) for i, s in shares.items()},
        ))
    return dict(py=py, vals=vals)


@pytest.fixture(scope="module")
def impl():
    return TorchImpl(device="cpu")


@pytest.fixture(scope="module")
def trusting():
    """Skips the device subgroup check of signature inputs (the aggregation
    path's setting: its partials were verified on arrival); the partial
    verify tests run with it."""
    return TorchImpl(device="cpu", verify_inputs=False)


@pytest.fixture(scope="module")
def aggregated(cluster, impl):
    """One threshold_aggregate_batch over the first t partials of every
    validator plus every t-subset of validator 0's partials."""
    vals = cluster["vals"]
    firsts = [{i: v["partials"][i] for i in list(v["partials"])[:T]} for v in vals]
    subsets = [{i: vals[0]["partials"][i] for i in c} for c in itertools.combinations(vals[0]["partials"], T)]
    out = impl.threshold_aggregate_batch(firsts + subsets)
    return dict(firsts=firsts, group=out[: len(vals)], subsets=out[len(vals):])


def test_threshold_aggregate_bytes_equal_python_impl(cluster, aggregated):
    py = cluster["py"]
    assert aggregated["group"] == [py.threshold_aggregate(p) for p in aggregated["firsts"]]


def test_any_t_subset_recombines_to_same_signature(aggregated):
    assert len(aggregated["subsets"]) == 10
    assert set(aggregated["subsets"]) == {aggregated["group"][0]}


def test_group_signatures_verify_and_wrong_keys_do_not(cluster, trusting, aggregated):
    vals = cluster["vals"]
    items = [(v["pubkey"], MSG, s) for v, s in zip(vals, aggregated["group"])]
    items.append((vals[1]["pubkey"], MSG, aggregated["group"][0]))  # wrong group key
    items.append((vals[0]["pubshares"][1], MSG, vals[0]["partials"][2]))  # wrong share
    assert trusting.verify_batch(items) == [True, True, True, False, False]


def test_verify_rejects_bad_inputs(cluster, impl):
    v = cluster["vals"][0]
    good = v["partials"][1]
    bad = [
        (v["pubkey"], MSG, good[:-1]),  # truncated signature
        (v["pubkey"][:-1], MSG, good),  # truncated pubkey
        (bytes(48), MSG, good),  # malformed pubkey
        (v["pubkey"], MSG, bytes([0xC0]) + bytes(95)),  # infinity signature
    ]
    assert impl.verify_batch(bad) == [False] * len(bad)
    with pytest.raises(TblsError):
        impl.verify(*bad[0])


def test_threshold_aggregate_rejects_bad_batches(cluster, impl):
    p = cluster["vals"][0]["partials"]
    with pytest.raises(TblsError):
        impl.threshold_aggregate_batch([{}])
    with pytest.raises(TblsError):
        impl.threshold_aggregate_batch([{0: p[1], 1: p[2], 2: p[3]}])
    with pytest.raises(TblsError):
        impl.threshold_aggregate_batch([{1: p[1], 2: p[2], 3: p[3]}, {1: p[1], 2: p[2]}])


def test_host_operations_match_python_impl(cluster, impl):
    py = cluster["py"]
    v = cluster["vals"][0]
    sub = {i: v["shares"][i] for i in list(v["shares"])[:T]}
    assert py.secret_to_public_key(impl.recover_secret(sub, N, T)) == v["pubkey"]
    assert impl.secret_to_public_key(v["secret"]) == v["pubkey"]
    assert impl.sign(v["shares"][2], MSG) == v["partials"][2]
    shares = impl.threshold_split(v["secret"], N, T)
    assert py.recover_secret(dict(list(shares.items())[2:]), N, T) == v["secret"]


def test_host_decode_matches_python_impl(cluster):
    from charon_tpu.tbls import python_impl as ref
    from charon_tpu_torch.tbls import python_impl as port

    v = cluster["vals"][0]
    assert port.pubkey_to_point(v["pubkey"]) == ref.pubkey_to_point(v["pubkey"])
    assert port.sig_to_point(v["partials"][1]) == ref.sig_to_point(v["partials"][1])
    for bad in (v["pubkey"][:-1], bytes(48), bytes([0xC0]) + bytes(47)):
        with pytest.raises(TblsError):
            port.pubkey_to_point(bad)


def test_point_cache_is_an_lru_with_bulk_put():
    from charon_tpu_torch.tbls.torch_impl import PointCache

    decoded = []
    cache = PointCache(lambda k: decoded.append(k) or k * 2, maxsize=2)
    assert cache(1) == 2 and cache(1) == 2 and decoded == [1]
    cache.put(3, 7)
    assert 3 in cache and cache(3) == 7
    cache(4)  # evicts the least recently used key, 1
    assert 1 not in cache and cache.cache_info() == (2, 2, 2, 2)
    cache.cache_clear()
    assert cache.cache_info() == (0, 0, 2, 0)


def test_aggregate_and_verify_aggregate(cluster, trusting):
    py = cluster["py"]
    sks = [v["secret"] for v in cluster["vals"]]
    pks = [v["pubkey"] for v in cluster["vals"]]
    sigs = [py.sign(sk, MSG) for sk in sks]
    agg = trusting.aggregate(sigs)
    assert agg == py.aggregate(sigs)
    trusting.verify_aggregate(pks, MSG, agg)


# -- error order: the reference's host-decode rung, TPUImpl(decode_mode="python") --

INFINITE = bytes([0xC0]) + bytes(95)


def _off_subgroup_sig():
    """An on-curve G2 point outside the prime-order subgroup (no cofactor
    clearing), found by incrementing x, as a compressed signature."""
    from charon_tpu.crypto import fields as F
    from charon_tpu.crypto import g1g2 as G

    x0 = 1
    while (y := F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr((x0, 1)), (x0, 1)), (4, 4)))) is None:
        x0 += 1
    pt = ((x0, 1), y)
    assert G.g2_is_on_curve(pt) and not G.g2_in_subgroup(pt)
    return G.g2_to_bytes(pt)


def _bad_batch(vals, case):
    """A batch of the three validators' partials with the faults of `case`;
    each validator keeps T partials unless the case says otherwise."""
    p = [{i: v["partials"][i] for i in list(v["partials"])[:T]} for v in vals]
    first = [dict(q) for q in p]
    if case == "infinite_then_index_0":  # the reference raises at validator 0's decode
        first[0][1] = INFINITE
        first[1] = {0: p[1][1], **p[1]}
    elif case == "index_0_then_empty":
        first[0] = {0: p[0][1], 2: p[0][2], 3: p[0][3]}
        first[1] = {}
    elif case == "empty_then_index_0":
        first[1] = {}
        first[2] = {0: p[2][1], **p[2]}
    elif case == "thresholds_then_infinite":  # decode outranks the thresholds
        del first[1][3]
        first[2][2] = INFINITE
    elif case == "inconsistent_thresholds":
        first[0][4] = vals[0]["partials"][4]
    elif case == "truncated_then_index_0":
        first[0][2] = p[0][2][:-1]
        first[2] = {0: p[2][1], **p[2]}
    elif case == "thresholds_then_truncated":
        del first[0][3]
        first[2][3] = p[2][3][:50]
    elif case == "off_subgroup_then_index_0":  # the subgroup check of validator 0 comes first
        first[0][2] = _off_subgroup_sig()
        first[1] = {0: p[1][1], **p[1]}
    elif case == "infinite_then_off_subgroup":  # validator 2 is never checked
        first[1][3] = INFINITE
        first[2][1] = _off_subgroup_sig()
    elif case == "thresholds_then_off_subgroup":
        del first[0][3]
        first[2][1] = _off_subgroup_sig()
    else:
        raise AssertionError(case)
    return first


def _message(impl, batch):
    with pytest.raises(Exception) as err:
        impl.threshold_aggregate_batch(batch)
    assert type(err.value).__name__ == "TblsError"
    return str(err.value)


@pytest.fixture(scope="module")
def reference_trusting():
    from charon_tpu.tbls.tpu_impl import TPUImpl

    return TPUImpl(decode_mode="python", verify_inputs=False)


@pytest.mark.parametrize("case", [
    "infinite_then_index_0", "index_0_then_empty", "empty_then_index_0", "thresholds_then_infinite",
    "inconsistent_thresholds", "truncated_then_index_0", "thresholds_then_truncated",
])
def test_threshold_aggregate_raises_the_reference_error_first(cluster, trusting, reference_trusting, case):
    """Validator by validator, as the reference: empty, indices, host decode;
    the thresholds after every validator."""
    batch = _bad_batch(cluster["vals"], case)
    want = _message(reference_trusting, batch)
    assert _message(trusting, batch) == want
    if case == "infinite_then_index_0":
        assert want == "infinite partial signature"


@pytest.mark.parametrize("case", [
    "off_subgroup_then_index_0", "infinite_then_off_subgroup", "thresholds_then_off_subgroup",
])
def test_threshold_aggregate_subgroup_error_keeps_the_reference_order(cluster, impl, case):
    """With the subgroup check on: a partial off the subgroup at a validator
    before the first host error is named first, and one after it never."""
    from charon_tpu.tbls.tpu_impl import TPUImpl

    batch = _bad_batch(cluster["vals"], case)
    want = _message(TPUImpl(decode_mode="python"), batch)
    assert _message(impl, batch) == want
    assert want == {"off_subgroup_then_index_0": "partial signature not in G2 subgroup",
                    "infinite_then_off_subgroup": "infinite partial signature",
                    "thresholds_then_off_subgroup": "partial signature not in G2 subgroup"}[case]
