"""PyTorch port: the host tbls backends (charon_tpu_torch/crypto/pairing.py,
pairing_fast.py, the verify half of crypto/bls.py, tbls/python_impl.py's
PythonImpl and tbls/native_impl.py's NativeImpl), held against the JAX
package.

  * The JAX package's tests/test_crypto_ref.py, test_pairing_fast.py and
    test_native_backend.py run on the port's modules (`reference_cases`).
    test_tbls.py is `slow` as a whole and its cross-implementation cases
    drive TPUImpl, so the parity below takes their place in tier 1.
  * Parity: on seeded keys and messages, the port's PythonImpl and
    NativeImpl and the reference's give byte-equal `sign`, `aggregate`
    and `threshold_aggregate`, and equal `verify` and `verify_aggregate`
    verdicts, with the same error text on every refusal (a signature over
    another message, a flipped byte, an infinite signature or pubkey, a
    wrong pubkey, a wrong length, a share index of 0, no inputs).

Tolerance: exact (bytes, verdicts, error texts).
"""

from __future__ import annotations

import random

import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu.tbls import native_impl as ref_native
from charon_tpu.tbls import python_impl as ref_python
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.tbls import native_impl as port_native
from charon_tpu_torch.tbls import python_impl as port_python

CRYPTO_REF_CASES = export_cases(reference_cases("test_crypto_ref"), globals())
PAIRING_FAST_CASES = export_cases(reference_cases("test_pairing_fast"), globals())
NATIVE_CASES = export_cases(reference_cases("test_native_backend"), globals())


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    # test_native_backend's 6 cases and its 2 fixtures; test_crypto_ref's 6 classes
    assert (len(CRYPTO_REF_CASES), len(PAIRING_FAST_CASES), len(NATIVE_CASES)) == (6, 5, 8)
    for name in CRYPTO_REF_CASES + PAIRING_FAST_CASES + NATIVE_CASES:
        assert not reference_modules(globals()[name]), name


BACKENDS = {
    "python": (port_python.PythonImpl, ref_python.PythonImpl),
    "native": (port_native.NativeImpl, ref_native.NativeImpl),
}
INFINITE_SIG = b"\xc0" + bytes(95)
INFINITE_PK = b"\xc0" + bytes(47)


def _outcome(fn, *args):
    """What a call gives: its value, or its error's type name and text."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, str(e)


def _flip(data: bytes, at: int) -> bytes:
    return data[:at] + bytes([data[at] ^ 1]) + data[at + 1 :]


@pytest.fixture(params=sorted(BACKENDS))
def pair(request):
    port_cls, ref_cls = BACKENDS[request.param]
    return port_cls(), ref_cls()


@pytest.fixture(scope="module")
def seeded():
    """Seeded secrets, their pubkeys, 3-of-5 shares of the first, and
    messages, from the port's PythonImpl."""
    rng = random.Random(20261017)
    py = port_python.PythonImpl()
    sks = [port_python.int_to_sk(rng.randrange(1, R)) for _ in range(3)]
    pks = [py.secret_to_public_key(sk) for sk in sks]
    msgs = [rng.randbytes(32) for _ in range(2)]
    shares = {i: port_python.int_to_sk(s) for i, s in _split(port_python.sk_to_int(sks[0]), rng).items()}
    return sks, pks, msgs, shares


def _split(secret: int, rng: random.Random, n: int = 5, t: int = 3) -> dict[int, int]:
    poly = [secret] + [rng.randrange(1, R) for _ in range(t - 1)]
    return {x: sum(c * x**k for k, c in enumerate(poly)) % R for x in range(1, n + 1)}


def test_sign_and_aggregates_are_byte_equal(pair, seeded):
    port, ref = pair
    sks, pks, msgs, shares = seeded
    for sk, pk in zip(sks, pks):
        assert port.secret_to_public_key(sk) == ref.secret_to_public_key(sk) == pk
        for msg in msgs:
            assert port.sign(sk, msg) == ref.sign(sk, msg)
    sigs = [ref.sign(sk, msgs[0]) for sk in sks]
    assert port.aggregate(sigs) == ref.aggregate(sigs)
    partials = {i: ref.sign(s, msgs[1]) for i, s in shares.items()}
    for subset in ((1, 2, 3), (2, 4, 5), (1, 2, 3, 4, 5)):
        sub = {i: partials[i] for i in subset}
        got = port.threshold_aggregate(sub)
        assert got == ref.threshold_aggregate(sub) == ref.sign(sks[0], msgs[1])


def test_verify_verdicts_and_error_texts_are_equal(pair, seeded):
    port, ref = pair
    sks, pks, msgs, _ = seeded
    sig = ref.sign(sks[0], msgs[0])
    cases = [
        (pks[0], msgs[0], sig),  # good
        (pks[0], msgs[1], sig),  # another message
        (pks[1], msgs[0], sig),  # a wrong pubkey
        (pks[0], msgs[0], _flip(sig, 95)),  # a flipped byte: off the curve or another point
        (pks[0], msgs[0], _flip(sig, 0)),  # a flipped flag bit
        (pks[0], msgs[0], INFINITE_SIG),
        (INFINITE_PK, msgs[0], sig),
        (pks[0], msgs[0], sig[:-1]),
        (pks[0][:-1], msgs[0], sig),
    ]
    outcomes = [_outcome(port.verify, *case) for case in cases]
    assert outcomes == [_outcome(ref.verify, *case) for case in cases]
    assert outcomes[0] == ("ok", None) and all(o[0] == "TblsError" for o in outcomes[1:])


def test_verify_aggregate_verdicts_and_error_texts_are_equal(pair, seeded):
    port, ref = pair
    sks, pks, msgs, _ = seeded
    agg = ref.aggregate([ref.sign(sk, msgs[0]) for sk in sks])
    cases = [
        (pks, msgs[0], agg),  # good
        (pks[:2], msgs[0], agg),  # a signer missing
        (pks, msgs[1], agg),  # another message
        (pks, msgs[0], _flip(agg, 50)),
        (pks, msgs[0], INFINITE_SIG),
        ([], msgs[0], agg),
        (pks[:2] + [INFINITE_PK], msgs[0], agg),
    ]
    outcomes = [_outcome(port.verify_aggregate, *case) for case in cases]
    assert outcomes == [_outcome(ref.verify_aggregate, *case) for case in cases]
    assert outcomes[0] == ("ok", None) and all(o[0] == "TblsError" for o in outcomes[1:])


def test_aggregate_refusals_are_equal(pair, seeded):
    port, ref = pair
    sks, _, msgs, shares = seeded
    sig = ref.sign(shares[1], msgs[0])
    cases = [
        (port.threshold_aggregate, ref.threshold_aggregate, {}),
        (port.threshold_aggregate, ref.threshold_aggregate, {0: sig, 1: sig}),
        (port.threshold_aggregate, ref.threshold_aggregate, {1: sig, 2: INFINITE_SIG}),
        (port.threshold_aggregate, ref.threshold_aggregate, {1: sig, 2: sig[:-1]}),
        (port.aggregate, ref.aggregate, []),
        (port.aggregate, ref.aggregate, [sig, INFINITE_SIG]),
        (port.aggregate, ref.aggregate, [sig, _flip(sig, 95)]),
    ]
    outcomes = [_outcome(port_fn, arg) for port_fn, _, arg in cases]
    assert outcomes == [_outcome(ref_fn, arg) for _, ref_fn, arg in cases]
    # the native `aggregate` sums an infinite signature as the identity, as the reference's does
    lenient = [5] if isinstance(port, port_native.NativeImpl) else []
    assert [i for i, o in enumerate(outcomes) if o[0] != "TblsError"] == lenient


def test_python_and_native_agree_across_packages(seeded):
    """The port's PythonImpl verifies what the reference's NativeImpl
    signed and aggregated, and the port's NativeImpl what the reference's
    PythonImpl did."""
    sks, pks, msgs, shares = seeded
    for port, ref in ((port_python.PythonImpl(), ref_native.NativeImpl()), (port_native.NativeImpl(), ref_python.PythonImpl())):
        port.verify(pks[2], msgs[1], ref.sign(sks[2], msgs[1]))
        group = ref.threshold_aggregate({i: ref.sign(shares[i], msgs[0]) for i in (1, 3, 5)})
        port.verify(pks[0], msgs[0], group)
        port.verify_aggregate(pks, msgs[0], ref.aggregate([ref.sign(sk, msgs[0]) for sk in sks]))
