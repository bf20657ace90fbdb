"""PyTorch port: the DKG and resharing ceremony calls of ops/blsops.py and
their routing flags in ops/msm.py.

The pure-Fr pieces (`lagrange_coeffs_at`, `_mont_powers`) and the host-built
fixed-base table are held exactly against the JAX package's functions; every
ceremony call of `BlsEngine(device="cpu")` at 4-8 lanes against the host
oracles (`g1g2.g1_mul`/`g2_mul`/`g1_add`, `shamir`), under both
`ceremony_straus` values, Pippenger windows 4 and 8, every `_eval_nbits`
bucket, and the empty, padding, chunking and error cases. The JAX engine's
curve programs take minutes of XLA:CPU compile, so their parity runs under
`slow`.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from charon_tpu.ops import blsops as JB
from charon_tpu.ops import curve as JC
from charon_tpu.ops import limb as JL
from charon_tpu.ops import msm as JMSM
from charon_tpu_torch import convert
from charon_tpu_torch.crypto import g1g2, shamir
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.ops import blsops as B
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops.blsops import BlsEngine

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CEREMONY = ("g1_scalar_mul", "g2_scalar_mul", "g1_gen_mul", "commitment_eval", "g1_msm", "lagrange_at")


@pytest.fixture(autouse=True)
def _ceremony_flags():
    yield
    MSM.set_ceremony_straus(None)
    MSM.set_ceremony_window(None)


@pytest.fixture(scope="module")
def engine():
    return BlsEngine(device="cpu")


def _g1s(rng, n):
    return [g1g2.g1_mul(g1g2.G1_GEN, rng.randrange(1, R)) for _ in range(n)]


def _host_eval(row, x, t):
    """sum_vec sum_k C_k x^k: frost's host loop."""
    acc = None
    for v in range(len(row) // t):
        xpow = 1
        for c in row[v * t : (v + 1) * t]:
            acc = g1g2.g1_add(acc, g1g2.g1_mul(c, xpow))
            xpow = xpow * x % R
    return acc


def _host_lagrange(idx, x):
    out = []
    for j, xj in enumerate(idx):
        num = den = 1
        for m, xm in enumerate(idx):
            if m != j:
                num = num * (x - xm) % R
                den = den * (xj - xm) % R
        out.append(num * pow(den, -1, R) % R)
    return out


# -- pure Fr and the fixed-base table against the JAX package -------------------


@pytest.mark.parametrize("t", [1, 4])
def test_lagrange_coeffs_at_matches_jax(t):
    rng = random.Random(t)
    rows = [rng.sample(range(1, 40), t) for _ in range(6)]
    xs = [0, 7, rows[2][0], 1 << 30, 3, 12]
    got = B.lagrange_coeffs_at(L.FR, torch.tensor(rows), t, torch.tensor(xs))
    want = jax.jit(lambda i, x: JB.lagrange_coeffs_at(JL.FR, i, t, x))(
        jnp.asarray(np.array(rows, np.int32)), jnp.asarray(np.array(xs, np.int32))
    )
    assert np.array_equal(convert.limbs_to_jax(got, "fr"), np.asarray(want))
    assert L.ctx_unpack(L.FR, got.reshape(-1, L.FR.n_limbs)) == [
        c for r, x in zip(rows, xs) for c in _host_lagrange(r, x)
    ]


@pytest.mark.parametrize("t", [1, 4])
def test_mont_powers_match_jax(t):
    xs = [0, 1, 7, 9, (1 << 31) - 1]
    got = B._mont_powers(L.FR, torch.tensor(xs), t)
    want = jax.jit(lambda x: JB._mont_powers(JL.FR, x, t))(jnp.asarray(np.array(xs, np.int32)))
    assert np.array_equal(convert.limbs_to_jax(got, "fr"), np.asarray(want))


@pytest.mark.parametrize("nbits,window", [(255, 4), (32, 8)])
def test_fixed_base_table_matches_jax(nbits, window):
    got = B._gen_table_g1(L.FP, nbits, window, torch.device("cpu"))
    want = jax.tree_util.tree_map(np.asarray, JB._gen_table_g1(JL.FP, nbits, window))
    assert all(np.array_equal(a, b) for a, b in zip(convert.point_to_jax(got, "fp"), want))
    # T[win][d] = d * 2^(window * win) * G
    flat = L.unpack_mont_host(L.FP, got[0])
    win, d = 3, 5
    assert flat[win * (1 << window) + d] == g1g2.g1_mul(g1g2.G1_GEN, d << (window * win))[0]


# -- engine calls against the host oracles ----------------------------------------


def test_g1_scalar_mul_batch(engine):
    rng = random.Random(11)
    pts = _g1s(rng, 3) + [None, g1g2.G1_GEN]
    ks = [rng.randrange(R), 1, R - 1, rng.randrange(R), 0]
    assert engine.g1_scalar_mul_batch(pts, ks) == [
        None if p is None else g1g2.g1_mul(p, k) for p, k in zip(pts, ks)
    ]


def test_g2_scalar_mul_batch(engine):
    rng = random.Random(12)
    pts = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, R)) for _ in range(2)] + [None]
    ks = [rng.randrange(R), R - 1, 5]
    assert engine.g2_scalar_mul_batch(pts, ks) == [
        None if p is None else g1g2.g2_mul(p, k) for p, k in zip(pts, ks)
    ]


def test_g1_gen_mul_batch(engine):
    rng = random.Random(13)
    ks = [0, 1, 2, R - 1, 16, rng.randrange(R)]
    assert engine.g1_gen_mul_batch(ks) == [g1g2.g1_mul(g1g2.G1_GEN, k) for k in ks]


@pytest.mark.parametrize("straus", [True, False])
@pytest.mark.parametrize("nbits,t,x_big", [(32, 3, 9), (64, 3, 1 << 20), (128, 3, 1 << 40), (255, 4, 1 << 47)])
def test_commitment_eval_batch_every_route_and_bucket(engine, straus, nbits, t, x_big):
    xs = [1, x_big, 0, 7, 2]
    assert BlsEngine._eval_nbits(t, xs) == nbits
    rng = random.Random(nbits)
    rows = [_g1s(rng, t) for _ in range(len(xs) - 1)] + [[None, g1g2.G1_GEN] + [None] * (t - 2)]
    MSM.set_ceremony_straus(straus)
    assert engine.commitment_eval_batch(rows, xs, t) == [_host_eval(r, x, t) for r, x in zip(rows, xs)]


@pytest.mark.parametrize("straus", [True, False])
def test_commitment_eval_batch_concatenated_vectors(engine, straus):
    """Rows of vecs = 3 vectors of t = 2 commitments: frost's pubshare
    wave shape."""
    rng = random.Random(14)
    t, xs = 2, [1, 2, 3, 4]
    rows = [_g1s(rng, 3 * t) for _ in xs]
    MSM.set_ceremony_straus(straus)
    assert engine.commitment_eval_batch(rows, xs, t) == [_host_eval(r, x, t) for r, x in zip(rows, xs)]


def test_commitment_eval_batch_chunks_give_the_same_points(monkeypatch, engine):
    rng = random.Random(15)
    t, xs = 3, [3, 1, 4, 1, 5]
    rows = [_g1s(rng, t) for _ in xs]
    whole = engine.commitment_eval_batch(rows, xs, t)
    calls = []
    real = B.commitment_eval

    def spy(ctx, fr_ctx, vecs, t_, nbits, commits, xs_t):
        calls.append((xs_t.shape[0], nbits))
        return real(ctx, fr_ctx, vecs, t_, nbits, commits, xs_t)

    monkeypatch.setattr(B, "commitment_eval", spy)
    monkeypatch.setattr(BlsEngine, "EVAL_CHUNK_LANES", 2)
    assert engine.commitment_eval_batch(rows, xs, t) == whole == [_host_eval(r, x, t) for r, x in zip(rows, xs)]
    # chunks of 2, 2 and 1 lanes, each padded to the 4-lane floor; one
    # bit schedule for the whole call
    assert calls == [(4, 32), (4, 32), (4, 32)]


@pytest.mark.parametrize("window", [4, 8])
def test_g1_msm_batch(engine, window):
    rng = random.Random(window)
    pts = _g1s(rng, 4) + [None]
    ks = [rng.randrange(R) for _ in range(3)] + [0, 9]
    seg = [0, 2, 0, 2, 0]
    MSM.set_ceremony_window(window)
    want = [None] * 3
    for p, k, s in zip(pts, ks, seg):
        want[s] = g1g2.g1_add(want[s], None if p is None else g1g2.g1_mul(p, k))
    # 3 segments pad to 4; segment 1 is empty
    assert engine.g1_msm_batch(pts, ks, seg, 3) == want


def test_lagrange_coeffs_batch(engine):
    rows = [[1, 2, 3], [2, 4, 7], [5, 6, 9], [1, 3, 4], [8, 2, 6]]
    xs = [0, 0, 4, 11, 2]
    got = engine.lagrange_coeffs_batch(rows, xs)
    assert got == [_host_lagrange(r, x) for r, x in zip(rows, xs)]
    zero = shamir.lagrange_coeffs_at_zero(rows[1])
    assert got[1] == [zero[i] for i in rows[1]]


def test_empty_calls(engine):
    assert engine.g1_gen_mul_batch([]) == []
    assert engine.commitment_eval_batch([], [], 3) == []
    assert engine.g1_msm_batch([], [], [], 0) == []
    assert engine.g1_msm_batch([g1g2.G1_GEN], [1], [0], -1) == []
    assert engine.lagrange_coeffs_batch([], []) == []


def test_error_cases(engine):
    g = g1g2.G1_GEN
    with pytest.raises(ValueError, match="commitment rows must share one vecs\\*t width"):
        engine.commitment_eval_batch([[g, g, g], [g, g]], [1, 2], 3)
    with pytest.raises(ValueError, match="commitment rows must share one vecs\\*t width"):
        engine.commitment_eval_batch([[g, g]], [1], 3)
    with pytest.raises(ValueError, match="index rows must share one width"):
        engine.lagrange_coeffs_batch([[1, 2], [1, 2, 3]], [0, 0])
    for bad in (0, 17):
        with pytest.raises(ValueError, match=f"ceremony MSM window out of range: {bad}"):
            MSM.set_ceremony_window(bad)


def test_routing_flags_match_the_reference_defaults():
    assert MSM.ceremony_straus_active() is JMSM.ceremony_straus_active() is True
    assert MSM.ceremony_window() == JMSM.ceremony_window() == 8
    MSM.set_ceremony_straus(False)
    MSM.set_ceremony_window(16)
    assert MSM.ceremony_straus_active() is False and MSM.ceremony_window() == 16


@pytest.mark.parametrize("nbits,width", [(32, 28), (64, 4), (128, 3), (255, 2)])
def test_windowed_joint_mul_at_ceremony_shapes(nbits, width):
    """Straus at the ceremony's bit schedules and widths up to vecs * t =
    28 (a 4-of-7 pubshare row), against the host oracle."""
    rng = random.Random(nbits)
    n = 2
    f = C.g1_ops(L.FP)
    pts = C.affine_to_point(f, B._grid(C.g1_pack(L.FP, _g1s(rng, n * width)), n, width))
    ks = [rng.randrange(1 << nbits) % R for _ in range(n * width)]
    scal = torch.as_tensor(L.ctx_pack(L.FR, ks)).reshape(n, width, -1)
    with torch.inference_mode():
        got = C.point_to_affine(f, MSM.windowed_joint_mul(f, L.FR, pts, scal, nbits=nbits))
    want = [None] * n
    flat = C.g1_unpack(L.FP, C.point_to_affine(f, pts))
    for i, (p, k) in enumerate(zip(flat, ks)):
        want[i // width] = g1g2.g1_add(want[i // width], g1g2.g1_mul(p, k))
    assert C.g1_unpack(L.FP, got) == want


# -- the program-family registry ----------------------------------------------------


def test_ceremony_families_use_the_reference_names_and_split():
    ours = {n: f.sentinel for n, f in B.kernel_families().items() if n.startswith("blsops/")}
    ref = {n: f.sentinel for n, f in JB.kernel_families().items() if n.startswith("blsops/")}
    assert ours == ref
    assert {f"blsops/{n}" for n in CEREMONY} <= ours.keys()


@pytest.mark.parametrize("name", ["g1_gen_mul", "commitment_eval", "lagrange_at"])
def test_ceremony_family_specs_launch(name):
    spec = B.kernel_families()[f"blsops/{name}"].build("cpu")
    assert spec.lanes == 4 and spec.ctx is L.FP
    out = spec.launch()
    if name == "lagrange_at":  # idx 1..3 at x = 1..4: rows of the basis
        got = L.ctx_unpack(L.FR, out.reshape(-1, L.FR.n_limbs))
        assert got == [c for x in range(1, 5) for c in _host_lagrange([1, 2, 3], x)]
    elif name == "g1_gen_mul":
        assert C.g1_unpack(L.FP, out) == [g1g2.G1_GEN] * 4
    else:  # G at x = 1..4, t = 3: (1 + x + x^2) G
        assert C.g1_unpack(L.FP, out) == [g1g2.g1_mul(g1g2.G1_GEN, 1 + x + x * x) for x in range(1, 5)]


# -- the JAX engine's curve programs (XLA:CPU compiles: slow) ---------------------


@pytest.mark.slow
@pytest.mark.parametrize("straus", [True, False])
def test_ceremony_programs_match_the_jax_engine(straus):
    """The same packed inputs through the JAX engine's jitted programs and
    the port's: equal affine limbs."""
    rng = random.Random(7)
    n, t = 4, 3
    ctx, fr_ctx = JL.FP, JL.FR
    base = _g1s(rng, n)
    ks = [rng.randrange(R) for _ in range(n)]
    jbase, jks = JC.g1_pack(ctx, base), JC.fr_pack(fr_ctx, ks)
    pbase, pks = convert.point_from_jax(jax.tree_util.tree_map(np.asarray, jbase), "fp"), convert.limbs_from_jax(
        np.asarray(jks), "fr"
    )

    def same(port, ref):
        a = jax.tree_util.tree_leaves(convert.point_to_jax(port, "fp"))
        b = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    JMSM.set_ceremony_straus(straus)
    MSM.set_ceremony_straus(straus)
    try:
        JB.clear_kernel_caches()
        with torch.inference_mode():
            assert same(
                B.scalar_mul_affine(C.g1_ops(L.FP), L.FR, pbase, pks),
                JB._g1_scalar_mul_kernel(ctx, fr_ctx)(jbase, jks),
            )
            assert same(B.g1_gen_mul(L.FP, L.FR, pks), JB._g1_gen_mul_kernel(ctx, fr_ctx, 255, 4)(jks))
            rows = _g1s(rng, n * t)
            jrows = jax.tree_util.tree_map(lambda a: a.reshape(n, t, *a.shape[1:]), JC.g1_pack(ctx, rows))
            prows = B._grid(C.g1_pack(L.FP, rows), n, t)
            xs = [1, 2, 3, 9]
            assert same(
                B.commitment_eval(L.FP, L.FR, 1, t, 32, prows, torch.tensor(xs)),
                JB._commitment_eval_kernel(ctx, fr_ctx, 1, t, 32)(jrows, jnp.asarray(np.array(xs, np.int32))),
            )
            seg = [0, 1, 0, 1]
            assert same(
                B.g1_msm(L.FP, L.FR, 2, 255, pbase, pks, torch.tensor(seg)),
                JB._g1_msm_kernel(ctx, fr_ctx, 2, 255)(jbase, jks, jnp.asarray(np.array(seg, np.int32))),
            )
            g2 = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, R)) for _ in range(n)]
            assert same(
                B.scalar_mul_affine(C.g2_ops(L.FP), L.FR, C.g2_pack(L.FP, g2), pks),
                JB._g2_scalar_mul_kernel(ctx, fr_ctx)(JC.g2_pack(ctx, g2), jks),
            )
    finally:
        JMSM.set_ceremony_straus(None)
        JB.clear_kernel_caches()
