"""PyTorch port: the int8 tensor-core configuration (kernels K4-K6).

The port's Toeplitz piece tables against the JAX package's
(charon_tpu/ops/limb_mxu.py); K4's plain version against limb_mxu.
mont_mul_mxu and the TPU kernel mont_mul_pallas(mxu=True) in interpret mode;
K5/K6's plain versions against fp2_mul_pallas/fp2_sqr_pallas(mxu=True); the
routing flag limb.set_mxu; and the slice as a whole — TorchImpl(device="cpu")
under KernelConfig(mxu_mont=True) against PythonImpl. Exact equality
throughout. The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py (marker `cuda`).
"""

from __future__ import annotations

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from charon_tpu.ops import limb as JL
from charon_tpu.ops import limb_mxu as JM
from charon_tpu.ops.pallas_mont import fp2_mul_pallas, fp2_sqr_pallas, mont_mul_pallas
from charon_tpu.tbls.python_impl import PythonImpl
from charon_tpu_torch import convert
from charon_tpu_torch.core.autotune import KernelConfig
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import limb_mxu as LM
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.tbls.torch_impl import TorchImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTXS = {"fp": (L.FP, JL.FP32), "fr": (L.FR, JL.FR32)}


def _values(ctx, n, seed):
    """Edge values (0, 1, m-1, m-2, R mod m, m//2) then seeded randoms."""
    m = ctx.modulus
    rng = random.Random(seed)
    edge = [0, 1, m - 1, m - 2, ctx.r_mont, m // 2]
    return edge + [rng.randrange(m) for _ in range(n - len(edge))]


@pytest.fixture(autouse=True)
def _default_route():
    yield
    L.set_mxu(None)
    MSM.set_msm(None)


@pytest.fixture
def spies(monkeypatch):
    """Counts calls of each plain version a CPU tensor takes."""
    calls = {}
    for name in ("mont_mul_plain", "mont_mul_mxu_plain", "fp2_mul_plain", "fp2_sqr_plain",
                 "fp2_mul_mxu_plain", "fp2_sqr_mxu_plain"):
        def spy(*args, _fn=getattr(MK, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(MK, name, spy)
    return calls


# -- piece tables --------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_piece_tables_recombine_to_constants_and_equal_reference(name):
    ctx, jctx = CTXS[name]
    n12 = 2 * ctx.n_limbs
    r = 1 << (24 * ctx.n_limbs)
    ninv = (-pow(ctx.modulus, -1, r)) % r
    for (T0, T1), c, (J0, J1) in (
        (LM._ninv_toeplitz(ctx), ninv, JM._ninv_toeplitz(jctx)),
        (LM._modulus_toeplitz(ctx), ctx.modulus, JM._modulus_toeplitz(jctx)),
    ):
        assert T0.dtype == np.int8 and 0 <= T0.min() and T1.max() <= LM.PIECE_MASK
        # row 0 of the band holds the constant's 12-bit limbs
        got = sum((int(T0[0, k]) + (int(T1[0, k]) << 6)) << (12 * k) for k in range(n12))
        assert got == c
        # row i is row 0 shifted i columns, cut at the table's width
        for i in range(1, n12):
            assert np.array_equal(T0[i, i:], T0[0, : T0.shape[1] - i])
        assert np.array_equal(T0, J0) and np.array_equal(T1, J1)
    # the kernels' padded block holds the same tables, zeros elsewhere, each
    # as 16-deep column-major planes: [k step][column][depth]
    block = LM.kernel_tables_np(ctx)
    nbytes = LM.K_DEPTH * LM.NINV_COLS

    def unplane(b, cols):
        return b.reshape(LM.K_DEPTH // 16, cols, 16).transpose(0, 2, 1).reshape(LM.K_DEPTH, cols)

    nT0 = unplane(block[:nbytes], LM.NINV_COLS)
    pT1 = unplane(block[2 * nbytes + LM.K_DEPTH * LM.MOD_COLS:], LM.MOD_COLS)
    assert np.array_equal(nT0[:n12, :n12], LM._ninv_toeplitz(ctx)[0])
    assert np.array_equal(pT1[:n12, : 2 * n12], LM._modulus_toeplitz(ctx)[1])
    assert block.size == 6144 and int(np.abs(block).sum()) == sum(
        int(t.astype(np.int64).sum()) for t in (*LM._ninv_toeplitz(ctx), *LM._modulus_toeplitz(ctx))
    )


# -- K4: Montgomery product ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_mont_mul_mxu(name):
    return jax.jit(functools.partial(JM.mont_mul_mxu, CTXS[name][1]))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_k4_plain_matches_jax_mxu_and_pallas_interpret(name):
    """K4's plain version against the JAX package's XLA-level int8
    decomposition and the TPU kernel itself (interpret mode), on the same
    Montgomery values through convert.py, and against K1's plain version."""
    ctx, jctx = CTXS[name]
    va, vb = _values(ctx, 12, 21), _values(ctx, 12, 22)[::-1]
    a32, b32 = JL.pack_mont_host(jctx, va), JL.pack_mont_host(jctx, vb)
    a, b = convert.limbs_from_jax(a32, name + "32"), convert.limbs_from_jax(b32, name + "32")
    got = MK.mont_mul_mxu(ctx, a, b)
    want_xla = np.asarray(_jax_mont_mul_mxu(name)(jnp.asarray(a32), jnp.asarray(b32)))
    want_pallas = np.asarray(mont_mul_pallas(jctx, jnp.asarray(a32), jnp.asarray(b32), interpret=True, mxu=True))
    assert np.array_equal(convert.limbs_to_jax(got, name + "32"), want_xla)
    assert np.array_equal(convert.limbs_to_jax(got, name + "32"), want_pallas)
    assert torch.equal(got, MK.mont_mul_plain(ctx, a, b))
    assert L.unpack_mont_host(ctx, got) == [x * y % ctx.modulus for x, y in zip(va, vb)]


def test_k4_plain_on_many_rows_and_batch_dims():
    """300 rows of edge and random values, in a (3, 100) batch shape,
    against K1's plain version and the bigint oracle."""
    for ctx in (L.FP, L.FR):
        va, vb = _values(ctx, 300, 23), _values(ctx, 300, 24)[::-1]
        a = torch.as_tensor(L.pack_mont_host(ctx, va)).reshape(3, 100, -1)
        b = torch.as_tensor(L.pack_mont_host(ctx, vb)).reshape(3, 100, -1)
        got = MK.mont_mul_mxu(ctx, a, b)
        assert got.shape == a.shape and torch.equal(got, MK.mont_mul(ctx, a, b))
        assert L.unpack_mont_host(ctx, got) == [x * y % ctx.modulus for x, y in zip(va, vb)]


# -- K5 / K6: fused Fp2 multiply and square ------------------------------------


def test_k5_k6_plain_match_pallas_interpret():
    """Both Pallas fp2 calls in one test: each interpret-mode program is a
    fresh XLA:CPU compile (tests/test_pallas_fp2.py keeps its own in a
    subprocess for the same reason)."""
    ctx, jctx = L.FP, JL.FP32
    vals = [_values(ctx, 8, 31 + k) for k in range(4)]
    vals[1], vals[3] = vals[1][::-1], vals[3][3:] + vals[3][:3]
    packed = [JL.pack_mont_host(jctx, v) for v in vals]
    ops = [convert.limbs_from_jax(p, "fp32") for p in packed]
    j = [jnp.asarray(p) for p in packed]

    got = MK.fp2_mul_mxu(ctx, (ops[0], ops[1]), (ops[2], ops[3]))
    want = fp2_mul_pallas(jctx, (j[0], j[1]), (j[2], j[3]), interpret=True, mxu=True)
    for g, w in zip(got, want):
        assert np.array_equal(convert.limbs_to_jax(g, "fp32"), np.asarray(w))
    assert all(torch.equal(g, w) for g, w in zip(got, MK.fp2_mul_plain(ctx, *ops)))

    got = MK.fp2_sqr_mxu(ctx, (ops[0], ops[1]))
    want = fp2_sqr_pallas(jctx, (j[0], j[1]), interpret=True, mxu=True)
    for g, w in zip(got, want):
        assert np.array_equal(convert.limbs_to_jax(g, "fp32"), np.asarray(w))
    assert all(torch.equal(g, w) for g, w in zip(got, MK.fp2_sqr_plain(ctx, ops[0], ops[1])))


# -- routing -------------------------------------------------------------------


def test_set_mxu_routes_products_through_k4_k6(spies, monkeypatch):
    """With the int8 route on, limb.mont_mul (Fp and Fr) takes K4 and
    fp2_batch takes K5/K6 — mul_fp through limb.mont_mul, so K4 — with K1's
    results; set_mxu(None) restores the K1-K3 route. The ops never read
    CHARON_MXU_MONT (the tuner folds it in)."""
    monkeypatch.setenv("CHARON_MXU_MONT", "1")
    fp, fr = L.FP, L.FR
    a = torch.as_tensor(L.pack_mont_host(fp, _values(fp, 8, 41)))
    b = torch.as_tensor(L.pack_mont_host(fp, _values(fp, 8, 42)))
    s = torch.as_tensor(L.pack_mont_host(fr, _values(fr, 8, 43)))
    ops = [("mul", (a, b), (b, a)), ("sqr", (a, b)), ("mul_fp", (a, b), b)]

    def run():
        return [L.mont_mul(fp, a, b), L.mont_mul(fr, s, s)] + [x for pair in T.fp2_batch(fp, ops) for x in pair]

    want = run()
    assert not L._mxu_active(fp) and set(spies) == {"mont_mul_plain", "fp2_mul_plain", "fp2_sqr_plain"}
    spies.clear()
    L.set_mxu(True)
    assert L._mxu_active(fp) and L._mxu_active(fr)
    got = run()
    assert set(spies) == {"mont_mul_mxu_plain", "fp2_mul_mxu_plain", "fp2_sqr_mxu_plain"}
    assert spies["mont_mul_mxu_plain"] == 5  # 2 products, mul_fp, one stacked call in each of K5, K6
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    spies.clear()
    L.set_mxu(None)
    assert not L._mxu_active(fp)
    assert all(torch.equal(g, w) for g, w in zip(run(), want))
    assert "mont_mul_mxu_plain" not in spies


# -- the slice as a whole ------------------------------------------------------


def test_torch_impl_under_int8_config_matches_python_impl(spies):
    """Under KernelConfig(mxu_mont=True): one grouped-RLC verify_batch of
    16 partials (4 validators, 3-of-5, two messages) and one
    threshold_aggregate_batch, verdicts and bytes equal to PythonImpl's,
    with every product on the int8 route and none on K1-K3."""
    py = PythonImpl()
    lanes, partials = [], []
    for v in range(4):
        shares = py.threshold_split(py.generate_secret_key(), 5, 3)
        msg = b"duty root %d" % (v % 2)
        sigs = {i: py.sign(shares[i], msg) for i in (1, 2, 4, 5)}
        lanes += [(py.secret_to_public_key(shares[i]), msg, s) for i, s in sigs.items()]
        partials.append({i: sigs[i] for i in (1, 4, 5)})

    KernelConfig(mxu_mont=True).apply()
    impl = TorchImpl(device="cpu")
    grouped = []
    inner = impl.engine.verify_batch_grouped_rlc
    impl.engine.verify_batch_grouped_rlc = lambda groups, rng=None: grouped.append(len(groups)) or inner(groups, rng)

    assert impl.verify_batch(lanes) == py.verify_batch(lanes) == [True] * 16
    assert grouped == [2]
    assert impl.threshold_aggregate_batch(partials) == [py.threshold_aggregate(p) for p in partials]
    assert set(spies) == {"mont_mul_mxu_plain", "fp2_mul_mxu_plain", "fp2_sqr_mxu_plain"}
