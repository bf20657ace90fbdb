"""PyTorch port on the card: each hand-written CUDA kernel (K1 Fp, K1 Fr,
K2, K3, and the int8 tensor-core K4 Fp, K4 Fr, K5, K6) against its plain
PyTorch version on the same CUDA tensors, K4-K6 against K1-K3, every
kernel at the edges of its tiles and waves and on operands off 16-byte
words (K4-K6 against K1-K3 at both kernels' edges), and TorchImpl's
verify/aggregate on the card against the host oracle under both kernel
configurations.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where those are absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

from __future__ import annotations

import random

import pytest
import torch

from charon_tpu_torch.crypto import g1g2, shamir
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.tbls.python_impl import PythonHost, sig_to_point

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _default_route():
    yield
    L.set_mxu(None)
    MSM.set_msm(None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operand(ctx, n, seed, device):
    """Edge values (0, 1, m-1, m-2, R mod m, m//2) then seeded randoms."""
    m = ctx.modulus
    rng = random.Random(seed)
    vals = [0, 1, m - 1, m - 2, ctx.r_mont, m // 2] + [rng.randrange(m) for _ in range(n - 6)]
    return torch.as_tensor(L.pack_mont_host(ctx, vals), device=device)


def _call(kernel, ctx, ops, plain=False):
    base = kernel.removesuffix("_fp").removesuffix("_fr")
    fn = getattr(MK, base + "_plain" if plain else base)
    if base.startswith("mont_mul"):
        return [fn(ctx, ops[0], ops[1])]
    if plain:
        return fn(ctx, *ops[: 4 if base.startswith("fp2_mul") else 2])
    if base.startswith("fp2_mul"):
        return fn(ctx, (ops[0], ops[1]), (ops[2], ops[3]))
    return fn(ctx, (ops[0], ops[1]))


KERNELS = ["mont_mul_fp", "mont_mul_fr", "fp2_mul", "fp2_sqr",
           "mont_mul_mxu_fp", "mont_mul_mxu_fr", "fp2_mul_mxu", "fp2_sqr_mxu"]


@pytest.mark.parametrize("rows", [4099, 131])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_version(card, kernel, rows):
    """Row counts that are not multiples of a 128-row block or a 32-row
    warp: the int8 kernels' dead rows must run the MMAs and store nothing."""
    ctx = L.FR if kernel.endswith("_fr") else L.FP
    ops = [_operand(ctx, rows, seed, card).roll(seed, 0) for seed in range(4)]
    before = MK.LAUNCHES[kernel]
    got, want = _call(kernel, ctx, ops), _call(kernel, ctx, ops, plain=True)
    torch.cuda.synchronize()
    assert MK.LAUNCHES[kernel] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["mont_mul_mxu_fp", "mont_mul_mxu_fr", "fp2_mul_mxu", "fp2_sqr_mxu"])
def test_int8_kernel_matches_its_k1_k3_twin(card, kernel):
    ctx = L.FR if kernel.endswith("_fr") else L.FP
    ops = [_operand(ctx, 65533, seed, card).roll(3 * seed, 0) for seed in range(4)]
    got, twin = _call(kernel, ctx, ops), _call(kernel.replace("_mxu", ""), ctx, ops)
    torch.cuda.synchronize()
    for g, w in zip(got, twin):
        assert torch.equal(g, w)


TILE_EDGES = ["1", "2", "3", "tile-1", "tile", "tile+1", "wave+2tile+1", "warp-1", "warp", "warp+1"]
TILED = KERNELS


def _edge_rows(kernel, edge):
    """A row count at an edge of the kernel's tiles or waves: a tile is a
    large launch's (K4: 128 rows, one warp's 32 up to 32 rows; the others:
    32), and one wave is the card's resident blocks times a tile."""
    sms = MK.sm_count(torch.device("cuda"))
    e = MK.geometry(kernel, 1 << 30, sms).elems
    wave = sms * MK._RESIDENT[kernel] * e
    return {"1": 1, "2": 2, "3": 3, "tile-1": e - 1, "tile": e, "tile+1": e + 1,
            "wave+2tile+1": wave + 2 * e + 1, "warp-1": 31, "warp": 32, "warp+1": 33}[edge]


def _ctx(kernel):
    return L.FR if kernel.endswith("_fr") else L.FP


@pytest.mark.parametrize("edge", TILE_EDGES)
@pytest.mark.parametrize("kernel", TILED)
def test_tiled_kernel_at_tile_edges(card, kernel, edge):
    """Every kernel walks tiles in persistent blocks: a partial last tile, a
    single tile and a launch past one wave all equal the plain version,
    and only the launched rows are written."""
    rows, ctx = _edge_rows(kernel, edge), _ctx(kernel)
    ops = [_operand(ctx, rows + 6, seed, card).roll(seed, 0)[:rows] for seed in range(4)]
    got, want = _call(kernel, ctx, ops), _call(kernel, ctx, ops, plain=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (rows, ctx.n_limbs) and torch.equal(g, w)


@pytest.mark.parametrize("edge", TILE_EDGES)
def test_k5_matches_k2_at_tile_edges(card, edge):
    rows = _edge_rows("fp2_mul_mxu", edge)
    ops = [_operand(L.FP, rows + 6, 7 * seed, card).roll(2 * seed, 0)[:rows] for seed in range(4)]
    got, twin = _call("fp2_mul_mxu", L.FP, ops), _call("fp2_mul", L.FP, ops)
    torch.cuda.synchronize()
    for g, w in zip(got, twin):
        assert torch.equal(g, w)


@pytest.mark.parametrize("edge", TILE_EDGES)
@pytest.mark.parametrize(
    "kernel", ["mont_mul_mxu_fp", "mont_mul_mxu_fr", "fp2_sqr_mxu", "mont_mul_fp", "mont_mul_fr", "fp2_sqr"]
)
def test_k4_k6_match_k1_k3_at_tile_edges(card, kernel, edge):
    """K4 == K1 and K6 == K3 at the edges of `kernel`'s tiles and waves."""
    rows, ctx = _edge_rows(kernel, edge), _ctx(kernel)
    int8 = kernel if "_mxu" in kernel else kernel.replace("mont_mul", "mont_mul_mxu").replace("fp2_sqr", "fp2_sqr_mxu")
    ops = [_operand(ctx, rows + 6, 5 * seed + 1, card).roll(2 * seed, 0)[:rows] for seed in range(4)]
    got, twin = _call(int8, ctx, ops), _call(int8.replace("_mxu", ""), ctx, ops)
    torch.cuda.synchronize()
    for g, w in zip(got, twin):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", TILED)
def test_tiled_kernel_takes_operands_off_16_byte_words(card, kernel):
    """A view that starts 8 bytes into a 16-byte word is copied before the
    launch (the tiles move in 16-byte words) and the copy counted; the
    result is unchanged."""
    rows, ctx = 77, _ctx(kernel)
    flat = torch.zeros(rows * ctx.n_limbs + 1, dtype=torch.int64, device=card)
    flat[1:] = _operand(ctx, rows, 3, card).reshape(-1)
    a0 = flat[1:].view(rows, ctx.n_limbs)
    assert a0.data_ptr() % 16 == 8
    ops = [a0] + [_operand(ctx, rows, seed, card).roll(seed, 0) for seed in range(1, 4)]
    before = MK.ALIGN_COPIES[kernel]
    got, want = _call(kernel, ctx, ops), _call(kernel, ctx, ops, plain=True)
    torch.cuda.synchronize()
    assert MK.ALIGN_COPIES[kernel] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mxu_mont", [False, True])
def test_torch_impl_on_card_matches_host_oracle(card, mxu_mont):
    """16 partials of 4 validators (2 messages) through grouped RLC, one
    forged lane through the per-lane re-check, and recombination equal to
    the host's Lagrange interpolation, under KernelConfig(mxu_mont=...);
    each configuration launches only its own kernels."""
    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    KernelConfig(mxu_mont=mxu_mont).apply()
    MK.reset_launches()
    host, impl = PythonHost(), TorchImpl()
    lanes, batch = [], []
    for v in range(4):
        shares = host.threshold_split(host.generate_secret_key(), 5, 3)
        msg = b"duty root %d" % (v % 2)
        partials = {i: host.sign(shares[i], msg) for i in (1, 2, 4, 5)}
        lanes += [(host.secret_to_public_key(shares[i]), msg, s) for i, s in partials.items()]
        batch.append({i: partials[i] for i in (1, 2, 4)})
    assert impl.verify_batch(lanes) == [True] * 16
    lanes[6] = (lanes[6][0], lanes[6][1], lanes[0][2])
    assert impl.verify_batch(lanes) == [i != 6 for i in range(16)]
    got = impl.threshold_aggregate_batch(batch)
    want = [
        g1g2.g2_to_bytes(shamir.threshold_aggregate_g2({i: sig_to_point(s) for i, s in p.items()}))
        for p in batch
    ]
    assert got == want
    used = {k for k, n in MK.LAUNCHES.items() if n}
    assert used == {k for k in KERNELS if ("_mxu" in k) == mxu_mont}
