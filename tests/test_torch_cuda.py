"""PyTorch port on the card: each hand-written CUDA kernel (K1 Fp, K1 Fr,
K2, K3, and the int8 tensor-core K4 Fp, K4 Fr, K5, K6) against its plain
PyTorch version on the same CUDA tensors, K4-K6 against K1-K3, every
kernel at the edges of its tiles and waves and on operands off 16-byte
words (K4-K6 against K1-K3 at both kernels' edges), and TorchImpl's
verify/aggregate, the slot plane and the DKG waves on the card against
the host oracle or the CPU engine, under both kernel configurations, and
an attester duty of the in-process cluster through the tenant service on
the card against the same duty on the CPU plane.

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
from charon_tpu_torch.tbls.python_impl import PythonImpl, sig_to_point

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _default_route():
    yield
    L.set_mxu(None)
    MSM.set_msm(None)
    MSM.set_ceremony_straus(None)
    MSM.set_ceremony_window(None)


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
    host, impl = PythonImpl(), TorchImpl()
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


def test_slot_plane_on_card_equals_the_cpu_plane(card):
    """All ten programs of the slot crypto plane on cuda:0 against the same
    plane on the CPU, for a 4-validator 3-of-4 workload with a forged
    partial: recombine and verify (RLC, then per-lane attribution), their
    decode-fused twins on parsed signatures, and the two warm-up programs.
    Points and verdicts equal, the same programs in the same order."""
    from charon_tpu_torch.crypto import bls, h2c
    from charon_tpu_torch.ops import decompress as DEC
    from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

    t, v = 3, 4
    ps, msgs, parts, gpks, idx = [], [], [], [], []
    for i in range(v):
        rng = random.Random(1000 + i)
        sk = bls.keygen(bytes([i + 1]) * 32)
        shares = shamir.split(sk, t + 1, t, rand=lambda: rng.randrange(1, shamir.R))
        signers = sorted(shares)[:t]
        ps.append([bls.sk_to_pk(shares[j]) for j in signers])
        parts.append([bls.sign(shares[j], b"plane-duty-%d" % i) for j in signers])
        msgs.append(h2c.hash_to_g2(b"plane-duty-%d" % i))
        gpks.append(bls.sk_to_pk(sk))
        idx.append(signers)
    parts[1][1] = bls.sign(bls.keygen(b"\x77" * 32), b"wrong message")
    lanes = ([ps[i][j] for i in range(v) for j in range(t)], [m for m in msgs for _ in range(t)], [s for r in parts for s in r])
    parsed = [[DEC.parse_g2_lane(g1g2.g2_to_bytes(s)) for s in r] for r in parts]

    def run(pl):
        fams = []
        pl.on_program = lambda fam, seconds, n: fams.append(fam)
        out = [
            pl.recombine_host(ps, msgs, parts, gpks, idx),
            pl.verify_host(*lanes),
            pl.recombine_packed_parsed(pl.pack_inputs_parsed(ps, msgs, parsed, gpks, idx), pl.make_rand(v), v),
            pl.verify_packed_parsed(
                pl.pack_verify_inputs_parsed(*lanes[:2], [p for r in parsed for p in r]), pl.make_lane_rand(v * t), v * t
            ),
            pl.hash_to_g2_host([b"plane-duty-0", b"plane-duty-3"]),
            pl.decompress_g1_host([g1g2.g1_to_bytes(g) for g in gpks]),
        ]
        return out, fams

    on_card, card_fams = run(SlotCryptoPlane(make_mesh(["cuda:0"]), t=t))
    on_cpu, cpu_fams = run(SlotCryptoPlane(make_mesh(["cpu"]), t=t))
    assert on_card == on_cpu and card_fams == cpu_fams and len(set(card_fams)) == 10
    assert on_card[0][1] == on_card[2][1] == [True, False, True, True]
    assert on_card[1] == on_card[3] == [k != 4 for k in range(v * t)]
    assert on_card[4] == ([msgs[0], msgs[3]], [True, True]) and on_card[5] == (gpks, [True] * v)


@pytest.mark.parametrize("mxu_mont", [False, True])
def test_dkg_waves_on_card_equal_the_cpu_engine(card, mxu_mont):
    """The three round-2 verification waves of a 4-of-7 FROST DKG over 4
    validators (proof of knowledge: the fixed-base table and the ladder;
    shares: the table and the Straus evaluation, both routes; pubshares at
    width 28), the G2 ladder, the Lagrange rows and the reshare MSM (both
    windows) on cuda:0 against the same calls of the CPU engine, under
    KernelConfig(mxu_mont=...); each configuration launches only its own
    kernels, and no Fp2 one."""
    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.crypto.fields import R
    from charon_tpu_torch.ops.blsops import BlsEngine

    rng = random.Random(2026)
    n, t, v, me = 7, 4, 4, 3
    lanes = n * v
    G = g1g2.G1_GEN
    commits = [[g1g2.g1_mul(G, rng.randrange(1, R)) for _ in range(t)] for _ in range(lanes)]
    scalars = [rng.randrange(R) for _ in range(lanes)]
    rows = [[c for i in range(n) for c in commits[i * v + val]] for val in range(v) for _ in range(n)]
    xs = [j for _ in range(v) for j in range(1, n + 1)]
    pts = [g1g2.g1_mul(G, rng.randrange(1, R)) for _ in range(12)]
    seg = [rng.randrange(6) for _ in pts]

    def waves(engine):
        out = [engine.g1_gen_mul_batch(scalars), engine.g1_scalar_mul_batch([c[0] for c in commits], scalars)]
        for straus in (True, False):
            KernelConfig(mxu_mont=mxu_mont, ceremony_straus=straus).apply()
            out.append(engine.commitment_eval_batch(commits, [me] * lanes, t))
        out.append(engine.commitment_eval_batch(rows, xs, t))
        out.append(engine.lagrange_coeffs_batch([[1, 3, 4, 7]] * 5, [0, 2, 5, 9, 11]))
        for w8 in (True, False):
            KernelConfig(mxu_mont=mxu_mont, ceremony_msm_w8=w8).apply()
            out.append(engine.g1_msm_batch(pts, scalars[: len(pts)], seg, 6))
        KernelConfig(mxu_mont=mxu_mont).apply()
        return out

    KernelConfig(mxu_mont=mxu_mont).apply()
    MK.reset_launches()
    on_card = waves(BlsEngine())
    used = {k for k, c in MK.LAUNCHES.items() if c}
    g2 = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, R)) for _ in range(3)]
    on_card.append(BlsEngine().g2_scalar_mul_batch(g2, scalars[:3]))
    on_cpu = waves(BlsEngine(device="cpu")) + [BlsEngine(device="cpu").g2_scalar_mul_batch(g2, scalars[:3])]
    assert on_card == on_cpu
    assert on_card[2] == on_card[3] and on_card[0][5] == g1g2.g1_mul(G, scalars[5])
    assert used == {k for k in ("mont_mul_fp", "mont_mul_fr", "mont_mul_mxu_fp", "mont_mul_mxu_fr") if ("_mxu" in k) == mxu_mont}


@pytest.mark.parametrize("window", [4, 8])
def test_msm_segmented_with_hundreds_of_segments_on_card(card, window):
    """The reshare pubshare shape at scale: 255-bit scalars over 300
    segments of a few points each, against the host oracle."""
    from charon_tpu_torch.crypto.fields import R
    from charon_tpu_torch.ops import curve as C

    rng = random.Random(window)
    n_seg, n = 300, 900
    base = [g1g2.g1_mul(g1g2.G1_GEN, rng.randrange(1, R)) for _ in range(7)]
    pts = [base[i % 7] for i in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    seg = [i % n_seg for i in range(n)]
    f = C.g1_ops(L.FP)
    with torch.inference_mode():
        out = MSM.msm_segmented(
            f, L.FR, C.affine_to_point(f, C.g1_pack(L.FP, pts, card)),
            L.to_device(L.ctx_pack(L.FR, ks), card), torch.tensor(seg, device=card), n_seg, nbits=255, window=window,
        )
        got = C.g1_unpack(L.FP, C.point_to_affine(f, out))
    want = [None] * n_seg
    for p, k, s in zip(pts, ks, seg):
        want[s] = g1g2.g1_add(want[s], g1g2.g1_mul(p, k))
    assert got == want


def test_attester_duty_through_the_service_on_card_equals_the_cpu_plane(card):
    """One attester duty of a 3-of-4, 1-validator cluster whose nodes are
    tenants of a CryptoPlaneService over the card's slot plane, against
    the same cluster (same seeded keys, same slot) on the CPU plane: every
    node of both broadcasts the same attestation bytes, and the registry's
    host backend (no batch calls) is never asked to verify or recombine."""
    import asyncio
    import time

    from charon_tpu_torch import tbls
    from charon_tpu_torch.core.cryptoplane import SlotCoalescer
    from charon_tpu_torch.core.cryptosvc import CryptoPlaneService
    from charon_tpu_torch.crypto import bls
    from charon_tpu_torch.eth2util import ssz
    from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh
    from charon_tpu_torch.tbls.python_impl import int_to_sk
    from charon_tpu_torch.tbls.torch_impl import TorchImpl
    from charon_tpu_torch.testutil.simnet import build_cluster

    class SeededHost(PythonImpl):
        def __init__(self, seed):
            self._rng = random.Random(seed)

        def generate_secret_key(self):
            return int_to_sk(bls.keygen(self._rng.randbytes(32)))

    slot_s = 120.0
    saved = tbls._current

    async def run():
        genesis = time.time() - slot_s / 3 + 1.0  # slot 0's attester duty is due now
        services, clusters = [], []
        for device in (card, torch.device("cpu")):
            impl = TorchImpl(device=device)
            coal = SlotCoalescer(SlotCryptoPlane(make_mesh([device]), t=3), window=0.5, impl=impl)
            svc = CryptoPlaneService(coal)
            tbls.set_implementation(SeededHost(seed=3))
            cluster = build_cluster(n=4, t=3, num_validators=1, slot_duration=slot_s, genesis_time=genesis,
                                    crypto_service=svc)
            await coal.warm_caches(pubkeys=[p for pubs in cluster.pubshares_by_idx.values() for p in pubs.values()])
            services.append((svc, coal))
            clusters.append(cluster)
        assert clusters[0].group_pubkeys == clusters[1].group_pubkeys
        tasks = [asyncio.create_task(node.scheduler.run()) for c in clusters for node in c.nodes]

        def atts(c):
            return [a for a in c.beacon.attestations if a.data.slot == 0]

        try:
            while not all(len(atts(c)) == 4 for c in clusters):
                await asyncio.sleep(0.1)
        finally:
            for c in clusters:
                for node in c.nodes:
                    node.scheduler.stop()
            await asyncio.gather(*tasks, return_exceptions=True)
            for svc, coal in services:
                svc.close()
                coal.close()
        card_bytes = {(ssz.serialize(a), a.signature) for a in atts(clusters[0])}
        assert len(card_bytes) == 1
        assert {(ssz.serialize(a), a.signature) for a in atts(clusters[1])} == card_bytes

    try:
        asyncio.run(asyncio.wait_for(run(), timeout=1200))
    finally:
        tbls._current = saved
