"""PyTorch port on the card: each hand-written CUDA kernel (K1 Fp, K1 Fr,
K2, K3) against its plain PyTorch version on the same CUDA tensors, and
TorchImpl's verify/aggregate on the card against the host oracle.

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
from charon_tpu_torch.tbls.python_impl import PythonHost, sig_to_point

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("kernel", ["mont_mul_fp", "mont_mul_fr", "fp2_mul", "fp2_sqr"])
def test_kernel_matches_plain_version(card, kernel):
    ctx = L.FR if kernel == "mont_mul_fr" else L.FP
    ops = [_operand(ctx, 4099, seed, card).roll(seed, 0) for seed in range(4)]
    before = MK.LAUNCHES[kernel]
    if kernel.startswith("mont_mul"):
        got, want = [MK.mont_mul(ctx, ops[0], ops[1])], [MK.mont_mul_plain(ctx, ops[0], ops[1])]
    elif kernel == "fp2_mul":
        got = MK.fp2_mul(ctx, (ops[0], ops[1]), (ops[2], ops[3]))
        want = MK.fp2_mul_plain(ctx, *ops)
    else:
        got, want = MK.fp2_sqr(ctx, (ops[0], ops[1])), MK.fp2_sqr_plain(ctx, ops[0], ops[1])
    torch.cuda.synchronize()
    assert MK.LAUNCHES[kernel] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_torch_impl_on_card_matches_host_oracle(card):
    """16 partials of 4 validators (2 messages) through grouped RLC, one
    forged lane through the per-lane re-check, and recombination equal to
    the host's Lagrange interpolation."""
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

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
