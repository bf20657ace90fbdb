"""User-facing batched BLS operations: verify, threshold-aggregate, aggregate.

The port of the main-path subset of charon_tpu/ops/blsops.py. The engine
takes whole [num_validators, threshold] / [num_sigs] batches and runs them
on one device as batched tensor programs; the field multiplies inside go to
the hand-written kernels K1-K3 on a CUDA device.

Shape discipline: public entry points pad the batch axis to the next power
of two (minimum 4), the JAX package's bucket ladder, so both engines see the
same padded shapes.

Identity encoding: affine (0, 0) lanes are group identities throughout
(safe on these curves since b != 0 means y = 0 never occurs).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.ops.curve import map_point
from charon_tpu_torch.ops.limb import ModCtx


def next_pow2(n: int) -> int:
    """Padded batch size: next power of two, minimum 4."""
    return max(4, 1 << max(0, (n - 1)).bit_length())


def bucket_lanes(n: int, multiple: int = 1) -> int:
    """The shape-bucket ladder every batched entry point pads to:
    `multiple * pow2(ceil(n / multiple))` (plain next_pow2 with its 4-lane
    floor for multiple == 1; a per-shard floor of 1 for sharded planes)."""
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    if multiple == 1:
        return next_pow2(n)
    per_shard = -(-n // multiple)
    return multiple * (1 << max(0, (per_shard - 1)).bit_length())


# ---------------------------------------------------------------------------
# Device Lagrange coefficients at zero (Fr)
# ---------------------------------------------------------------------------


def _indices_to_fr(fr_ctx: ModCtx, idx):
    """Integer share indices (...,) -> raw Fr limb tensors (..., n_limbs)
    (indices up to 2^(2 * limb_bits), far beyond any cluster size)."""
    out = torch.zeros((*idx.shape, fr_ctx.n_limbs), dtype=limb.DTYPE, device=idx.device)
    out[..., 0] = idx & fr_ctx.mask
    out[..., 1] = idx >> fr_ctx.limb_bits
    return out


def lagrange_coeffs_at_zero(fr_ctx: ModCtx, idx, t: int):
    """Batched Lagrange basis at x=0: idx is (..., t) of distinct nonzero
    share indices; returns raw Fr limbs (..., t, n_limbs).

        coeff_j = prod_{m != j} x_m / (x_m - x_j)   (mod r)

    (spec: crypto/shamir.py lagrange_coeffs_at_zero). The inversions are
    one vectorized Fermat chain."""
    x_mont = limb.to_mont(fr_ctx, _indices_to_fr(fr_ctx, idx))  # (..., t, L)
    xs = [x_mont[..., j, :] for j in range(t)]
    nums, dens = [], []
    for j in range(t):
        num = den = None
        for m in range(t):
            if m == j:
                continue
            num = xs[m] if num is None else limb.mont_mul(fr_ctx, num, xs[m])
            d = limb.sub_mod(fr_ctx, xs[m], xs[j])
            den = d if den is None else limb.mont_mul(fr_ctx, den, d)
        if num is None:  # t == 1
            num = den = limb.const(fr_ctx, 1, xs[j].shape[:-1], idx.device)
        nums.append(num)
        dens.append(den)
    num = torch.stack(torch.broadcast_tensors(*nums), dim=-2)  # (..., t, L)
    den = torch.stack(torch.broadcast_tensors(*dens), dim=-2)
    coeff = limb.mont_mul(fr_ctx, num, limb.inv_mod(fr_ctx, den))
    return limb.from_mont(fr_ctx, coeff)  # raw, for the bit schedule


def threshold_recombine(ctx: ModCtx, fr_ctx: ModCtx, t: int, sig_affine, idx):
    """(V, t) affine G2 share sigs + (V, t) share indices -> [V] affine
    group signatures: Straus joint windowed mul (ops/msm.py) when MSM is on,
    else per-lane 255-bit double-and-add and a fold over t."""
    f = C.g2_ops(ctx)
    coeffs = lagrange_coeffs_at_zero(fr_ctx, idx, t)  # (V, t, L)
    proj = C.affine_to_point(f, sig_affine)
    if MSM.msm_active():
        total = MSM.windowed_joint_mul(f, fr_ctx, proj, coeffs)
    else:
        total = C.point_sum(f, C.point_scalar_mul(f, fr_ctx, proj, coeffs), axis=-1)
    return C.point_to_affine(f, total)


def _grid(point, rows: int, cols: int):
    return map_point(lambda a: a.reshape(rows, cols, *a.shape[1:]), point)


def _resolve_device(device) -> torch.device:
    """None means the card; a CPU engine must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class BlsEngine:
    """Batched BLS12-381 engine on one device.

    Host boundary: affine Python-int points in/out (the tbls backend handles
    compressed bytes and caching). Every method pads its batch to a power
    of two, and runs in inference mode: no autograd bookkeeping on the
    thousands of small tensor ops a pairing takes.
    """

    def __init__(self, device=None):
        self.device = _resolve_device(device)
        self.ctx = limb.FP
        self.fr_ctx = limb.FR

    def _g1(self, points):
        return C.g1_pack(self.ctx, points, self.device)

    def _g2(self, points):
        return C.g2_pack(self.ctx, points, self.device)

    def _fr(self, values):
        return limb.to_device(limb.ctx_pack(self.fr_ctx, values), self.device)

    # -- verification -----------------------------------------------------

    @torch.inference_mode()
    def verify_batch(self, pks, msg_points, sigs) -> list[bool]:
        """Lane-wise: e(pk_i, H(m)_i) == e(G1, sig_i). pks: affine G1 (or
        None); msg_points: affine G2 hashed messages; sigs: affine G2 (or
        None)."""
        n = len(pks)
        pad = next_pow2(n)
        ok = DP.batched_verify(
            self.ctx,
            self._g1(list(pks) + [None] * (pad - n)),
            self._g2(list(msg_points) + [None] * (pad - n)),
            self._g2(list(sigs) + [None] * (pad - n)),
        )
        return ok.cpu().tolist()[:n]

    @torch.inference_mode()
    def verify_batch_rlc(self, pks, msg_points, sigs, rng=None) -> bool:
        """Whole-batch verification by random linear combination (one shared
        final exponentiation, 2^-64 soundness with fresh randomness). None
        lanes contribute neutrally. On False the caller re-runs
        verify_batch for per-lane attribution."""
        rng = rng or random.SystemRandom()
        n = len(pks)
        pad = next_pow2(n)
        rand = self._fr([rng.randrange(1, 1 << 64) for _ in range(n)] + [0] * (pad - n))
        ok = DP.batched_verify_rlc(
            self.ctx,
            self.fr_ctx,
            self._g1(list(pks) + [None] * (pad - n)),
            self._g2(list(msg_points) + [None] * (pad - n)),
            self._g2(list(sigs) + [None] * (pad - n)),
            rand,
        )
        return bool(ok)

    @torch.inference_mode()
    def verify_batch_grouped_rlc(self, groups, rng=None) -> bool:
        """Grouped whole-batch verification: `groups` is a list of
        (msg_point, [(pk_point, sig_point), ...]), one entry per DISTINCT
        message. Grid dims are padded to powers of two (pad lanes: identity
        points + zero exponents, which contribute neutrally)."""
        rng = rng or random.SystemRandom()
        m = next_pow2(len(groups))
        k = next_pow2(max(len(lanes) for _, lanes in groups))
        pk_flat, sig_flat, rand_ints, msg_list = [], [], [], []
        for msg_pt, lanes in groups:
            msg_list.append(msg_pt)
            for pk_pt, sig_pt in lanes:
                pk_flat.append(pk_pt)
                sig_flat.append(sig_pt)
                rand_ints.append(rng.randrange(1, 1 << 64))
            pad = k - len(lanes)
            pk_flat.extend([None] * pad)
            sig_flat.extend([None] * pad)
            rand_ints.extend([0] * pad)
        for _ in range(m - len(groups)):  # identity pad groups
            msg_list.append(None)
            pk_flat.extend([None] * k)
            sig_flat.extend([None] * k)
            rand_ints.extend([0] * k)
        ok = DP.batched_verify_grouped_rlc(
            self.ctx,
            self.fr_ctx,
            _grid(self._g1(pk_flat), m, k),
            self._g2(msg_list),
            _grid(self._g2(sig_flat), m, k),
            self._fr(rand_ints).reshape(m, k, -1),
        )
        return bool(ok)

    # -- threshold recombination -----------------------------------------

    @torch.inference_mode()
    def threshold_aggregate_batch(self, partials: list[dict]) -> list:
        """Each entry maps share index -> affine G2 partial signature; all
        entries share the threshold t = len(dict). Returns the recombined
        affine G2 group signature per entry (spec: crypto/shamir.py
        threshold_aggregate_g2)."""
        if not partials:
            return []
        t = len(partials[0])
        if any(len(p) != t for p in partials):
            raise ValueError("all entries must have the same threshold")
        v = len(partials)
        pad = next_pow2(v)
        idx = np.tile(np.arange(1, t + 1, dtype=np.int64), (pad, 1))  # benign pad rows
        flat_sigs = []
        for row, p in enumerate(partials):
            items = sorted(p.items())
            idx[row] = [i for i, _ in items]
            flat_sigs.extend(s for _, s in items)
        flat_sigs.extend([None] * ((pad - v) * t))
        out = threshold_recombine(
            self.ctx,
            self.fr_ctx,
            t,
            _grid(self._g2(flat_sigs), pad, t),
            torch.as_tensor(idx, device=self.device),
        )
        return C.g2_unpack(self.ctx, out)[:v]

    # -- plain aggregation (point addition) ------------------------------

    def _sum_groups(self, groups, f, pack, unpack):
        k = max(len(g) for g in groups)
        v = len(groups)
        pad = next_pow2(v)
        flat = []
        for g in groups:
            flat.extend(g)
            flat.extend([None] * (k - len(g)))
        flat.extend([None] * ((pad - v) * k))
        proj = C.affine_to_point(f, _grid(pack(flat), pad, k))
        return unpack(self.ctx, C.point_to_affine(f, C.point_sum(f, proj, axis=-1)))[:v]

    @torch.inference_mode()
    def aggregate_sigs_batch(self, groups: list[list]) -> list:
        """Sum each group of affine G2 signatures (ref: tbls/herumi.go:225
        Aggregate). Groups are padded to a common length with identities."""
        if not groups:
            return []
        return self._sum_groups(groups, C.g2_ops(self.ctx), self._g2, C.g2_unpack)

    @torch.inference_mode()
    def aggregate_pks_batch(self, groups: list[list]) -> list:
        """Sum each group of affine G1 pubkeys (FastAggregateVerify input)."""
        if not groups:
            return []
        return self._sum_groups(groups, C.g1_ops(self.ctx), self._g1, C.g1_unpack)

    # -- subgroup membership ---------------------------------------------

    def _subgroup_check(self, points, f, pack) -> list[bool]:
        n = len(points)
        if n == 0:
            return []
        pad = next_pow2(n)
        proj = C.affine_to_point(f, pack(list(points) + [None] * (pad - n)))
        # raw (unreduced!) group order as the ladder schedule
        order = self._fr([self.fr_ctx.modulus] * pad)
        rp = C.point_scalar_mul(f, self.fr_ctx, proj, order)
        return C.point_is_identity(f, rp).cpu().tolist()[:n]

    @torch.inference_mode()
    def subgroup_check_g2_batch(self, points) -> list[bool]:
        """[r]P == identity for decompressed (on-curve) G2 points — the
        prime-order subgroup check eth2 mandates before pairing. None lanes
        (identities) pass."""
        return self._subgroup_check(points, C.g2_ops(self.ctx), self._g2)

    @torch.inference_mode()
    def subgroup_check_g1_batch(self, points) -> list[bool]:
        return self._subgroup_check(points, C.g1_ops(self.ctx), self._g1)
