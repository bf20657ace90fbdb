"""User-facing batched BLS operations: verify, threshold-aggregate, aggregate,
point decode, hash-to-curve, and the DKG and resharing ceremony calls.

The port of charon_tpu/ops/blsops.py. The engine
takes whole [num_validators, threshold] / [num_sigs] batches and runs them
on one device as batched tensor programs; the field multiplies inside go to
the hand-written kernels K1-K6 on a CUDA device.

Shape discipline: public entry points pad the batch axis to the next power
of two (minimum 4), the JAX package's bucket ladder, so both engines see the
same padded shapes.

Identity encoding: affine (0, 0) lanes are group identities throughout
(safe on these curves since b != 0 means y = 0 never occurs).

Program families: every device program the engine runs is registered by
name (`kernel_families()`, with the slot plane's `mesh/*` programs once
`parallel.mesh.register_analysis_families()` ran), each with a function
that packs canonical inputs on the bucket ladder into a launchable spec.
"""

from __future__ import annotations

import dataclasses
import functools
import random
from typing import Callable

import numpy as np
import torch

from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import decompress as DEC
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.ops import sswu as SSWU
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


def lagrange_coeffs_at(fr_ctx: ModCtx, idx, t: int, xs):
    """Batched Lagrange basis at arbitrary evaluation points, the
    resharing generalization of lagrange_coeffs_at_zero:

        coeff_j(x) = prod_{m != j} (x - x_m) / (x_j - x_m)   (mod r)

    idx is (..., t) of distinct share indices, xs (...,) the evaluation
    points, one a batch lane. Returns raw Fr limbs (..., t, n_limbs)."""
    x_mont = limb.to_mont(fr_ctx, _indices_to_fr(fr_ctx, idx))  # (..., t, L)
    e_mont = limb.to_mont(fr_ctx, _indices_to_fr(fr_ctx, xs))  # (..., L)
    pts = [x_mont[..., j, :] for j in range(t)]
    nums, dens = [], []
    for j in range(t):
        num = den = None
        for m in range(t):
            if m == j:
                continue
            nm = limb.sub_mod(fr_ctx, e_mont, pts[m])
            num = nm if num is None else limb.mont_mul(fr_ctx, num, nm)
            d = limb.sub_mod(fr_ctx, pts[j], pts[m])
            den = d if den is None else limb.mont_mul(fr_ctx, den, d)
        if num is None:  # t == 1
            num = den = limb.const(fr_ctx, 1, pts[j].shape[:-1], idx.device)
        nums.append(num)
        dens.append(den)
    num = torch.stack(torch.broadcast_tensors(*nums), dim=-2)  # (..., t, L)
    den = torch.stack(torch.broadcast_tensors(*dens), dim=-2)
    coeff = limb.mont_mul(fr_ctx, num, limb.inv_mod(fr_ctx, den))
    return limb.from_mont(fr_ctx, coeff)


def _mont_powers(fr_ctx: ModCtx, xs, t: int):
    """Integer evaluation points (...,) -> Montgomery-form powers
    x^0..x^(t-1), shape (..., t, n_limbs): t - 1 products."""
    x = limb.to_mont(fr_ctx, _indices_to_fr(fr_ctx, xs))
    pows = [limb.const(fr_ctx, 1, x.shape[:-1], xs.device)]
    for _ in range(1, t):
        pows.append(limb.mont_mul(fr_ctx, pows[-1], x))
    return torch.stack(torch.broadcast_tensors(*pows), dim=-2)


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


def sum_affine(f, affine, axis: int = -1):
    """Affine points summed over `axis` (a fold of complete adds), affine
    out: the aggregate family."""
    return C.point_to_affine(f, C.point_sum(f, C.affine_to_point(f, affine), axis=axis))


def subgroup_mask(f, fr_ctx: ModCtx, affine, order):
    """[r]P == identity lane by lane, `order` the raw (unreduced) group
    order as the ladder schedule: the subgroup_g1/g2 families."""
    return C.point_is_identity(f, C.point_scalar_mul(f, fr_ctx, C.affine_to_point(f, affine), order))


# ---------------------------------------------------------------------------
# Ceremony programs: DKG verification and key resharing
# ---------------------------------------------------------------------------


def scalar_mul_affine(f, fr_ctx: ModCtx, base_affine, scalars):
    """[k_i] P_i lane by lane over a 255-bit double-and-add ladder, affine
    in and out: the g1_scalar_mul and g2_scalar_mul families."""
    return C.point_to_affine(f, C.point_scalar_mul(f, fr_ctx, C.affine_to_point(f, base_affine), scalars))


@functools.lru_cache(maxsize=None)
def _gen_table_g1(ctx: ModCtx, nbits: int, window: int, device: torch.device):
    """Fixed-base window table of the G1 generator, affine limb tensors of
    shape (n_win, 2^window, n_limbs): T[win][d] = d * 2^(window * win) * G,
    built once on the host (public constants) and cached per device."""
    from charon_tpu_torch.crypto.g1g2 import G1_GEN, g1_add

    n_win = -(-nbits // window)
    flat = []
    base = G1_GEN
    for _ in range(n_win):
        entry = None
        for _d in range(1 << window):
            flat.append(entry)
            entry = g1_add(entry, base)
        for _ in range(window):
            base = g1_add(base, base)
    return limb.settled(map_point(lambda a: a.reshape(n_win, 1 << window, -1), C.g1_pack(ctx, flat, device)))


def g1_gen_mul(ctx: ModCtx, fr_ctx: ModCtx, scalars, nbits: int = 255, window: int = 4):
    """[k_i] G for raw Fr scalars (N, n_limbs) through the fixed-base table:
    one gathered complete add a window, no doublings. Affine out."""
    f = C.g1_ops(ctx)
    table = _gen_table_g1(ctx, nbits, window, scalars.device)
    digits = MSM._digits(fr_ctx, scalars, nbits, window)  # (N, n_win)
    acc = None
    for w in range(digits.shape[-1]):
        sel = C.affine_to_point(f, map_point(lambda a, w=w: a[w][digits[:, w]], table))
        acc = sel if acc is None else C.point_add(f, acc, sel)
    return C.point_to_affine(f, acc)


def commitment_eval(ctx: ModCtx, fr_ctx: ModCtx, vecs: int, t: int, nbits: int, commit_affine, xs):
    """Per lane: sum over `vecs` commitment vectors of sum_k C_k x^k, the
    Feldman/FROST commitment-polynomial evaluation. commit_affine: affine
    (N, vecs * t); xs: integer evaluation points (N,). The powers x^k are
    built on the device; `msm.ceremony_straus_active()` picks Straus joint
    windowed mul (one shared doubling chain a lane) or per-lane
    double-and-add and a fold, over an nbits-bit schedule."""
    f = C.g1_ops(ctx)
    pows = limb.from_mont(fr_ctx, _mont_powers(fr_ctx, xs, t)).repeat(1, vecs, 1)  # (N, vecs * t, L)
    proj = C.affine_to_point(f, commit_affine)
    if MSM.ceremony_straus_active():
        total = MSM.windowed_joint_mul(f, fr_ctx, proj, pows, nbits=nbits, window=4)
    else:
        total = C.point_sum(f, C.point_scalar_mul(f, fr_ctx, proj, pows, nbits=nbits), axis=-1)
    return C.point_to_affine(f, total)


def g1_msm(ctx: ModCtx, fr_ctx: ModCtx, n_segments: int, nbits: int, points_affine, scalars, segment_ids):
    """Segmented G1 Pippenger MSM over full-width raw Fr scalars, the
    reshare pubshare recombination; the window is the tuned ceremony axis
    (`msm.ceremony_window()`). Affine (n_segments,) out."""
    f = C.g1_ops(ctx)
    proj = C.affine_to_point(f, points_affine)
    out = MSM.msm_segmented(
        f, fr_ctx, proj, scalars, segment_ids, n_segments, nbits=nbits, window=MSM.ceremony_window()
    )
    return C.point_to_affine(f, out)


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
        return unpack(self.ctx, sum_affine(f, _grid(pack(flat), pad, k)))[:v]

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
        order = self._fr([self.fr_ctx.modulus] * pad)
        return subgroup_mask(f, self.fr_ctx, pack(list(points) + [None] * (pad - n)), order).cpu().tolist()[:n]

    @torch.inference_mode()
    def subgroup_check_g2_batch(self, points) -> list[bool]:
        """[r]P == identity for decompressed (on-curve) G2 points — the
        prime-order subgroup check eth2 mandates before pairing. None lanes
        (identities) pass."""
        return self._subgroup_check(points, C.g2_ops(self.ctx), self._g2)

    @torch.inference_mode()
    def subgroup_check_g1_batch(self, points) -> list[bool]:
        return self._subgroup_check(points, C.g1_ops(self.ctx), self._g1)

    # -- batched point decompression -------------------------------------

    def _padded(self, lanes):
        """Pad to the lane bucket with copies of lane 0 (valid work, so the
        pad lanes take the same path as the live ones)."""
        return lanes + [lanes[0]] * (bucket_lanes(len(lanes)) - len(lanes))

    @torch.inference_mode()
    def decompress_g2_batch(self, encoded, subgroup_check: bool = True):
        """Compressed 96-byte G2 lanes (raw bytes or decompress.ParsedPoint)
        -> ([affine point | None], [valid]): the field work (sqrt, sign,
        on-curve, psi subgroup check) batched on the device. Per lane,
        never raises: valid with point None is a well-formed infinity;
        invalid covers malformed flags, x >= p, non-residue x and (with
        `subgroup_check`) points off the subgroup."""
        parsed = [p if isinstance(p, DEC.ParsedPoint) else DEC.parse_g2_lane(p) for p in encoded]
        n = len(parsed)
        if n == 0:
            return [], []
        x0, x1, sign, inf, ok = DEC.pack_parsed_g2(self.ctx, self._padded(parsed), self.device)
        aff, valid = DEC.decompress_g2_graph(self.ctx, (x0, x1), sign, inf, ok, subgroup=subgroup_check)
        return C.g2_unpack(self.ctx, aff)[:n], valid.cpu().tolist()[:n]

    @torch.inference_mode()
    def decompress_g1_batch(self, encoded, subgroup_check: bool = True):
        """Compressed 48-byte G1 lanes -> ([affine point | None], [valid])
        with the GLV subgroup check; the mask contract of
        decompress_g2_batch."""
        parsed = [p if isinstance(p, DEC.ParsedPoint) else DEC.parse_g1_lane(p) for p in encoded]
        n = len(parsed)
        if n == 0:
            return [], []
        x0, sign, inf, ok = DEC.pack_parsed_g1(self.ctx, self._padded(parsed), self.device)
        aff, valid = DEC.decompress_g1_graph(self.ctx, x0, sign, inf, ok, subgroup=subgroup_check)
        return C.g1_unpack(self.ctx, aff)[:n], valid.cpu().tolist()[:n]

    # -- batched hash-to-curve -------------------------------------------

    @torch.inference_mode()
    def hash_to_g2_batch(self, msgs, dst: bytes = SSWU.DST_POP):
        """Messages (raw bytes, or sswu.HashedMsg lanes hashed on the host
        under any DST) -> ([affine G2 point], [valid]): SSWU, isogeny and
        psi cofactor clearing batched on the device; the host pays only
        expand_message_xmd/hash_to_field. valid is True for every real
        lane and is carried so a bad lane masks instead of raising."""
        lanes = [m if isinstance(m, SSWU.HashedMsg) else SSWU.hash_to_field_lane(m, dst) for m in msgs]
        n = len(lanes)
        if n == 0:
            return [], []
        u00, u01, u10, u11, s0, s1 = SSWU.pack_hashed(self.ctx, self._padded(lanes), self.device)
        aff, valid = SSWU.hash_to_g2_graph(self.ctx, (u00, u01), (u10, u11), s0, s1)
        return C.g2_unpack(self.ctx, aff)[:n], valid.cpu().tolist()[:n]

    # -- scalar multiplication (DKG / key derivation) --------------------

    def _scalars(self, values):
        return C.fr_pack(self.fr_ctx, values, self.device)

    def _first(self, unpack, affine, n: int) -> list:
        """The first n lanes of a padded affine result, as host points."""
        return unpack(self.ctx, map_point(lambda a: a[:n], affine))

    def _ints(self, values):
        return torch.as_tensor(list(values), dtype=torch.int64, device=self.device)

    @torch.inference_mode()
    def g1_scalar_mul_batch(self, bases, scalars: list[int]) -> list:
        """[k_i] P_i over G1: the DKG proof-of-knowledge check's A0 side."""
        n = len(bases)
        pad = next_pow2(n)
        out = scalar_mul_affine(
            C.g1_ops(self.ctx),
            self.fr_ctx,
            self._g1(list(bases) + [None] * (pad - n)),
            self._scalars(list(scalars) + [0] * (pad - n)),
        )
        return self._first(C.g1_unpack, out, n)

    @torch.inference_mode()
    def g2_scalar_mul_batch(self, bases, scalars: list[int]) -> list:
        """[k_i] P_i over G2."""
        n = len(bases)
        pad = next_pow2(n)
        out = scalar_mul_affine(
            C.g2_ops(self.ctx),
            self.fr_ctx,
            self._g2(list(bases) + [None] * (pad - n)),
            self._scalars(list(scalars) + [0] * (pad - n)),
        )
        return self._first(C.g2_unpack, out, n)

    # -- ceremony calls (DKG verification and resharing) ------------------

    # Lanes of one commitment_eval program. A larger call runs in chunks of
    # this many lanes, each padded to its bucket as a whole call would be:
    # the Straus tables grow with lanes x width (16 projective multiples of
    # every commitment), and a 4-of-7 pubshare wave of 10,000 validators
    # (131,072 padded lanes x 28 commitments) would not fit the card's memory.
    EVAL_CHUNK_LANES = 32768

    @staticmethod
    def _eval_nbits(t: int, xs) -> int:
        """Bit schedule of the x^k powers: the raw values are bounded by
        max(x)^(t-1), so share indices need far fewer than 255 bits;
        bucketed to a short ladder."""
        mx = max((int(x) for x in xs), default=1)
        need = max(1, t - 1) * max(1, mx.bit_length()) + 1
        for cand in (32, 64, 128):
            if need <= cand:
                return cand
        return 255

    @torch.inference_mode()
    def g1_gen_mul_batch(self, scalars: list[int]) -> list:
        """[k_i] G over G1 through the fixed-base window table: the DKG
        share and proof-of-knowledge checks' left side. The scalars are
        secrets the caller owns: they ride the device as packed limbs, and
        what comes back is public curve points."""
        n = len(scalars)
        if n == 0:
            return []
        pad = bucket_lanes(n)
        out = g1_gen_mul(self.ctx, self.fr_ctx, self._scalars(list(scalars) + [0] * (pad - n)))
        return self._first(C.g1_unpack, out, n)

    @torch.inference_mode()
    def commitment_eval_batch(self, commit_rows, xs: list[int], t: int) -> list:
        """Evaluate commitment polynomials at public points, one lane a
        row: row i is a flat sequence of vecs * t affine G1 commitments
        (vecs concatenated degree-(t-1) vectors); the result is
        sum_vec sum_k C_k * xs[i]^k. Runs in chunks of EVAL_CHUNK_LANES."""
        n = len(commit_rows)
        if n == 0:
            return []
        width = len(commit_rows[0])
        if width % t or any(len(r) != width for r in commit_rows):
            raise ValueError("commitment rows must share one vecs*t width")
        vecs = width // t
        nbits = self._eval_nbits(t, xs)
        xs = list(xs)
        out: list = []
        for lo in range(0, n, self.EVAL_CHUNK_LANES):
            rows = commit_rows[lo : lo + self.EVAL_CHUNK_LANES]
            k = len(rows)
            pad = bucket_lanes(k)
            flat = [pt for row in rows for pt in row] + [None] * ((pad - k) * width)
            res = commitment_eval(
                self.ctx,
                self.fr_ctx,
                vecs,
                t,
                nbits,
                _grid(self._g1(flat), pad, width),
                self._ints(xs[lo : lo + k] + [0] * (pad - k)),
            )
            out.extend(self._first(C.g1_unpack, res, k))
        return out

    @torch.inference_mode()
    def g1_msm_batch(self, points, scalars: list[int], segment_ids: list[int], n_segments: int) -> list:
        """Segmented multi-scalar multiplication over G1 with full-width
        scalars: out[s] = sum_{i: seg[i] == s} scalars[i] * points[i], the
        reshare pubshare recombination (Pippenger)."""
        if n_segments <= 0:
            return []
        n = len(points)
        pad = bucket_lanes(max(n, 1))
        out = g1_msm(
            self.ctx,
            self.fr_ctx,
            next_pow2(n_segments),
            255,
            self._g1(list(points) + [None] * (pad - n)),
            self._scalars(list(scalars) + [0] * (pad - n)),
            self._ints(list(segment_ids) + [0] * (pad - n)),
        )
        return self._first(C.g1_unpack, out, n_segments)

    @torch.inference_mode()
    def lagrange_coeffs_batch(self, idx_rows, xs: list[int]) -> list[list[int]]:
        """Lagrange basis rows at arbitrary evaluation points: row i lists
        distinct share indices, xs[i] is its evaluation point; returns the
        coefficient rows as ints (public: functions of public indices)."""
        n = len(idx_rows)
        if n == 0:
            return []
        t = len(idx_rows[0])
        if any(len(r) != t for r in idx_rows):
            raise ValueError("index rows must share one width")
        pad = bucket_lanes(n)
        benign = list(range(1, t + 1))
        idx = self._ints([list(r) for r in idx_rows] + [benign] * (pad - n))
        out = lagrange_coeffs_at(self.fr_ctx, idx, t, self._ints(list(xs) + [0] * (pad - n)))
        flat = limb.ctx_unpack(self.fr_ctx, out.reshape(pad * t, -1))
        return [flat[i * t : (i + 1) * t] for i in range(n)]


# ---------------------------------------------------------------------------
# Program-family registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceSpec:
    """One instantiation of a program family: the program (a plain function
    on tensors), canonical inputs on a bucket-ladder shape, the limb
    geometry, the padded lanes and the ladder multiple (the plane's shard
    count; 1 for the engine)."""

    fn: Callable
    args: tuple
    ctx: ModCtx
    lanes: int
    multiple: int = 1

    def launch(self):
        """Run the program once on its inputs, in inference mode."""
        with torch.inference_mode():
            return self.fn(*self.args)


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """A registered device-program family. `build(device=None)` returns its
    TraceSpec with inputs on `device` (None: the card). `sentinel` marks
    the families cheap enough to launch on every check."""

    name: str
    build: Callable[..., TraceSpec]
    sentinel: bool = False


_KERNEL_FAMILIES: dict[str, KernelFamily] = {}


def register_kernel_family(name: str, build: Callable[..., TraceSpec], sentinel: bool = False) -> None:
    if name in _KERNEL_FAMILIES:
        raise ValueError(f"kernel family {name!r} already registered")
    _KERNEL_FAMILIES[name] = KernelFamily(name, build, sentinel)


def kernel_families() -> dict[str, KernelFamily]:
    """Snapshot of the registry: the engine families at import, the slot
    plane's after parallel.mesh.register_analysis_families()."""
    return dict(_KERNEL_FAMILIES)


def _register_engine_families() -> None:
    """The engine's programs, under the JAX package's names, on canonical
    generator-point inputs: 4 lanes (the ladder floor), t = 3; the ceremony
    families' evaluation points are 1..4."""
    from charon_tpu_torch.crypto.g1g2 import G1_GEN, G2_GEN, g1_to_bytes, g2_to_bytes

    n, t = 4, 3
    ctx, fr_ctx = limb.FP, limb.FR
    g1f, g2f = C.g1_ops(ctx), C.g2_ops(ctx)

    def spec(fn, args):
        return TraceSpec(fn, args, ctx, n)

    def g1(dev, k=n):
        return C.g1_pack(ctx, [G1_GEN] * k, dev)

    def g2(dev, k=n):
        return C.g2_pack(ctx, [G2_GEN] * k, dev)

    def fr(dev, values):
        return limb.to_device(limb.ctx_pack(fr_ctx, values), dev)

    def grid(pt, cols):
        return map_point(lambda a: torch.stack([a] * cols, 1), pt)

    def order(dev):
        return fr(dev, [fr_ctx.modulus] * n)

    def idx(dev):
        return torch.arange(1, t + 1, device=dev).repeat(n, 1)

    def dec_g2(x0, x1, sign, inf, ok):
        return DEC.decompress_g2_graph(ctx, (x0, x1), sign, inf, ok)

    def dec_g1(x0, sign, inf, ok):
        return DEC.decompress_g1_graph(ctx, x0, sign, inf, ok)

    def h2c(u00, u01, u10, u11, s0, s1):
        return SSWU.hash_to_g2_graph(ctx, (u00, u01), (u10, u11), s0, s1)

    def ones(dev):
        return fr(dev, [1] * n)

    def xs(dev):
        return torch.arange(1, n + 1, device=dev)

    def lag_at(idx, xs):
        return lagrange_coeffs_at(fr_ctx, idx, t, xs)

    families = {
        "verify": (lambda d: spec(functools.partial(DP.batched_verify, ctx), (g1(d), g2(d), g2(d))), False),
        "verify_rlc": (
            lambda d: spec(
                functools.partial(DP.batched_verify_rlc, ctx, fr_ctx), (g1(d), g2(d), g2(d), fr(d, [1] * n))
            ),
            False,
        ),
        "verify_grouped_rlc": (
            lambda d: spec(
                functools.partial(DP.batched_verify_grouped_rlc, ctx, fr_ctx),
                (grid(g1(d), n), g2(d), grid(g2(d), n), fr(d, [1] * (n * n)).reshape(n, n, -1)),
            ),
            False,
        ),
        "threshold_agg": (
            lambda d: spec(functools.partial(threshold_recombine, ctx, fr_ctx, t), (grid(g2(d), t), idx(d))),
            False,
        ),
        "hash_to_g2": (
            lambda d: spec(h2c, SSWU.pack_hashed(ctx, [SSWU.hash_to_field_lane(b"family-check")] * n, d)),
            False,
        ),
        "aggregate": (lambda d: spec(functools.partial(sum_affine, g2f), (grid(g2(d), t),)), True),
        "g1_sum": (lambda d: spec(functools.partial(sum_affine, g1f), (grid(g1(d), t),)), True),
        "subgroup_g2": (lambda d: spec(functools.partial(subgroup_mask, g2f, fr_ctx), (g2(d), order(d))), True),
        "subgroup_g1": (lambda d: spec(functools.partial(subgroup_mask, g1f, fr_ctx), (g1(d), order(d))), True),
        "decompress_g2": (
            lambda d: spec(dec_g2, DEC.pack_parsed_g2(ctx, [DEC.parse_g2_lane(g2_to_bytes(G2_GEN))] * n, d)),
            True,
        ),
        "decompress_g1": (
            lambda d: spec(dec_g1, DEC.pack_parsed_g1(ctx, [DEC.parse_g1_lane(g1_to_bytes(G1_GEN))] * n, d)),
            True,
        ),
        # the ceremony families: fixed-base table adds, the commitment
        # evaluation, the reshare Pippenger MSM (curve-heavy), and the
        # ladders and Lagrange rows (cheap)
        "g1_gen_mul": (lambda d: spec(functools.partial(g1_gen_mul, ctx, fr_ctx), (ones(d),)), False),
        "commitment_eval": (
            lambda d: spec(functools.partial(commitment_eval, ctx, fr_ctx, 1, t, 32), (grid(g1(d), t), xs(d))),
            False,
        ),
        "g1_msm": (
            lambda d: spec(
                functools.partial(g1_msm, ctx, fr_ctx, 1, 255),
                (g1(d), ones(d), torch.zeros(n, dtype=torch.int64, device=d)),
            ),
            False,
        ),
        "g1_scalar_mul": (lambda d: spec(functools.partial(scalar_mul_affine, g1f, fr_ctx), (g1(d), ones(d))), True),
        "g2_scalar_mul": (lambda d: spec(functools.partial(scalar_mul_affine, g2f, fr_ctx), (g2(d), ones(d))), True),
        "lagrange_at": (lambda d: spec(lag_at, (idx(d), xs(d))), True),
    }
    for fname, (build, sentinel) in families.items():
        register_kernel_family(
            f"blsops/{fname}", lambda device=None, build=build: build(_resolve_device(device)), sentinel
        )


_register_engine_families()
