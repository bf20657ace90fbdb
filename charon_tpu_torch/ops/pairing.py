"""Batched optimal-ate pairing for BLS12-381 on the limb engine, in PyTorch.

The port of charon_tpu/ops/pairing.py (whose scalar specification is the
JAX package's crypto/pairing_fast.py): projective Miller loop with
unnormalized sparse lines, and an x-chain final exponentiation computing
f^(3h) via the BLS12 lattice identity — sound for every
product-of-pairings == 1 check.

Batch semantics: every function maps over leading batch axes. A "pair" is
(p, q) with p a batched affine G1 point (Fp limb pair) and q a batched
affine G2 point (Fp2 pair). Identity lanes (encoded affine (0, 0))
contribute the neutral line, so e(identity, q) == 1 per lane.

Control flow: the JAX package's lax.scan over the static 64-bit BLS
parameter schedule and lax.cond on its 6 set bits become Python loops and
branches over the same static schedule.
"""

from __future__ import annotations

import functools

import torch

from charon_tpu_torch.crypto import g1g2 as REF
from charon_tpu_torch.crypto.fields import X_ABS, X_IS_NEG
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.curve import map_point, zip_point
from charon_tpu_torch.ops.limb import ModCtx

# Miller-loop schedule: bits of |x| below the leading one, MSB first.
X_BITS = tuple(int(b) for b in bin(X_ABS)[3:])


# ---------------------------------------------------------------------------
# Sparse line multiplication: f * (l0 + l1 v w + l2 v^2 w)
# ---------------------------------------------------------------------------


def fp12_mul_sparse_line(ctx, f, l0, l1, l2):
    """18 fp2 muls (one stacked launch) vs 36 for a dense fp12 mul; the
    combine runs in three stacked add levels:
        c0 = (p0 + xi(p7+p8), p1 + xi(p3+p4), p2 + p5 + xi p6)
        c1 = (xi(p9+p10) + p15, p11 + xi p12 + p16, p13 + p14 + p17)
    """
    (a0, a1, a2), (b0, b1, b2) = f
    p = T.fp2_mul_many(
        ctx,
        [
            (a0, l0), (a1, l0), (a2, l0),
            (b1, l2), (b2, l1), (b0, l1), (b2, l2), (b0, l2), (b1, l1),
            (a1, l2), (a2, l1), (a0, l1), (a2, l2), (a0, l2), (a1, l1),
            (b0, l0), (b1, l0), (b2, l0),
        ],
    )
    s78, s34, s910, s25, s1116, s1314 = T.fp2_add_many(
        ctx,
        [(p[7], p[8]), (p[3], p[4]), (p[9], p[10]), (p[2], p[5]), (p[11], p[16]), (p[13], p[14])],
    )
    x78, x34, x6, x910, x12 = T.fp2_mul_xi_many(ctx, [s78, s34, p[6], s910, p[12]])
    c = T.fp2_add_many(
        ctx,
        [(p[0], x78), (p[1], x34), (s25, x6), (x910, p[15]), (s1116, x12), (s1314, p[17])],
    )
    return ((c[0], c[1], c[2]), (c[3], c[4], c[5]))


# ---------------------------------------------------------------------------
# Projective Miller-loop steps (spec: pairing_fast.py:120,149)
# ---------------------------------------------------------------------------


def _dbl_step(ctx, t, xp, yp):
    """Double T and return the tangent line at P=(xp, yp) (batched Fp)."""
    sub = functools.partial(T.fp2_sub, ctx)
    small = functools.partial(T.fp2_small, ctx)
    x, y, z = t
    xx, y2, s, xy = T.fp2_batch(ctx, [("sqr", x), ("sqr", y), ("mul", y, z), ("mul", x, y)])
    w = small(xx, 3)
    w2, bb, ss, sz, y2z, wx, wz = T.fp2_batch(
        ctx,
        [
            ("sqr", w),
            ("mul", xy, s),
            ("sqr", s),
            ("mul", s, z),
            ("mul", y2, z),
            ("mul", w, x),
            ("mul", w, z),
        ],
    )
    h = sub(w2, small(bb, 8))
    two_yp = limb.double_mod(ctx, yp)
    hs, wb, y2ss, sss, l0raw, l2 = T.fp2_batch(
        ctx,
        [
            ("mul", h, s),
            ("mul", w, sub(small(bb, 4), h)),
            ("mul", y2, ss),
            ("mul", s, ss),
            ("mul_fp", sz, two_yp),
            ("mul_fp", wz, limb.neg_mod(ctx, xp)),
        ],
    )
    x3 = T.fp2_double(ctx, hs)
    y3 = sub(wb, small(y2ss, 8))
    z3 = small(sss, 8)
    l0 = T.fp2_mul_xi(ctx, l0raw)
    l1 = sub(wx, T.fp2_double(ctx, y2z))
    return (x3, y3, z3), (l0, l1, l2)


def _add_step(ctx, t, q, xp, yp):
    """Mixed add T + affine Q; chord line at P=(xp, yp)."""
    sub = functools.partial(T.fp2_sub, ctx)
    add = functools.partial(T.fp2_add, ctx)
    x, y, z = t
    x2, y2 = q
    y2z, x2z = T.fp2_mul_many(ctx, [(y2, z), (x2, z)])
    theta = sub(y, y2z)
    lam = sub(x, x2z)
    lam2, theta2, tx2, ly2, l0raw, l2 = T.fp2_batch(
        ctx,
        [
            ("sqr", lam),
            ("sqr", theta),
            ("mul", theta, x2),
            ("mul", lam, y2),
            ("mul_fp", lam, yp),
            ("mul_fp", theta, limb.neg_mod(ctx, xp)),
        ],
    )
    l0 = T.fp2_mul_xi(ctx, l0raw)
    l1 = sub(tx2, ly2)
    lam3, theta2z, lam2x = T.fp2_mul_many(ctx, [(lam2, lam), (theta2, z), (lam2, x)])
    ww = add(sub(theta2z, T.fp2_double(ctx, lam2x)), lam3)
    x3, tt, lam3y, z3 = T.fp2_batch(
        ctx,
        [
            ("mul", lam, ww),
            ("mul", theta, sub(lam2x, ww)),
            ("mul", lam3, y),
            ("mul", lam3, z),
        ],
    )
    y3 = sub(tt, lam3y)
    return (x3, y3, z3), (l0, l1, l2)


def _neutral_line(ctx, batch_shape, device):
    return (
        T.fp2_one(ctx, batch_shape, device),
        T.fp2_zero(ctx, batch_shape, device),
        T.fp2_zero(ctx, batch_shape, device),
    )


def _mask_line(ctx, dead_mask, line):
    """Force identity-member pairs to contribute the neutral line l = 1."""
    neutral = _neutral_line(ctx, dead_mask.shape, dead_mask.device)
    return tuple(T.fp2_select(dead_mask, n, l) for n, l in zip(neutral, line))


def miller_loop(ctx: ModCtx, pairs):
    """Product of Miller loops over a static list of batched (p, q) pairs.

    Multiple pairs are STACKED onto one extra leading axis and run as
    independent per-lane Miller loops, combined with fp12 muls at the end
    (valid since the final exponentiation distributes over the product).
    """
    if len(pairs) > 1:
        stacked = zip_point(lambda *xs: torch.stack(torch.broadcast_tensors(*xs)), *pairs)
        lanes = miller_loop(ctx, [stacked])
        f = map_point(lambda a: a[0], lanes)
        for i in range(1, len(pairs)):
            f = T.fp12_mul(ctx, f, map_point(lambda a, i=i: a[i], lanes))
        return f

    ((p, q),) = pairs
    batch_shape, dev = p[0].shape[:-1], p[0].device
    dead = (limb.is_zero(p[0]) & limb.is_zero(p[1])) | (
        T.fp2_is_zero(q[0]) & T.fp2_is_zero(q[1])
    )
    t = (q[0], q[1], T.fp2_one(ctx, batch_shape, dev))
    f = T.fp12_one(ctx, batch_shape, dev)
    for bit in X_BITS:
        t, line = _dbl_step(ctx, t, p[0], p[1])
        f = fp12_mul_sparse_line(ctx, T.fp12_sqr(ctx, f), *_mask_line(ctx, dead, line))
        if bit:
            t, line = _add_step(ctx, t, q, p[0], p[1])
            f = fp12_mul_sparse_line(ctx, f, *_mask_line(ctx, dead, line))
    if X_IS_NEG:
        f = T.fp12_conj(ctx, f)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation (spec: pairing_fast.py:211-244)
# ---------------------------------------------------------------------------


def _cyc_pow_u(ctx, f):
    """f^|x| in the cyclotomic subgroup: Granger-Scott squarings and a
    multiply on each of the schedule's set bits."""
    acc = f
    for bit in bin(X_ABS)[3:]:  # leading 1: start from f
        acc = T.fp12_cyclotomic_sqr(ctx, acc)
        if bit == "1":
            acc = T.fp12_mul(ctx, acc, f)
    return acc


def _cyc_pow_x(ctx, f):
    out = _cyc_pow_u(ctx, f)
    return T.fp12_conj(ctx, out) if X_IS_NEG else out


def final_exp(ctx: ModCtx, f):
    """f^(3 * (p^12-1)/r): easy part, then the lattice-identity hard part."""
    f = T.fp12_mul(ctx, T.fp12_conj(ctx, f), T.fp12_inv(ctx, f))
    m = T.fp12_mul(ctx, T.fp12_frobenius_n(ctx, f, 2), f)
    a = T.fp12_mul(ctx, _cyc_pow_u(ctx, m), m)  # m^(u+1)
    a = T.fp12_mul(ctx, _cyc_pow_u(ctx, a), a)  # m^((x-1)^2)
    b = T.fp12_mul(ctx, _cyc_pow_x(ctx, a), T.fp12_frobenius(ctx, a))
    c = T.fp12_mul(
        ctx,
        T.fp12_mul(ctx, _cyc_pow_x(ctx, _cyc_pow_x(ctx, b)), T.fp12_frobenius_n(ctx, b, 2)),
        T.fp12_conj(ctx, b),
    )
    m3 = T.fp12_mul(ctx, T.fp12_cyclotomic_sqr(ctx, m), m)
    return T.fp12_mul(ctx, c, m3)


def multi_pairing_check(ctx: ModCtx, pairs):
    """Batch mask: prod e(p_i, q_i) == 1 (computed as the cube — sound:
    GT has prime order r and gcd(3, r) = 1)."""
    return T.fp12_is_one(ctx, final_exp(ctx, miller_loop(ctx, pairs)))


# ---------------------------------------------------------------------------
# BLS verification (eth2 flavour: pubkeys G1, signatures/messages G2)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _neg_g1_gen_consts(ctx: ModCtx):
    x, y = REF.g1_neg(REF.G1_GEN)
    return limb.pack_mont_host(ctx, [x])[0], limb.pack_mont_host(ctx, [y])[0]


def neg_g1_gen(ctx: ModCtx, batch_shape=(), device="cpu"):
    """-G1 generator broadcast to a batch shape (the fixed verify pair)."""
    x, y = _neg_g1_gen_consts(ctx)
    shape = (*batch_shape, ctx.n_limbs)
    return (limb.to_device(x, device).expand(shape), limb.to_device(y, device).expand(shape))


def batched_verify(ctx: ModCtx, pk, msg, sig):
    """Per-lane BLS verify: e(pk, H(m)) * e(-G1, sig) == 1. pk: batched
    affine G1; msg: batched affine G2 (hashed); sig: batched affine G2.
    Returns a bool mask over the batch."""
    neg_g = neg_g1_gen(ctx, pk[0].shape[:-1], pk[0].device)
    return multi_pairing_check(ctx, [(pk, msg), (neg_g, sig)])


def _fp12_prod_tree(ctx: ModCtx, f):
    """Product of a [N, ...] batch of Fp12 values over the leading axis in
    log2(N) stacked multiplies (padded to a power of two with ones)."""
    lead = f[0][0][0]
    n = lead.shape[0]
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        ones = T.fp12_one(ctx, (pow2 - n, *lead.shape[1:-1]), lead.device)
        f = zip_point(lambda a, b: torch.cat((a, b), 0), f, ones)
        n = pow2
    while n > 1:
        half = n // 2
        f = T.fp12_mul(ctx, map_point(lambda x: x[:half], f), map_point(lambda x: x[half:], f))
        n = half
    return map_point(lambda x: x[0], f)


def point_sum_tree(f, pts, n: int, axis: int = 0):
    """Log-depth pairwise sum of projective points over `axis` (padded to a
    power of two with identities; complete adds are identity-safe)."""
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        leaf = f.leaf(pts[0])
        shape = list(leaf.shape[:-1])
        shape[axis] = pow2 - n
        ident = C.point_identity(f, tuple(shape), leaf.device)
        pts = zip_point(lambda a, b: torch.cat((a, b), axis), pts, ident)
        n = pow2
    while n > 1:
        half = n // 2
        pts = C.point_add(
            f,
            map_point(lambda x: x.narrow(axis, 0, half), pts),
            map_point(lambda x: x.narrow(axis, half, half), pts),
        )
        n = half
    return map_point(lambda x: x.select(axis, 0), pts)


def batched_verify_grouped_rlc(ctx: ModCtx, fr_ctx: ModCtx, pk, msg, sig, rand, nbits: int = 64):
    """Grouped random-linear-combination batch verification:

        prod_m e( sum_{i in m} r_i * pk_i,  H(m) )  *  e(-G1, sum_i r_i * sig_i) == 1

    Layout: lanes pre-grouped by message on host — pk/sig/rand have shape
    [M, K] (M distinct messages, K lanes per group, padded with identity
    points + ZERO exponents), msg has shape [M]. Per lane the pairing work
    collapses to the randomization (MSM); the Miller stage runs over only
    M + 1 pairs and ONE final exponentiation. 2^-nbits Schwartz-Zippel
    soundness. Returns a 0-dim bool tensor (all-valid)."""
    from charon_tpu_torch.ops import msm as MSM

    g1f, g2f = C.g1_ops(ctx), C.g2_ops(ctx)
    m_groups, k = pk[0].shape[0], pk[0].shape[1]

    def flat2(t):
        return map_point(lambda a: a.reshape(m_groups * k, *a.shape[2:]), t)

    rand_flat = rand.reshape(m_groups * k, -1)
    pk_proj = C.affine_to_point(g1f, flat2(pk))
    sig_proj = C.affine_to_point(g2f, flat2(sig))
    if MSM.msm_active():
        seg = torch.arange(m_groups, device=rand.device).repeat_interleave(k)
        buckets = MSM.msm_segmented(g1f, fr_ctx, pk_proj, rand_flat, seg, m_groups, nbits=nbits)
        s_total = MSM.msm(g2f, fr_ctx, sig_proj, rand_flat, nbits=nbits)
    else:
        pk_r = C.point_scalar_mul(g1f, fr_ctx, pk_proj, rand_flat, nbits=nbits)
        sig_r = C.point_scalar_mul(g2f, fr_ctx, sig_proj, rand_flat, nbits=nbits)

        def regroup(t, f):
            t = map_point(lambda a: a.reshape(m_groups, k, *a.shape[1:]), t)
            return point_sum_tree(f, t, k, axis=1)

        buckets = regroup(pk_r, g1f)
        s_total = point_sum_tree(g2f, regroup(sig_r, g2f), m_groups)
    return grouped_rlc_check(ctx, buckets, msg, s_total)


def grouped_rlc_check(ctx: ModCtx, buckets, msgs, s_total):
    """The grouped-RLC equation's shared tail: per-group bucket pairs
    e(B_m, H_m) plus ONE aggregate pair e(-G1, S), a product tree and ONE
    final exponentiation; True iff the product is 1."""
    g1f, g2f = C.g1_ops(ctx), C.g2_ops(ctx)
    bucket_aff = C.point_to_affine(g1f, buckets)
    s_aff = C.point_to_affine(g2f, s_total)
    append_lane = lambda a, b: torch.cat((a, b.unsqueeze(0)), 0)  # noqa: E731
    neg_g = neg_g1_gen(ctx, (), s_aff[0][0].device)
    pk_lanes = zip_point(append_lane, bucket_aff, neg_g)
    q_lanes = zip_point(append_lane, msgs, s_aff)
    f_lanes = miller_loop(ctx, [(pk_lanes, q_lanes)])  # [M+1] fp12
    return T.fp12_is_one(ctx, final_exp(ctx, _fp12_prod_tree(ctx, f_lanes)))


def batched_verify_rlc(ctx: ModCtx, fr_ctx: ModCtx, pk, msg, sig, rand, nbits: int = 64):
    """Whole-batch BLS verification by random linear combination in GT:

        prod_i e(pk_i^(r_i), H(m_i)) * e((-G1)^(r_i), sig_i) == 1

    with caller-supplied random nonzero `nbits`-bit exponents r_i (raw Fr
    limbs, shape [N, fr_limbs]). A batch with any forged lane passes only
    with probability 2^-nbits. Returns a 0-dim bool tensor."""
    g1f = C.g1_ops(ctx)
    neg_g = neg_g1_gen(ctx, pk[0].shape[:-1], pk[0].device)
    pts = zip_point(lambda a, b: torch.stack(torch.broadcast_tensors(a, b)), pk, neg_g)
    rand2 = torch.stack([rand, rand])
    scaled = C.point_scalar_mul(g1f, fr_ctx, C.affine_to_point(g1f, pts), rand2, nbits=nbits)
    aff = C.point_to_affine(g1f, scaled)
    pk_r = map_point(lambda a: a[0], aff)
    negg_r = map_point(lambda a: a[1], aff)
    f_lanes = miller_loop(ctx, [(pk_r, msg), (negg_r, sig)])
    return T.fp12_is_one(ctx, final_exp(ctx, _fp12_prod_tree(ctx, f_lanes)))

