"""Batched hash-to-curve (G2 SSWU) on the limb engine, in PyTorch.

The port of charon_tpu/ops/sswu.py. Hash-to-curve splits in two:

  * HOST — `hash_to_field_lane`: expand_message_xmd + hash_to_field
    (RFC 9380 §5.2/§5.3.1, SHA-256 and byte slicing only) -> two Fp2
    elements a message plus their sgn0 bits (u is host-known, so the RFC
    sign of y is decided by a host bit).
  * DEVICE — `hash_to_g2_graph`: the field work, batched over lanes, every
    product on the kernels K1-K6:
      - simplified SWU onto E'' (RFC 9380 §6.6.2) without branches: one
        fixed-exponent chain c = gx1^((p^2+7)/16) serves both cases; the
        four candidates c r decide the square case, and the non-square
        case's sqrt(gx2) = u^3 Z^(3(p^2+7)/16) c r reuses c with a host
        constant, so there is no second chain;
      - the 3-isogeny E'' -> E' (Horner over the RFC appendix E.3
        constants, both denominators through ONE shared inversion);
      - cofactor clearing by the psi split (Budroni-Pintore): h_eff P =
        [x^2-x-1]P + [x-1]psi(P) + psi^2(2P), two 64-bit static ladders in
        place of the 1253-bit h_eff one (host oracle
        g1g2.g2_clear_cofactor_psi).
    The two field elements of every message run through one SSWU and one
    isogeny as a stacked batch axis.

Per-lane `ok` masks ride the whole graph (always True for real field
elements: SSWU is total), so a padded or malformed lane never raises.
"""

from __future__ import annotations

import dataclasses

import torch

from charon_tpu_torch.crypto import fields as F
from charon_tpu_torch.crypto import h2c as H
from charon_tpu_torch.crypto.g1g2 import PSI2_CX
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.decompress import (
    SQRT_EXP_G2,
    four_root_correction,
    fp2_pow_const,
    g2_psi_graph,
)
from charon_tpu_torch.ops.limb import ModCtx

P = F.P
X_ABS = F.X_ABS

DST_POP = H.DST_POP

# -- host-precomputed SSWU constants ----------------------------------------
_A, _B, _Z = H.A_PRIME, H.B_PRIME, H.Z_SSWU
# generic x1 = (-B/A) (1 + 1/(Z u^2 + Z^2 u^4)); exceptional (denominator
# 0) x1 = B / (Z A)
NEG_B_OVER_A = F.fp2_mul(F.fp2_neg(_B), F.fp2_inv(_A))
B_OVER_ZA = F.fp2_mul(_B, F.fp2_inv(F.fp2_mul(_Z, _A)))
# Z^(3(p^2+7)/16): with c = gx1^((p^2+7)/16) from the square case,
# sqrt(gx2) = sqrt(gx1 (Z u^2)^3) = u^3 C_Z3 c up to a 4th root of unity.
C_Z3 = F.fp2_pow(_Z, 3 * (P * P + 7) // 16)


# ---------------------------------------------------------------------------
# Host hashing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HashedMsg:
    """One message after host hash_to_field: the two Fp2 elements of the
    random-oracle construction plus their sgn0 bits."""

    u0: tuple
    u1: tuple
    sgn0: bool
    sgn1: bool


def hash_to_field_lane(msg: bytes, dst: bytes = DST_POP) -> HashedMsg:
    """RFC 9380 hash_to_field for one message (SHA-256 and byte work)."""
    u0, u1 = H.hash_to_field_fp2(msg, 2, dst)
    return HashedMsg(u0, u1, bool(F.fp2_sgn0(u0)), bool(F.fp2_sgn0(u1)))


def pack_hashed(ctx: ModCtx, lanes, device="cpu"):
    """[HashedMsg] -> device inputs: four raw limb tensors (the u0/u1 Fp2
    components) and two sgn0 bool tensors."""
    comps = [
        limb.to_device(limb.ctx_pack(ctx, [getattr(l, u)[k] for l in lanes]), device)
        for u in ("u0", "u1")
        for k in (0, 1)
    ]
    signs = [torch.as_tensor([getattr(l, s) for l in lanes], dtype=torch.bool, device=device) for s in ("sgn0", "sgn1")]
    return (*comps, *signs)


# ---------------------------------------------------------------------------
# Device graph pieces
# ---------------------------------------------------------------------------


def fp2_sgn0_graph(ctx: ModCtx, a):
    """RFC 9380 sgn0 of a Montgomery Fp2 element, as a device bool:
    sign_0 | (zero_0 & sign_1) on the raw limbs (parity is bit 0 of limb
    0)."""
    a0r, a1r = limb.from_mont(ctx, torch.stack(torch.broadcast_tensors(a[0], a[1])))
    sign_0 = (a0r[..., 0] & 1) != 0
    sign_1 = (a1r[..., 0] & 1) != 0
    return sign_0 | (limb.is_zero(a0r) & sign_1)


def sswu_graph(ctx: ModCtx, u, sgn_u):
    """Simplified SWU onto E'' (RFC 9380 §6.6.2), branch-free.

    u: Montgomery Fp2; sgn_u: host sgn0(u) bools. Returns ((x, y) affine on
    E'', ok): ok is True whenever one of the eight sqrt candidates
    verified (always, for real field elements)."""
    shape, dev = u[0].shape[:-1], u[0].device
    u2 = T.fp2_sqr(ctx, u)
    tv1 = T.fp2_mul(ctx, u2, T.fp2_const(ctx, _Z, shape, dev))  # Z u^2
    tv2 = T.fp2_sqr(ctx, tv1)
    den = T.fp2_add(ctx, tv1, tv2)
    # fp2_inv(0) == 0, so the generic expression is garbage-free on the
    # exceptional lanes and the select swaps in B/(Z A)
    x1 = T.fp2_mul(
        ctx,
        T.fp2_const(ctx, NEG_B_OVER_A, shape, dev),
        T.fp2_add(ctx, T.fp2_one(ctx, shape, dev), T.fp2_inv(ctx, den)),
    )
    x1 = T.fp2_select(T.fp2_is_zero(den), T.fp2_const(ctx, B_OVER_ZA, shape, dev), x1)
    x1_sq, x2, tv12, u3 = T.fp2_batch(ctx, [("sqr", x1), ("mul", tv1, x1), ("mul", tv1, tv2), ("mul", u2, u)])
    gx1 = T.fp2_add(
        ctx,
        T.fp2_mul(ctx, T.fp2_add(ctx, x1_sq, T.fp2_const(ctx, _A, shape, dev)), x1),
        T.fp2_const(ctx, _B, shape, dev),
    )
    # the chain: c = gx1^((p^2+7)/16); everything else is corrections
    c = fp2_pow_const(ctx, gx1, SQRT_EXP_G2)
    y1, ok1 = four_root_correction(ctx, c, gx1, shape, dev)
    # non-square case: x2 = Z u^2 x1, gx2 = gx1 (Z u^2)^3, and
    # sqrt(gx2) = u^3 C_Z3 c up to the same four roots
    gx2, u3c = T.fp2_batch(ctx, [("mul", gx1, tv12), ("mul", u3, c)])
    base = T.fp2_mul(ctx, u3c, T.fp2_const(ctx, C_Z3, shape, dev))
    y2, ok2 = four_root_correction(ctx, base, gx2, shape, dev)
    x = T.fp2_select(ok1, x1, x2)
    y = T.fp2_select(ok1, y1, y2)
    # RFC sign: sgn0(y) must equal sgn0(u)
    flip = fp2_sgn0_graph(ctx, y) != sgn_u
    y = T.fp2_select(flip, T.fp2_neg(ctx, y), y)
    return (x, y), ok1 | ok2


def iso_map_graph(ctx: ModCtx, pt):
    """3-isogeny E'' -> E' (RFC 9380 appendix E.3) on batched affine
    points. The four Horner evaluations run stacked, and both denominators
    share ONE inversion: inv(xd) = inv(xd yd) yd, inv(yd) = inv(xd yd) xd."""
    x, y = pt
    shape, dev = x[0].shape[:-1], x[0].device
    polys = [H._K[k] for k in ("x_num", "x_den", "y_num", "y_den")]
    accs = [T.fp2_const(ctx, c[-1], shape, dev) for c in polys]
    for step in range(max(len(c) for c in polys) - 1):
        live = [i for i, c in enumerate(polys) if len(c) - 1 > step]
        prods = T.fp2_batch(ctx, [("mul", accs[i], x) for i in live])
        sums = T.fp2_add_many(
            ctx, [(m, T.fp2_const(ctx, polys[i][len(polys[i]) - 2 - step], shape, dev)) for i, m in zip(live, prods)]
        )
        for i, s in zip(live, sums):
            accs[i] = s
    x_num, x_den, y_num, y_den = accs
    d_inv = T.fp2_inv(ctx, T.fp2_mul(ctx, x_den, y_den))
    inv_xd, inv_yd = T.fp2_batch(ctx, [("mul", d_inv, y_den), ("mul", d_inv, x_den)])
    xo, y_ratio = T.fp2_batch(ctx, [("mul", x_num, inv_xd), ("mul", y_num, inv_yd)])
    return (xo, T.fp2_mul(ctx, y, y_ratio))


def _g2_psi_proj(ctx: ModCtx, p):
    """psi on batched projective G2: conjugate all coordinates, scale X by
    cx and Y by cy (homogeneous, so Z just conjugates)."""
    x, y, z = p
    psi_x, psi_y = g2_psi_graph(ctx, (x, y))
    return (psi_x, psi_y, T.fp2_conj(ctx, z))


def _g2_psi2_proj(ctx: ModCtx, p):
    """psi^2 in its collapsed linear form: (PSI2_CX X, -Y, Z)."""
    x, y, z = p
    cx = limb.const(ctx, PSI2_CX, x[0].shape[:-1], x[0].device)
    return (T.fp2_mul_fp(ctx, x, cx), T.fp2_neg(ctx, y), z)


def _ladder_x(f: C.FieldOps, p):
    """[x]P for the (negative) BLS parameter: a 64-bit static |x| ladder
    and a negation."""
    return C.point_neg(f, C.point_mul_static(f, p, X_ABS))


def clear_cofactor_psi_graph(ctx: ModCtx, proj):
    """Budroni-Pintore cofactor clearing on batched projective G2:
    [x^2-x-1]P + [x-1]psi(P) + psi^2(2P). Two 64-bit ladders and a few
    complete adds (host oracle: g1g2.g2_clear_cofactor_psi)."""
    f = C.g2_ops(ctx)
    x_p = _ladder_x(f, proj)  # [x]P
    s = C.point_add(f, x_p, _g2_psi_proj(ctx, proj))  # [x]P + psi(P)
    t = _ladder_x(f, s)  # [x^2]P + [x]psi(P)
    t = C.point_add(f, t, C.point_neg(f, s))  # ... - [x]P - psi(P)
    t = C.point_add(f, t, C.point_neg(f, proj))  # ... - P
    return C.point_add(f, t, _g2_psi2_proj(ctx, C.point_double(f, proj)))


def map_to_g2_graph(ctx: ModCtx, u, sgn_u):
    """SSWU + isogeny: hash_to_field outputs -> affine E' points."""
    q, ok = sswu_graph(ctx, u, sgn_u)
    return iso_map_graph(ctx, q), ok


def hash_to_g2_graph(ctx: ModCtx, u0_raw, u1_raw, sgn0, sgn1, host_ok=None):
    """The device hash_to_curve tail: two raw-limb Fp2 elements a lane
    (the host hash_to_field outputs, pairs of (..., L) tensors) and their
    sgn0 bits -> ((x, y) Montgomery affine G2 in the r-subgroup, valid).

    Invalid lanes (host_ok False, or the impossible no-root case) come out
    as the (0, 0) identity encoding with valid False, never exceptions."""
    shape, dev = u0_raw[0].shape[:-1], u0_raw[0].device
    if host_ok is None:
        host_ok = torch.ones(shape, dtype=torch.bool, device=dev)
    # u0 and u1 of every lane as one stacked batch axis of two
    u = limb.to_mont(ctx, torch.stack([torch.stack([u0_raw[k], u1_raw[k]]) for k in (0, 1)]))
    q, ok = map_to_g2_graph(ctx, (u[0], u[1]), torch.stack([sgn0, sgn1]))
    f = C.g2_ops(ctx)
    pq = C.affine_to_point(f, q)
    p = C.point_add(f, C.map_point(lambda a: a[0], pq), C.map_point(lambda a: a[1], pq))
    x, y = C.point_to_affine(f, clear_cofactor_psi_graph(ctx, p))
    valid = ok[0] & ok[1] & host_ok
    zero = T.fp2_zero(ctx, shape, dev)
    return (T.fp2_select(valid, x, zero), T.fp2_select(valid, y, zero)), valid
