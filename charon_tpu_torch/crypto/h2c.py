"""RFC 9380 hash-to-curve for BLS12-381 G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_).

Pipeline: expand_message_xmd(SHA-256) -> 2x hash_to_field(Fp2) ->
simplified SWU onto the 3-isogenous curve E'' -> 3-isogeny map onto E' ->
cofactor clearing by h_eff.

The eth2 ciphersuite DST (proof-of-possession scheme) is
BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_, the same one herumi is
configured with in the reference (ref: tbls/herumi.go:25-36 eth mode init).

Internal self-checks: every mapped point is verified on-curve and
in-subgroup by tests; the isogeny constants below are additionally
sanity-checked at import by mapping a fixed point and asserting the image
lands on E'.
"""

from __future__ import annotations

import hashlib

from charon_tpu_torch.crypto.fields import (
    FP2_ONE,
    FP2_ZERO,
    P,
    fp2_add,
    fp2_inv,
    fp2_is_square,
    fp2_is_zero,
    fp2_mul,
    fp2_neg,
    fp2_sgn0,
    fp2_sqr,
    fp2_sqrt,
    fp2_sub,
)
from charon_tpu_torch.crypto.g1g2 import (
    g2_add,
    g2_clear_cofactor_psi,
    g2_is_on_curve,
    g2_mul_raw,
)

DST_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- SSWU curve E'': y^2 = x^3 + A'x + B' over Fp2 (3-isogenous to E') ---
A_PRIME = (0, 240)
B_PRIME = (1012, 1012)
Z_SSWU = ((-2) % P, (-1) % P)  # Z = -(2 + u)

# --- 3-isogeny map E'' -> E' coefficients (RFC 9380 appendix E.3) ---
_K = {
    "x_num": [
        (
            0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
            0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        ),
        (
            0,
            0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
        ),
        (
            0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
            0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
        ),
        (
            0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
            0,
        ),
    ],
    "x_den": [
        (
            0,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
        ),
        (
            0xC,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
        ),
        (1, 0),
    ],
    "y_num": [
        (
            0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
            0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        ),
        (
            0,
            0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
        ),
        (
            0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
            0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
        ),
        (
            0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
            0,
        ),
    ],
    "y_den": [
        (
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        ),
        (
            0,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
        ),
        (
            0x12,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
        ),
        (1, 0),
    ],
}

# Effective G2 cofactor h_eff (RFC 9380 §8.8.2): clear_cofactor(P) = h_eff * P.
# The live path clears by the psi-endomorphism split (g1g2.
# g2_clear_cofactor_psi — two 64-bit ladders instead of this 1253-bit
# one); H_EFF stays THE spec value, cross-checked at import below.
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    b_in_bytes = 32
    s_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds exceeded")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = bytes(s_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    msg_prime = z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    b0 = hashlib.sha256(msg_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        blocks.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST_POP):
    """RFC 9380 §5.2 hash_to_field for Fp2 (m=2, L=64)."""
    L = 64
    pseudo = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            offset = L * (j + i * 2)
            coeffs.append(int.from_bytes(pseudo[offset : offset + L], "big") % P)
        out.append(tuple(coeffs))
    return out


def sswu_fp2(u):
    """Simplified SWU map (RFC 9380 §6.6.2) onto E'': returns affine (x, y)."""
    A, B, Z = A_PRIME, B_PRIME, Z_SSWU
    tv1 = fp2_mul(Z, fp2_sqr(u))  # Z u^2
    tv2 = fp2_sqr(tv1)
    x1_den = fp2_add(tv1, tv2)
    if fp2_is_zero(x1_den):
        # Exceptional case: x1 = B / (Z*A)
        x1 = fp2_mul(B, fp2_inv(fp2_mul(Z, A)))
    else:
        x1 = fp2_mul(
            fp2_mul(fp2_neg(B), fp2_inv(A)),
            fp2_add(FP2_ONE, fp2_inv(x1_den)),
        )
    gx1 = fp2_add(fp2_mul(fp2_add(fp2_sqr(x1), A), x1), B)
    if fp2_is_square(gx1):
        x, y = x1, fp2_sqrt(gx1)
    else:
        x2 = fp2_mul(tv1, x1)
        gx2 = fp2_mul(gx1, fp2_mul(tv1, tv2))  # gx2 = Z^3 u^6 gx1
        x, y = x2, fp2_sqrt(gx2)
    if y is None:  # pragma: no cover - mathematically impossible
        raise AssertionError("SSWU: no square root found")
    if fp2_sgn0(u) != fp2_sgn0(y):
        y = fp2_neg(y)
    return (x, y)


def iso_map_g2(pt):
    """3-isogeny from E'' to E' (RFC 9380 appendix E.3)."""
    x, y = pt

    def horner(coeffs):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = fp2_add(fp2_mul(acc, x), c)
        return acc

    x_num = horner(_K["x_num"])
    x_den = horner(_K["x_den"])
    y_num = horner(_K["y_num"])
    y_den = horner(_K["y_den"])
    xo = fp2_mul(x_num, fp2_inv(x_den))
    yo = fp2_mul(y, fp2_mul(y_num, fp2_inv(y_den)))
    return (xo, yo)


def clear_cofactor_g2(pt):
    """[h_eff]P by the psi-endomorphism split — bit-identical to the
    g2_mul_raw(pt, H_EFF) ladder (asserted at import on a mapped point)
    at ~1/9 the point-op cost; this is what makes the PYTHON rung of a
    cold-cache hash-to-curve burst survivable."""
    return g2_clear_cofactor_psi(pt)


def map_to_curve_g2(u):
    return iso_map_g2(sswu_fp2(u))


def hash_to_g2(msg: bytes, dst: bytes = DST_POP):
    """Full hash_to_curve for G2: returns an affine E'(Fp2) point in the
    r-subgroup."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    return clear_cofactor_g2(g2_add(q0, q1))


def _selfcheck() -> None:
    """Verify the isogeny constants map E'' points onto E', and that the
    psi cofactor-clearing split equals the spec [H_EFF]P ladder on a
    mapped (pre-clearing, non-subgroup) point."""
    u = (5, 7)
    q = sswu_fp2(u)
    # On E''?
    lhs = fp2_sqr(q[1])
    rhs = fp2_add(fp2_add(fp2_mul(fp2_sqr(q[0]), q[0]), fp2_mul(A_PRIME, q[0])), B_PRIME)
    if lhs != rhs:
        raise AssertionError("SSWU output not on E''")
    mapped = iso_map_g2(q)
    if not g2_is_on_curve(mapped):
        raise AssertionError("isogeny image not on E' — bad constants")
    if g2_clear_cofactor_psi(mapped) != g2_mul_raw(mapped, H_EFF):
        raise AssertionError("psi cofactor clearing != [h_eff]P ladder")


_selfcheck()
