"""Plain pure-Python BLS12-381 for the benchmark: the fields Fp and Fp2,
the groups G1 and G2 in Jacobian coordinates, fixed-base multiplication,
the eth2 compressed encodings, and RFC 9380 hash-to-G2
(BLS12381G2_XMD:SHA-256_SSWU_RO_ with the proof-of-possession DST).

The benchmark's generator signs with it and its reference recomputes the
expected answers with it. It imports nothing of the program under test,
so a fault in the program cannot also be a fault here; its tests hold it
against RFC 9380's vectors and against the BLS verify of a pairing.
"""

from __future__ import annotations

import hashlib

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
DST_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


# --- Fp2 = Fp[u] / (u^2 + 1), elements (c0, c1) -------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_sqr(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * n % P, -a[1] * n % P)


def f2_pow(a, e: int):
    out = (1, 0)
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sqr(a)
        e >>= 1
    return out


def f2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def f2_sqrt(a):
    """A square root of a (p = 3 mod 4), or None where a is no square."""
    if f2_is_zero(a):
        return (0, 0)
    a1 = f2_pow(a, (P - 3) // 4)
    x0 = f2_mul(a1, a)
    alpha = f2_mul(a1, x0)
    if alpha == (P - 1, 0):
        cand = ((-x0[1]) % P, x0[0])
    else:
        cand = f2_mul(f2_pow(f2_add((1, 0), alpha), (P - 1) // 2), x0)
    return cand if f2_sqr(cand) == (a[0] % P, a[1] % P) else None


def f2_sgn0(a) -> int:
    return (a[0] % 2) | ((a[0] % P == 0) & (a[1] % 2))


def f2_lex_largest(a) -> bool:
    if a[1] % P:
        return a[1] % P > (P - 1) // 2
    return a[0] % P > (P - 1) // 2


# --- Jacobian points over Fp (G1) or Fp2 (G2) ---------------------------
# (add, sub, mul, sqr, inv, zero, one); a point is (X, Y, Z), Z = 0 at
# infinity; affine points are (x, y) and None at infinity.

FP = (
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    lambda a: a * a % P,
    lambda a: pow(a, P - 2, P),
    0,
    1,
)
FP2 = (f2_add, f2_sub, f2_mul, f2_sqr, f2_inv, (0, 0), (1, 0))


def jac_double(p, f):
    add, sub, mul, sqr, _, zero, _ = f
    x, y, z = p
    if z == zero:
        return p
    a, b = sqr(x), sqr(y)
    c = sqr(b)
    d = sub(sub(sqr(add(x, b)), a), c)
    d = add(d, d)
    e = add(add(a, a), a)
    x3 = sub(sqr(e), add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    return (x3, sub(mul(e, sub(d, x3)), c8), mul(add(y, y), z))


def jac_add_affine(p, q, f):
    """p (Jacobian) + q (affine, not infinity)."""
    add, sub, mul, sqr, _, zero, one = f
    x1, y1, z1 = p
    if z1 == zero:
        return (q[0], q[1], one)
    z1z1 = sqr(z1)
    u2 = mul(q[0], z1z1)
    s2 = mul(mul(q[1], z1), z1z1)
    h = sub(u2, x1)
    r = sub(s2, y1)
    if h == zero:
        return jac_double(p, f) if r == zero else (zero, zero, zero)
    hh = sqr(h)
    i = add(add(hh, hh), add(hh, hh))
    j = mul(h, i)
    r = add(r, r)
    v = mul(x1, i)
    x3 = sub(sub(sqr(r), j), add(v, v))
    y1j = mul(y1, j)
    y3 = sub(mul(r, sub(v, x3)), add(y1j, y1j))
    z3 = sub(sub(sqr(add(z1, h)), z1z1), hh)
    return (x3, y3, z3)


def to_affine(points: list, f) -> list:
    """Jacobian points to affine with one field inversion for all of them
    (Montgomery's trick); None for a point at infinity."""
    _, _, mul, sqr, inv, zero, one = f
    live = [k for k, p in enumerate(points) if p[2] != zero]
    prefix, acc = [], one
    for k in live:
        prefix.append(acc)
        acc = mul(acc, points[k][2])
    out: list = [None] * len(points)
    if not live:
        return out
    acc = inv(acc)
    for k, pre in zip(reversed(live), reversed(prefix)):
        zinv = mul(acc, pre)
        acc = mul(acc, points[k][2])
        x, y, _ = points[k]
        zi2 = sqr(zinv)
        out[k] = (mul(x, zi2), mul(mul(y, zi2), zinv))
    return out


def mul_affine(pt, k: int, f):
    """[k] pt by double-and-add (k not reduced), affine in and out."""
    if pt is None or k == 0:
        return None
    zero = f[5]
    acc = (zero, zero, zero)
    for bit in bin(k)[2:]:
        acc = jac_double(acc, f)
        if bit == "1":
            acc = jac_add_affine(acc, pt, f)
    return to_affine([acc], f)[0]


def add_affine(a, b, f):
    if a is None:
        return b
    if b is None:
        return a
    one = f[6]
    return to_affine([jac_add_affine((a[0], a[1], one), b, f)], f)[0]


def fixed_base(pt, scalars: list, f) -> list:
    """[k] pt for every k in `scalars` (each reduced mod r), by a table of
    the base's window multiples: one table for the batch, then an addition
    a window a scalar. The window widens with the batch."""
    n = len(scalars)
    w = 3 if n < 16 else 5 if n < 256 else 7 if n < 2048 else 8
    windows = -(-255 // w)
    zero, one = f[5], f[6]
    table = []  # table[j][d - 1] = [d * 2^(w j)] pt, affine
    base_aff = pt
    for j in range(windows):
        row = [(base_aff[0], base_aff[1], one)]
        for _ in range((1 << w) - 2):
            row.append(jac_add_affine(row[-1], base_aff, f))
        table.append(to_affine(row, f))
        nxt = table[-1][-1]  # (2^w - 1) * base
        base_aff = add_affine(nxt, base_aff, f)  # 2^w * base
        if base_aff is None:
            raise ValueError("base of small order")
    mask = (1 << w) - 1
    out = []
    for k in scalars:
        k %= R
        acc = (zero, zero, zero)
        j = 0
        while k:
            d = k & mask
            if d:
                acc = jac_add_affine(acc, table[j][d - 1], f)
            k >>= w
            j += 1
        out.append(acc)
    return to_affine(out, f)


# --- encodings (ZCash / eth2 compressed) --------------------------------


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    out = bytearray(pt[0].to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if pt[1] > (P - 1) // 2 else 0)
    return bytes(out)


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = pt
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if f2_lex_largest(y) else 0)
    return bytes(out)


def g2_from_bytes(data: bytes):
    """A compressed G2 point (no subgroup check); raises ValueError on a
    malformed encoding."""
    if len(data) != 96 or not data[0] & 0x80:
        raise ValueError("not a compressed G2 point")
    if data[0] & 0x40:
        return None
    x = (int.from_bytes(data[48:], "big"), int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big"))
    if x[0] >= P or x[1] >= P:
        raise ValueError("G2 x out of range")
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), (4, 4)))
    if y is None:
        raise ValueError("G2 x not on the curve")
    if f2_lex_largest(y) != bool(data[0] & 0x20):
        y = f2_neg(y)
    return (x, y)


# --- RFC 9380 hash-to-G2 -------------------------------------------------

_A = (0, 240)
_B = (1012, 1012)
_Z = ((-2) % P, (-1) % P)
_ISO = {
    "x_num": [
        (0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
         0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6),
        (0, 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
        (0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
         0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D),
        (0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0),
    ],
    "x_den": [
        (0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
        (0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
        (1, 0),
    ],
    "y_num": [
        (0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
         0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706),
        (0, 0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
        (0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
         0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F),
        (0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0),
    ],
    "y_den": [
        (0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB),
        (0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3),
        (0x12, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99),
        (1, 0),
    ],
}
# the effective G2 cofactor h_eff of RFC 9380 section 8.8.2
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def expand_message_xmd(msg: bytes, dst: bytes, n: int) -> bytes:
    ell = -(-n // 32)
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + n.to_bytes(2, "big") + b"\x00" + dst_prime).digest()
    blocks = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        mixed = bytes(a ^ b for a, b in zip(b0, blocks[-1]))
        blocks.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:n]


def _sswu(u):
    tv1 = f2_mul(_Z, f2_sqr(u))
    tv2 = f2_sqr(tv1)
    den = f2_add(tv1, tv2)
    if f2_is_zero(den):
        x1 = f2_mul(_B, f2_inv(f2_mul(_Z, _A)))
    else:
        x1 = f2_mul(f2_mul(f2_neg(_B), f2_inv(_A)), f2_add((1, 0), f2_inv(den)))
    gx1 = f2_add(f2_mul(f2_add(f2_sqr(x1), _A), x1), _B)
    y = f2_sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = f2_mul(tv1, x1)
        y = f2_sqrt(f2_mul(gx1, f2_mul(tv1, tv2)))
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    return (x, y)


def _iso(pt):
    x, y = pt

    def horner(coeffs):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = f2_add(f2_mul(acc, x), c)
        return acc

    xo = f2_mul(horner(_ISO["x_num"]), f2_inv(horner(_ISO["x_den"])))
    yo = f2_mul(y, f2_mul(horner(_ISO["y_num"]), f2_inv(horner(_ISO["y_den"]))))
    return (xo, yo)


def hash_to_g2(msg: bytes, dst: bytes = DST_POP):
    """RFC 9380 hash_to_curve onto G2: an affine point of the r-subgroup."""
    data = expand_message_xmd(msg, dst, 256)
    us = [
        (int.from_bytes(data[128 * i : 128 * i + 64], "big") % P, int.from_bytes(data[128 * i + 64 : 128 * i + 128], "big") % P)
        for i in range(2)
    ]
    q = add_affine(_iso(_sswu(us[0])), _iso(_sswu(us[1])), FP2)
    return mul_affine(q, H_EFF, FP2)


# --- keys and signatures -------------------------------------------------


def split(secret: int, n: int, t: int, rng) -> dict:
    """Shamir shares {i: f(i)} for i = 1..n of a degree t - 1 polynomial
    with f(0) = secret, its other coefficients drawn from rng."""
    coeffs = [secret] + [rng.randrange(1, R) for _ in range(t - 1)]
    return {i: sum(c * pow(i, k, R) for k, c in enumerate(coeffs)) % R for i in range(1, n + 1)}


def lagrange_at_zero(indices) -> dict:
    out = {}
    for i in indices:
        num = den = 1
        for j in indices:
            if j != i:
                num = num * j % R
                den = den * (j - i) % R
        out[i] = num * pow(den, R - 2, R) % R
    return out


def public_keys(secrets: list) -> list:
    """Compressed G1 public keys of the secrets."""
    return [g1_to_bytes(pt) for pt in fixed_base(G1_GEN, secrets, FP)]


def sign_root(root: bytes, secrets: list) -> list:
    """Compressed signatures of one signing root under each secret."""
    return [g2_to_bytes(pt) for pt in fixed_base(hash_to_g2(root), secrets, FP2)]
