"""Batched multi-limb Montgomery arithmetic for big prime fields, in PyTorch.

The port of charon_tpu/ops/limb.py. An element of Z/m is a little-endian
vector of `n_limbs` limbs of `limb_bits` bits in an int64 tensor, shape
(..., n_limbs); leading axes are batch axes. All public ops accept
broadcastable batch shapes, keep values fully reduced (< m), and run on the
device their inputs live on.

Geometry: 24-bit limbs in int64 — the JAX package's CPU contexts `FP` (16
limbs, R = 2^384) and `FR` (11 limbs, R = 2^264). Reduced Montgomery values
therefore equal the JAX package's element for element. Products of two
limbs are < 2^48, so a full schoolbook column plus the Montgomery additions
stays < 2^54: no carry normalization inside the products, one carry pass at
the end (asserted in make_ctx). Signed int64 is exact here because nothing
relies on unsigned wrap: subtraction is `a + (mask - b) + one0`.

Every Fp and Fr multiply goes through `mont_mul`, which is the K1 kernel
wrapper (ops/mont_kernels.py) — or, with the int8 route on (`set_mxu`), the
K4 wrapper: the hand-written CUDA kernel for a CUDA tensor, its plain
PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from charon_tpu_torch.crypto.fields import P, R as FR_MOD

LIMB_BITS = 24
DTYPE = torch.int64


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, so
# module-singleton contexts work as lru_cache keys despite holding arrays.
class ModCtx:
    """Everything the device needs to do arithmetic mod `modulus`."""

    name: str
    modulus: int
    n_limbs: int
    limb_bits: int
    limbs: np.ndarray  # (n_limbs,) — the modulus
    pinv: int  # -modulus^-1 mod 2^limb_bits
    ninv: np.ndarray  # (n_limbs,) — -modulus^-1 mod 2^(limb_bits*n_limbs)
    r2: np.ndarray  # (n_limbs,) — R^2 mod m (to_mont multiplier)
    mont_one: np.ndarray  # (n_limbs,) — R mod m (1 in Montgomery form)

    @property
    def mask(self) -> int:
        return (1 << self.limb_bits) - 1

    @property
    def r_mont(self) -> int:
        return (1 << (self.limb_bits * self.n_limbs)) % self.modulus


def int_to_limbs(x: int, n_limbs: int, limb_bits: int = LIMB_BITS) -> np.ndarray:
    mask = (1 << limb_bits) - 1
    return np.array(
        [(x >> (limb_bits * i)) & mask for i in range(n_limbs)], np.int64
    )


def make_ctx(name: str, modulus: int, n_limbs: int, limb_bits: int = LIMB_BITS) -> ModCtx:
    if modulus.bit_length() > limb_bits * n_limbs - 2:
        raise ValueError("need >= 2 bits of headroom above the modulus")
    # No-mid-loop-carry invariant: a schoolbook column of n products plus n
    # Montgomery additions plus carries must fit the signed accumulator.
    worst = 2 * n_limbs * ((1 << limb_bits) - 1) ** 2 + (1 << 62) // (1 << limb_bits)
    if worst >= 1 << 63:
        raise ValueError(f"limb geometry {limb_bits}b x {n_limbs} overflows int64")
    r = 1 << (limb_bits * n_limbs)
    return ModCtx(
        name=name,
        modulus=modulus,
        n_limbs=n_limbs,
        limb_bits=limb_bits,
        limbs=int_to_limbs(modulus, n_limbs, limb_bits),
        pinv=(-pow(modulus, -1, 1 << limb_bits)) % (1 << limb_bits),
        ninv=int_to_limbs((-pow(modulus, -1, r)) % r, n_limbs, limb_bits),
        r2=int_to_limbs(r * r % modulus, n_limbs, limb_bits),
        mont_one=int_to_limbs(r % modulus, n_limbs, limb_bits),
    )


FP = make_ctx("fp", P, 16)
FR = make_ctx("fr", FR_MOD, 11)


@functools.lru_cache(maxsize=None)
def _const_tensor(ctx: ModCtx, what: str, device: torch.device) -> torch.Tensor:
    """Per-(context, device) constant limb tensors, built once."""
    n = ctx.n_limbs
    if what == "p":
        arr = ctx.limbs
    elif what == "ninv":
        arr = ctx.ninv
    elif what == "r2":
        arr = ctx.r2
    elif what == "one":
        arr = ctx.mont_one
    elif what == "r_minus_m":
        arr = int_to_limbs((1 << (ctx.limb_bits * n)) - ctx.modulus, n, ctx.limb_bits)
    elif what == "r_minus_m_hi":  # (R - m) shifted into the high n of 2n
        arr = np.concatenate([np.zeros(n, np.int64), _const_np(ctx, "r_minus_m")])
    elif what == "one0":
        arr = int_to_limbs(1, n, ctx.limb_bits)
    else:
        raise ValueError(what)
    return torch.as_tensor(arr, dtype=DTYPE, device=device)


def _const_np(ctx: ModCtx, what: str) -> np.ndarray:
    return _const_tensor(ctx, what, torch.device("cpu")).numpy()


def ctx_const(ctx: ModCtx, what: str, device) -> torch.Tensor:
    return _const_tensor(ctx, what, torch.device(device))


# ---------------------------------------------------------------------------
# Host <-> device packing (numpy)
# ---------------------------------------------------------------------------


def bytes_to_limbs_batch(data, n_limbs: int, item_bytes: int | None = None, byteorder: str = "big") -> np.ndarray:
    """Concatenated fixed-width byte strings (or an (N, item_bytes) uint8
    array) -> (N, n_limbs) int64 24-bit limb array in one numpy pass."""
    if isinstance(data, np.ndarray):
        raw = np.ascontiguousarray(data, dtype=np.uint8)
        if raw.ndim != 2:
            raise ValueError("ndarray input must be (N, item_bytes)")
        item_bytes = raw.shape[1]
    else:
        if item_bytes is None:
            raise ValueError("item_bytes required for flat byte input")
        raw = np.frombuffer(data, np.uint8)
        if item_bytes == 0 or raw.size % item_bytes:
            raise ValueError("byte length not a multiple of item_bytes")
        raw = raw.reshape(-1, item_bytes)
    if item_bytes > 3 * n_limbs:
        raise ValueError(f"{item_bytes}-byte items overflow {n_limbs} 24-bit limbs")
    if byteorder == "big":
        raw = raw[:, ::-1]
    elif byteorder != "little":
        raise ValueError(f"bad byteorder {byteorder!r}")
    if item_bytes != 3 * n_limbs:
        pad = np.zeros((raw.shape[0], 3 * n_limbs - item_bytes), np.uint8)
        raw = np.concatenate([raw, pad], axis=1)
    b = np.ascontiguousarray(raw).reshape(-1, n_limbs, 3).astype(np.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


def pack(values, n_limbs: int) -> np.ndarray:
    """Iterable of ints -> (N, n_limbs) int64 limb array."""
    nbytes = 3 * n_limbs
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    if not buf:
        return np.zeros((0, n_limbs), np.int64)
    return bytes_to_limbs_batch(buf, n_limbs, item_bytes=nbytes, byteorder="little")


def unpack(arr, limb_bits: int = LIMB_BITS) -> list[int]:
    """(..., n_limbs) limb array or tensor -> flat list of ints (C order)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    arr = arr.reshape(-1, arr.shape[-1])
    out = []
    for row in arr.tolist():
        v = 0
        for i, limb in enumerate(row):
            v |= int(limb) << (limb_bits * i)
        out.append(v)
    return out


def ctx_pack(ctx: ModCtx, values) -> np.ndarray:
    return pack(values, ctx.n_limbs)


def ctx_unpack(ctx: ModCtx, arr) -> list[int]:
    return unpack(arr, ctx.limb_bits)


def pack_mont_host(ctx: ModCtx, values) -> np.ndarray:
    """ints -> Montgomery limb array (host bigint conversion)."""
    r = ctx.r_mont
    return ctx_pack(ctx, (v % ctx.modulus * r % ctx.modulus for v in values))


def unpack_mont_host(ctx: ModCtx, arr) -> list[int]:
    rinv = pow(ctx.r_mont, -1, ctx.modulus)
    return [v * rinv % ctx.modulus for v in ctx_unpack(ctx, arr)]


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=DTYPE, device=device)


# ---------------------------------------------------------------------------
# Parallel carry machinery: elementwise shift passes, then a Kogge-Stone
# (generate, propagate) scan for the final {0,1} carries — log-depth over
# the limb axis, no sequential ripple.
# ---------------------------------------------------------------------------


def _shift_right_limbs(x: torch.Tensor, s: int) -> torch.Tensor:
    """Move limbs s positions up the limb axis (toward the top), zero fill."""
    return torch.constant_pad_nd(x[..., :-s], (s, 0))


def _shift_carries(ctx: ModCtx, t):
    """One elementwise carry pass: each limb's excess moves one position
    up. Returns (limbs, carry out of the top limb)."""
    carry = t >> ctx.limb_bits
    return (t & ctx.mask) + _shift_right_limbs(carry, 1), carry[..., -1]


def _kogge_resolve(ctx: ModCtx, t):
    """Resolve limbs in [0, 2^(limb_bits+1)) to canonical form; returns
    (limbs, carry_out in {0, 1}). Kogge-Stone over (generate, propagate):
    g as 0/1 int64, p as bool; the last level needs no new p."""
    g = t >> ctx.limb_bits
    p = (t & ctx.mask) == ctx.mask
    width = t.shape[-1]
    shift = 1
    while shift < width:
        g = g | (p & _shift_right_limbs(g, shift))
        if 2 * shift < width:
            p = p & _shift_right_limbs(p, shift)
        shift *= 2
    out = (t + _shift_right_limbs(g, 1)) & ctx.mask
    return out, g[..., -1]


def _normalize(ctx: ModCtx, t, passes: int = 3):
    """Accumulator-range limbs -> canonical form, (limbs, carry). `carry`
    is the total overflow out of the top limb. 3 passes cover the full
    accumulator range; 1 suffices for sums of a few canonical values."""
    total = None
    for _ in range(passes):
        t, c = _shift_carries(ctx, t)
        total = c if total is None else total + c
    out, c_final = _kogge_resolve(ctx, t)
    return out, total + c_final


# ---------------------------------------------------------------------------
# Modular add / sub / neg / select: one stacked normalize per batch of
# independent ops — the raw result and its modulus-adjusted twin are
# normalized together and selected by the twin's carry-out. Precondition
# (make_ctx): 2 * modulus < R, so a + b never carries out on its own.
# ---------------------------------------------------------------------------


def addsub_mod_many(ctx: ModCtx, add_pairs, sub_pairs):
    """Independent modular adds and subs in ONE stacked normalize.

    add lane pair: s = a + b and s + (R - m), which carries iff a + b >= m;
    sub lane pair: z = a - b + R (limbwise, no borrows), which carries iff
    a >= b, and z + m."""
    add_pairs, sub_pairs = list(add_pairs), list(sub_pairs)
    if not add_pairs and not sub_pairs:
        return [], []
    ref = (add_pairs or sub_pairs)[0][0]
    dev = ref.device
    rm = ctx_const(ctx, "r_minus_m", dev)
    one0 = ctx_const(ctx, "one0", dev)
    p = ctx_const(ctx, "p", dev)
    lanes = []
    for a, b in add_pairs:
        s = a + b
        lanes += [s, s + rm]
    for a, b in sub_pairs:
        z = a + (ctx.mask - b) + one0
        lanes += [z, z + p]
    out, carry = _normalize(ctx, torch.stack(torch.broadcast_tensors(*lanes)), passes=1)
    carried = (carry == 1).unsqueeze(-1)
    res_add, res_sub = [], []
    for i in range(len(add_pairs)):
        res_add.append(torch.where(carried[2 * i + 1], out[2 * i + 1], out[2 * i]))
    off = 2 * len(add_pairs)
    for i in range(len(sub_pairs)):
        j = off + 2 * i
        # carry on the raw lane <=> a >= b <=> no +m needed
        res_sub.append(torch.where(carried[j], out[j], out[j + 1]))
    return res_add, res_sub


def add_mod_many(ctx: ModCtx, pairs):
    return addsub_mod_many(ctx, pairs, [])[0]


def sub_mod_many(ctx: ModCtx, pairs):
    return addsub_mod_many(ctx, [], pairs)[1]


def add_mod(ctx: ModCtx, a, b):
    return add_mod_many(ctx, [(a, b)])[0]


def sub_mod(ctx: ModCtx, a, b):
    return sub_mod_many(ctx, [(a, b)])[0]


def neg_mod(ctx: ModCtx, a):
    return sub_mod(ctx, torch.zeros_like(a), a)


def double_mod(ctx: ModCtx, a):
    return add_mod(ctx, a, a)


def is_zero(a):
    """Boolean mask over batch dims: element == 0 (must be reduced)."""
    return torch.all(a == 0, dim=-1)


def select(mask, a, b):
    """Elementwise: mask ? a : b, with mask over batch dims."""
    return torch.where(mask.unsqueeze(-1), a, b)


def zeros(ctx: ModCtx, batch_shape=(), device="cpu"):
    return torch.zeros((*batch_shape, ctx.n_limbs), dtype=DTYPE, device=device)


def const(ctx: ModCtx, value: int, batch_shape=(), device="cpu"):
    """Montgomery-form constant broadcast to a batch shape."""
    limbs = int_to_limbs(value % ctx.modulus * ctx.r_mont % ctx.modulus, ctx.n_limbs, ctx.limb_bits)
    t = torch.as_tensor(limbs, dtype=DTYPE, device=device)
    return t.expand(*batch_shape, ctx.n_limbs)


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------


def has_kernel_instance(ctx: ModCtx) -> bool:
    """The Montgomery kernels (K1, K4) are instantiated for the port's two
    contexts: 24-bit limbs, FP's 16 and FR's 11."""
    return ctx.limb_bits == LIMB_BITS and ctx.n_limbs in (FP.n_limbs, FR.n_limbs)


# int8 tensor-core route (ops/limb_mxu.py, kernels K4-K6): off by default,
# as in the reference. The startup tuner owns it through
# core/autotune.KernelConfig; the CHARON_MXU_MONT deploy pin folds in
# there, so this hot path never reads the environment.
_MXU_MODE: bool | None = None


def set_mxu(mode: bool | None) -> None:
    global _MXU_MODE
    _MXU_MODE = mode


def _mxu_active(ctx: ModCtx) -> bool:
    """Whether ctx's products take the int8 route. The reference tests for
    its 12-bit geometry; the port's test is whether K4 has an instance for
    ctx, so FP and FR both take the route, as FP32 and FR32 do on the TPU."""
    return bool(_MXU_MODE) and has_kernel_instance(ctx)


def mont_mul(ctx: ModCtx, a, b):
    """a * b * R^-1 mod m for reduced Montgomery-form inputs: kernel K1, or
    K4 with the int8 route on, on a CUDA tensor; its plain version on a CPU
    tensor."""
    from charon_tpu_torch.ops import mont_kernels

    if _mxu_active(ctx):
        return mont_kernels.mont_mul_mxu(ctx, a, b)
    return mont_kernels.mont_mul(ctx, a, b)


def mont_sqr(ctx: ModCtx, a):
    return mont_mul(ctx, a, a)


def to_mont(ctx: ModCtx, a):
    """Raw limbs (< m) -> Montgomery form, on device."""
    return mont_mul(ctx, a, ctx_const(ctx, "r2", a.device))


def from_mont(ctx: ModCtx, a):
    """Montgomery form -> raw limbs, on device."""
    return mont_mul(ctx, a, ctx_const(ctx, "one0", a.device))


# ---------------------------------------------------------------------------
# Exponentiation by a static exponent (a Python loop over its bits)
# ---------------------------------------------------------------------------


def mont_pow(ctx: ModCtx, a, exponent: int):
    """a^exponent (Montgomery in, Montgomery out), left-to-right
    square-and-multiply over the static exponent's bits."""
    if exponent == 0:
        return ctx_const(ctx, "one", a.device).expand(a.shape).clone()
    acc = a
    for bit in bin(exponent)[3:]:  # leading 1: start from a
        acc = mont_sqr(ctx, acc)
        if bit == "1":
            acc = mont_mul(ctx, acc, a)
    return acc


def inv_mod(ctx: ModCtx, a):
    """a^-1 via Fermat (Montgomery in/out). 0 maps to 0."""
    return mont_pow(ctx, a, ctx.modulus - 2)
