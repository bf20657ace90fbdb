"""Batched multi-scalar multiplication: sorted-bucket Pippenger, in PyTorch.

The port of charon_tpu/ops/msm.py. The grouped-RLC verify's dominant stage
is the per-lane randomization (one 64-bit G1 and one 64-bit G2 scalar
multiplication per signature lane). Pippenger's bucket method shares that
work across lanes: for each w-bit window of the scalars, lanes with equal
digits collapse into one bucket sum, and each window's bucket table
combines with ~2^w point-ops regardless of lane count.

Same algorithm as the JAX package, step for step:

  1. digits: [N, n_win] w-bit windows of the raw scalars;
  2. one flat element list over (window, lane) with the composite sort key
     (window, segment, digit), sorted so equal buckets form runs;
  3. a segmented inclusive scan of complete point adds reduces every run
     (log-depth Hillis-Steele: element i absorbs element i - s while their
     keys match — the sorted keys make a match mean "same run");
  4. the last element of each run lands in a dense [n_win, n_segments, 2^w]
     bucket table; digit-0 buckets are dropped;
  5. the suffix sum turns each window's buckets into sum_b b * B_b;
  6. Horner across windows: acc = 2^w acc + W_win.

Complete projective formulas make every step total: identity padding lanes,
zero scalars, repeated points and empty buckets take the same code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops.curve import FieldOps, map_point, zip_point
from charon_tpu_torch.ops.limb import ModCtx


def _digits(fr_ctx: ModCtx, scalars, nbits: int, window: int):
    """Raw Fr limb tensor [..., n_limbs] -> [..., n_win] w-bit digits,
    little-endian windows (window 0 = least significant)."""
    shifts = torch.arange(fr_ctx.limb_bits, device=scalars.device)
    bits = (scalars.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*scalars.shape[:-1], -1)[..., :nbits]
    n_win = -(-nbits // window)
    pad = n_win * window - nbits
    if pad:
        bits = F.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], n_win, window)
    weights = 1 << torch.arange(window, device=scalars.device)
    return (bits * weights).sum(-1)


def _identity_like(f: FieldOps, batch_shape, device):
    """Identity points as writable (contiguous) tensors."""
    return map_point(lambda a: a.contiguous(), C.point_identity(f, batch_shape, device))


def msm_segmented(
    f: FieldOps,
    fr_ctx: ModCtx,
    points,
    scalars,
    segment_ids,
    n_segments: int,
    nbits: int = 64,
    window: int = 8,
):
    """sum_{i: segment_ids[i] == s} scalars[i] * points[i] for each s.

    points: projective point with leading batch axis [N]; scalars: raw
    (non-Montgomery) Fr limbs [N, n_limbs]; segment_ids: int [N] in
    [0, n_segments). Returns a projective point with batch [n_segments]."""
    dev = scalars.device
    n = segment_ids.shape[0]
    n_win = -(-nbits // window)
    n_buckets = 1 << window

    digits = _digits(fr_ctx, scalars, nbits, window)  # [N, n_win]
    # flat element e = win * N + i (window-major, so point index = e % N)
    win_idx = torch.arange(n_win, device=dev).repeat_interleave(n)
    seg_flat = segment_ids.to(torch.int64).repeat(n_win)
    key = (win_idx * n_segments + seg_flat) * n_buckets + digits.T.reshape(-1)
    key, order = torch.sort(key, stable=True)
    pts = map_point(lambda a: a[order % n], points)

    total = key.shape[0]
    shift = 1
    while shift < total:
        lo = map_point(lambda a: a[:-shift], pts)
        hi = map_point(lambda a: a[shift:], pts)
        same = key[shift:] == key[:-shift]
        new_hi = C.point_select(f, same, C.point_add(f, lo, hi), hi)
        pts = zip_point(lambda a, b: torch.cat((a[:shift], b), 0), pts, new_hi)
        shift *= 2

    # run tails -> dense bucket table (unique targets)
    table_size = n_win * n_segments * n_buckets
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    tails = torch.nonzero(last).squeeze(1)
    table = _identity_like(f, (table_size,), dev)
    table = zip_point(lambda t, v: t.index_copy_(0, key[tails], v[tails]), table, pts)
    table = map_point(lambda a: a.reshape(n_win, n_segments, n_buckets, *a.shape[1:]), table)

    # suffix sum over buckets b = 2^w - 1 .. 1 (digit 0 dropped), batched
    # over [n_win, n_segments]
    running = _identity_like(f, (n_win, n_segments), dev)
    acc = running
    for b in range(n_buckets - 1, 0, -1):
        running = C.point_add(f, running, map_point(lambda a, b=b: a[:, :, b], table))
        acc = C.point_add(f, acc, running)

    # Horner across windows, most significant first: acc = 2^w acc + W
    out = map_point(lambda a: a[n_win - 1], acc)
    for w in range(n_win - 2, -1, -1):
        for _ in range(window):
            out = C.point_double(f, out)
        out = C.point_add(f, out, map_point(lambda a, w=w: a[w], acc))
    return out


def windowed_joint_mul(f: FieldOps, fr_ctx: ModCtx, points, scalars, nbits: int = 255, window: int = 4):
    """out[v] = sum_j scalars[v, j] * points[v, j] — the threshold
    recombination shape (per validator, t share signatures scaled by
    255-bit Lagrange coefficients and summed), by Straus/windowed joint
    multiplication: per-lane tables of the first 2^w multiples, then ONE
    shared doubling chain per validator with t table-gather adds per window.

    points: projective point with batch (V, t); scalars raw Fr limbs
    (V, t, n_limbs). Returns a projective point with batch (V,)."""
    digits = _digits(fr_ctx, scalars, nbits, window)  # (V, t, n_win)
    v, t, n_win = digits.shape
    dev = scalars.device
    multiples = [C.point_identity(f, (v, t), dev), points]
    for _ in range(2, 1 << window):
        multiples.append(C.point_add(f, multiples[-1], points))
    table = zip_point(lambda *xs: torch.stack(torch.broadcast_tensors(*xs), 2), *multiples)
    rows = torch.arange(v, device=dev)
    acc = C.point_identity(f, (v,), dev)
    for win in range(n_win - 1, -1, -1):  # MSB window first
        for _ in range(window):
            acc = C.point_double(f, acc)
        for j in range(t):
            idx = digits[:, j, win]
            acc = C.point_add(f, acc, map_point(lambda a, j=j, idx=idx: a[rows, j, idx], table))
    return acc


def msm(f: FieldOps, fr_ctx: ModCtx, points, scalars, nbits=64, window=8):
    """Single-segment convenience: sum_i scalars[i] * points[i]."""
    n = scalars.shape[0]
    seg = torch.zeros(n, dtype=torch.int64, device=scalars.device)
    out = msm_segmented(f, fr_ctx, points, scalars, seg, 1, nbits=nbits, window=window)
    return map_point(lambda a: a[0], out)


_MSM_MODE: bool | None = None


def set_msm(mode: bool | None) -> None:
    """Force the grouped-RLC randomization and the threshold recombination
    onto (True) / off (False) the MSM kernels; None restores the default
    (on)."""
    global _MSM_MODE
    _MSM_MODE = mode


def msm_active() -> bool:
    if _MSM_MODE is not None:
        return _MSM_MODE
    return True


# Ceremony routing (DKG and resharing): the commitment evaluation picks
# Straus joint windowed mul or per-lane double-and-add, and the reshare MSM
# its Pippenger window width. Owned by core/autotune.KernelConfig, like
# set_msm; read at call time.
_CEREMONY_STRAUS: bool | None = None
_CEREMONY_WINDOW: int | None = None


def set_ceremony_straus(mode: bool | None) -> None:
    """Commitment-polynomial evaluation: Straus joint windowed mul (True)
    vs per-lane double-and-add (False); None restores the default (on)."""
    global _CEREMONY_STRAUS
    _CEREMONY_STRAUS = mode


def ceremony_straus_active() -> bool:
    if _CEREMONY_STRAUS is not None:
        return _CEREMONY_STRAUS
    return True


def set_ceremony_window(window: int | None) -> None:
    """Pippenger window width for the ceremony MSM (reshare pubshare
    combination); None restores the default (8)."""
    global _CEREMONY_WINDOW
    if window is not None and not 1 <= window <= 16:
        raise ValueError(f"ceremony MSM window out of range: {window}")
    _CEREMONY_WINDOW = window


def ceremony_window() -> int:
    if _CEREMONY_WINDOW is not None:
        return _CEREMONY_WINDOW
    return 8
