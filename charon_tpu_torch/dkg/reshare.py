"""Batched key resharing: operator join/leave, threshold change, and
proactive rotation over many validators at once.

The port of charon_tpu/dkg/reshare.py, with its imports rewritten to the
port's crypto/ and eth2util/ copies.

Protocol (Desmedt–Jajodia resharing, the standard re-randomization of a
Shamir sharing without reconstructing the secret): each DEALER i from
the old operator set takes its live share s_i and, per validator, deals
a fresh degree-(t_new - 1) polynomial g_i with g_i(0) = s_i — Feldman
commitments D_ik = [g_ik] G broadcast, sub-shares g_i(j) sent privately
to each new node j. Each RECEIVER j then

  1. binds every dealer's commitment vector to the LIVE key:
     D_i0 must equal dealer i's existing pubshare (so a dealer cannot
     reshare a different secret), and sum_i lambda_i D_i0 must equal
     the group pubkey (the group key is provably unchanged);
  2. verifies its sub-shares against the commitments:
     [g_i(j)] G == sum_k D_ik j^k — the commitment_eval_batch /
     g1_gen_mul_batch device kernels, the same program family the FROST
     ceremony uses;
  3. re-interpolates: new share s'_j = sum_i lambda_i g_i(j) where
     lambda are the Lagrange coefficients AT ZERO over the dealer index
     set (host-side — sub-shares are secrets);
  4. derives every new node's pubshare without any secret:
     P'_m = sum_{i,k} (lambda_i m^k) D_ik — one segmented Pippenger MSM
     over all (validator, m) segments (blsops.g1_msm_batch), with the
     m = 0 segment doubling as the group-key consistency check.

Old shares keep satisfying the OLD polynomial — unusability of stale
shares is enforced at the cluster layer: the rotated pubshare registry
makes the verifier reject partials signed with pre-reshare shares.

Secret material (old shares, dealt polynomials, sub-shares, new shares)
never leaves the host; only commitments and derived public shares ride
the device. Abort semantics: ANY verification failure raises
ReshareError before any output is assembled — there is no partial
success, and disk output (write_reshare_outputs) stages into a temp
directory and renames, so a crash mid-ceremony leaves the old key
state untouched.
"""

from __future__ import annotations

import asyncio
import secrets as _secrets
from dataclasses import dataclass, field

from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.crypto.g1g2 import (
    G1_GEN,
    g1_add,
    g1_in_subgroup,
    g1_is_on_curve,
    g1_mul,
)
from charon_tpu_torch.crypto.shamir import lagrange_coeffs_at_zero


class ReshareError(Exception):
    """Typed failure for any reshare abort (verification, transport,
    parameter). Carries NO secret material by construction — messages
    name peers/validators, never share values."""


@dataclass(frozen=True)
class ReshareConfig:
    """Public parameters of one resharing ceremony.

    old_indices/new_indices are 1-based Shamir x-coordinates; overlap is
    allowed and is the common case (join/leave/rotate keep most nodes).
    Dealers are the old nodes that participate; any subset of
    old_indices of size >= t_old re-shares the same key."""

    old_indices: tuple
    new_indices: tuple
    t_old: int
    t_new: int
    num_validators: int
    ctx: bytes = b""

    def __post_init__(self):
        old = tuple(self.old_indices)
        new = tuple(self.new_indices)
        if len(set(old)) != len(old) or len(set(new)) != len(new):
            raise ReshareError("duplicate share indices")
        if any(i < 1 for i in old + new):
            raise ReshareError("share indices are 1-based")
        if not 1 < self.t_old <= len(old):
            raise ReshareError("bad old threshold")
        if not 1 < self.t_new <= len(new):
            raise ReshareError("bad new threshold")
        if self.num_validators < 1:
            raise ReshareError("need at least one validator")


@dataclass(frozen=True)
class ReshareBroadcast:
    """Per (dealer, validator): Feldman commitments to the dealt
    polynomial — t_new G1 points, D_0 = [old share] G (the dealer's
    live pubshare)."""

    commitments: tuple


@dataclass(frozen=True)
class ReshareShares:
    """Secret sub-shares g_i(j) a dealer sends one recipient, one per
    validator ceremony. MUST travel an authenticated private channel.

    repr=False: the auto-repr would dump raw sub-share scalars into any
    log line or traceback that formats the object (secret-flow lint)."""

    shares: tuple = field(repr=False)  # num_validators scalars


@dataclass(frozen=True)
class ReshareResult:
    """One validator's post-reshare state for the local node."""

    group_pubkey: object  # G1 affine — UNCHANGED by the reshare
    # repr=False: a formatted result names the ceremony, never the
    # long-lived secret share (secret-flow lint)
    secret_share: int = field(repr=False)
    pubshares: dict  # new share idx -> G1 affine pubshare


class ReshareDealer:
    """Dealer side: re-shares this node's live shares to the new set."""

    def __init__(self, idx: int, cfg: ReshareConfig, share_secrets, rand=None):
        if idx not in cfg.old_indices:
            raise ReshareError(f"dealer index {idx} not in the old set")
        if len(share_secrets) != cfg.num_validators:
            raise ReshareError("one old share per validator required")
        self.idx = idx
        self.cfg = cfg
        randfn = rand or (lambda: _secrets.randbelow(R - 1) + 1)
        # per validator: fresh polynomial with g(0) = the live old share
        self._polys = [
            [int(s) % R] + [randfn() for _ in range(cfg.t_new - 1)]
            for s in share_secrets
        ]

    def round1(self):
        """-> (per-validator ReshareBroadcast, {new idx: ReshareShares})."""
        broadcasts = [
            ReshareBroadcast(
                commitments=tuple(g1_mul(G1_GEN, c) for c in poly)
            )
            for poly in self._polys
        ]
        shares = {
            j: ReshareShares(
                shares=tuple(_poly_eval(poly, j) for poly in self._polys)
            )
            for j in self.cfg.new_indices
        }
        return broadcasts, shares


def _poly_eval(poly, x: int) -> int:
    acc = 0
    for c in reversed(poly):
        acc = (acc * x + c) % R
    return acc


class ReshareReceiver:
    """Receiver side: verifies dealt material and derives the new share
    + the full new pubshare map for every validator."""

    def __init__(self, idx: int, cfg: ReshareConfig):
        if idx not in cfg.new_indices:
            raise ReshareError(f"receiver index {idx} not in the new set")
        self.idx = idx
        self.cfg = cfg

    # -- structural + binding checks (host, cheap) -----------------------

    def _check_structure(self, broadcasts, old_pubshares, group_pubkeys):
        cfg = self.cfg
        dealers = sorted(broadcasts)
        if len(dealers) < cfg.t_old:
            raise ReshareError(
                f"{len(dealers)} dealers < old threshold {cfg.t_old}"
            )
        if not set(dealers) <= set(cfg.old_indices):
            raise ReshareError("dealer outside the old operator set")
        for i in dealers:
            blist = broadcasts[i]
            if len(blist) != cfg.num_validators:
                raise ReshareError(
                    f"dealer {i}: {len(blist)} ceremonies, want "
                    f"{cfg.num_validators}"
                )
            for v, b in enumerate(blist):
                if len(b.commitments) != cfg.t_new:
                    raise ReshareError(
                        f"dealer {i} validator {v}: "
                        f"{len(b.commitments)} commitments, want "
                        f"t_new={cfg.t_new}"
                    )
                for pt in b.commitments:
                    if pt is None or not (
                        g1_is_on_curve(pt) and g1_in_subgroup(pt)
                    ):
                        raise ReshareError(
                            f"dealer {i} validator {v}: commitment "
                            "not in G1"
                        )
                # the binding that makes resharing ≠ a fresh DKG: the
                # constant term must be the dealer's LIVE pubshare
                if b.commitments[0] != old_pubshares[v].get(i):
                    raise ReshareError(
                        f"dealer {i} validator {v}: commitment does "
                        "not bind to the live pubshare"
                    )
        if len(group_pubkeys) != cfg.num_validators:
            raise ReshareError("one group pubkey per validator required")
        return dealers

    # -- round 2 ---------------------------------------------------------

    def round2(
        self,
        broadcasts: dict,
        my_shares: dict,
        old_pubshares,
        group_pubkeys,
        engine=None,
        metrics=None,
    ):
        """broadcasts: dealer idx -> per-validator ReshareBroadcast;
        my_shares: dealer idx -> ReshareShares addressed to us;
        old_pubshares: per validator {old idx: G1 affine};
        group_pubkeys: per validator G1 affine.
        Returns per-validator ReshareResult."""
        cfg = self.cfg
        dealers = self._check_structure(
            broadcasts, old_pubshares, group_pubkeys
        )
        if sorted(my_shares) != dealers:
            raise ReshareError("sub-share set does not match dealer set")
        for i in dealers:
            sh = my_shares[i].shares
            if len(sh) != cfg.num_validators or not all(
                isinstance(s, int) and 0 <= s < R for s in sh
            ):
                raise ReshareError(f"dealer {i}: malformed sub-shares")

        self._verify_subshares(broadcasts, my_shares, dealers, engine, metrics)

        # Lagrange at zero over the dealer set: public coefficients.
        lam = lagrange_coeffs_at_zero(dealers)

        pubshare_rows = self._derive_pubshares(
            broadcasts, dealers, lam, group_pubkeys, engine, metrics
        )

        results = []
        for v in range(cfg.num_validators):
            # host-side: sub-shares are secrets
            new_share = 0
            for i in dealers:
                new_share = (
                    new_share + lam[i] * my_shares[i].shares[v]
                ) % R
            results.append(
                ReshareResult(
                    group_pubkey=group_pubkeys[v],
                    secret_share=new_share,
                    pubshares=pubshare_rows[v],
                )
            )

        # self-consistency: our derived pubshare must be [new share] G
        if engine is not None:
            mine = engine.g1_gen_mul_batch(
                [r.secret_share for r in results]
            )
        else:
            mine = [g1_mul(G1_GEN, r.secret_share) for r in results]
        for v, (r, m) in enumerate(zip(results, mine)):
            if r.pubshares[self.idx] != m:
                raise ReshareError(
                    f"validator {v}: derived share does not match the "
                    "derived pubshare"
                )
        return results

    def _verify_subshares(self, broadcasts, my_shares, dealers, engine, metrics):
        """[g_i(j)] G == sum_k D_ik j^k per (dealer, validator)."""
        cfg = self.cfg
        tasks = []  # (i, v, sub-share)
        for i in dealers:
            for v in range(cfg.num_validators):
                tasks.append((i, v, my_shares[i].shares[v]))
        if engine is not None:
            lhs = engine.g1_gen_mul_batch([s for (_, _, s) in tasks])
            rhs = engine.commitment_eval_batch(
                [broadcasts[i][v].commitments for (i, v, _) in tasks],
                [self.idx] * len(tasks),
                cfg.t_new,
            )
            path = "device"
        else:
            lhs = [g1_mul(G1_GEN, s) for (_, _, s) in tasks]
            rhs = []
            for i, v, _ in tasks:
                acc = None
                xpow = 1
                for c in broadcasts[i][v].commitments:
                    acc = g1_add(acc, g1_mul(c, xpow))
                    xpow = xpow * self.idx % R
                rhs.append(acc)
            path = "host"
        if metrics is not None:
            metrics.observe_dkg_verify("reshare_share", path, len(tasks))
        for (i, v, _), l, r in zip(tasks, lhs, rhs):
            if l != r:
                raise ReshareError(
                    f"invalid sub-share from dealer {i} (validator {v})"
                )

    def _derive_pubshares(
        self, broadcasts, dealers, lam, group_pubkeys, engine, metrics
    ):
        """P'_m = sum_{i,k} (lambda_i m^k) D_ik for every new node m,
        plus the m = 0 segment == group pubkey consistency check.

        Device path: ONE segmented Pippenger MSM over all
        (validator, m) segments — q*t_new points each, full-width
        combined scalars lambda_i * m^k mod r (all public)."""
        cfg = self.cfg
        evals = [0] + list(cfg.new_indices)  # m = 0 first: group-key check
        if engine is not None:
            points, scalars, seg_ids = [], [], []
            seg = 0
            for v in range(cfg.num_validators):
                for m in evals:
                    for i in dealers:
                        xpow = 1
                        for c in broadcasts[i][v].commitments:
                            points.append(c)
                            scalars.append(lam[i] * xpow % R)
                            xpow = xpow * m % R
                    seg += 1
                    seg_ids.extend(
                        [seg - 1] * (len(dealers) * cfg.t_new)
                    )
            out = engine.g1_msm_batch(
                points, scalars, seg_ids, seg
            )
            if metrics is not None:
                metrics.observe_dkg_verify(
                    "reshare_pubshare", "device", len(points)
                )
            rows = []
            width = len(evals)
            for v in range(cfg.num_validators):
                lane = out[v * width : (v + 1) * width]
                if lane[0] != group_pubkeys[v]:
                    raise ReshareError(
                        f"validator {v}: resharing changed the group key"
                    )
                rows.append(dict(zip(cfg.new_indices, lane[1:])))
            return rows
        # host fallback: same math, sequential
        rows = []
        for v in range(cfg.num_validators):
            lane = {}
            for m in evals:
                acc = None
                for i in dealers:
                    xpow = 1
                    for c in broadcasts[i][v].commitments:
                        acc = g1_add(acc, g1_mul(c, lam[i] * xpow % R))
                        xpow = xpow * m % R
                lane[m] = acc
            if metrics is not None:
                metrics.observe_dkg_verify(
                    "reshare_pubshare",
                    "host",
                    len(evals) * len(dealers) * cfg.t_new,
                )
            if lane[0] != group_pubkeys[v]:
                raise ReshareError(
                    f"validator {v}: resharing changed the group key"
                )
            rows.append({m: lane[m] for m in cfg.new_indices})
        return rows


# ---------------------------------------------------------------------------
# Lockstep round runner and in-memory transport (tests, simnet, CLI)
# ---------------------------------------------------------------------------


async def run_reshare_parallel(
    transport,
    idx: int,
    cfg: ReshareConfig,
    old_pubshares,
    group_pubkeys,
    share_secrets=None,
    engine=None,
    metrics=None,
):
    """One node's side of the resharing ceremony.

    A node acts as dealer (it holds old shares: `share_secrets` given),
    receiver (idx in cfg.new_indices), or both — the overlap case.
    transport duck-type: round1(broadcasts, shares_by_peer) ->
    (all_broadcasts, my_shares); a leaving node passes through round1
    and returns [] (it receives nothing).
    """
    dealer = (
        ReshareDealer(idx, cfg, share_secrets)
        if share_secrets is not None
        else None
    )
    broadcasts, shares = dealer.round1() if dealer else ([], {})
    all_bcasts, my_shares = await transport.round1(broadcasts, shares)
    if idx not in cfg.new_indices:
        return []  # leaving node: dealt and is done
    receiver = ReshareReceiver(idx, cfg)
    return receiver.round2(
        all_bcasts,
        my_shares,
        old_pubshares,
        group_pubkeys,
        engine=engine,
        metrics=metrics,
    )


class MemReshareTransport:
    """In-memory lockstep transport: `dealer_indices` publish, every
    new-set node collects. `timeout` bounds the barrier wait so a
    crashed peer aborts the ceremony cleanly (ReshareError) instead of
    hanging it; `crash` simulates a dealer dying before publishing."""

    def __init__(self, dealer_indices, timeout: float = 30.0, crash=()):
        self.dealers = tuple(sorted(dealer_indices))
        self.timeout = timeout
        self.crash = frozenset(crash)
        self._bcasts: dict[int, list] = {}
        self._shares: dict[int, dict] = {}
        self._done = asyncio.Event()

    def participant(self, idx: int) -> "_MemResharePort":
        return _MemResharePort(self, idx)


class _MemResharePort:
    def __init__(self, net: MemReshareTransport, idx: int):
        self.net = net
        self.idx = idx

    async def round1(self, broadcasts, shares):
        net = self.net
        if self.idx in net.crash:
            raise ReshareError(f"peer {self.idx} crashed mid-reshare")
        if broadcasts:
            net._bcasts[self.idx] = broadcasts
            net._shares[self.idx] = shares
        live = [d for d in net.dealers if d not in net.crash]
        if set(net._bcasts) >= set(live):
            net._done.set()
        try:
            await asyncio.wait_for(net._done.wait(), net.timeout)
        except asyncio.TimeoutError:
            missing = sorted(set(net.dealers) - set(net._bcasts))
            raise ReshareError(
                f"reshare round 1 timed out waiting for dealers {missing}"
            ) from None
        if set(net._bcasts) != set(net.dealers):
            missing = sorted(set(net.dealers) - set(net._bcasts))
            raise ReshareError(
                f"dealers {missing} never published — aborting"
            )
        my_shares = {
            i: net._shares[i][self.idx]
            for i in net._shares
            if self.idx in net._shares[i]
        }
        return dict(net._bcasts), my_shares


# ---------------------------------------------------------------------------
# Atomic disk handoff
# ---------------------------------------------------------------------------


def write_reshare_outputs(data_dir, results, pubshare_hexes=None):
    """Persist post-reshare keystores with NO torn intermediate state:
    everything stages into a sibling temp directory, then one rename
    swaps it in (the old validator_keys stays intact until the swap).
    Returns the path of the replaced (stale) key directory so callers
    can archive or shred it."""
    import os
    from pathlib import Path

    from charon_tpu_torch.eth2util import keystore

    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    share_secrets = [
        (r.secret_share % (1 << 256)).to_bytes(32, "big") for r in results
    ]
    stage = data_dir / f".reshare-stage-{os.getpid()}"
    if stage.exists():
        import shutil

        shutil.rmtree(stage)
    # keystore I/O IS the reshare's output: shares leave only as
    # EIP-2335-encrypted keystores
    # lint: allow(secret-flow)
    keystore.store_keys(share_secrets, stage, pubkeys=pubshare_hexes)
    final = data_dir / "validator_keys"
    stale = data_dir / "validator_keys.pre-reshare"
    if stale.exists():
        import shutil

        shutil.rmtree(stale)
    if final.exists():
        os.replace(final, stale)
    os.replace(stage, final)
    return stale if stale.exists() else None
