"""PyTorch/CUDA tbls backend: the batched device engine behind the
Implementation API.

The port of charon_tpu/tbls/tpu_impl.py's TPUImpl. Every public-point
operation runs through the batched engine (charon_tpu_torch/ops/blsops.py)
on one device, whose field multiplies are the hand-written kernels K1-K3
on a CUDA card. Single-item calls are batches of one; the *_batch entry
points take whole duty sets.

Host/device split:
  * secret material (keygen, Shamir split/recover, signing) stays on the
    host — the device only ever sees public points;
  * decode (point decompression, pubkey subgroup check) and hash-to-curve
    run on the host, cached; signature subgroup checks run on the device;
  * pairings, Lagrange recombination and point sums run on the device.

A device or kernel error propagates to the caller: this backend has no
ladder that catches it and carries on down a slower path.
"""

from __future__ import annotations

import collections
import threading
from typing import Mapping, NamedTuple, Sequence

from charon_tpu_torch.crypto import g1g2, h2c
from charon_tpu_torch.ops.blsops import BlsEngine
from charon_tpu_torch.tbls import Implementation, TblsError
from charon_tpu_torch.tbls.python_impl import PythonHost, sig_to_point


def _decode_pubkey_point(pubkey: bytes):
    """Decompress + subgroup-check a pubkey (uncached decode body)."""
    try:
        pt = g1g2.g1_from_bytes(pubkey, subgroup_check=True)
    except ValueError as e:
        raise TblsError(str(e)) from e
    if pt is None:
        raise TblsError("infinite public key")
    return pt


def _decode_msg_point(data: bytes):
    return h2c.hash_to_g2(data)


class _CacheInfo(NamedTuple):
    hits: int
    misses: int
    maxsize: int
    currsize: int


class PointCache:
    """Thread-safe LRU point cache with bulk insertion (the JAX package's
    tpu_impl.PointCache). Decode runs outside the lock, so concurrent
    misses of one key may decode twice but never block each other."""

    def __init__(self, decode, maxsize: int):
        self._decode = decode
        self._maxsize = maxsize
        self._data: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def __call__(self, key):
        with self._lock:
            try:
                val = self._data[key]
            except KeyError:
                self._misses += 1
            else:
                self._data.move_to_end(key)
                self._hits += 1
                return val
        val = self._decode(key)  # bigint work — never under the lock
        self.put(key, val)
        return val

    def put(self, key, value) -> None:
        """Insert without decoding."""
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._maxsize:
                self._data.popitem(last=False)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def cache_info(self) -> _CacheInfo:
        with self._lock:
            return _CacheInfo(self._hits, self._misses, self._maxsize, len(self._data))

    def cache_clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._hits = 0
            self._misses = 0


class TorchImpl(Implementation):
    """Batched device implementation.

    device: None means the CUDA card (and raises if there is none); tests
    pass "cpu". verify_inputs: when True (default), signature points are
    subgroup-checked on the device before use.
    """

    # Below this size the per-lane pairing check is used directly: RLC's
    # shared tail amortizes only over larger batches.
    RLC_MIN_BATCH = 16
    # At most this many distinct messages take the grouped RLC check (one
    # Miller pair per message); beyond it, the ungrouped RLC check.
    RLC_MAX_GROUPS = 8

    def __init__(self, device=None, verify_inputs: bool = True):
        self.engine = BlsEngine(device)
        self.verify_inputs = verify_inputs
        self._host = PythonHost()
        # Decompressed pubkeys and hashed messages cached by their bytes
        # (cluster pubshares and duty roots are small recurring sets).
        self.pubkey_points = PointCache(_decode_pubkey_point, 65536)
        self.msg_points = PointCache(_decode_msg_point, 16384)

    # -- host-side secret ops ---------------------------------------------

    def generate_secret_key(self) -> bytes:
        return self._host.generate_secret_key()

    def secret_to_public_key(self, secret: bytes) -> bytes:
        return self._host.secret_to_public_key(secret)

    def threshold_split(self, secret: bytes, total: int, threshold: int):
        return self._host.threshold_split(secret, total, threshold)

    def recover_secret(self, shares, total: int, threshold: int) -> bytes:
        return self._host.recover_secret(shares, total, threshold)

    def sign(self, secret: bytes, data: bytes) -> bytes:
        return self._host.sign(secret, data)

    # -- decode -----------------------------------------------------------

    def _sig_points(self, sigs: Sequence[bytes], what: str) -> list:
        """Decompress signatures on the host; subgroup-check them on the
        device when verify_inputs is set."""
        pts = self._decode_sigs(sigs, what)
        self._subgroup_check(pts, what)
        return pts

    @staticmethod
    def _decode_sigs(sigs: Sequence[bytes], what: str) -> list:
        pts = []
        for sig in sigs:
            pt = sig_to_point(sig, subgroup_check=False)
            if pt is None:
                raise TblsError(f"infinite {what}")
            pts.append(pt)
        return pts

    def _subgroup_check(self, pts: list, what: str) -> None:
        if self.verify_inputs and pts and not all(self.engine.subgroup_check_g2_batch(pts)):
            raise TblsError(f"{what} not in G2 subgroup")

    # -- verification -----------------------------------------------------

    def verify(self, pubkey: bytes, data: bytes, sig: bytes) -> None:
        if not self.verify_batch([(pubkey, data, sig)])[0]:
            raise TblsError("signature verification failed")

    def verify_batch(self, items) -> list[bool]:
        if not items:
            return []
        n = len(items)
        pks: list = [None] * n
        msgs: list = [None] * n
        sigs: list = [None] * n
        ok = [True] * n
        for i, (pk, data, sig) in enumerate(items):
            try:
                pks[i] = self.pubkey_points(pk)
                msgs[i] = self.msg_points(data)
                sigs[i] = sig_to_point(sig, subgroup_check=False)
                if sigs[i] is None:
                    raise TblsError("infinite signature")
            except TblsError:
                ok[i] = False
                pks[i] = msgs[i] = sigs[i] = None
        accepted = n >= self.RLC_MIN_BATCH and self._rlc_accepts(items, pks, msgs, sigs)
        if accepted:
            # the whole batch verified in one shared-final-exp check;
            # decode failures passed None lanes, which contribute neutrally
            # and stay False below
            verified = [True] * n
        else:
            verified = self.engine.verify_batch(pks, msgs, sigs)
        in_subgroup = [True] * n
        live = [i for i in range(n) if sigs[i] is not None]
        if self.verify_inputs and live:
            checked = self.engine.subgroup_check_g2_batch([sigs[i] for i in live])
            for i, s in zip(live, checked):
                in_subgroup[i] = s
        return [o and v and s for o, v, s in zip(ok, verified, in_subgroup)]

    def _rlc_accepts(self, items, pks, msgs, sigs) -> bool:
        """Whole-batch RLC check, grouped by message when few distinct
        messages exist (every validator in a committee signs the same
        attestation data, so a slot's partials collapse to a handful of
        Miller pairs)."""
        distinct: dict[bytes, list[int]] = {}
        for i, (_, data, _) in enumerate(items):
            distinct.setdefault(data, []).append(i)
        if len(distinct) > self.RLC_MAX_GROUPS:
            return self.engine.verify_batch_rlc(pks, msgs, sigs)
        groups = []
        for data, lane_ids in distinct.items():
            lanes = [(pks[i], sigs[i]) for i in lane_ids if pks[i] is not None]
            if lanes:
                groups.append((self.msg_points(data), lanes))
        if not groups:
            return True  # nothing decodable; per-lane flags carry it
        return self.engine.verify_batch_grouped_rlc(groups)

    def verify_aggregate(self, pubkeys: Sequence[bytes], data: bytes, sig: bytes) -> None:
        if not pubkeys:
            raise TblsError("no public keys")
        pts = [self.pubkey_points(pk) for pk in pubkeys]
        [agg_pk] = self.engine.aggregate_pks_batch([pts])
        if agg_pk is None:
            raise TblsError("aggregate public key is infinite")
        [sig_pt] = self._sig_points([sig], "signature")
        [ok] = self.engine.verify_batch([agg_pk], [self.msg_points(data)], [sig_pt])
        if not ok:
            raise TblsError("aggregate signature verification failed")

    # -- aggregation ------------------------------------------------------

    def threshold_aggregate(self, partials: Mapping[int, bytes]) -> bytes:
        return self.threshold_aggregate_batch([partials])[0]

    def threshold_aggregate_batch(self, batch) -> list[bytes]:
        """The reference's checks in its order, validator by validator: an
        empty partial set, its indices, the host decode of its signatures,
        their subgroup check; the thresholds after every validator. One
        device subgroup check covers every validator decoded before the
        first host error, so its failure outranks that error, as it would
        have come first."""
        if not batch:
            return []
        point_batch, host_error = [], None
        for partials in batch:
            try:
                if not partials:
                    raise TblsError("no partial signatures")
                if any(i <= 0 for i in partials):
                    raise TblsError("share indices are 1-based")
                pts = self._decode_sigs(list(partials.values()), "partial signature")
            except TblsError as e:
                host_error = e
                break
            point_batch.append(dict(zip(partials, pts)))
        self._subgroup_check([pt for p in point_batch for pt in p.values()], "partial signature")
        if host_error is not None:
            raise host_error
        t = len(point_batch[0])
        if any(len(p) != t for p in point_batch):
            raise TblsError("inconsistent thresholds in batch")
        out = self.engine.threshold_aggregate_batch(point_batch)
        return [g1g2.g2_to_bytes(pt) for pt in out]

    def aggregate(self, sigs: Sequence[bytes]) -> bytes:
        return self.aggregate_batch([sigs])[0]

    def aggregate_batch(self, groups) -> list[bytes]:
        if not groups:
            return []
        point_groups = []
        for sigs in groups:
            if not sigs:
                raise TblsError("no signatures")
            point_groups.append(self._sig_points(sigs, "signature"))
        out = self.engine.aggregate_sigs_batch(point_groups)
        return [g1g2.g2_to_bytes(pt) for pt in out]
