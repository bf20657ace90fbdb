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
  * signature decode: with decode_mode "device" (the default on a CUDA
    card) one batched device program decompresses, sign-selects and
    psi-subgroup-checks every signature of a call (ops/decompress.py);
    with "python" (the default on the CPU) signatures decompress on the
    host and a separate device [r]P ladder checks the subgroup;
  * pubkeys and messages are cached per instance by their bytes; a miss
    decodes on the host, and `warm_point_caches` fills both caches in
    batched device programs (decompress_g1_batch, hash_to_g2_batch);
  * pairings, Lagrange recombination and point sums run on the device.

A device or kernel error propagates to the caller: this backend has no
ladder that catches it and carries on down a slower path.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Mapping, NamedTuple, Sequence

from charon_tpu_torch.crypto import g1g2, h2c
from charon_tpu_torch.ops.blsops import BlsEngine
from charon_tpu_torch.tbls import Implementation, TblsError
from charon_tpu_torch.tbls.python_impl import PythonImpl, sig_to_point


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
    subgroup-checked on the device before use. decode_mode: "device"
    decodes signatures in one batched device program, "python" on the
    host; "auto" (default) is "device" on a CUDA engine and "python" on
    the CPU.
    """

    # Below this size the per-lane pairing check is used directly: RLC's
    # shared tail amortizes only over larger batches.
    RLC_MIN_BATCH = 16
    # At most this many distinct messages take the grouped RLC check (one
    # Miller pair per message); beyond it, the ungrouped RLC check.
    RLC_MAX_GROUPS = 8

    def __init__(self, device=None, verify_inputs: bool = True, decode_mode: str = "auto"):
        if decode_mode not in ("auto", "device", "python"):
            raise ValueError(f"bad decode_mode {decode_mode!r}")
        self.engine = BlsEngine(device)
        self.verify_inputs = verify_inputs
        self.decode_mode = decode_mode
        self._host = PythonImpl()
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

    def _device_decode(self) -> bool:
        if self.decode_mode != "auto":
            return self.decode_mode == "device"
        return self.engine.device.type == "cuda"

    def _sig_points(self, sigs: Sequence[bytes], what: str) -> list:
        """Decode signatures, raising the first failing lane's error: in one
        device program (sqrt, sign, on-curve and, with verify_inputs, the
        psi subgroup check), or on the host with a separate device subgroup
        check."""
        if self._device_decode():
            pts, valid = self.engine.decompress_g2_batch(sigs, subgroup_check=self.verify_inputs)
            for pt, ok in zip(pts, valid):
                if not ok:
                    raise TblsError(f"{what} failed decompression or subgroup check")
                if pt is None:
                    raise TblsError(f"infinite {what}")
            return pts
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

    def _sig_point_groups(self, groups, what: str, host_sigs) -> list[list]:
        """Decode groups of signatures, raising the error that the
        reference's group-by-group walk (host checks, then _sig_points, for
        each group) raises first, in one decode: host_sigs(group) raises the
        group's host error or returns its signatures; every group before the
        first host error (host_sigs's, or a host decode's in python mode)
        decodes together, its failures raise in group and lane order, and
        then that host error."""
        device = self._device_decode()
        done, host_error = [], None
        for group in groups:
            try:
                sigs = host_sigs(group)
                done.append(sigs if device else self._decode_sigs(sigs, what))
            except TblsError as e:
                host_error = e
                break
        flat = [s for g in done for s in g]
        if device:
            flat = self._sig_points(flat, what)
        else:
            self._subgroup_check(flat, what)
        if host_error is not None:
            raise host_error
        out, k = [], 0
        for g in done:
            out.append(flat[k : k + len(g)])
            k += len(g)
        return out

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
        device_decode = self._device_decode()
        if device_decode:
            # one device program decodes and subgroup-checks every
            # signature; malformed lanes stay False (None lanes contribute
            # neutrally)
            sigs, sig_ok = self.engine.decompress_g2_batch(
                [sig for _, _, sig in items], subgroup_check=self.verify_inputs
            )
            for i in range(n):
                if not sig_ok[i] or sigs[i] is None:
                    ok[i] = False
                    sigs[i] = None
        for i, (pk, data, sig) in enumerate(items):
            try:
                pks[i] = self.pubkey_points(pk)
                msgs[i] = self.msg_points(data)
                if not device_decode:
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
        if self.verify_inputs and not device_decode and live:
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
        empty partial set, its indices, the decode of its signatures; the
        thresholds after every validator. One decode covers every
        validator before the first host error, and its failures outrank
        that error, as they would have come first."""
        if not batch:
            return []

        def host_sigs(partials):
            if not partials:
                raise TblsError("no partial signatures")
            if any(i <= 0 for i in partials):
                raise TblsError("share indices are 1-based")
            return list(partials.values())

        groups = self._sig_point_groups(batch, "partial signature", host_sigs)
        point_batch = [dict(zip(partials, pts)) for partials, pts in zip(batch, groups)]
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

        def host_sigs(sigs):
            if not sigs:
                raise TblsError("no signatures")
            return list(sigs)

        point_groups = self._sig_point_groups(groups, "signature", host_sigs)
        out = self.engine.aggregate_sigs_batch(point_groups)
        return [g1g2.g2_to_bytes(pt) for pt in out]


# Warm-up lanes a device program: big enough to amortize the launches of a
# decode, small enough that a warm chunk never holds the card for long.
WARMUP_CHUNK = 512


def warm_point_caches(
    impl: TorchImpl,
    pubkeys: Sequence[bytes] = (),
    messages: Sequence[bytes] = (),
    engine=None,
    device: bool | None = None,
    chunk: int = WARMUP_CHUNK,
) -> dict:
    """Fill `impl`'s pubkey and message caches in bulk, as a node does at
    boot with its cluster's key set.

    With `device` (None: as impl's decode_mode resolves), pubkeys decode
    through `engine`'s decompress_g1_batch (GLV subgroup check) and
    messages through its hash_to_g2_batch, `chunk` lanes a program (None:
    impl's own engine; the slot coalescer passes an adapter over the
    plane's warm-up programs); without, each decodes on the host. Lanes are unique keys not yet cached, at most each cache's
    capacity (the last ones; the rest count as `overflow`). Invalid lanes
    are not inserted: the on-demand decode raises their precise error when
    a key is used. A device error propagates: there is no step-down to the
    host decode.

    Returns per-cache lane counts by source (device/python/cached/invalid)
    and the wall `seconds`."""
    t0 = time.monotonic()
    if device is None:
        device = impl._device_decode()
    eng = engine or impl.engine
    stats = {name: {"device": 0, "python": 0, "cached": 0, "invalid": 0} for name in ("pubkey", "message")}

    def work(keys, cache, bulk, single, name):
        st = stats[name]
        uniq = list(dict.fromkeys(keys))
        todo = [k for k in uniq if k not in cache]
        st["cached"] += len(uniq) - len(todo)
        cap = cache.cache_info().maxsize
        if len(todo) > cap:
            # decoding past capacity would only evict its own results
            st["overflow"] = st.get("overflow", 0) + len(todo) - cap
            todo = todo[-cap:]
        for i in range(0, len(todo), chunk):
            batch = todo[i : i + chunk]
            if device:
                pts, valid = bulk(batch)
                for k, pt, ok in zip(batch, pts, valid):
                    if ok and pt is not None:
                        cache.put(k, pt)
                        st["device"] += 1
                    else:
                        st["invalid"] += 1
                continue
            for k in batch:
                try:
                    cache.put(k, single(k))
                    st["python"] += 1
                except TblsError:
                    st["invalid"] += 1

    work(
        pubkeys,
        impl.pubkey_points,
        lambda b: eng.decompress_g1_batch(b, subgroup_check=True),
        _decode_pubkey_point,
        "pubkey",
    )
    work(messages, impl.msg_points, eng.hash_to_g2_batch, _decode_msg_point, "message")
    stats["seconds"] = time.monotonic() - t0
    return stats
