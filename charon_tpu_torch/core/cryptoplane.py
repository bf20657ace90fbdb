"""Slot-tick coalescer: ONE plane program per flush for the whole node's
concurrent crypto work, with a pipelined host plane.

The port of charon_tpu/core/cryptoplane.py. Launching a device program
costs milliseconds while extra lanes in a launched batch cost
microseconds, so the win is batching ACROSS concurrent duties, not only
within one. SlotCoalescer is that batching point. Components submit work
from the event loop and await results; submissions arriving within one
coalescing window are merged:

  * verify lanes (pk, root, sig) from ParSigEx inbound sets, the
    ValidatorAPI's pubshare checks and SigAgg, concatenated into one RLC
    verify (`SlotCryptoPlane.verify_packed[_parsed]`);
  * threshold recombination jobs [V, t] from SigAgg, concatenated along
    the validator axis into one recombine-and-verify step
    (`SlotCryptoPlane.recombine_packed[_parsed]`).

Pipeline: a flush passes through three host/device stages, so host work
overlaps device work and the event loop never runs bigint math:

      submit ──► decode pool ──► window ──► pack (decode pool)
                 (cache lookups,                 │
                  parse/sqrt off                 ▼
                  the loop)              device lane (1 thread)

  * DECODE: pubkeys and messages come from the TorchImpl point caches;
    signatures are parsed (decode_mode "device": the flush program
    decompresses them) or decompressed on the host ("python"). Items
    ship to a ThreadPoolExecutor in chunks.
  * PACK: once a window closes, tensor packing and the RLC randomness run
    on the decode pool, off the event loop.
  * DEVICE: one serialized worker thread dispatches the plane's programs.

The window adapts: it grows toward `window_max` under sustained
multi-job load and decays back to the base once traffic thins; a
submission carrying a duty deadline pulls the flush earlier. A window
whose time is up while the device lane still runs the previous flush
stays open until the lane is free: the lane runs one flush at a time, so
every submission arriving meanwhile rides the next flush instead of
queueing a flush of its own behind it. (The JAX package queues one flush
a window; on this engine a program costs seconds whatever its lanes, so
queued windows multiply the device time a slot takes.)

Malformed encodings never reach the device: those lanes fail on the
host and are left out of the batch. A device or pack error fails every
waiter of that flush with TblsError carrying the cause; there is no
degrade ladder (no decode step-down, no msm-off rebuild, no host oracle),
and the next flush runs normally.

The plane needs `t`, `verify_host` and `recombine_host`; planes that
also have the packed two-stage API (`pack_verify_inputs`/`verify_packed`,
`pack_inputs`/`recombine_packed`) get the pipelined pack stage, and the
parsed API (`*_parsed`) the device decode.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import time
from dataclasses import dataclass
from typing import Sequence

import torch

from charon_tpu_torch.crypto import g1g2
from charon_tpu_torch.ops import decompress as _dec
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls import torch_impl
from charon_tpu_torch.tbls.python_impl import sig_to_point


@dataclass
class _VerifyJob:
    lanes: list  # [(pk_pt, msg_pt, sig_pt | ParsedPoint) | None]: None = host decode fail
    fut: asyncio.Future
    decode_delays: tuple = ()  # decode-pool queue delay per chunk
    decode_spans: tuple = ()  # wall-clock (start, end) per decode chunk
    parent: tuple | None = None  # submitter's (trace_id, span_id)
    tenant: str | None = None  # submitting tenant


@dataclass
class _RecombineJob:
    # all rows [V][t] / [V]; rows with decode failures are pre-failed
    pubshares: list
    msgs: list
    partials: list
    group_pks: list
    indices: list
    prefail: list  # [V] bool: True fails the row without the device
    fut: asyncio.Future
    decode_delays: tuple = ()
    decode_spans: tuple = ()
    parent: tuple | None = None
    tenant: str | None = None


@dataclass(frozen=True)
class FlushStats:
    """Per-flush pipeline observability, delivered to `stats_hook` from the
    device worker thread (thread-safe sinks only). The stage spans
    (wall-clock `time.time()` windows) and the submitters' trace contexts
    in `parents` are what a tracer needs to bridge the flush into the duty
    traces whose work it merged."""

    jobs: int
    lanes: int
    flush_seconds: float  # device-lane wall clock (pack excluded)
    window: float  # adaptive window in force when the flush armed
    inflight: int  # device-lane depth at submit (1: windows wait for a free lane)
    pad_lanes: int | None  # bucket-padding lanes shipped (packed path)
    padded_lanes: int | None  # total lanes after bucket padding
    decode_queue_seconds: tuple[float, ...]  # decode-pool queue delays
    # the JAX package's host-oracle rung; the port has none, so it is
    # always False (kept for the consumers that read it)
    fallback: bool = False
    # decode-source breakdown: point lookups served by the point caches
    # (pubkeys, messages, pubshares) against signature lanes decompressed
    # on the device (parsed lanes shipped to a decode-fused program) or on
    # the host
    decode_mode: str = "python"
    decode_cache_lanes: int = 0
    decode_device_lanes: int = 0
    decode_python_lanes: int = 0
    # wall-clock stage windows of THIS flush's pipeline pass
    decode_spans: tuple[tuple[float, float], ...] = ()  # per decode chunk
    pack_span: tuple[float, float] | None = None
    device_span: tuple[float, float] | None = None
    # (trace_id, span_id) captured from each submission's active span
    parents: tuple[tuple[str, str], ...] = ()
    # live lanes per submitting tenant: (tenant_id, lanes) pairs for the
    # jobs that carried a tenant tag
    tenant_lanes: tuple[tuple[str, int], ...] = ()


class PlaneConfigError(ValueError):
    """A crypto-plane configuration this host cannot run: a deploy
    mistake, distinguishable from wire and crypto failures."""


def kernel_inventory(device=None) -> dict:
    """Every registered device-program family behind this plane: the
    engine's (ops/blsops) and the slot plane's `mesh/*` programs, the
    latter registered on a one-shard plane on `device` (None: the card).
    The startup tuner records the names in its profile. Returns {name:
    {"sentinel": bool}}."""
    from charon_tpu_torch.ops import blsops
    from charon_tpu_torch.parallel import mesh as _mesh

    _mesh.register_analysis_families(None if device is None else [device])
    return {name: {"sentinel": fam.sentinel} for name, fam in sorted(blsops.kernel_families().items())}


def _decode_sig(sig: bytes):
    pt = sig_to_point(sig, subgroup_check=False)
    if pt is None:
        raise TblsError("infinite signature")
    return pt


def _no_submit_ctx():
    return None


class SlotCoalescer:
    """Merges concurrent verify / recombine submissions into single plane
    programs (see the module docstring).

    window: base seconds to wait after the first submission before
    flushing; the adaptive controller moves the live window within
    [window, window_max] under load, and deadlines cap it down to
    window_min.
    decode_workers: decode/pack pool size; 0 disables the pipeline (decode
    runs on the caller, packing on the device lane). The pool is created
    on first use, so an idle or disabled coalescer owns no threads.
    decode_mode: "device" ships parsed signature lanes to the plane's
    decode-fused programs, "python" decompresses on the host; "auto"
    (default) is "device" when the plane's first device is CUDA.
    impl: the TorchImpl whose point caches serve pubkeys and messages
    (None: a fresh one on the plane's first device).
    submit_ctx: callable returning the submitting context's (trace_id,
    span_id), carried into FlushStats.parents (None: no tracer).
    flushes / coalesced_flushes / lanes_flushed / failed_flushes:
    observability counters.
    """

    # decode-pool chunking: large enough to amortize executor submission,
    # small enough to spread one burst across the workers
    DECODE_CHUNK = 16
    # adaptive window controller: grow when a flush coalesced >= 2 jobs or
    # carried a burst, decay back to the base window otherwise
    WINDOW_GROW = 1.5
    WINDOW_DECAY = 0.75
    GROW_LANES = 64
    # graded deadline shrink: spend at most this fraction of the time left
    # before the duty deadline on coalescing
    DEADLINE_WINDOW_FRAC = 0.01

    def __init__(
        self,
        plane,
        window: float = 0.02,
        metrics_hook=None,
        window_min: float = 0.002,
        window_max: float = 0.08,
        decode_workers: int = 4,
        stats_hook=None,
        decode_mode: str = "auto",
        impl=None,
        submit_ctx=None,
    ):
        if decode_mode not in ("auto", "device", "python"):
            raise PlaneConfigError(f"bad decode_mode {decode_mode!r}")
        self.plane = plane
        self.impl = impl if impl is not None else torch_impl.TorchImpl(device=getattr(plane, "device", None))
        self.window = window
        self.window_min = min(window_min, window)
        self.window_max = max(window_max, window)
        self.decode_workers = decode_workers
        self.decode_mode = decode_mode
        self._decode_live: str | None = None  # resolved on first use
        self._submit_ctx = submit_ctx or _no_submit_ctx
        self._closed = False
        self._verify_q: list[_VerifyJob] = []
        self._recombine_q: list[_RecombineJob] = []
        self._flush_task: asyncio.Task | None = None
        self._flush_at: float = 0.0  # monotonic flush target of the armed task
        self._flush_wake = asyncio.Event()
        self._queue_deadline: float | None = None  # monotonic, min over jobs
        self._wall_offset = 0.0  # wall -> monotonic, snapshotted per window
        # submissions mid-decode (closing windows wait for these)
        self._decode_tickets: set[asyncio.Future] = set()
        self._window_current = window
        # first-dispatch gate (the node wires the tuner's tune_done event
        # here): flushes queue behind it, and keep coalescing, until it
        # fires, so no flush runs under a transient trial KernelConfig.
        # None means no gating.
        self.dispatch_gate: asyncio.Event | None = None
        self.gated_flushes = 0  # flushes that waited on dispatch_gate
        # single-threaded device lane: a second window can elapse while a
        # program is still running; its flush QUEUES behind the first
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="crypto-plane")
        # decode/pack pool, created on first use
        self._decode_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self.flushes = 0
        self.coalesced_flushes = 0  # flushes that merged >= 2 jobs
        self.lanes_flushed = 0
        self.failed_flushes = 0  # flushes whose waiters got TblsError
        self.pad_lanes_flushed = 0  # bucket-padding lanes shipped
        self.held_flushes = 0  # windows held open for a busy device lane
        self._inflight = 0  # flushes inside the device lane
        self._lane_free: asyncio.Event | None = None  # set as a flush leaves the lane
        # called after each flush with (jobs, lanes), and with FlushStats:
        # both on the device worker thread (thread-safe sinks only)
        self.metrics_hook = metrics_hook
        self.stats_hook = stats_hook
        # bulk warm-up: called with the stats dict of every warm_caches()
        # pass (worker thread), and its counters
        self.warmup_hook = None
        self.warmups = 0
        self.warmup_lanes = 0

    @property
    def t(self) -> int:
        return self.plane.t

    # -- decode mode -------------------------------------------------------

    def _plane_has_packed_api(self) -> bool:
        return all(
            hasattr(self.plane, name)
            for name in (
                "pack_verify_inputs",
                "make_lane_rand",
                "verify_packed",
                "pack_inputs",
                "make_rand",
                "recombine_packed",
            )
        )

    def _plane_has_parsed_api(self) -> bool:
        return self._plane_has_packed_api() and all(
            hasattr(self.plane, name)
            for name in (
                "pack_verify_inputs_parsed",
                "verify_packed_parsed",
                "pack_inputs_parsed",
                "recombine_packed_parsed",
            )
        )

    def _decode_rung(self) -> str:
        """The decode mode in force, resolved once: "auto" means device when
        the plane's first device is CUDA; device needs the parsed plane API
        (test fakes without it stay on python)."""
        if self._decode_live is None:
            mode = self.decode_mode
            if not self._plane_has_parsed_api():
                mode = "python"
            elif mode == "auto":
                dev = getattr(self.plane, "device", None)
                mode = "device" if dev is not None and torch.device(dev).type == "cuda" else "python"
            self._decode_live = mode
        return self._decode_live

    @property
    def current_window(self) -> float:
        """The adaptive coalescing window currently in force."""
        return self._window_current

    def close(self) -> None:
        """Shut down the worker pools (idempotent). Late flushes fail their
        waiters fast."""
        self._closed = True
        self._executor.shutdown(wait=False)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False)
            self._decode_pool = None

    # -- decode pool (host stage 1) ---------------------------------------

    def _pool(self):
        if self._decode_pool is None:
            self._decode_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.decode_workers, thread_name_prefix="crypto-decode"
            )
        return self._decode_pool

    async def _map_offloop(self, fn, items: list):
        """Apply `fn` per item OFF the event loop: items ship to the decode
        pool in DECODE_CHUNK chunks. Returns (results, per-chunk queue
        delays, per-chunk wall-clock spans), which travel with the job so
        each flush's stats report its own decode timing. With the pool
        disabled (or closed) the map runs inline on the caller."""
        if self.decode_workers <= 0 or self._closed:
            # stage spans are attribution: wall-clock windows for traces
            w0 = time.time()  # lint: allow(monotonic-clock) — stage span: wall-clock trace attribution
            out = [fn(it) for it in items]
            return out, (), ((w0, time.time()),)  # lint: allow(monotonic-clock)
        loop = asyncio.get_running_loop()
        pool = self._pool()
        submitted = time.monotonic()

        def run_chunk(chunk):
            t0 = time.monotonic()
            w0 = time.time()  # lint: allow(monotonic-clock) — stage span: wall-clock trace attribution
            out = [fn(it) for it in chunk]
            return out, t0 - submitted, (w0, time.time())  # lint: allow(monotonic-clock)

        chunks = [items[i : i + self.DECODE_CHUNK] for i in range(0, len(items), self.DECODE_CHUNK)]
        parts = await asyncio.gather(*(loop.run_in_executor(pool, run_chunk, c) for c in chunks))
        return (
            [lane for part, _, _ in parts for lane in part],
            tuple(delay for _, delay, _ in parts),
            tuple(span for _, _, span in parts),
        )

    def _decode_verify_lane(self, item):
        """(pk, root, sig) bytes -> point triple, or None on any malformed
        encoding (the lane fails on the host and never ships)."""
        pk, root, sig = item
        try:
            return (self.impl.pubkey_points(pk), self.impl.msg_points(root), _decode_sig(sig))
        except (TblsError, ValueError):
            return None

    def _parse_verify_lane(self, item):
        """decode_mode "device" twin of _decode_verify_lane: the pubkey and
        message still come from the point caches, the signature is only
        PARSED (flags and range checks); the sqrt, sign, on-curve and
        subgroup checks run batched in the flush program. Lanes the parse
        rejects (malformed flags, x >= p, infinity) fail on the host."""
        pk, root, sig = item
        try:
            pk_pt, msg_pt = self.impl.pubkey_points(pk), self.impl.msg_points(root)
        except (TblsError, ValueError):
            return None
        parsed = _dec.parse_g2_lane(sig)
        if not parsed.ok or parsed.infinity:
            return None
        return (pk_pt, msg_pt, parsed)

    # -- submission APIs (event-loop side) --------------------------------

    async def verify(
        self,
        items: Sequence[tuple[bytes, bytes, bytes]],
        deadline: float | None = None,
        tenant: str | None = None,
    ) -> list[bool]:
        """Batch-verify (pubkey_bytes, signing_root, sig_bytes) lanes.
        Returns per-lane validity; malformed encodings are False.
        deadline: optional absolute wall-clock (time.time) duty deadline,
        which pulls the flush earlier when the window would overshoot it.
        tenant: optional tenant id, for per-flush attribution in
        FlushStats."""
        if not items:
            return []
        loop = asyncio.get_running_loop()
        # decode ticket: an armed flush whose window closes while this
        # submission is still decoding WAITS for it; otherwise a burst whose
        # cold-cache decode outlasts the window splits into one program per
        # submission
        ticket = loop.create_future()
        self._decode_tickets.add(ticket)
        try:
            decode_fn = self._parse_verify_lane if self._decode_rung() == "device" else self._decode_verify_lane
            lanes, delays, spans = await self._map_offloop(decode_fn, list(items))
            job = _VerifyJob(
                lanes=lanes,
                fut=loop.create_future(),
                decode_delays=delays,
                decode_spans=spans,
                parent=self._submit_ctx(),
                tenant=tenant,
            )
            self._verify_q.append(job)
            self._arm(deadline)
        finally:
            # resolve AFTER the append above (same synchronous block): the
            # waiting flush wakes only on the next scheduler turn, so the
            # job is in the collected queue
            self._decode_tickets.discard(ticket)
            if not ticket.done():
                ticket.set_result(None)
        return await job.fut

    async def recombine(
        self,
        pubshares: Sequence[Sequence[bytes]],
        roots: Sequence[bytes],
        partials: Sequence[Sequence[bytes]],
        group_pks: Sequence[bytes],
        indices: Sequence[Sequence[int]],
        deadline: float | None = None,
        tenant: str | None = None,
    ) -> tuple[list[bytes | None], list[bool]]:
        """Threshold-recombine and verify a duty's [V, t] workload. Returns
        ([V] group signature bytes or None, [V] ok flags)."""
        if not roots:
            return [], []
        t = self.plane.t
        device_decode = self._decode_rung() == "device"
        impl = self.impl

        def parse_partial(sig: bytes):
            parsed = _dec.parse_g2_lane(sig)
            if not parsed.ok or parsed.infinity:
                raise TblsError("malformed partial signature")
            return parsed

        def decode_row(row):
            ps_row, root, sig_row, gpk, idx_row = row
            try:
                if len(sig_row) != t or len(ps_row) != t or len(idx_row) != t:
                    raise TblsError(f"need exactly t={t} partials per lane")
                if any(i <= 0 for i in idx_row):
                    raise TblsError("share indices are 1-based")
                return (
                    [impl.pubkey_points(p) for p in ps_row],
                    impl.msg_points(root),
                    # device decode: partials ship PARSED (no field
                    # arithmetic here) and the flush program decompresses
                    # them; host-parse rejects prefail
                    [parse_partial(s) if device_decode else _decode_sig(s) for s in sig_row],
                    impl.pubkey_points(gpk),
                    list(idx_row),
                    False,
                )
            except (TblsError, ValueError):
                # prefail row: left out of the batch, failed on the host
                return (None, None, None, None, None, True)

        loop = asyncio.get_running_loop()
        ticket = loop.create_future()  # see verify() for the contract
        self._decode_tickets.add(ticket)
        try:
            rows, delays, spans = await self._map_offloop(
                decode_row, list(zip(pubshares, roots, partials, group_pks, indices))
            )
            ps_rows, msg_pts, sig_rows, gpk_pts, idx_rows, prefail = [list(col) for col in zip(*rows)]
            job = _RecombineJob(
                pubshares=ps_rows,
                msgs=msg_pts,
                partials=sig_rows,
                group_pks=gpk_pts,
                indices=idx_rows,
                prefail=prefail,
                fut=loop.create_future(),
                decode_delays=delays,
                decode_spans=spans,
                parent=self._submit_ctx(),
                tenant=tenant,
            )
            self._recombine_q.append(job)
            self._arm(deadline)
        finally:
            self._decode_tickets.discard(ticket)
            if not ticket.done():
                ticket.set_result(None)
        sigs_pts, oks = await job.fut
        return [g1g2.g2_to_bytes(pt) if pt is not None else None for pt in sigs_pts], oks

    # -- flush machinery ---------------------------------------------------

    def _arm(self, deadline: float | None = None) -> None:
        now = time.monotonic()
        new_window = self._flush_task is None or self._flush_task.done()
        if new_window:
            # duty deadlines are wall-clock but the flush timer runs on the
            # monotonic base: snapshot the wall -> monotonic offset ONCE a
            # window, so a host clock step mid-window cannot translate later
            # submissions' deadlines inconsistently
            self._wall_offset = now - time.time()  # lint: allow(monotonic-clock) — the one-shot wall->monotonic anchor
        if deadline is not None:
            dl_mono = max(now, deadline + self._wall_offset)
            if self._queue_deadline is None or dl_mono < self._queue_deadline:
                self._queue_deadline = dl_mono
        target = now + self._window_current
        if self._queue_deadline is not None:
            # graded shrink toward the deadline, never below window_min
            remaining = self._queue_deadline - now
            cap = max(self.window_min, remaining * self.DEADLINE_WINDOW_FRAC)
            target = min(target, now + cap)
        if new_window:
            self._flush_at = target
            # a fresh Event per armed task: asyncio primitives bind to the
            # running loop, and one coalescer may serve several loops
            self._flush_wake = asyncio.Event()
            self._flush_task = asyncio.create_task(self._flush_after_window())
        elif target < self._flush_at:
            # a tighter deadline arrived while the window timer sleeps:
            # pull the armed flush earlier (never later)
            self._flush_at = target
            self._flush_wake.set()

    def _fail(self, jobs, err: BaseException) -> None:
        """Fail every waiter of a flush with TblsError carrying `err`."""
        for job in jobs:
            if not job.fut.done():
                exc = TblsError(f"crypto plane flush failed: {type(err).__name__}: {err}")
                exc.__cause__ = err
                job.fut.set_exception(exc)

    async def _flush_after_window(self) -> None:
        while True:
            self._flush_wake.clear()
            remaining = self._flush_at - time.monotonic()
            if remaining <= 0:
                break
            try:
                await asyncio.wait_for(self._flush_wake.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                pass
        gate = self.dispatch_gate
        if gate is not None and not gate.is_set():
            # the startup tuner is still settling the kernel routing: queue
            # behind it; submissions arriving meanwhile join this flush
            self.gated_flushes += 1
            await gate.wait()
        if self._inflight:
            # the device lane still runs the previous flush: this window
            # stays open, and submissions arriving meanwhile join it
            self.held_flushes += 1
            while self._inflight:
                self._lane_free = asyncio.Event()
                await self._lane_free.wait()
        # submissions still mid-decode when the window closed join this
        # flush (ONE snapshot: later arrivals take the next window)
        pending = list(self._decode_tickets)
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        vq, self._verify_q = self._verify_q, []
        rq, self._recombine_q = self._recombine_q, []
        # new submissions from here on arm a fresh flush task, whose
        # decode stage overlaps this flush's device stage
        self._flush_task = None
        self._queue_deadline = None
        if not vq and not rq:
            return
        if self._closed:
            for job in [*vq, *rq]:
                if not job.fut.done():
                    job.fut.set_exception(TblsError("crypto plane closed"))
            return
        window_used = self._window_current
        self._adapt_window(vq, rq)
        loop = asyncio.get_running_loop()
        # this flush holds the device lane from here, its pack stage
        # included: a window closing meanwhile waits for it
        self._inflight += 1
        inflight = self._inflight
        try:
            # host stage 2: pack on the decode pool, off the event loop
            packed = None
            if self.decode_workers > 0 and self._plane_has_packed_api():
                packed = await loop.run_in_executor(self._pool(), self._pack_flush, vq, rq)
            vres, rres = await loop.run_in_executor(
                self._executor, self._run_device, vq, rq, packed, window_used, inflight
            )
        except Exception as e:  # noqa: BLE001 — fail the waiters, not the loop
            self.failed_flushes += 1
            self._fail([*vq, *rq], e)
            return
        finally:
            self._inflight -= 1
            if self._lane_free is not None:
                self._lane_free.set()
        for job, res in zip(vq, vres):
            if not job.fut.done():
                job.fut.set_result(res)
        for job, res in zip(rq, rres):
            if not job.fut.done():
                job.fut.set_result(res)

    def _adapt_window(self, vq, rq) -> None:
        """Sustained load (multi-job windows or lane bursts) grows the window
        toward window_max; light traffic decays it back to the base."""
        jobs = len(vq) + len(rq)
        lanes = sum(len(j.lanes) for j in vq) + sum(len(j.msgs) for j in rq)
        if jobs >= 2 or lanes >= self.GROW_LANES:
            self._window_current = min(self.window_max, self._window_current * self.WINDOW_GROW)
        else:
            self._window_current = max(self.window, self._window_current * self.WINDOW_DECAY)

    @staticmethod
    def _flat_verify_lanes(vq: list[_VerifyJob]) -> list:
        return [lane for job in vq for lane in job.lanes if lane is not None]

    @staticmethod
    def _live_recombine_rows(rq: list[_RecombineJob]):
        ps, msg, sig, gpk, idx = [], [], [], [], []
        for job in rq:
            for i in range(len(job.msgs)):
                if not job.prefail[i]:
                    ps.append(job.pubshares[i])
                    msg.append(job.msgs[i])
                    sig.append(job.partials[i])
                    gpk.append(job.group_pks[i])
                    idx.append(job.indices[i])
        return ps, msg, sig, gpk, idx

    def _pack_flush(self, vq, rq):
        """Decode-pool thread: tensor packing and RLC randomness for the
        whole flush. Returns (vpack, rpack, pack_span) for _run_device."""
        w0 = time.time()  # lint: allow(monotonic-clock) — pack span: wall-clock trace attribution
        plane = self.plane
        parsed = self._decode_rung() == "device"
        vpack = None
        flat = self._flat_verify_lanes(vq)
        if flat:
            pks, msgs, sigs = zip(*flat)
            pack = plane.pack_verify_inputs_parsed if parsed else plane.pack_verify_inputs
            vpack = (pack(pks, msgs, sigs), plane.make_lane_rand(len(flat)), len(flat))
        rpack = None
        ps, msg, sig, gpk, idx = self._live_recombine_rows(rq)
        if msg:
            pack = plane.pack_inputs_parsed if parsed else plane.pack_inputs
            rpack = (pack(ps, msg, sig, gpk, idx), plane.make_rand(len(msg)), len(msg))
        return vpack, rpack, (w0, time.time())  # lint: allow(monotonic-clock)

    # -- device side (worker thread) --------------------------------------

    def _verify_device(self, vq, vpack):
        """Verify stage on the device lane: (per-lane verdicts of the
        shipped lanes, lanes shipped after padding or None)."""
        plane = self.plane
        parsed = self._decode_rung() == "device"
        if vpack is not None:
            arrays, rand, n = vpack
            verify = plane.verify_packed_parsed if parsed else plane.verify_packed
            return verify(arrays, rand, n), self._packed_lane_count(arrays)
        flat = self._flat_verify_lanes(vq)
        if not flat:
            return [], None
        pks, msgs, sigs = zip(*flat)
        if parsed:
            arrays = plane.pack_verify_inputs_parsed(pks, msgs, sigs)
            return plane.verify_packed_parsed(arrays, plane.make_lane_rand(len(flat)), len(flat)), None
        return plane.verify_host(pks, msgs, sigs), None

    def _recombine_device(self, rq, rpack):
        """Recombine stage on the device lane: ((group sigs, oks) of the
        shipped rows, lanes shipped after padding or None)."""
        plane = self.plane
        parsed = self._decode_rung() == "device"
        if rpack is not None:
            arrays, rand, v = rpack
            recombine = plane.recombine_packed_parsed if parsed else plane.recombine_packed
            return recombine(arrays, rand, v), self._packed_lane_count(arrays)
        ps, msg, sig, gpk, idx = self._live_recombine_rows(rq)
        if not msg:
            return ([], []), None
        if parsed:
            args = plane.pack_inputs_parsed(ps, msg, sig, gpk, idx)
            return plane.recombine_packed_parsed(args, plane.make_rand(len(msg)), len(msg)), None
        return plane.recombine_host(ps, msg, sig, gpk, idx), None

    def _run_device(
        self, vq: list[_VerifyJob], rq: list[_RecombineJob], packed=None, window_used: float = 0.0, inflight: int = 1
    ):
        # counters update only after both stages succeeded
        t0 = time.monotonic()
        w0 = time.time()  # lint: allow(monotonic-clock) — device span: wall-clock trace attribution
        vpack, rpack, pack_span = packed if packed is not None else (None, None, None)
        lanes = 0
        pad_lanes = padded_lanes = 0 if packed is not None else None
        vres: list[list[bool]] = []
        if vq:
            oks, shipped = self._verify_device(vq, vpack)
            n = len(oks)
            if shipped is not None:
                pad_lanes += shipped - n
                padded_lanes += shipped
            it = iter(oks)
            vres = [[next(it) if lane is not None else False for lane in job.lanes] for job in vq]
            lanes += n
        rres: list[tuple[list, list[bool]]] = []
        if rq:
            (out_sigs, out_oks), shipped = self._recombine_device(rq, rpack)
            if shipped is not None:
                pad_lanes += shipped - len(out_oks)
                padded_lanes += shipped
            it_sig, it_ok = iter(out_sigs), iter(out_oks)
            for job in rq:
                sigs_pts: list = []
                oks: list[bool] = []
                for pf in job.prefail:
                    if pf:
                        sigs_pts.append(None)
                        oks.append(False)
                    else:
                        sigs_pts.append(next(it_sig))
                        oks.append(next(it_ok))
                rres.append((sigs_pts, oks))
            lanes += len(out_oks)
        mode, cache_n, device_n, python_n = self._decode_breakdown(vq, rq)
        self._account_flush(
            vq,
            rq,
            lanes,
            FlushStats(
                jobs=len(vq) + len(rq),
                lanes=lanes,
                flush_seconds=time.monotonic() - t0,
                window=window_used,
                inflight=inflight,
                pad_lanes=pad_lanes,
                padded_lanes=padded_lanes,
                decode_queue_seconds=tuple(d for job in [*vq, *rq] for d in job.decode_delays),
                decode_mode=mode,
                decode_cache_lanes=cache_n,
                decode_device_lanes=device_n,
                decode_python_lanes=python_n,
                decode_spans=tuple(s for job in [*vq, *rq] for s in job.decode_spans),
                pack_span=pack_span,
                device_span=(w0, time.time()),  # lint: allow(monotonic-clock)
                parents=tuple(job.parent for job in [*vq, *rq] if job.parent is not None),
                tenant_lanes=self._job_tenant_lanes(vq, rq),
            ),
        )
        return vres, rres

    @staticmethod
    def _packed_lane_count(arrays) -> int:
        """Leading-axis size of a packed batch = lanes after bucket padding
        (the live mask is the last element of every pack)."""
        return int(arrays[-1].shape[0])

    def _decode_breakdown(self, vq, rq) -> tuple[str, int, int, int]:
        """(mode, cache_lanes, device_lanes, python_lanes) of a flush:
        cache_lanes counts point lookups served by the point caches (pubkey
        and message a verify lane; pubshares, message and group pubkey a
        recombine row), device/python_lanes the signature lanes by where
        they decompress. A flush with no live signature lane reports the
        mode in force."""
        cache = device = python = 0
        for job in vq:
            for lane in job.lanes:
                if lane is None:
                    continue
                cache += 2
                if isinstance(lane[2], _dec.ParsedPoint):
                    device += 1
                else:
                    python += 1
        for job in rq:
            for i, pf in enumerate(job.prefail):
                if pf:
                    continue
                cache += len(job.pubshares[i]) + 2
                if isinstance(job.partials[i][0], _dec.ParsedPoint):
                    device += len(job.partials[i])
                else:
                    python += len(job.partials[i])
        if device:
            mode = "device"
        elif python:
            mode = "python"
        else:
            mode = self._decode_live or "python"
        return mode, cache, device, python

    @staticmethod
    def _job_tenant_lanes(vq, rq) -> tuple:
        """Live lanes per submitting tenant; untagged jobs contribute
        nothing."""
        per: dict[str, int] = {}
        for job in vq:
            if job.tenant is not None:
                per[job.tenant] = per.get(job.tenant, 0) + sum(1 for lane in job.lanes if lane is not None)
        for job in rq:
            if job.tenant is not None:
                per[job.tenant] = per.get(job.tenant, 0) + sum(1 for pf in job.prefail if not pf)
        return tuple(sorted(per.items()))

    def _account_flush(self, vq, rq, lanes: int, stats: FlushStats) -> None:
        self.lanes_flushed += lanes
        self.flushes += 1
        if stats.pad_lanes:
            self.pad_lanes_flushed += stats.pad_lanes
        if len(vq) + len(rq) >= 2:
            self.coalesced_flushes += 1
        if self.metrics_hook is not None:
            self.metrics_hook(len(vq) + len(rq), lanes)
        if self.stats_hook is not None:
            self.stats_hook(stats)

    # -- prewarm (startup) -------------------------------------------------

    async def prewarm(
        self,
        verify_lanes: Sequence[int] | None = None,
        recombine_lanes: Sequence[int] | None = None,
    ) -> list:
        """Run the canonical duty shapes on the device lane, so the first
        live slot pays neither the kernel build nor first launches. None
        defers to the plane's bucket-ladder defaults. Runs through the
        serialized device lane, so a live flush queues behind it. Returns
        the plane's [(kind, lanes, seconds)] report; [] when the plane has
        no prewarm (test fakes)."""
        fn = getattr(self.plane, "prewarm", None)
        if fn is None:
            return []
        kwargs = {}
        if self._decode_rung() == "device" and "decompress" in inspect.signature(fn).parameters:
            # also the decode-fused programs: live flushes land on those
            kwargs["decompress"] = True
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor,
            lambda: fn(
                verify_lanes=None if verify_lanes is None else tuple(verify_lanes),
                recombine_lanes=None if recombine_lanes is None else tuple(recombine_lanes),
                **kwargs,
            ),
        )

    # -- bulk cache warm-up ------------------------------------------------

    def _plane_has_warm_api(self) -> bool:
        return all(hasattr(self.plane, name) for name in ("hash_to_g2_host", "decompress_g1_host"))

    def _warm_sync(self, pubkeys: list, messages: list, chunk: int | None) -> dict:
        """Worker-thread body of warm_caches: bulk decode through the
        plane's warm-up programs (decode_mode device) or per point on the
        host, into the impl's point caches."""
        device = self._decode_rung() == "device" and self._plane_has_warm_api()
        plane = self.plane

        class _PlaneWarmEngine:
            """The plane's warm-up programs behind the engine's bulk-decode
            surface that warm_point_caches drives."""

            @staticmethod
            def decompress_g1_batch(batch, subgroup_check=True):
                return plane.decompress_g1_host(batch)

            @staticmethod
            def hash_to_g2_batch(batch):
                return plane.hash_to_g2_host(batch)

        return torch_impl.warm_point_caches(
            self.impl,
            pubkeys=pubkeys,
            messages=messages,
            engine=_PlaneWarmEngine() if device else None,
            device=device,
            chunk=chunk if chunk is not None else torch_impl.WARMUP_CHUNK,
        )

    async def warm_caches(
        self,
        pubkeys: Sequence[bytes] = (),
        messages: Sequence[bytes] = (),
        chunk: int | None = None,
    ) -> dict:
        """Fill the point caches for a key/message set in bulk: the boot and
        validator-set-rotation hook. With the device decode the field work
        (G1 decompression with the GLV subgroup check; SSWU, isogeny and
        psi cofactor clearing) runs as chunked plane programs; otherwise
        each point decodes on the host (still off the event loop).

        Runs on its OWN short-lived worker thread, never the serialized
        device lane, so a live flush never queues behind thousands of
        warm-up lanes. Idempotent (cached keys are skipped), so a rotation
        re-warm costs only the new entries. Returns the per-cache stats and
        feeds them to `warmup_hook`."""
        loop = asyncio.get_running_loop()
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="crypto-warmup")
        try:
            stats = await loop.run_in_executor(ex, self._warm_sync, list(pubkeys), list(messages), chunk)
        finally:
            ex.shutdown(wait=False)
        self.warmups += 1
        self.warmup_lanes += sum(
            n
            for cache in ("pubkey", "message")
            for src, n in stats.get(cache, {}).items()
            if src in ("device", "python")
        )
        if self.warmup_hook is not None:
            self.warmup_hook(stats)
        return stats
