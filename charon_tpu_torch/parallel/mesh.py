"""Slot-level crypto step over a list of devices.

The port of charon_tpu/parallel/mesh.py. The two parallel axes of a slot,
the validators and the t shares of each, are the tensor dimensions
[V, t]. V is split over the plane's shards, one torch device each; t
stays local (the Lagrange reduction is a t-term point fold). On two or
more shards a program runs every shard's slice at once, as the reference's
shard_map does: one host thread and one CUDA stream a shard, both owned by
the plane. Every torch op releases the GIL, and threads that all want it
back hand it over at every op, which cost a card's shards several times
one shard's wall each (PERF.md section 6); so on a card the shards'
threads take turns at the host instead, in slices of a few milliseconds
ended at a kernel launch (_Turns), while each shard's queued work runs on
its stream. The only reduction across shards, the reference's scalar psum
of the validity counts, is a sum of the per-shard counts on the host,
within each host's shards first on a make_mesh_2d layout. A one-shard
plane runs in the calling thread on its stream.

One call per slot does every validator's work: verify each partial
signature against its pubshare, recombine the group signatures, verify
those. Each of the plane's ten programs is a plain function on tensors;
its field multiplies go to the engine's kernels (K1-K6 on a CUDA device)
through the same ops as BlsEngine.
"""

from __future__ import annotations

import collections
import concurrent.futures
import random
import threading
import time

import numpy as np
import torch

from charon_tpu_torch.ops import blsops
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import decompress as DEC
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.ops import sswu as SSWU
from charon_tpu_torch.ops.curve import map_point, zip_point
from charon_tpu_torch.ops.limb import ModCtx

# the plane's programs, by family name, and whether each is cheap enough to
# launch on every check (the JAX package's sentinel flag)
FAMILIES = {
    "step": False,
    "step_rlc": False,
    "verify": False,
    "verify_rlc": False,
    "verify_dec": False,
    "verify_rlc_dec": False,
    "step_dec": False,
    "step_rlc_dec": False,
    "h2c": False,
    "g1dec": True,
}


def _dedupe_buckets(lanes, bucket_fn):
    """Keep one representative lane count per padded bucket shape."""
    seen, out = set(), []
    for n in lanes:
        b = bucket_fn(n)
        if b not in seen:
            seen.add(b)
            out.append(n)
    return out


def make_mesh(devices=None) -> list[torch.device]:
    """The plane's shards, one torch device each; None means every visible
    card (as the reference's jax.devices()). A CUDA entry needs a card:
    pass "cpu" entries to run on the CPU."""
    if devices is None:
        # with no card, cuda:0 stands in so that resolving it raises
        devices = [f"cuda:{i}" for i in range(max(1, torch.cuda.device_count()))]
    devices = list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return [blsops._resolve_device(d) for d in devices]


def make_mesh_2d(n_hosts: int, devices=None) -> list[list[torch.device]]:
    """The reference's multi-host layout: the devices (None: every visible
    card) row by row as n_hosts rows, a host's devices a row.
    SlotCryptoPlane splits V over the devices in row order and sums the
    validity count within each host's shards before it sums over hosts."""
    devices = make_mesh(devices)
    if len(devices) % n_hosts:
        raise ValueError(f"{len(devices)} devices do not split over {n_hosts} hosts")
    per = len(devices) // n_hosts
    return [devices[h * per : (h + 1) * per] for h in range(n_hosts)]


def _layout(mesh) -> tuple[list[torch.device], int]:
    """(the shards in row order, the hosts) of a make_mesh list, a
    make_mesh_2d layout or None."""
    if mesh is not None and len(mesh) and all(isinstance(row, (list, tuple)) for row in mesh):
        if len({len(row) for row in mesh}) != 1:
            raise ValueError("every host of a 2-D mesh needs the same number of devices")
        return make_mesh([d for row in mesh for d in row]), len(mesh)
    return make_mesh(mesh), 1


def _first_leaf(tree):
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def _leaves(tree) -> list:
    out = []
    map_point(out.append, tree)
    return out


class _Turns:
    """The host, taken in turns by the shards' threads of one plane on a
    card, first come first served: a thread holds its turn while it issues
    its shard's ops and passes it on after a kernel launch once it has held
    it SLICE seconds and another thread waits. Only the holder wants the
    GIL then, so it gets it back from each op at once, and every shard's
    queued work runs on its own stream meanwhile."""

    SLICE = 0.005

    def __init__(self):
        self._lock = threading.Lock()
        self._waiting: collections.deque[threading.Event] = collections.deque()
        self._busy = False
        self._since = 0.0

    def enter(self) -> None:
        with self._lock:
            if not self._busy:
                self._busy = True
                self._since = time.perf_counter()
                return
            handed = threading.Event()
            self._waiting.append(handed)
        handed.wait()
        self._since = time.perf_counter()

    def leave(self) -> None:
        with self._lock:
            if self._waiting:
                self._waiting.popleft().set()  # the turn goes straight to the next
            else:
                self._busy = False

    def pass_on(self) -> None:
        if self._waiting and time.perf_counter() - self._since >= self.SLICE:
            self.leave()
            self.enter()


class _Shards:
    """The plane's workers: one host thread a shard (a one-worker pool,
    started at the first program) and, on a card, one CUDA stream a shard.
    A shard's work runs on its own thread, so two programs in flight on one
    plane queue up per shard and never mix their slices. The threads hold
    no reference to the plane: close() ends them, and so does dropping the
    plane."""

    def __init__(self, mesh: list[torch.device]):
        self.mesh = mesh
        self._pools = [
            concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"plane-shard{k}") for k in range(len(mesh))
        ]
        self._streams = None
        self._lock = threading.Lock()
        self.turns = _Turns()

    def streams(self) -> list:
        """A stream of its own for each shard on a card (None for a CPU
        shard), made at the first program. Raises if one cannot be had."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.mesh]
            return self._streams

    def submit(self, k: int, fn, *args) -> concurrent.futures.Future:
        return self._pools[k].submit(fn, *args)

    def close(self) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True)


def _event(timing: bool):
    return torch.cuda.Event(enable_timing=timing)


def _run_shard(body, part, stream, ready, reduce, timing: bool, turns: _Turns):
    """One shard's slice of a program, on the shard's thread, under
    inference mode (thread-local), on the shard's stream after the inputs'
    `ready` event, taking turns at the host with the other shards on a
    card. The count and verdict outputs come back as host values, synced on
    this stream alone, after the turn is given up. Returns (outputs, done
    event or None, (start, end) in s or as CUDA events)."""

    def host(out):
        return tuple(int(o) if kind == "count" else bool(o) if kind == "all" else o for o, kind in zip(out, reduce))

    with torch.inference_mode():
        if stream is None:
            t0 = time.perf_counter()
            out = host(body(*part))
            return out, None, (t0, time.perf_counter())
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            for leaf in _leaves(part):
                leaf.record_stream(stream)
            start = _event(timing)
            start.record(stream)
            turns.enter()
            MK.AFTER_LAUNCH.hook = turns.pass_on
            try:
                out = body(*part)
            finally:
                MK.AFTER_LAUNCH.hook = None
                turns.leave()
            done = _event(timing)
            done.record(stream)
            return host(out), done, (start, done)


def _cat_grid(a, b):
    """[V, t, ...] ++ [V, ...] -> [V, t + 1, ...]."""
    return torch.cat((a, b.unsqueeze(1)), 1)


def _flat(a):
    return a.reshape(-1, *a.shape[2:])


class SlotCryptoPlane:
    """The per-slot batched crypto programs, V split over the mesh's shards.

    Inputs per slot (leading axis V = #validators, split over shards):
      pubshares  [V, t]  affine G1: per-share public keys
      msg        [V]     affine G2: per-validator hashed signing roots
      partials   [V, t]  affine G2: per-share partial signatures
      group_pk   [V]     affine G1: group public keys
      indices    [V, t]  int64: share indices (1-based)

    Outputs:
      group_sig  [V]  affine G2: recombined signatures
      sig_ok     [V]  bool: per-partial verify AND group verify
      total_ok   int: count of fully valid lanes over every shard

    mesh: the list of devices make_mesh returns, or make_mesh_2d's rows
    (None: every visible card). Packed inputs live on the first device; a
    program moves each shard's slice to its device, runs the shards at
    once, and gathers the sliced outputs back on the first. close() ends
    the shards' threads.
    """

    # canonical duty shapes: lane 1 catches the SMALLEST bucket (a lone
    # first-slot submission), the rest cover the burst sizes; lane counts
    # sharing a bucket after padding are run once
    PREWARM_VERIFY_LANES = (1, 16, 64, 256)
    PREWARM_RECOMBINE_LANES = (1, 16, 64)

    def __init__(self, mesh, t: int, ctx: ModCtx | None = None, fr_ctx: ModCtx | None = None):
        self.mesh, self.hosts = _layout(mesh)
        self.device = self.mesh[0]
        self._shards = _Shards(self.mesh) if len(self.mesh) > 1 else None
        self.t = t
        self.ctx = ctx or limb.FP
        self.fr_ctx = fr_ctx or limb.FR
        # (program, padded lanes) pairs dispatched: the bucket-discipline
        # signal jit_cache_size reports
        self._dispatched: set[tuple[str, int]] = set()
        self._step = self._program("step", self._step_body, ("cat", "cat", "count"))
        self._step_rlc = self._program("step_rlc", self._step_rlc_body, ("cat", "all"))
        self._verify = self._program("verify", self._verify_body, ("cat",))
        self._verify_rlc = self._program("verify_rlc", self._verify_rlc_body, ("all",))
        # decode-fused variants: signatures arrive as parsed compressed
        # lanes and the program decompresses them on the device first (the
        # coalescer's decode_mode "device")
        self._verify_dec = self._program("verify_dec", self._verify_dec_body, ("cat",))
        self._verify_rlc_dec = self._program("verify_rlc_dec", self._verify_rlc_dec_body, ("all", "cat"))
        self._step_dec = self._program("step_dec", self._step_dec_body, ("cat", "cat", "count"))
        self._step_rlc_dec = self._program("step_rlc_dec", self._step_rlc_dec_body, ("cat", "all", "cat"))
        # bulk warm-up programs: hash-to-curve and G1 decompression for the
        # point caches, thousands of entries a dispatch
        self._h2c = self._program("h2c", self._h2c_body, ("cat", "cat"))
        self._g1dec = self._program("g1dec", self._g1dec_body, ("cat", "cat"))
        # per-program timing hook: callable(family, seconds, lanes), family
        # names as in kernel_families ("mesh/verify_rlc", ...), fired
        # around each program dispatch INCLUDING its result sync, so the
        # per-family times sum to about the flush's device span. None (the
        # default) costs one attribute check a dispatch.
        self.on_program = None
        # per-shard timing hook: callable(family, [(start, end) ms]), each
        # shard's device interval of a program on two or more shards,
        # measured from the event its inputs were ready at (host
        # perf_counter spans on CPU shards). None (the default) keeps the
        # shards' events untimed.
        self.on_shards = None

    # -- dispatch ---------------------------------------------------------

    def _program(self, name: str, body, reduce: tuple[str, ...]):
        """A program: `body` on each shard's slice of the packed inputs, on
        the shard's device, under inference mode (grad mode is
        thread-local). One shard runs in the calling thread; two or more
        run at once, each on its own thread and stream (_run_shards). Each
        output reduces by its `reduce` entry: "cat" gathers the slices on
        the first device in shard order, "count" sums the per-shard counts
        on the host, "all" ANDs the per-shard verdicts. One output comes
        back bare, several as a tuple."""

        def run(*args):
            lanes = int(_first_leaf(args).shape[0])
            shards = len(self.mesh)
            if lanes % shards:
                raise ValueError(f"{lanes} lanes do not split over {shards} shards")
            self._dispatched.add((name, lanes))
            if self._shards is None:
                with torch.inference_mode():
                    outs = [body(*map_point(lambda a: a.to(self.device), args))]
            else:
                outs = self._run_shards(name, body, args, lanes // shards, reduce)
            res = tuple(self._reduce(kind, [o[i] for o in outs]) for i, kind in enumerate(reduce))
            return res[0] if len(res) == 1 else res

        run.__name__ = name
        return run

    def _run_shards(self, name: str, body, args, per: int, reduce: tuple[str, ...]) -> list:
        """Every shard's slice of `args` at once, one shard a thread and a
        stream. The slices are cut (and moved to their cards) on the
        caller's streams, and each shard's stream waits on an event
        recorded after them; the caller's streams wait on each shard's
        last event before they read its outputs. Every tensor read on a
        stream it was not made on is marked with record_stream, so the
        caching allocator does not hand its memory out early. Waits for
        every shard, then raises the lowest-numbered shard's error."""
        streams = self._shards.streams()
        timing = self.on_shards is not None
        futures = []
        for k, dev in enumerate(self.mesh):
            part = map_point(lambda a, k=k, dev=dev: a[k * per : (k + 1) * per].to(dev), args)
            ready = None
            if streams[k] is not None:
                ready = _event(timing)
                ready.record(torch.cuda.current_stream(dev))
            futures.append((ready, self._shards.submit(
                k, _run_shard, body, part, streams[k], ready, reduce, timing, self._shards.turns
            )))
        concurrent.futures.wait([f for _, f in futures])
        for _, f in futures:
            if f.exception() is not None:
                raise f.exception()
        outs, spans = [], []
        for (ready, f), dev in zip(futures, self.mesh):
            out, done, span = f.result()
            if done is not None:
                caller = torch.cuda.current_stream(dev)
                caller.wait_event(done)
                for o, kind in zip(out, reduce):
                    if kind == "cat":
                        for leaf in _leaves(o):
                            leaf.record_stream(caller)
                if timing:
                    done.synchronize()
                    span = (ready.elapsed_time(span[0]), ready.elapsed_time(span[1]))
            outs.append(out)
            spans.append(span)
        if timing:
            if streams[0] is None:
                t0 = min(s for s, _ in spans)
                spans = [((s - t0) * 1e3, (e - t0) * 1e3) for s, e in spans]
            self.on_shards(f"mesh/{name}", spans)
        return outs

    def _reduce(self, kind: str, parts: list):
        if kind == "count":
            # within each host's shards first, then over the hosts
            per = len(parts) // self.hosts
            return sum(sum(int(p) for p in parts[h * per : (h + 1) * per]) for h in range(self.hosts))
        if kind == "all":
            return all(bool(p) for p in parts)
        if len(parts) == 1:
            return parts[0]
        return zip_point(lambda *xs: torch.cat([x.to(self.device) for x in xs]), *parts)

    def close(self) -> None:
        """End the shards' threads (idempotent; a program after it raises).
        Dropping the plane ends them too."""
        if self._shards is not None:
            self._shards.close()

    def _timed(self, family: str, lanes: int, fn):
        """Run one program dispatch (with its sync) under the timing hook.
        Hook faults never fail the dispatch."""
        hook = self.on_program
        if hook is None:
            return fn()
        t0 = time.monotonic()
        try:
            return fn()
        finally:
            try:
                hook(f"mesh/{family}", time.monotonic() - t0, lanes)
            except Exception:  # noqa: BLE001 — observability stays off the duty path
                pass

    # -- program bodies (one shard's slice) --------------------------------

    def _step_body(self, pubshares, msg, partials, group_pk, indices, live):
        """Recombination, then every partial and the group signature
        verified lane by lane as ONE batch over Vl * (t + 1) lanes. Shared
        by the point-input program and the decode-fused one (which ANDs its
        decompression mask into `live` first)."""
        ctx, t = self.ctx, self.t
        group_sig = blsops.threshold_recombine(ctx, self.fr_ctx, t, partials, indices)
        cat = lambda a, b: _flat(_cat_grid(a, b))  # noqa: E731
        pk_all = zip_point(cat, pubshares, group_pk)
        sig_all = zip_point(cat, partials, group_sig)
        msg_rep = map_point(lambda a: a.repeat_interleave(t + 1, 0), msg)
        ok = DP.batched_verify(ctx, pk_all, msg_rep, sig_all).reshape(-1, t + 1).all(-1)
        # `live` masks the padding lanes out of the count
        ok = ok & live
        return group_sig, ok, ok.sum()

    def _step_rlc_body(self, pubshares, msg, partials, group_pk, indices, live, rand):
        """The throughput path: the same recombination, then verification by
        random linear combination with ONE final exponentiation a shard.
        `rand` holds an INDEPENDENT exponent for every verify lane
        ([Vl, t + 1]): one exponent shared over a validator's lanes would
        let colluding signers craft partial errors that cancel. Padding
        lanes get exponent 0, so they contribute the identity."""
        ctx, fr_ctx, t = self.ctx, self.fr_ctx, self.t
        g2f = C.g2_ops(ctx)
        group_sig = blsops.threshold_recombine(ctx, fr_ctx, t, partials, indices)
        rand_live = torch.where(live[:, None, None], rand, 0)
        pk_grid = zip_point(_cat_grid, pubshares, group_pk)
        sig_grid = zip_point(_cat_grid, partials, group_sig)
        if MSM.msm_active():
            # grouped RLC: a validator's t + 1 lanes share its message, so
            # they collapse into ONE pair e(sum_j r_vj pk_vj, H_v); the
            # Miller stage runs Vl + 1 pairs instead of Vl (t + 1)
            g1f = C.g1_ops(ctx)
            buckets = MSM.windowed_joint_mul(g1f, fr_ctx, C.affine_to_point(g1f, pk_grid), rand_live, nbits=64)
            sig_v = MSM.windowed_joint_mul(g2f, fr_ctx, C.affine_to_point(g2f, sig_grid), rand_live, nbits=64)
            s_total = DP.point_sum_tree(g2f, sig_v, live.shape[0])
            ok = DP.grouped_rlc_check(ctx, buckets, msg, s_total)
        else:
            msg_rep = map_point(lambda a: a.repeat_interleave(t + 1, 0), msg)
            ok = DP.batched_verify_rlc(
                ctx,
                fr_ctx,
                map_point(_flat, pk_grid),
                msg_rep,
                map_point(_flat, sig_grid),
                rand_live.reshape(-1, rand.shape[-1]),
            )
        return group_sig, ok

    def _step_dec_body(self, ps, msg, px0, px1, psign, gpk, idx, live):
        """Attribution recombine on PARSED partials: decompress the [Vl, t]
        grid, then the step body. Rows with an undecodable partial
        recombine from identities and fail through the mask folded into
        `live`."""
        partials, dec_ok = DEC.decompress_g2_graph(self.ctx, (px0, px1), psign)
        return self._step_body(ps, msg, partials, gpk, idx, live & dec_ok.all(1))

    def _step_rlc_dec_body(self, ps, msg, px0, px1, psign, gpk, idx, live, rand):
        """RLC recombine on PARSED partials: rows with an undecodable
        partial leave the shared product (exponent 0) and come back False
        in the third output, the per-row answer of the all-valid path."""
        partials, dec_ok = DEC.decompress_g2_graph(self.ctx, (px0, px1), psign)
        row_ok = dec_ok.all(1) & live
        group_sig, all_ok = self._step_rlc_body(ps, msg, partials, gpk, idx, row_ok, rand)
        return group_sig, all_ok, row_ok

    def _verify_body(self, pk, msg, sig, live):
        """Per-lane verify: each lane pays its own final exponentiation (the
        attribution path, run only when the RLC path found a failure)."""
        return (DP.batched_verify(self.ctx, pk, msg, sig) & live,)

    def _verify_rlc_body(self, pk, msg, sig, live, rand):
        """Whole-batch RLC verify: independent 64-bit exponents and ONE
        final exponentiation a shard; padding lanes get exponent 0."""
        rand = torch.where(live[:, None], rand, 0)
        return (DP.batched_verify_rlc(self.ctx, self.fr_ctx, pk, msg, sig, rand),)

    def _verify_dec_body(self, pk, msg, sx0, sx1, sign, live):
        """Per-lane verify on PARSED signature lanes: decompression (sqrt,
        sign, on-curve, psi subgroup check), then the pairing check."""
        sig, dec_ok = DEC.decompress_g2_graph(self.ctx, (sx0, sx1), sign)
        return (DP.batched_verify(self.ctx, pk, msg, sig) & dec_ok & live,)

    def _verify_rlc_dec_body(self, pk, msg, sx0, sx1, sign, live, rand):
        """RLC verify on PARSED lanes. Undecodable lanes get exponent 0 and
        come back False in the lane mask, so all_ok means "every lane that
        decoded verified" and the mask is the per-lane answer."""
        sig, dec_ok = DEC.decompress_g2_graph(self.ctx, (sx0, sx1), sign)
        lane_ok = dec_ok & live
        rand = torch.where(lane_ok[:, None], rand, 0)
        return DP.batched_verify_rlc(self.ctx, self.fr_ctx, pk, msg, sig, rand), lane_ok

    def _h2c_body(self, u00, u01, u10, u11, s0, s1, live):
        """The device hash-to-curve tail: hash_to_field outputs in, cleared
        G2 points out (the message-cache warm-up program)."""
        aff, valid = SSWU.hash_to_g2_graph(self.ctx, (u00, u01), (u10, u11), s0, s1)
        return aff, valid & live

    def _g1dec_body(self, x0, sign, inf, ok, live):
        """Batched G1 decompression with the GLV subgroup check (the
        pubkey-cache warm-up program)."""
        aff, valid = DEC.decompress_g1_graph(self.ctx, x0, sign, inf, ok)
        return aff, valid & live

    # -- programs ---------------------------------------------------------

    def step(self, pubshares, msg, partials, group_pk, indices, live):
        """One slot step on packed inputs: (group_sig, ok, total_ok)."""
        return self._step(pubshares, msg, partials, group_pk, indices, live)

    def step_rlc(self, pubshares, msg, partials, group_pk, indices, live, rand):
        """Fast path: (group_sig, all_ok). `rand` is a [V, t + 1] raw Fr limb
        tensor of independent nonzero 64-bit exponents (see make_rand)."""
        return self._step_rlc(pubshares, msg, partials, group_pk, indices, live, rand)

    # -- host-facing ------------------------------------------------------

    def shard_count(self) -> int:
        return len(self.mesh)

    def bucket_lanes(self, n: int) -> int:
        """Padded batch size for n lanes: the engine's power-of-two bucket
        ladder (blsops.bucket_lanes), kept divisible by the shard count."""
        return blsops.bucket_lanes(n, self.shard_count())

    def jit_cache_size(self) -> int:
        """Distinct (program, padded lanes) pairs dispatched so far: the
        bucket-discipline signal (O(log max batch) per program, never one
        per flush)."""
        return len(self._dispatched)

    def _live(self, n: int, padded: int):
        return torch.arange(padded, device=self.device) < n

    def _rand(self, count: int, rng) -> torch.Tensor:
        rng = rng or random.SystemRandom()
        vals = [rng.randrange(1, 1 << 64) for _ in range(count)]
        return limb.to_device(limb.ctx_pack(self.fr_ctx, vals), self.device)

    def make_rand(self, v: int, rng=None) -> torch.Tensor:
        """[V_padded, t + 1] independent nonzero 64-bit exponents as raw Fr
        limbs. OS randomness (SystemRandom) by default: the 2^-64 soundness
        bound assumes exponents the signers cannot predict. Pass a seeded
        Random only in tests."""
        vp = self.bucket_lanes(v)
        return self._rand(vp * (self.t + 1), rng).reshape(vp, self.t + 1, -1)

    def make_lane_rand(self, n: int, rng=None) -> torch.Tensor:
        """[N_padded] independent nonzero 64-bit exponents as raw Fr limbs
        (see make_rand for the randomness contract)."""
        return self._rand(self.bucket_lanes(n), rng)

    @staticmethod
    def _pad(pad: int, *cols):
        """Each column padded with `pad` copies of its lane 0."""
        return [list(c) + [c[0]] * pad for c in cols]

    # -- bulk warm-up host API --------------------------------------------

    def hash_to_g2_host(self, msgs, dst: bytes = SSWU.DST_POP):
        """Messages (raw bytes or sswu.HashedMsg lanes) -> ([affine G2
        point], [valid]) through the device SSWU program; the host pays
        only SHA-256 hash_to_field. Bucket-padded like every entry point."""
        lanes = [m if isinstance(m, SSWU.HashedMsg) else SSWU.hash_to_field_lane(m, dst) for m in msgs]
        n = len(lanes)
        if n == 0:
            return [], []
        padded = self.bucket_lanes(n)
        [lanes] = self._pad(padded - n, lanes)
        arrays = SSWU.pack_hashed(self.ctx, lanes, self.device)
        live = self._live(n, padded)

        def run():
            aff, valid = self._h2c(*arrays, live)
            return C.g2_unpack(self.ctx, map_point(lambda a: a[:n], aff)), valid.tolist()[:n]

        return self._timed("h2c", n, run)

    def decompress_g1_host(self, encoded):
        """Compressed 48-byte G1 lanes (or parsed lanes) -> ([affine point |
        None], [valid]) through the decompression program: per-lane masks,
        never exceptions."""
        parsed = [p if isinstance(p, DEC.ParsedPoint) else DEC.parse_g1_lane(p) for p in encoded]
        n = len(parsed)
        if n == 0:
            return [], []
        padded = self.bucket_lanes(n)
        [parsed] = self._pad(padded - n, parsed)
        x0, sign, inf, ok = DEC.pack_parsed_g1(self.ctx, parsed, self.device)
        live = self._live(n, padded)

        def run():
            aff, valid = self._g1dec(x0, sign, inf, ok, live)
            return C.g1_unpack(self.ctx, map_point(lambda a: a[:n], aff)), valid.tolist()[:n]

        return self._timed("g1dec", n, run)

    # -- slot step host API -----------------------------------------------

    def pack_inputs(self, pubshares, msgs, partials, group_pks, indices):
        """Python-int affine points -> tensors laid out [V, t] / [V] on the
        first device. V is padded up the bucket ladder by repeating lane 0;
        padding lanes carry live=False, stay out of the count and are
        sliced off by the host wrappers."""
        v, t = len(msgs), self.t
        vp = self.bucket_lanes(v)
        pubshares, msgs, partials, group_pks, indices = self._pad(
            vp - v, pubshares, msgs, partials, group_pks, indices
        )
        grid = lambda pt: map_point(lambda a: a.reshape(vp, t, -1), pt)  # noqa: E731
        dev = self.device
        ps = grid(C.g1_pack(self.ctx, [p for row in pubshares for p in row], dev))
        sig = grid(C.g2_pack(self.ctx, [s for row in partials for s in row], dev))
        msg = C.g2_pack(self.ctx, msgs, dev)
        gpk = C.g1_pack(self.ctx, group_pks, dev)
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
        return ps, msg, sig, gpk, idx, self._live(v, vp)

    def pack_inputs_parsed(self, pubshares, msgs, parsed_partials, group_pks, indices):
        """Decode-mode-device recombine pack: the [V, t] PARSED partial
        signatures ride as raw limb grids; the rest are points as in
        pack_inputs."""
        v, t = len(msgs), self.t
        vp = self.bucket_lanes(v)
        pubshares, msgs, parsed_partials, group_pks, indices = self._pad(
            vp - v, pubshares, msgs, parsed_partials, group_pks, indices
        )
        dev = self.device
        ps = map_point(
            lambda a: a.reshape(vp, t, -1), C.g1_pack(self.ctx, [p for row in pubshares for p in row], dev)
        )
        px0, px1, psign, _inf, _ok = DEC.pack_parsed_g2(self.ctx, [p for row in parsed_partials for p in row], dev)
        msg = C.g2_pack(self.ctx, msgs, dev)
        gpk = C.g1_pack(self.ctx, group_pks, dev)
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
        return (
            ps,
            msg,
            px0.reshape(vp, t, -1),
            px1.reshape(vp, t, -1),
            psign.reshape(vp, t),
            gpk,
            idx,
            self._live(v, vp),
        )

    def _unpack_sigs(self, group_sig, v: int) -> list:
        return C.g2_unpack(self.ctx, map_point(lambda a: a[:v], group_sig))

    def step_host(self, pubshares, msgs, partials, group_pks, indices):
        """Pack, run the per-lane step, unpack: ([V] group signatures, [V]
        ok flags, count of valid lanes)."""
        v = len(msgs)
        group_sig, ok, total = self._step(*self.pack_inputs(pubshares, msgs, partials, group_pks, indices))
        return self._unpack_sigs(group_sig, v), ok.tolist()[:v], total

    # -- coalescer-facing host API ----------------------------------------
    # (core/cryptoplane.SlotCoalescer talks to the plane only through these,
    # so a counting fake can stand in for the device in tests)

    def pack_verify_inputs(self, pks, msgs, sigs):
        """Python-int affine points -> [N] tensors + live mask, N padded up
        the bucket ladder by repeating lane 0."""
        n = len(pks)
        padded = self.bucket_lanes(n)
        pks, msgs, sigs = self._pad(padded - n, pks, msgs, sigs)
        dev = self.device
        return (
            C.g1_pack(self.ctx, pks, dev),
            C.g2_pack(self.ctx, msgs, dev),
            C.g2_pack(self.ctx, sigs, dev),
            self._live(n, padded),
        )

    def pack_verify_inputs_parsed(self, pks, msgs, parsed):
        """Decode-mode-device pack: pk/msg POINTS (cached decodes) and
        PARSED compressed signature lanes (host-valid and finite: the
        coalescer prefails the rest), padded as pack_verify_inputs."""
        n = len(pks)
        padded = self.bucket_lanes(n)
        pks, msgs, parsed = self._pad(padded - n, pks, msgs, parsed)
        dev = self.device
        sx0, sx1, sign, _inf, _ok = DEC.pack_parsed_g2(self.ctx, parsed, dev)
        return (
            C.g1_pack(self.ctx, pks, dev),
            C.g2_pack(self.ctx, msgs, dev),
            sx0,
            sx1,
            sign,
            self._live(n, padded),
        )

    def verify_packed_parsed(self, arrays, rand, n: int) -> list[bool]:
        """Device stage of a parsed verify batch: decompression fused into
        the verify program. Lanes that fail decompression come back False;
        on the RLC path the per-lane answer is exactly the decode mask."""
        pk, msg, sx0, sx1, sign, live = arrays

        def fast():
            all_ok, lane_ok = self._verify_rlc_dec(pk, msg, sx0, sx1, sign, live, rand)
            return all_ok, lane_ok.tolist()

        all_ok, lane_ok = self._timed("verify_rlc_dec", n, fast)
        if all_ok:
            return lane_ok[:n]
        ok = self._timed("verify_dec", n, lambda: self._verify_dec(pk, msg, sx0, sx1, sign, live).tolist())
        return ok[:n]

    def verify_packed(self, arrays, rand, n: int) -> list[bool]:
        """Device stage of verify_host on an already-packed batch: the
        coalescer packs on its decode pool and calls this from its device
        lane, so packing window k overlaps the device work of window k-1."""
        pk, msg, sig, live = arrays
        if self._timed("verify_rlc", n, lambda: self._verify_rlc(pk, msg, sig, live, rand)):
            return [True] * n
        ok = self._timed("verify", n, lambda: self._verify(pk, msg, sig, live).tolist())
        return ok[:n]

    def verify_host(self, pks, msgs, sigs, rng=None) -> list[bool]:
        """Batch verify of N independent (pk, msg, sig) lanes: the RLC path
        first (one shared final exponentiation a shard); only a failing
        batch pays the per-lane program."""
        n = len(pks)
        if n == 0:
            return []
        arrays = self.pack_verify_inputs(pks, msgs, sigs)
        return self.verify_packed(arrays, self.make_lane_rand(n, rng=rng), n)

    def recombine_packed_parsed(self, args, rand, v: int):
        """Device stage of a parsed recombine batch. Rows with an
        undecodable partial recombine from identities (their group
        signature is whatever those give) and come back ok=False."""

        def fast():
            group_sig, all_ok, row_ok = self._step_rlc_dec(*args, rand)
            if not all_ok:
                return None
            return self._unpack_sigs(group_sig, v), row_ok.tolist()[:v]

        res = self._timed("step_rlc_dec", v, fast)
        if res is not None:
            return res

        def attrib():
            group_sig, ok, _total = self._step_dec(*args)
            return self._unpack_sigs(group_sig, v), ok.tolist()[:v]

        return self._timed("step_dec", v, attrib)

    def recombine_packed(self, args, rand, v: int):
        """Device stage of recombine_host on an already-packed [V, t] batch
        (the pipelining contract of verify_packed)."""

        def fast():
            group_sig, all_ok = self.step_rlc(*args, rand)
            if not all_ok:
                return None
            return self._unpack_sigs(group_sig, v), [True] * v

        res = self._timed("step_rlc", v, fast)
        if res is not None:
            return res

        def attrib():
            group_sig, ok, _total = self.step(*args)
            return self._unpack_sigs(group_sig, v), ok.tolist()[:v]

        return self._timed("step", v, attrib)

    def recombine_host(self, pubshares, msgs, partials, group_pks, indices, rng=None):
        """Recombine and verify [V, t] threshold workloads: ([V] group
        signature points, [V] ok flags). The RLC path first; a failing
        batch re-runs the per-lane step for attribution."""
        v = len(msgs)
        if v == 0:
            return [], []
        args = self.pack_inputs(pubshares, msgs, partials, group_pks, indices)
        return self.recombine_packed(args, self.make_rand(v, rng=rng), v)

    # -- program families -------------------------------------------------

    def _spec(self, fname: str) -> blsops.TraceSpec:
        """Family `fname` on canonical generator-point inputs, 4 lanes up
        the ladder (a seeded exponent source: the verdict does not depend
        on it)."""
        from charon_tpu_torch.crypto.g1g2 import G1_GEN, G2_GEN, g1_to_bytes, g2_to_bytes

        t, n = self.t, self.bucket_lanes(4)
        rng = random.Random(0)
        g2_parsed = DEC.parse_g2_lane(g2_to_bytes(G2_GEN))
        points = ([[G1_GEN] * t] * n, [G2_GEN] * n, [[G2_GEN] * t] * n, [G1_GEN] * n, [list(range(1, t + 1))] * n)
        parsed = (*points[:2], [[g2_parsed] * t] * n, *points[3:])
        lanes = ([G1_GEN] * n, [G2_GEN] * n)
        inputs = {
            "step": lambda: self.pack_inputs(*points),
            "step_rlc": lambda: (*self.pack_inputs(*points), self.make_rand(n, rng)),
            "verify": lambda: self.pack_verify_inputs(*lanes, [G2_GEN] * n),
            "verify_rlc": lambda: (*self.pack_verify_inputs(*lanes, [G2_GEN] * n), self.make_lane_rand(n, rng)),
            "verify_dec": lambda: self.pack_verify_inputs_parsed(*lanes, [g2_parsed] * n),
            "verify_rlc_dec": lambda: (
                *self.pack_verify_inputs_parsed(*lanes, [g2_parsed] * n),
                self.make_lane_rand(n, rng),
            ),
            "step_dec": lambda: self.pack_inputs_parsed(*parsed),
            "step_rlc_dec": lambda: (*self.pack_inputs_parsed(*parsed), self.make_rand(n, rng)),
            "h2c": lambda: (
                *SSWU.pack_hashed(self.ctx, [SSWU.hash_to_field_lane(b"family-check")] * n, self.device),
                self._live(n, n),
            ),
            "g1dec": lambda: (
                *DEC.pack_parsed_g1(self.ctx, [DEC.parse_g1_lane(g1_to_bytes(G1_GEN))] * n, self.device),
                self._live(n, n),
            ),
        }
        return blsops.TraceSpec(getattr(self, f"_{fname}"), inputs[fname](), self.ctx, n, self.shard_count())

    def kernel_families(self, prefix: str = "mesh") -> dict:
        """This plane's programs as named families ({name:
        blsops.KernelFamily}): build(device=None) packs canonical
        generator-point inputs on the bucket ladder and returns a
        launchable TraceSpec, on this plane or, given a device, on a
        one-shard plane of the same threshold there."""

        def family(fname: str, sentinel: bool):
            def build(device=None):
                plane = self if device is None else SlotCryptoPlane([device], self.t, self.ctx, self.fr_ctx)
                return plane._spec(fname)

            return blsops.KernelFamily(f"{prefix}/{fname}", build, sentinel)

        return {f"{prefix}/{fname}": family(fname, sentinel) for fname, sentinel in FAMILIES.items()}

    # -- prewarm ----------------------------------------------------------

    def prewarm(
        self, verify_lanes=None, recombine_lanes=None, decompress: bool = False
    ) -> list[tuple[str, int, float]]:
        """Run the canonical duty shapes once up front, so the first live
        slot pays neither the kernel build nor first launches on the duty
        path.

        Each shape runs BOTH tiers explicitly, the RLC path AND the per-lane
        attribution program (generator-point inputs are valid, so the RLC
        early return would skip the second). Shapes land on the bucket
        ladder live flushes pad to, one per bucket; with `decompress` the
        decode-fused programs run too. Returns [(kind, bucket lanes,
        seconds)] per shape. Run it after core/autotune.resolve, so the
        programs run under the tuned KernelConfig; the tuner's prewarm
        ladder (autotune.PREWARM_LANES) matches these shapes."""
        from charon_tpu_torch.crypto.g1g2 import G1_GEN, G2_GEN, g2_to_bytes

        verify_lanes = _dedupe_buckets(
            self.PREWARM_VERIFY_LANES if verify_lanes is None else verify_lanes, self.bucket_lanes
        )
        recombine_lanes = _dedupe_buckets(
            self.PREWARM_RECOMBINE_LANES if recombine_lanes is None else recombine_lanes, self.bucket_lanes
        )
        t = self.t
        idx_row = list(range(1, t + 1))
        gen_parsed = DEC.parse_g2_lane(g2_to_bytes(G2_GEN))
        report: list[tuple[str, int, float]] = []

        def timed(kind: str, n: int, run) -> None:
            t0 = time.monotonic()
            run()
            report.append((kind, self.bucket_lanes(n), time.monotonic() - t0))

        def verify(n: int) -> None:
            pk, msg, sig, live = self.pack_verify_inputs([G1_GEN] * n, [G2_GEN] * n, [G2_GEN] * n)
            self._verify_rlc(pk, msg, sig, live, self.make_lane_rand(n))
            self._verify(pk, msg, sig, live).tolist()

        def recombine(v: int) -> None:
            args = self.pack_inputs([[G1_GEN] * t] * v, [G2_GEN] * v, [[G2_GEN] * t] * v, [G1_GEN] * v, [idx_row] * v)
            self.step_rlc(*args, self.make_rand(v))
            self.step(*args)[1].tolist()

        def verify_dec(n: int) -> None:
            arrays = self.pack_verify_inputs_parsed([G1_GEN] * n, [G2_GEN] * n, [gen_parsed] * n)
            self._verify_rlc_dec(*arrays, self.make_lane_rand(n))
            self._verify_dec(*arrays).tolist()

        def recombine_dec(v: int) -> None:
            args = self.pack_inputs_parsed(
                [[G1_GEN] * t] * v, [G2_GEN] * v, [[gen_parsed] * t] * v, [G1_GEN] * v, [idx_row] * v
            )
            self._step_rlc_dec(*args, self.make_rand(v))
            self._step_dec(*args)[1].tolist()

        for n in verify_lanes:
            timed("verify", n, lambda: verify(n))
        for v in recombine_lanes:
            timed("recombine", v, lambda: recombine(v))
        if decompress:
            # decode-fused programs (decode_mode "device"), on generator
            # encodings, so decompression takes the valid path
            for n in verify_lanes:
                timed("verify-dec", n, lambda: verify_dec(n))
            for v in recombine_lanes:
                timed("recombine-dec", v, lambda: recombine_dec(v))
        return report


_ANALYSIS_PLANE_T = 3  # the canonical threshold of the registry's plane


def register_analysis_families(mesh=None, t: int = _ANALYSIS_PLANE_T) -> SlotCryptoPlane:
    """Build the canonical plane (one shard: a program does not change
    with the shard count, only its split) on `mesh` (None: the first card) and
    register its programs in the blsops family registry. Idempotent.
    Called by core/cryptoplane.kernel_inventory()."""
    plane = SlotCryptoPlane(make_mesh()[:1] if mesh is None else mesh, t)
    for name, fam in plane.kernel_families().items():
        if name not in blsops.kernel_families():
            blsops.register_kernel_family(name, fam.build, fam.sentinel)
    return plane
