"""The system under test, as a node runs it: one SlotCryptoPlane over the
first card (threshold t) under one SlotCoalescer, the default kernel
configuration, decode_mode "auto", and the program's own spans and
counters (FlushStats, on_program walls, kernel launches) recorded from
here, around the calls into each layer."""

from __future__ import annotations

import asyncio
import functools
import time


class Program:
    """Boot, warm-up and slots of the program on `device` ("cuda:0", or
    "cpu" for a dry run with the kernels' plain versions)."""

    def __init__(self, t: int, device: str):
        import torch

        from charon_tpu_torch.core.autotune import KernelConfig
        from charon_tpu_torch.core.cryptoplane import SlotCoalescer
        from charon_tpu_torch.ops import mont_kernels
        from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

        self.torch = torch
        self.kernels = mont_kernels
        self.cuda = device != "cpu"
        if self.cuda:
            mont_kernels.build()  # reuses the libraries already in charon_tpu_torch/_build
        KernelConfig().apply()
        self.plane = SlotCryptoPlane(None if self.cuda else make_mesh([device]), t=t)
        self.flushes: list = []  # FlushStats, one a flush
        self.programs: list = []  # (family, seconds, lanes, end wall ns), one a program
        self.plane.on_program = self._on_program
        self.coal = SlotCoalescer(self.plane, stats_hook=self.flushes.append)

    def _on_program(self, family: str, seconds: float, lanes: int) -> None:
        self.programs.append((family, seconds, lanes, time.time_ns()))

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def warm(self, pubkeys: list) -> dict:
        """The boot warm-up of the point caches: every public key a slot can
        name; no signing root, since a slot's roots are not known before it."""
        stats = asyncio.run(self.coal.warm_caches(pubkeys, ()))
        self.sync()
        return stats

    async def _slot(self, subs) -> list:
        async def send(delay, call):
            if delay:
                await asyncio.sleep(delay)
            return await call()

        calls = [functools.partial(self.coal.verify, lanes) for lanes, _ in subs.verify]
        calls += [functools.partial(self.coal.recombine, *args) for args, _ in subs.recombine]
        return await asyncio.gather(*(send(d, c) for d, c in zip(subs.delays, calls)), return_exceptions=True)

    def slot(self, subs) -> list:
        """One slot's submissions, all answered; an answer is the call's
        result or the exception it raised."""
        out = asyncio.run(self._slot(subs))
        self.sync()
        return out

    def window(self, slots, seconds: float) -> dict:
        """Whole slots, one after another (closed loop: a slot is submitted
        when the one before is answered), until the clock passes `seconds`
        or `slots` runs out; the slot in flight when the clock passes is
        finished and counted."""

        async def run():
            walls, answers = [], []
            t0 = time.perf_counter()
            ran_out = True
            for subs in slots:
                s0 = time.perf_counter()
                answers.append(await self._slot(subs))
                walls.append(time.perf_counter() - s0)
                if time.perf_counter() - t0 >= seconds:
                    ran_out = False
                    break
            self.sync()
            return {"seconds": time.perf_counter() - t0, "walls": walls, "answers": answers, "ran_out": ran_out}

        self.kernels.reset_launches()
        self.flushes.clear()
        self.programs.clear()
        out = asyncio.run(run())
        out["flushes"] = len(self.flushes)
        out["pack_s"] = sum(f.pack_span[1] - f.pack_span[0] for f in self.flushes if f.pack_span)
        out["programs_s"] = sum(p[1] for p in self.programs)
        out["families"] = {}
        for fam, secs, _, _ in self.programs:
            out["families"][fam] = out["families"].get(fam, 0.0) + secs
        out["launches"] = sum(self.kernels.LAUNCHES.values())
        return out

    def traced_slot(self, subs) -> dict:
        """One more slot, torch.profiler (CUDA activity only) on from its
        submission to the end of its first plane program (verify_rlc_dec
        today: a whole slot holds 1.8 million device events, whose profile
        takes longer to stop and read than a run may last). The process's
        last work on the card, since a trace slows every launch of its
        process after it. Returns the answers, the profile, the traced
        span's wall-clock ends, and the span's launches by kernel and row
        count and its programs."""
        import threading
        import warnings

        from torch.profiler import ProfilerActivity, profile

        # one profiling cycle: the note that a cycle's events are cleared at its end says nothing here
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        self.kernels.reset_launches()
        self.programs.clear()
        self.sync()
        first = threading.Event()
        span: dict = {}

        def close_span() -> None:
            span.update(end_ns=time.time_ns(), launches=dict(self.kernels.LAUNCHES),
                        rows={k: dict(v) for k, v in self.kernels.ROWS.items()}, programs=list(self.programs))
            first.set()

        def on_program(family: str, seconds: float, lanes: int) -> None:
            # on the coalescer's device lane, right after the program's result sync
            self._on_program(family, seconds, lanes)
            if not first.is_set():
                close_span()

        async def run():
            # the CPU dry run has no device activity to profile
            prof = profile(activities=[ProfilerActivity.CUDA]) if self.cuda else None
            if prof is not None:
                prof.start()
            start_ns = time.time_ns()
            task = asyncio.ensure_future(self._slot(subs))
            while not first.is_set() and not task.done():
                await asyncio.sleep(0.005)
            if not first.is_set():
                close_span()
            if prof is not None:
                prof.stop()
            return prof, start_ns, await task

        self.plane.on_program = on_program
        try:
            prof, start_ns, answers = asyncio.run(run())
        finally:
            self.plane.on_program = self._on_program
        self.sync()
        return {"answers": answers, "prof": prof, "start_ns": start_ns, **span}

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def close(self) -> None:
        """Free the program's state: the coalescer's pools, the plane, the
        card's cached blocks."""
        self.coal.close()
        self.plane.close()
        self.coal = self.plane = None
        if self.cuda:
            self.torch.cuda.empty_cache()
