"""Runtime concurrency sanitizer: lock-order tracking + leak detection.

The crypto host plane is a genuinely concurrent machine: the coalescer's
decode pool, the serialized device lane, the warm-up worker
(`SlotCoalescer.warm_caches`' short-lived thread), the tpu_impl
`PointCache` locks hammered from all of them, and the metrics/tracer
locks every stage reports into. Nothing enforces an acquisition order
across those locks today except care — and a future "grab the cache
lock while holding the stats lock" change would deadlock only under
production interleavings, not in tests. Same for lifecycle: every
ThreadPoolExecutor and asyncio.Task the plane spawns must die with its
owner, or a chaos crash/restart suite leaks a thread per scenario and
the 400th test hangs the runner.

Two sanitizers, both jax-free and dependency-free:

**Lock-order tracker** — wrap locks in `TrackedLock` (threading AND
asyncio locks) sharing a `LockGraph`. Each acquisition-while-holding
records a directed edge (held -> wanted) keyed per thread+task; an
acquisition whose new edge closes a cycle raises `LockOrderError`
*instead of deadlocking*, naming the cycle and the first acquisition
site of every edge. This is deadlock detection by ORDER violation: the
inversion is caught even when the interleaving that would actually
deadlock never fires in the test run.

**Leak detectors** — `thread_snapshot()` + `check_thread_leaks()`
diff live Python threads around a test (joining briefly so
`shutdown(wait=False)` stragglers drain); `TaskDestroyedWatcher`
captures asyncio's "Task was destroyed but it is pending!" reports
(the signature of a task leaked past its loop's lifetime under
`asyncio.run`); `task_snapshot()`/`check_task_leaks()` diff pending
tasks inside a running loop. tests/conftest.py turns these into the
autouse leak fixture over the host-plane/chaos/cryptoplane suites.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import traceback


class LockOrderError(RuntimeError):
    """A lock acquisition would establish an ordering cycle."""


class ThreadLeakError(AssertionError):
    """A test/scope left live threads behind."""


class TaskLeakError(AssertionError):
    """A test/scope left pending asyncio tasks behind."""


def _holder_key() -> tuple:
    """Locks are held per (thread, asyncio task): two tasks on one
    loop thread are distinct holders (asyncio.Lock interleaves them),
    while plain threads key on the thread alone."""
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    return (threading.get_ident(), id(task) if task is not None else None)


def _site() -> str:
    """Compact acquisition site: innermost caller outside this module."""
    for frame in reversed(traceback.extract_stack(limit=12)):
        if "analysis/sanitizer" not in frame.filename.replace("\\", "/"):
            return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown>"


class LockGraph:
    """Shared acquisition-order graph for a set of TrackedLocks.

    Thread-safe. `before_acquire` is called BEFORE blocking on the
    underlying lock: it records the would-be edges and raises
    LockOrderError if any closes a cycle — turning a potential
    deadlock into a loud, attributed failure."""

    def __init__(self, name: str = "lock-graph") -> None:
        self.name = name
        self._mu = threading.Lock()
        # edges[a][b] = first acquisition site that took b while holding a
        self._edges: dict[str, dict[str, str]] = {}
        self._held: dict[tuple, list[str]] = {}

    # -- recording ---------------------------------------------------------

    def before_acquire(self, lock_name: str) -> None:
        key = _holder_key()
        with self._mu:
            held = self._held.get(key, [])
            new_edges = []
            for h in held:
                if h == lock_name:
                    return  # reentrant re-acquire: no ordering info
                sites = self._edges.setdefault(h, {})
                if lock_name not in sites:
                    sites[lock_name] = _site()
                    new_edges.append((h, lock_name))
            if not new_edges:
                # the committed graph is invariantly acyclic (offending
                # edges roll back below), so a re-walk of known edges —
                # the steady-state hot case under instrumentation —
                # cannot have created a cycle
                return
            cycle = self._find_cycle()
            if cycle is not None:
                detail = " -> ".join(cycle)
                sites = [
                    f"  {a} -> {b}: first at {self._edges[a][b]}"
                    for a, b in zip(cycle, cycle[1:])
                ]
                # roll the offending edges back out: the recorded graph
                # stays acyclic, so the violation reports ONCE here
                # instead of poisoning every later (well-ordered)
                # acquisition with the same stored cycle
                for a, b in new_edges:
                    self._edges.get(a, {}).pop(b, None)
                raise LockOrderError(
                    f"[{self.name}] lock-order cycle: {detail} "
                    f"(acquiring {lock_name!r} while holding "
                    f"{held!r})\n" + "\n".join(sites)
                )

    def acquired(self, lock_name: str) -> None:
        with self._mu:
            self._held.setdefault(_holder_key(), []).append(lock_name)

    def released(self, lock_name: str) -> None:
        key = _holder_key()
        with self._mu:
            held = self._held.get(key)
            if held and lock_name in held:
                # remove the LAST occurrence (re-entrant pairing)
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == lock_name:
                        del held[i]
                        break
                if not held:
                    del self._held[key]

    # -- analysis ----------------------------------------------------------

    def edges(self) -> dict[str, dict[str, str]]:
        with self._mu:
            return {a: dict(bs) for a, bs in self._edges.items()}

    def _find_cycle(self) -> list[str] | None:
        """First cycle in the edge graph as [a, b, ..., a], else None.
        Caller holds self._mu."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color: dict[str, int] = {}
        stack: list[str] = []

        def dfs(node: str) -> list[str] | None:
            color[node] = GRAY
            stack.append(node)
            for nxt in self._edges.get(node, ()):
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    i = stack.index(nxt)
                    return stack[i:] + [nxt]
                if c == WHITE:
                    found = dfs(nxt)
                    if found is not None:
                        return found
            stack.pop()
            color[node] = BLACK
            return None

        for start in list(self._edges):
            if color.get(start, WHITE) == WHITE:
                found = dfs(start)
                if found is not None:
                    return found
        return None

    def check(self) -> None:
        """Explicit end-of-scenario assertion (the acquire-time raise
        normally fires first; this catches edges recorded with raising
        disabled in a subclass/wrapper)."""
        with self._mu:
            cycle = self._find_cycle()
        if cycle is not None:
            raise LockOrderError(
                f"[{self.name}] lock-order cycle: " + " -> ".join(cycle)
            )


class TrackedLock:
    """Order-tracking wrapper for threading.Lock/RLock and asyncio.Lock.

    Sync use:   with TrackedLock(threading.Lock(), "cache", graph): ...
    Async use:  async with TrackedLock(asyncio.Lock(), "conn", graph): ...

    Unknown attributes delegate to the wrapped lock, so duck-typed
    callers (locked(), etc.) keep working after instrumentation."""

    def __init__(self, inner, name: str, graph: LockGraph) -> None:
        self._inner = inner
        self._name = name
        self._graph = graph

    # -- sync protocol -----------------------------------------------------

    def acquire(self, *args, **kwargs):
        self._graph.before_acquire(self._name)
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._graph.acquired(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph.released(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- async protocol (asyncio.Lock) -------------------------------------

    async def __aenter__(self):
        self._graph.before_acquire(self._name)
        await self._inner.acquire()
        self._graph.acquired(self._name)
        return self

    async def __aexit__(self, *exc) -> None:
        self._inner.release()
        self._graph.released(self._name)

    def __getattr__(self, item):
        return getattr(self._inner, item)


def instrument_lock_attr(obj, attr: str, name: str, graph: LockGraph):
    """Swap `obj.<attr>` (a lock) for a TrackedLock in-place; returns
    the wrapper. The production wiring for test scenarios:

        graph = LockGraph("hostplane")
        instrument_lock_attr(cache, "_lock", "pointcache:pub", graph)
    """
    inner = getattr(obj, attr)
    wrapped = TrackedLock(inner, name, graph)
    setattr(obj, attr, wrapped)
    return wrapped


# ---------------------------------------------------------------------------
# Thread leaks
# ---------------------------------------------------------------------------

# Thread-name prefixes that are infrastructure with process lifetime,
# not per-test resources (the pytest main thread, jax/pjrt internals
# should they ever surface as Python threads).
DEFAULT_ALLOW_PREFIXES = (
    "MainThread",
    "pydevd",
    "jax",
    "pjrt",
    "grpc",
)


def thread_snapshot() -> set[int]:
    """idents of currently live Python threads."""
    return {t.ident for t in threading.enumerate() if t.is_alive()}


def live_threads_since(before: set[int]) -> list[threading.Thread]:
    return [
        t
        for t in threading.enumerate()
        if t.is_alive() and t.ident not in before
    ]


def check_thread_leaks(
    before: set[int],
    grace: float = 2.0,
    allow_prefixes: tuple[str, ...] = DEFAULT_ALLOW_PREFIXES,
) -> list[str]:
    """Names of threads created since `before` that are still alive
    after up to `grace` seconds of joining. Pool threads mid-shutdown
    (`shutdown(wait=False)`) drain inside the grace window; a thread
    still alive after it is parked forever — an unclosed executor or
    an orphaned worker loop."""
    import time as _time

    leaked: list[str] = []
    deadline = _time.monotonic() + grace
    for t in live_threads_since(before):
        if t.name.startswith(allow_prefixes):
            continue
        t.join(timeout=max(0.0, deadline - _time.monotonic()))
        if t.is_alive():
            leaked.append(t.name)
    return leaked


def assert_no_thread_leaks(before: set[int], grace: float = 2.0) -> None:
    leaked = check_thread_leaks(before, grace=grace)
    if leaked:
        raise ThreadLeakError(
            f"leaked thread(s) survived {grace}s grace: {leaked} — an "
            "executor/worker outlived its owner (missing close()/"
            "shutdown())"
        )


# ---------------------------------------------------------------------------
# Asyncio task leaks
# ---------------------------------------------------------------------------


def task_snapshot() -> set:
    """Pending tasks of the RUNNING loop (call from within the loop)."""
    return {t for t in asyncio.all_tasks() if not t.done()}


def check_task_leaks(before: set, exclude_current: bool = True) -> list[str]:
    """Repr names of tasks pending now that were not pending at
    `before` (call from within the same running loop)."""
    current = asyncio.current_task() if exclude_current else None
    return [
        t.get_name()
        for t in asyncio.all_tasks()
        if not t.done() and t not in before and t is not current
    ]


class TaskDestroyedWatcher:
    """Captures asyncio's 'Task was destroyed but it is pending!' error
    reports — the signature of a task leaked past its event loop's
    lifetime (asyncio.run closes the loop; the GC then reports every
    still-pending task through the 'asyncio' logger)."""

    _PAT = "Task was destroyed but it is pending"

    def __init__(self) -> None:
        self.records: list[str] = []
        self._handler: logging.Handler | None = None

    def install(self) -> "TaskDestroyedWatcher":
        # drain pre-existing garbage first: a task leaked by an EARLIER
        # (unguarded) test whose Task object is still uncollected must
        # report before this watcher's window opens, not inside it
        import gc

        gc.collect()
        watcher = self

        class _H(logging.Handler):
            def emit(self, record: logging.LogRecord) -> None:
                msg = record.getMessage()
                if watcher._PAT in msg:
                    watcher.records.append(msg)

        self._handler = _H(level=logging.ERROR)
        logging.getLogger("asyncio").addHandler(self._handler)
        return self

    def uninstall(self) -> list[str]:
        # the destroy report fires from Task.__del__: force the
        # collection BEFORE detaching so leaks land in THIS scope
        import gc

        gc.collect()
        if self._handler is not None:
            logging.getLogger("asyncio").removeHandler(self._handler)
            self._handler = None
        return list(self.records)
