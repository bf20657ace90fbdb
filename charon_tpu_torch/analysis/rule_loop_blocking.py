"""event-loop-blocking: no sync crypto/sleep directly in core async defs.

The pipelined host plane exists because host BLS work on the event loop stalled it for
seconds (8.93 s over a 256-lane burst) — every timer, ping, consensus
round-change and QBFT timeout in the process queues behind one
synchronous pairing call. The pipeline moved the duty path's crypto
off-loop, but nothing stops a *new* `async def` in core/ from calling
`tbls.verify_batch(...)` inline (≈0.3 s/verify on the python rung) or
sleeping the whole loop with `time.sleep`. The degradation ladders are
especially exposed: their fallback branches run exactly when the
system is already under stress.

The rule: inside `async def` bodies in `charon_tpu_torch/core/` (not nested
sync defs — those run wherever their caller runs), a *non-awaited*
call is a violation when it is:

  * `time.sleep(...)` — sleeps the loop; use `asyncio.sleep`;
  * any `tbls.<fn>(...)` — host/device crypto; await the plane or ship
    it via `loop.run_in_executor(None, tbls.<fn>, ...)`;
  * a call whose terminal attribute is a known blocking-crypto name
    (`verify`, `verify_batch`, `threshold_aggregate_batch`,
    `recombine_batch`) — the duck-typed sync verifier surfaces.

Awaited calls are async by construction and exempt; function
*references* passed to `run_in_executor` are not calls and never flag.

Audited exceptions exist: the plane-LESS host-BLS rungs in parsigex/
sigagg/validatorapi stay inline by design — an executor hop there
GIL-convoys the busy loop and distorts duty timing (measured 7-17x
vapi-e2e slowdown), while production wires the async crypto plane.
Those sites carry `# lint: allow(event-loop-blocking)` pragmas citing
exactly that; the rule exists so the NEXT sync crypto call needs the
same audit before it lands.
"""

from __future__ import annotations

import ast
from typing import Iterator

from charon_tpu_torch.analysis.lint import LintModule, Rule, Violation, in_scope

_PREFIXES = ("charon_tpu_torch/core/",)
_BLOCKING_ATTRS = frozenset(
    {"verify", "verify_batch", "threshold_aggregate_batch",
     "recombine_batch"}
)


def _async_body_calls(fn: ast.AsyncFunctionDef):
    """Yield (call, awaited) for calls lexically inside this async def,
    not descending into nested function/lambda bodies."""

    def walk(node: ast.AST, awaited: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
            ):
                continue
            if isinstance(child, ast.Await):
                # the directly awaited call is fine; calls nested in
                # its ARGUMENTS are still sync-evaluated
                val = child.value
                if isinstance(val, ast.Call):
                    yield (val, True)
                    for sub in ast.iter_child_nodes(val):
                        yield from walk(sub, False)
                else:
                    yield from walk(val, False)
                continue
            if isinstance(child, ast.Call):
                yield (child, awaited)
            yield from walk(child, False)

    yield from walk(ast.Module(body=fn.body, type_ignores=[]), False)


class EventLoopBlocking(Rule):
    name = "event-loop-blocking"
    description = (
        "no sync crypto / time.sleep calls directly in async def "
        "bodies in core/ — await the plane or use run_in_executor"
    )

    def applies(self, mod: LintModule) -> bool:
        return in_scope(mod, _PREFIXES)

    def check(self, mod: LintModule) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for call, awaited in _async_body_calls(node):
                if awaited:
                    continue
                func = call.func
                if mod.resolves_to(func, "time.sleep"):
                    yield Violation(
                        self.name, mod.relpath, call.lineno,
                        "time.sleep in an async def sleeps the whole "
                        "event loop; use await asyncio.sleep(...)",
                    )
                    continue
                if isinstance(func, ast.Attribute):
                    # tbls.<anything>(...) — the sync crypto facade
                    if mod.is_module_ref(func.value, "charon_tpu_torch.tbls") or (
                        isinstance(func.value, ast.Name)
                        and func.value.id == "tbls"
                    ):
                        yield Violation(
                            self.name, mod.relpath, call.lineno,
                            f"sync tbls.{func.attr}() on the event loop; "
                            "await the crypto plane or run it via "
                            "loop.run_in_executor",
                        )
                        continue
                    if func.attr in _BLOCKING_ATTRS:
                        yield Violation(
                            self.name, mod.relpath, call.lineno,
                            f"sync blocking-crypto call .{func.attr}() "
                            "in an async def; await it or ship it to an "
                            "executor",
                        )
