"""no-swallowed-cancellation: retry/fault paths must let cancel through.

The retry machinery's contract (app/retry.Retryer docstring) is
that cancellation — a torn-down duty, a stopping node — propagates
immediately: it is how `stop()` everywhere guarantees bounded shutdown
and how the chaos crash/restart scenarios keep a killed node from
ghost-completing work. One `except:` or `except BaseException:` in a
retry loop that logs-and-continues turns task cancellation into an
infinite retry; a swallowed `asyncio.CancelledError` leaves the
awaiting canceller hanging. (Plain `except Exception` is safe on this
interpreter: CancelledError subclasses BaseException since 3.8 — the
rule deliberately does not flag it.)

The rule: inside `async def` bodies in `charon_tpu_torch/core/`,
`charon_tpu_torch/p2p/`, and the retry/fault machinery (`app/retry.py`,
`app/expbackoff.py`, `app/faultinject.py`), an except handler that can
catch CancelledError — bare `except:`, `except BaseException`, or any
clause naming `CancelledError` — must re-raise (contain a `raise`).
The one blessed idiom is exempt automatically: awaiting a task the
same function just `.cancel()`ed (`task.cancel(); await task` inside
`except CancelledError: pass`) — that cancellation is *ours* and
already delivered.
"""

from __future__ import annotations

import ast
from typing import Iterator

from charon_tpu_torch.analysis.lint import LintModule, Rule, Violation, in_scope

_PREFIXES = ("charon_tpu_torch/core/", "charon_tpu_torch/p2p/")
_FILES = frozenset(
    {
        "charon_tpu_torch/app/retry.py",
        "charon_tpu_torch/app/expbackoff.py",
        "charon_tpu_torch/app/faultinject.py",
    }
)


def _handler_names(handler: ast.ExceptHandler) -> set[str] | None:
    """Exception names a handler catches; None = bare except."""
    t = handler.type
    if t is None:
        return None
    names: set[str] = set()
    for n in t.elts if isinstance(t, ast.Tuple) else [t]:
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


def _contains_raise(stmts) -> bool:
    """A `raise` at handler level (not inside a nested def/lambda —
    a raise in a defined-but-maybe-never-called closure re-raises
    nothing)."""

    def walk(node: ast.AST) -> bool:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return False
        if isinstance(node, ast.Raise):
            return True
        return any(walk(c) for c in ast.iter_child_nodes(node))

    return any(walk(st) for st in stmts)


def _fn_cancels_a_task(fn: ast.AsyncFunctionDef) -> bool:
    """True when the function calls `<x>.cancel()` somewhere — the
    cancel-then-await-then-swallow shutdown idiom."""
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "cancel"
        ):
            return True
    return False


class SwallowedCancellation(Rule):
    name = "no-swallowed-cancellation"
    description = (
        "except handlers in async retry/fault paths must not eat "
        "asyncio.CancelledError (bare except / BaseException / "
        "CancelledError without re-raise)"
    )

    def applies(self, mod: LintModule) -> bool:
        return in_scope(mod, _PREFIXES, _FILES)

    def check(self, mod: LintModule) -> Iterator[Violation]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            cancels_own = None  # computed lazily, once per function
            for node in ast.walk(fn):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    names = _handler_names(handler)
                    catches_cancel = names is None or bool(
                        names & {"BaseException", "CancelledError"}
                    )
                    if not catches_cancel:
                        continue
                    if _contains_raise(handler.body):
                        continue
                    if names is not None and names <= {"CancelledError"}:
                        # CancelledError-only swallow is the blessed
                        # idiom iff this function cancelled the task
                        # it awaits
                        if cancels_own is None:
                            cancels_own = _fn_cancels_a_task(fn)
                        if cancels_own:
                            continue
                    what = (
                        "bare except"
                        if names is None
                        else f"except {'/'.join(sorted(names))}"
                    )
                    yield Violation(
                        self.name,
                        mod.relpath,
                        handler.lineno,
                        f"{what} swallows asyncio.CancelledError in an "
                        "async retry/fault path; re-raise it (or cancel "
                        "the awaited task in this function)",
                    )
