"""typed-errors: no bare generic raises at trust boundaries.

The codec, crypto-plane, and transport boundaries each built a typed
error ladder for a reason: `CodecError(ValueError)` is what lets the
transport recv loop drop-and-count a malformed frame instead of killing
the authenticated connection; `TblsError`/`PlaneOverloadError`
is what lets submitters route shed load to the host tbls rung instead
of crashing a duty. A bare `raise ValueError(...)` at one of
these boundaries silently opts out of that routing: callers either
over-catch (swallowing programming errors) or under-catch (a flood of
malformed input kills a connection/duty that typed handling would have
degraded gracefully).

The rule: in boundary modules (`charon_tpu_torch/p2p/*`,
`core/cryptoplane.py`, `core/cryptosvc.py`), raising a bare
`ValueError`, `RuntimeError`, or `Exception` is a violation — raise
(or define) a domain subclass instead. Subclasses keep working:
`CodecError` IS a ValueError, so pre-existing generic catchers still
see it; the point is that the boundary's own handlers can tell typed
wire/plane failures from genuine bugs.
"""

from __future__ import annotations

import ast
from typing import Iterator

from charon_tpu_torch.analysis.lint import LintModule, Rule, Violation, in_scope

_PREFIXES = ("charon_tpu_torch/p2p/",)
_FILES = frozenset(
    {
        "charon_tpu_torch/core/cryptoplane.py",
        "charon_tpu_torch/core/cryptosvc.py",
    }
)
_GENERIC = {"ValueError", "RuntimeError", "Exception"}


class TypedErrors(Rule):
    name = "typed-errors"
    description = (
        "no bare raise ValueError/RuntimeError/Exception in the codec/"
        "crypto-plane/transport trust-boundary modules — raise a typed "
        "domain error so boundary handlers can route it"
    )

    def applies(self, mod: LintModule) -> bool:
        return in_scope(mod, _PREFIXES, _FILES)

    def check(self, mod: LintModule) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name) and exc.id in _GENERIC:
                yield Violation(
                    self.name,
                    mod.relpath,
                    node.lineno,
                    f"bare `raise {exc.id}` at a trust boundary; raise a "
                    "typed domain error (CodecError/TblsError/"
                    "StructuredError subclass) so handlers can route it",
                )
