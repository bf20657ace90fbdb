"""monotonic-clock: no `time.time()` in scheduling/duration code.

The motivating bug is the `SlotCoalescer._arm` fix: duty deadlines
are wall-clock (slots ARE a wall timeline) but the flush timer runs on
the monotonic base, and converting per call meant a host clock step
mid-window (NTP correction, VM migration, operator fat-finger — the
chaos `SkewedClock` injector) collapsed or stretched armed windows.
The same class of bug hid in every retry loop comparing
`time.time() + delay >= deadline`: a forward step silently aborts the
remaining retries, a backward step retries past the duty deadline.

The rule: inside `charon_tpu_torch/core/`, `charon_tpu_torch/p2p/`, and the retry
machinery (`app/retry.py`, `app/expbackoff.py`), any reference to
`time.time` — called, aliased (`import time as _time`), from-imported,
or passed as a default/callback — is a violation. Durations and
deadline math belong on `time.monotonic()` (anchor a wall deadline to
the monotonic base ONCE, like `_arm` does). Wall time is legitimate
only at attribution/logging edges (span timestamps, slot-relative
delay metrics, debug sniffers) — those sites carry an audited
`# lint: allow(monotonic-clock)` pragma saying why.
"""

from __future__ import annotations

import ast
from typing import Iterator

from charon_tpu_torch.analysis.lint import LintModule, Rule, Violation, in_scope

_PREFIXES = ("charon_tpu_torch/core/", "charon_tpu_torch/p2p/")
_FILES = frozenset(
    {"charon_tpu_torch/app/retry.py", "charon_tpu_torch/app/expbackoff.py"}
)


class MonotonicClock(Rule):
    name = "monotonic-clock"
    description = (
        "no time.time() for durations/deadlines/scheduling in core/, "
        "p2p/, or the retry machinery (wall time only at audited "
        "attribution/logging edges)"
    )

    def applies(self, mod: LintModule) -> bool:
        return in_scope(mod, _PREFIXES, _FILES)

    def check(self, mod: LintModule) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Attribute, ast.Name)) and (
                mod.resolves_to(node, "time.time")
            ):
                # a Name that is the *target* of `from time import time`
                # itself (the import statement) resolves too; skip
                # import statements — the reference sites are the bug
                yield Violation(
                    self.name,
                    mod.relpath,
                    node.lineno,
                    "wall-clock time.time reference in scheduling code; "
                    "use time.monotonic() for durations/deadlines "
                    "(pragma-allow audited attribution/logging edges)",
                )
