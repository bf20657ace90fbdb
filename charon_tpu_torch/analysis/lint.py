"""Project-invariant linter: AST framework, pragma handling, CLI.

Generic machinery only — the actual invariants live one-per-module in
`rule_*.py` siblings (see `all_rules()`); each rule names the real past
bug that motivated it. Run it the way CI does:

    python -m charon_tpu_torch.analysis.lint charon_tpu_torch/ bench_wire.py

Exit status 0 means every scoped file is clean; 1 means violations
(printed one per line as `path:line: rule: message`); 2 is usage error.

Allowlist pragma: a site that *audited* deliberately wants the flagged
construct (e.g. a wall-clock read at a logging/attribution edge) carries

    something()  # lint: allow(monotonic-clock) — why wall time is right

on the violating line (or the line directly above, for calls that span
lines). Multiple rules: `# lint: allow(rule-a, rule-b)`. Pragmas are
per-line on purpose — a file-wide waiver would rot silently.

The framework is pure stdlib (ast + re) and never imports the modules
it lints, so it runs identically on jax-less hosts — which is also why
`ci.sh analysis` can sit in the fast tier's tail.
"""

from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([A-Za-z0-9_\-, ]+)\)")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # posix path as reported (repo-relative where possible)
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class LintModule:
    """One parsed source file plus the lookups every rule needs:
    pragma lines, import-alias resolution, and the repo-relative scope
    key rules match their file scopes against."""

    def __init__(self, source: str, relpath: str, path: Path | None = None):
        self.source = source
        self.relpath = relpath.replace("\\", "/")
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # Pragmas are COMMENT tokens only: a docstring that *mentions*
        # the syntax (every rule module documents it) must neither
        # allowlist its own line nor pollute the --pragmas audit.
        self._allow: dict[int, set[str]] = {}
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(
                io.StringIO(source).readline
            ):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m:
                    self._allow.setdefault(tok.start[0], set()).update(
                        r.strip()
                        for r in m.group(1).split(",")
                        if r.strip()
                    )
        except tokenize.TokenError:
            # ast.parse succeeded, so this is unreachable in practice;
            # fall back to the plain line scan rather than dropping
            # every pragma in the file
            for i, ln in enumerate(self.lines, 1):
                m = _PRAGMA_RE.search(ln)
                if m:
                    self._allow[i] = {
                        r.strip()
                        for r in m.group(1).split(",")
                        if r.strip()
                    }
        # import x [as y]  ->  {y_or_x_head: "x"}   (full dotted module)
        # from m import a [as b]  ->  {b_or_a: "m:a"}
        self.imports: dict[str, str] = {}
        self.from_imports: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.imports[local] = a.name if a.asname else local
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (
                        f"{node.module}:{a.name}"
                    )

    # -- pragma ------------------------------------------------------------

    def allowed(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            if rule in self._allow.get(ln, ()):
                return True
        return False

    # -- name resolution ---------------------------------------------------

    def resolves_to(self, node: ast.AST, dotted: str) -> bool:
        """True when `node` is a reference to module attr `dotted`
        (e.g. "time.time"), through any import alias in this file —
        `time.time`, `_time.time`, or `from time import time`."""
        mod, attr = dotted.rsplit(".", 1)
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            return (
                self.imports.get(node.value.id) == mod
                and node.attr == attr
            )
        if isinstance(node, ast.Name):
            return self.from_imports.get(node.id) == f"{mod}:{attr}"
        return False

    def is_module_ref(self, node: ast.AST, module: str) -> bool:
        """True when `node` names the module `module` itself (imported
        as `import module [as x]` or `from pkg import module`)."""
        if not isinstance(node, ast.Name):
            return False
        if self.imports.get(node.id) == module:
            return True
        ref = self.from_imports.get(node.id)
        if ref is None:
            return False
        m, _, a = ref.partition(":")
        return f"{m}.{a}" == module or (a == module and "." not in module)


class Rule:
    """One project invariant. Subclasses set `name` (the pragma token)
    and implement applies()/check(); check() yields raw findings and the
    framework applies the pragma allowlist."""

    name = ""
    description = ""

    def applies(self, mod: LintModule) -> bool:
        raise NotImplementedError

    def check(self, mod: LintModule) -> Iterator[Violation]:
        raise NotImplementedError


def in_scope(mod: LintModule, prefixes: tuple[str, ...] = (),
             files: frozenset | set | tuple = ()) -> bool:
    key = scope_key(mod.relpath)
    if prefixes and key.startswith(tuple(prefixes)):
        return True
    return key in set(files)


def scope_key(relpath: str) -> str:
    """Normalize any reported path to the repo-rooted key rules match
    on: '.../charon_tpu_torch/core/x.py' -> 'charon_tpu_torch/core/x.py'; files
    outside the package (bench_*.py) key on their basename."""
    p = relpath.replace("\\", "/")
    idx = p.rfind("charon_tpu_torch/")
    if idx >= 0:
        return p[idx:]
    return p.rsplit("/", 1)[-1]


def all_rules() -> list[Rule]:
    from charon_tpu_torch.analysis.rule_cancellation import SwallowedCancellation
    from charon_tpu_torch.analysis.rule_jax_free import JaxFreeHost
    from charon_tpu_torch.analysis.rule_loop_blocking import EventLoopBlocking
    from charon_tpu_torch.analysis.rule_monotonic_clock import MonotonicClock
    from charon_tpu_torch.analysis.rule_secret_flow import SecretFlow
    from charon_tpu_torch.analysis.rule_typed_errors import TypedErrors

    return [
        MonotonicClock(),
        TypedErrors(),
        JaxFreeHost(),
        EventLoopBlocking(),
        SwallowedCancellation(),
        SecretFlow(),
    ]


def check_module(
    mod: LintModule, rules: Iterable[Rule] | None = None
) -> list[Violation]:
    out: list[Violation] = []
    for rule in rules if rules is not None else all_rules():
        if not rule.applies(mod):
            continue
        for v in rule.check(mod):
            if not mod.allowed(rule.name, v.line):
                out.append(v)
    return out


def iter_py_files(paths: Iterable[str]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                yield f
        elif p.suffix == ".py" and p.is_file():
            yield p
        else:
            # an explicit argument that resolves to nothing weakens the
            # gate silently (a renamed bench file would stop being
            # linted while CI stays green) — fail loudly instead
            raise FileNotFoundError(
                f"lint target {raw!r} is neither a directory nor an "
                "existing .py file"
            )


def lint_paths(
    paths: Iterable[str], rules: Iterable[Rule] | None = None
) -> tuple[list[Violation], int]:
    """Lint every .py under `paths`. Returns (violations, files_seen).
    Files that fail to parse surface as a framework violation rather
    than crashing the run (the tree must stay lintable even mid-edit)."""
    rules = list(rules) if rules is not None else all_rules()
    violations: list[Violation] = []
    n = 0
    for f in iter_py_files(paths):
        n += 1
        rel = f.as_posix()
        try:
            mod = LintModule(
                f.read_text(encoding="utf-8"), relpath=rel, path=f
            )
        except SyntaxError as e:
            violations.append(
                Violation("parse", rel, e.lineno or 0, f"syntax error: {e.msg}")
            )
            continue
        violations.extend(check_module(mod, rules))
    return violations, n


def audit_pragmas(
    paths: Iterable[str],
) -> list[tuple[str, str, int, str]]:
    """Inventory of every `# lint: allow(...)` pragma under `paths`:
    (rule, posix path, line, stripped source line). The pragma allowlist
    alone was write-only — pragmas accreted but nothing listed
    them for an audit. This is the auditable ledger: one row per
    (rule, site), sorted by rule then location. Git-blame-free by
    design — the listing itself is the audit surface."""
    out: list[tuple[str, str, int, str]] = []
    for f in iter_py_files(paths):
        rel = f.as_posix()
        try:
            mod = LintModule(
                f.read_text(encoding="utf-8"), relpath=rel, path=f
            )
        except SyntaxError:
            continue  # the lint pass itself reports parse errors
        for line, rules in sorted(mod._allow.items()):
            snippet = mod.lines[line - 1].strip()
            for rule in sorted(rules):
                out.append((rule, mod.relpath, line, snippet))
    out.sort(key=lambda r: (r[0], r[1], r[2]))
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="charon_tpu_torch.analysis.lint",
        description="project-invariant linter (see rule_*.py for the catalogue)",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument(
        "--rule",
        action="append",
        default=None,
        help="run only this rule (repeatable; default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue"
    )
    ap.add_argument(
        "--pragmas",
        action="store_true",
        help="audit report: list every `# lint: allow(...)` pragma "
        "with rule, file:line, and the allowed source line",
    )
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.name}: {r.description}")
        return 0
    if args.pragmas:
        try:
            entries = audit_pragmas(args.paths)
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            return 2
        counts: dict[str, int] = {}
        for rule, rel, line, snippet in entries:
            counts[rule] = counts.get(rule, 0) + 1
            print(f"{rule}: {rel}:{line}: {snippet}")
        summary = ", ".join(
            f"{r}={n}" for r, n in sorted(counts.items())
        )
        print(
            f"{len(entries)} pragma(s) [{summary or 'none'}]",
            file=sys.stderr,
        )
        return 0
    if args.rule:
        known = {r.name for r in rules}
        unknown = set(args.rule) - known
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in set(args.rule)]

    try:
        violations, n = lint_paths(args.paths, rules)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    for v in violations:
        print(v.render())
    print(
        f"{len(violations)} violation(s) across {n} file(s) "
        f"[{', '.join(r.name for r in rules)}]",
        file=sys.stderr,
    )
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
