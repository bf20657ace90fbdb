"""jax-free-host: the port reaches neither jax nor the JAX package, and
its host modules reach no torch at import time.

Two invariants, one rule:

1. **The package is jax-free.** `charon_tpu_torch` runs where jax is
   not installed (the CUDA machine) and holds its own copy of every
   module it needs from the JAX package `charon_tpu`. So no file under
   `charon_tpu_torch/`, and not `chip_smoke.py`, may import `jax`,
   `jaxlib` or `charon_tpu` at ANY scope: module scope, function scope,
   guarded by `try/except ImportError` or under `if TYPE_CHECKING:`,
   or through `importlib.import_module`/`__import__` of a literal name.
   A guarded import would hide the dependency on a host that has jax
   and break on the one that does not; the only files that may import
   both packages are the parity tests.
2. **The host set is torch-free at import time.** Several host modules
   are load-bearing in processes that never touch the card: the wire
   codec and quarantine state machine, app/metrics.py (scraped in every
   process), testutil/chaos.py (the seeded fault plane injects into
   pure-host tests), and this analysis package. For each module in that
   set (explicit list below, plus any module whose docstring claims to
   be "jax-free"/"jax-less"), no *unguarded module-scope* import may
   reach `torch`, `jax`/`jaxlib` or `charon_tpu`, directly or
   transitively through `charon_tpu_torch`-internal imports. Guarded
   imports (inside `try/except ImportError`) are soft edges and allowed
   for torch; `if TYPE_CHECKING:` blocks are ignored. Module-scope
   *calls* to module-level functions (the `_register_core_types()`
   pattern in p2p/codec.py) count as module scope: their imports
   execute at import time all the same.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator

from charon_tpu_torch.analysis.lint import (
    LintModule,
    Rule,
    Violation,
    scope_key,
)

_PACKAGE_PREFIX = "charon_tpu_torch/"
_PACKAGE_FILES = frozenset({"chip_smoke.py"})
_FORBIDDEN = ("jax", "jaxlib", "charon_tpu")
_HOST_FORBIDDEN = _FORBIDDEN + ("torch",)
_JAX_FREE_PREFIXES = ("charon_tpu_torch/analysis/",)
_JAX_FREE_FILES = frozenset(
    {
        "charon_tpu_torch/p2p/codec.py",
        "charon_tpu_torch/p2p/quarantine.py",
        "charon_tpu_torch/app/metrics.py",
        "charon_tpu_torch/testutil/chaos.py",
    }
)
_DOC_MARK = re.compile(r"jax[- ](free|less)", re.IGNORECASE)


def _docstring_claims_jax_free(tree: ast.AST) -> bool:
    doc = ast.get_docstring(tree, clean=False) or ""
    return bool(_DOC_MARK.search(doc))


def _module_scope_imports(
    tree: ast.Module,
) -> list[tuple[str, int, bool]]:
    """(dotted_module, lineno, guarded) for every import that executes
    at module import time. `guarded` = inside a try whose handlers
    catch ImportError/ModuleNotFoundError/Exception (the module works
    without it). `if TYPE_CHECKING:` bodies never execute — skipped."""
    out: list[tuple[str, int, bool]] = []
    funcs = {
        n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
    }

    def _is_type_checking(test: ast.AST) -> bool:
        return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
            isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
        )

    def _catches_import_error(handlers) -> bool:
        names = set()
        for h in handlers:
            t = h.type
            if t is None:
                return True
            for n in t.elts if isinstance(t, ast.Tuple) else [t]:
                if isinstance(n, ast.Name):
                    names.add(n.id)
                elif isinstance(n, ast.Attribute):
                    names.add(n.attr)
        return bool(
            names & {"ImportError", "ModuleNotFoundError", "Exception",
                     "BaseException"}
        )

    def walk(stmts, guarded: bool) -> None:
        for st in stmts:
            if isinstance(st, ast.Import):
                for a in st.names:
                    out.append((a.name, st.lineno, guarded))
            elif isinstance(st, ast.ImportFrom):
                if st.level:  # relative import; repo uses absolute
                    continue
                if st.module:
                    for a in st.names:
                        # `from pkg import sub` may bind a submodule —
                        # record both candidates, resolver picks
                        out.append(
                            (f"{st.module}.{a.name}", st.lineno, guarded)
                        )
                        out.append((st.module, st.lineno, guarded))
            elif isinstance(st, ast.Try):
                g = guarded or _catches_import_error(st.handlers)
                walk(st.body, g)
                walk(st.orelse, guarded)
                walk(st.finalbody, guarded)
                for h in st.handlers:
                    walk(h.body, guarded)
            elif isinstance(st, ast.If):
                if _is_type_checking(st.test):
                    walk(st.orelse, guarded)
                    continue
                walk(st.body, guarded)
                walk(st.orelse, guarded)
            elif isinstance(st, (ast.With, ast.For, ast.While)):
                walk(st.body, guarded)
                walk(getattr(st, "orelse", []), guarded)
            elif (
                isinstance(st, ast.Expr)
                and isinstance(st.value, ast.Call)
                and isinstance(st.value.func, ast.Name)
                and st.value.func.id in funcs
            ):
                # module-scope call of a module-level function: its
                # imports execute at import time (codec's
                # _register_core_types pattern)
                fn = funcs[st.value.func.id]
                walk(fn.body, guarded)

    walk(tree.body, False)
    return out


def _top(dotted: str) -> str:
    return dotted.split(".")[0]


def _import_sites(tree: ast.AST) -> Iterator[tuple[str, int]]:
    """(dotted module, lineno) of every import anywhere in the file:
    statements at any scope and `importlib.import_module`/`__import__`
    calls with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module and not node.level:
                yield node.module, node.lineno
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(
                arg, ast.Constant
            ) and isinstance(arg.value, str):
                yield arg.value, node.lineno


class JaxFreeHost(Rule):
    name = "jax-free-host"
    description = (
        "the port imports no jax, jaxlib or charon_tpu at any scope; its "
        "host modules reach no torch via unguarded module-scope imports"
    )

    def __init__(self) -> None:
        self._cache: dict[Path, list[tuple[str, int, bool]] | None] = {}

    @staticmethod
    def _in_package(key: str) -> bool:
        return key.startswith(_PACKAGE_PREFIX) or key in _PACKAGE_FILES

    def _in_host_set(self, key: str, mod: LintModule) -> bool:
        return (
            key in _JAX_FREE_FILES
            or key.startswith(_JAX_FREE_PREFIXES)
            or _docstring_claims_jax_free(mod.tree)
        )

    def applies(self, mod: LintModule) -> bool:
        key = scope_key(mod.relpath)
        return self._in_package(key) or self._in_host_set(key, mod)

    # -- transitive resolution --------------------------------------------

    def _root(self, mod: LintModule) -> Path | None:
        if mod.path is None:
            return None
        key = scope_key(mod.relpath)
        p = mod.path.resolve()
        if key.startswith(_PACKAGE_PREFIX):
            # strip the key's components off the real path
            for _ in key.split("/"):
                p = p.parent
            return p
        return p.parent

    def _imports_of(self, root: Path, dotted: str):
        """Module-scope imports of `dotted` (charon_tpu_torch.*), or None
        when it doesn't resolve to a file (attr import / namespace miss)."""
        rel = dotted.split(".")
        for cand in (
            root.joinpath(*rel).with_suffix(".py"),
            root.joinpath(*rel, "__init__.py"),
        ):
            if cand.is_file():
                if cand not in self._cache:
                    try:
                        tree = ast.parse(
                            cand.read_text(encoding="utf-8")
                        )
                        self._cache[cand] = _module_scope_imports(tree)
                    except (OSError, SyntaxError):
                        self._cache[cand] = None
                return self._cache[cand], cand
        return None, None

    def _package_chain(self, dotted: str) -> list[str]:
        """Importing a.b.c executes a/__init__, a.b/__init__ too."""
        parts = dotted.split(".")
        return [".".join(parts[: i + 1]) for i in range(len(parts) - 1)]

    def check(self, mod: LintModule) -> Iterator[Violation]:
        key = scope_key(mod.relpath)
        flagged_lines: set[int] = set()
        if self._in_package(key):
            for dotted, line in _import_sites(mod.tree):
                if line in flagged_lines or _top(dotted) not in _FORBIDDEN:
                    continue
                flagged_lines.add(line)
                yield Violation(
                    self.name,
                    mod.relpath,
                    line,
                    f"{dotted} imported in the port (at any scope, guarded "
                    "or not): the port keeps its own copy of what it "
                    "needs and imports neither jax nor charon_tpu",
                )
        if not self._in_host_set(key, mod):
            return
        root = self._root(mod)
        # the module's own imports are checked directly below: a cycle
        # back into it (codec -> cryptosvc_wire -> codec) adds nothing
        seen: set[str] = {key[:-3].replace("/", ".")} if key.endswith(".py") else set()

        def reaches(dotted: str, depth: int) -> list[str] | None:
            """Chain of modules from `dotted` to a forbidden import, or
            None."""
            if _top(dotted) in _HOST_FORBIDDEN:
                return [dotted]
            if _top(dotted) != "charon_tpu_torch" or root is None:
                return None
            if dotted in seen or depth > 12:
                return None
            seen.add(dotted)
            imports, _ = self._imports_of(root, dotted)
            if imports is None:
                return None
            for sub, _line, guarded in imports:
                if guarded:
                    continue
                chain = reaches(sub, depth + 1)
                if chain is not None:
                    return [dotted] + chain
            return None

        for dotted, line, guarded in _module_scope_imports(mod.tree):
            if guarded or line in flagged_lines:
                continue
            if _top(dotted) in _HOST_FORBIDDEN:
                flagged_lines.add(line)
                yield Violation(
                    self.name,
                    mod.relpath,
                    line,
                    f"{_top(dotted)} imported at module scope in a host "
                    "module (guard it behind try/except ImportError or "
                    "move it into the function that needs it)",
                )
                continue
            if _top(dotted) == "charon_tpu_torch":
                for hop in self._package_chain(dotted) + [dotted]:
                    chain = reaches(hop, 0)
                    if chain is not None:
                        flagged_lines.add(line)
                        yield Violation(
                            self.name,
                            mod.relpath,
                            line,
                            "module-scope import chain reaches "
                            f"{_top(chain[-1])}: " + " -> ".join(chain),
                        )
                        break
