"""secret-flow: secret key material must never reach an output channel.

The motivating near-miss is the DKG ceremony surface (this PR's sweep):
`frost.Round1Shares` / `frost.FrostResult` / `ceremony.DKGResult` were
plain dataclasses whose AUTO-GENERATED reprs embedded raw Shamir share
scalars and secret shares — one `log.warn(f"bad payload {msg}")`, one
asyncio "Task exception was never retrieved" traceback, or one codec
error printing its argument away from dumping long-lived validator key
material into logs that ship to aggregators. The same class of bug:
interpolating a share into a raised error message, stamping one into a
metrics label or tracer span attr, or handing one to the wire codec
outside the sealed share channel.

The rule is a function-scope taint analysis with alias resolution:

Sources (taint enters):
  * calls resolving to the key-material producers: tbls
    `generate_secret_key` / `threshold_split` / `recover_secret` (and
    the same method names on any object — every Implementation backend
    shares the contract), `shamir.split` / `shamir.recover_secret`,
    `bls.keygen`, `keystore.load_keys`, and the `secrets` module
    (`randbelow` / `token_bytes` — FROST nonces and polynomial
    coefficients are sampled from it);
  * parameters and attributes with canonical secret names (`secret`,
    `secrets`, `secret_key`, `secret_share`, `share_secrets`,
    `privkey`, `private_key`, `sk`, `ikm`, `shares`, `_polys`) — the
    cross-function half of alias resolution: a helper receiving a
    secret under one of these names is tainted without whole-program
    inference;
  * `self.<attr>` loads where any method of the class assigned that
    attr from a tainted value (class-level alias resolution).

Taint propagates through assignments, tuple/list/dict/set literals and
comprehensions, subscripts, arithmetic, `.items()`/`.values()` loops
(dict VALUES carry the secret; `for i, s in shares.items()` taints `s`,
not the index `i`), and pure converters (`int`/`bytes`/`str`/
`int.from_bytes`/`.to_bytes`/`.hex`/`bytes.fromhex`). It does NOT
propagate through arbitrary calls: `tbls.sign(secret, root)` returns a
PUBLIC partial signature and `g1_mul(G, k)` a public commitment —
one-way functions are where taint legitimately dies.

Sinks (violation when a tainted value arrives):
  * logging (`log.*`, `logging.*`, `logger.*`, `print`);
  * exception constructors in `raise` statements;
  * f-strings anywhere (a formatted secret is a leak wherever the
    string ends up), `repr(...)`, `"%"`/`.format` on string literals;
  * metrics label/observe calls (`.labels(...)`, `app.metrics.*`);
  * tracer span attributes (`.set_attr(...)`, `tracer.span(...)`);
  * the wire codec and transport (`codec.encode*`, `.publish` /
    `.broadcast` / `.send` / `.exchange`);
  * `@dataclass` fields with secret names missing `repr=False` (the
    auto-repr IS an output channel).

Legitimate sinks — keystore I/O (`store_keys`, EIP-2335 writes) and the
sealed per-recipient share channel in dkg/netdkg.py — carry audited
`# lint: allow(secret-flow)` pragmas explaining why the flow is safe.
"""

from __future__ import annotations

import ast
from typing import Iterator

from charon_tpu_torch.analysis.lint import LintModule, Rule, Violation, in_scope

_PREFIXES = ("charon_tpu_torch/",)

SECRET_NAMES = frozenset(
    {
        "secret",
        "secrets",
        "secret_key",
        "secret_share",
        "share_secrets",
        "privkey",
        "private_key",
        "sk",
        "ikm",
        "shares",
        "_polys",
        # remote crypto-plane tenant auth: the service token
        # is a bearer secret — only its HMAC proof may cross the wire.
        # Deliberately NOT bare "token": tracer contextvar tokens and
        # cancellation tokens are not secrets.
        "auth_token",
        "auth_tokens",
        "_auth_token",
        "_auth_tokens",
        "tenant_token",
        "tenant_tokens",
        "crypto_remote_token",
        "crypto_serve_tokens",
    }
)

# call targets (resolved via import aliases) that MINT secret material
_SOURCE_CALLS = frozenset(
    {
        "charon_tpu_torch.tbls.generate_secret_key",
        "charon_tpu_torch.tbls.threshold_split",
        "charon_tpu_torch.tbls.recover_secret",
        "tbls.generate_secret_key",
        "tbls.threshold_split",
        "tbls.recover_secret",
        "shamir.split",
        "shamir.recover_secret",
        "bls.keygen",
        "keystore.load_keys",
        "secrets.randbelow",
        "secrets.token_bytes",
        "secrets.token_hex",
    }
)
# ... and the same operations called as methods on ANY backend object
_SOURCE_METHODS = frozenset(
    {"generate_secret_key", "threshold_split", "recover_secret", "load_keys"}
)

_CONVERTER_BUILTINS = frozenset(
    {"int", "bytes", "bytearray", "str", "list", "tuple", "dict", "set",
     "sorted", "reversed"}
)
_CONVERTER_METHODS = frozenset(
    {"to_bytes", "hex", "items", "values", "get", "copy", "setdefault",
     "from_bytes", "fromhex"}
)

_LOG_ATTRS = frozenset(
    {"info", "warn", "warning", "error", "debug", "exception", "critical"}
)
_LOG_OBJECTS = frozenset({"log", "logger", "logging"})
_WIRE_METHODS = frozenset(
    {"publish", "broadcast", "send", "exchange", "encode",
     "encode_envelope"}
)
_METRIC_METHODS = frozenset({"labels"})
_SPAN_METHODS = frozenset({"set_attr", "set_attrs", "span"})
_KEYSTORE_METHODS = frozenset({"store_keys", "write_text", "write_bytes"})
# flight-recorder intake (app/flightrec.FlightRecorder.record and the
# hook adapters): events are dumped to disk and served at /debug/flight,
# so a tainted value reaching record() is an exfiltration path even
# though the sanitizer reduces structured objects to type names
_RECORD_METHODS = frozenset({"record"})


def _call_name(func: ast.AST, mod: LintModule) -> str | None:
    """Dotted name of a call target through this file's import aliases:
    `tbls.threshold_split` whether spelled via `import charon_tpu_torch.tbls
    as tbls`, `from charon_tpu_torch import tbls`, or a direct from-import."""
    if isinstance(func, ast.Name):
        ref = mod.from_imports.get(func.id)
        if ref:
            m, _, a = ref.partition(":")
            return f"{m}.{a}"
        return func.id
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        base = func.value.id
        modname = mod.imports.get(base)
        if modname:
            return f"{modname}.{func.attr}"
        ref = mod.from_imports.get(base)
        if ref:
            m, _, a = ref.partition(":")
            return f"{m}.{a}.{func.attr}"
        return f"{base}.{func.attr}"
    return None


def _is_source_call(call: ast.Call, mod: LintModule) -> bool:
    name = _call_name(call.func, mod)
    if name is not None:
        if name in _SOURCE_CALLS:
            return True
        # suffix match handles deep aliases (charon_tpu_torch.crypto.shamir.split)
        for src in _SOURCE_CALLS:
            if name.endswith("." + src):
                return True
    if isinstance(call.func, ast.Attribute):
        return call.func.attr in _SOURCE_METHODS
    return False


class _Scope:
    """Tainted-name set for one function (or module) body plus the
    owning class's tainted attribute names."""

    def __init__(self, mod: LintModule, class_attrs: frozenset[str] = frozenset()):
        self.mod = mod
        self.tainted: set[str] = set()
        self.class_attrs = class_attrs

    # -- expression taint --------------------------------------------------

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in SECRET_NAMES or node.attr in self.class_attrs:
                return True
            return False  # taint does not cross into non-secret attrs
        if isinstance(node, ast.Subscript):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.expr_tainted(node.left) or self.expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.expr_tainted(node.body) or self.expr_tainted(node.orelse)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(
                v is not None and self.expr_tainted(v) for v in node.values
            )
        if isinstance(node, ast.Starred):
            return self.expr_tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comp_tainted(node, [node.elt])
        if isinstance(node, ast.DictComp):
            return self._comp_tainted(node, [node.value])
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.Await):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.expr_tainted(node.value)
        return False

    def _comp_tainted(self, comp, results) -> bool:
        inner = _Scope(self.mod, self.class_attrs)
        inner.tainted = set(self.tainted)
        for gen in comp.generators:
            inner.bind_loop_target(gen.target, gen.iter)
        return any(inner.expr_tainted(r) for r in results)

    def _call_tainted(self, call: ast.Call) -> bool:
        if _is_source_call(call, self.mod):
            return True
        args_tainted = any(self.expr_tainted(a) for a in call.args) or any(
            kw.value is not None and self.expr_tainted(kw.value)
            for kw in call.keywords
        )
        func = call.func
        if isinstance(func, ast.Name) and func.id in _CONVERTER_BUILTINS:
            return args_tainted
        if isinstance(func, ast.Attribute):
            if func.attr in _CONVERTER_METHODS:
                # tainted.to_bytes(...) / int.from_bytes(tainted, ...)
                return self.expr_tainted(func.value) or args_tainted
        return False  # taint dies at one-way calls (sign, g1_mul, hash)

    # -- statement-level binding -------------------------------------------

    def bind(self, target: ast.AST, tainted: bool) -> None:
        """Taint is STICKY: the pass is not control-flow aware, so a
        later clean rebinding of a once-tainted name must not launder
        it (a reused loop variable would otherwise erase the taint of
        an earlier secret-carrying loop)."""
        if not tainted:
            return
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)

    def bind_loop_target(self, target: ast.AST, iterable: ast.AST) -> None:
        """`for tgt in iter`: dict `.items()` iteration taints only the
        VALUE half of a 2-tuple target (keys are share indices)."""
        if not self.expr_tainted(iterable):
            return
        if (
            isinstance(iterable, ast.Call)
            and isinstance(iterable.func, ast.Attribute)
            and iterable.func.attr == "items"
            and isinstance(target, (ast.Tuple, ast.List))
            and len(target.elts) == 2
        ):
            self.bind(target.elts[1], True)
            return
        self.bind(target, True)


def _dataclass_secret_fields(cls: ast.ClassDef, mod: LintModule):
    """Secret-named fields of a @dataclass lacking repr=False."""
    is_dc = any(
        (isinstance(d, ast.Name) and d.id == "dataclass")
        or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
        or (
            isinstance(d, ast.Call)
            and (
                (isinstance(d.func, ast.Name) and d.func.id == "dataclass")
                or (
                    isinstance(d.func, ast.Attribute)
                    and d.func.attr == "dataclass"
                )
            )
        )
        for d in cls.decorator_list
    )
    if not is_dc:
        return
    for stmt in cls.body:
        if not isinstance(stmt, ast.AnnAssign) or not isinstance(
            stmt.target, ast.Name
        ):
            continue
        if stmt.target.id not in SECRET_NAMES:
            continue
        hidden = False
        if isinstance(stmt.value, ast.Call):
            fname = _call_name(stmt.value.func, mod) or ""
            if fname.endswith("field"):
                for kw in stmt.value.keywords:
                    if (
                        kw.arg == "repr"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                    ):
                        hidden = True
        if not hidden:
            yield stmt


class SecretFlow(Rule):
    name = "secret-flow"
    description = (
        "secret key material (tbls secrets/shares, FROST nonces and "
        "polynomial coefficients) must not reach logging, raised error "
        "messages, f-strings/repr, metrics labels, span attrs, the "
        "wire codec, or dataclass auto-reprs"
    )

    def applies(self, mod: LintModule) -> bool:
        return in_scope(mod, _PREFIXES)

    def check(self, mod: LintModule) -> Iterator[Violation]:
        # dataclass auto-repr fields (module-wide)
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                for fld in _dataclass_secret_fields(cls, mod):
                    yield Violation(
                        self.name,
                        mod.relpath,
                        fld.lineno,
                        f"dataclass {cls.name}.{fld.target.id} is secret "
                        "material reachable via auto-repr (any log/"
                        "traceback formatting the object dumps it); "
                        "declare it field(repr=False)",
                    )

        # per-class tainted attribute names (self.<attr> = tainted)
        class_attrs: dict[ast.ClassDef, frozenset[str]] = {}
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs: set[str] = set()
            for fn in cls.body:
                if not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                sc = self._function_scope(fn, mod, frozenset())
                for stmt in ast.walk(fn):
                    if isinstance(stmt, ast.Assign):
                        for tgt in stmt.targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                                and sc.expr_tainted(stmt.value)
                            ):
                                attrs.add(tgt.attr)
            class_attrs[cls] = frozenset(attrs)

        # function scopes (methods get their class's tainted attrs)
        owners: dict[ast.AST, frozenset[str]] = {}
        for cls, attrs in class_attrs.items():
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owners[fn] = attrs
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(
                    fn, mod, owners.get(fn, frozenset())
                )

    # -- per-function ------------------------------------------------------

    def _function_scope(
        self, fn, mod: LintModule, class_attrs: frozenset[str]
    ) -> _Scope:
        """Forward taint pass over the function body (two passes so
        later-defined aliases of earlier taint resolve without a full
        fixpoint — the code under analysis is straight-line)."""
        sc = _Scope(mod, class_attrs)
        args = fn.args
        for a in (
            list(args.posonlyargs)
            + list(args.args)
            + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        ):
            if a.arg in SECRET_NAMES:
                sc.tainted.add(a.arg)
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    t = sc.expr_tainted(node.value)
                    for tgt in node.targets:
                        if t:
                            sc.bind(tgt, True)
                        elif isinstance(tgt, ast.Name):
                            # do not UNtaint on reassignment ambiguity:
                            # walk order is lexical within a pass
                            pass
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    if sc.expr_tainted(node.value):
                        sc.bind(node.target, True)
                elif isinstance(node, ast.AugAssign):
                    if sc.expr_tainted(node.value):
                        sc.bind(node.target, True)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    sc.bind_loop_target(node.target, node.iter)
                elif isinstance(node, ast.NamedExpr):
                    if sc.expr_tainted(node.value):
                        sc.bind(node.target, True)
                elif isinstance(node, ast.comprehension):
                    sc.bind_loop_target(node.target, node.iter)
        return sc

    def _check_function(
        self, fn, mod: LintModule, class_attrs: frozenset[str]
    ) -> Iterator[Violation]:
        # one violation per line: `print(f"share {s}")` is one leak,
        # not a print-sink finding plus an f-string finding (ast.walk
        # visits the call first, so the specific sink message wins)
        seen: set[int] = set()
        for v in self._check_function_raw(fn, mod, class_attrs):
            if v.line not in seen:
                seen.add(v.line)
                yield v

    def _check_function_raw(
        self, fn, mod: LintModule, class_attrs: frozenset[str]
    ) -> Iterator[Violation]:
        # no tainted-locals early-out: secret-named ATTRIBUTE loads
        # (`res.secret_share` on an untainted parameter) are sources
        # too, so every function gets the sink scan
        sc = self._function_scope(fn, mod, class_attrs)

        def names_in(expr: ast.AST) -> bool:
            """Deep scan: does any tainted value appear inside expr?
            `len(tainted)` subtrees are pruned — a COUNT of secrets is
            attribution data, not secret material."""
            if isinstance(expr, ast.Call) and (
                isinstance(expr.func, ast.Name) and expr.func.id == "len"
            ):
                return False
            if isinstance(expr, ast.Name):
                return expr.id in sc.tainted
            if isinstance(expr, ast.Attribute) and (
                expr.attr in SECRET_NAMES or expr.attr in class_attrs
            ):
                return True
            return any(names_in(c) for c in ast.iter_child_nodes(expr))

        for node in ast.walk(fn):
            # f-strings: a formatted secret is a leak wherever it lands
            if isinstance(node, ast.JoinedStr):
                for part in node.values:
                    if isinstance(part, ast.FormattedValue) and names_in(
                        part.value
                    ):
                        yield Violation(
                            self.name, mod.relpath, node.lineno,
                            "secret-tainted value interpolated into an "
                            "f-string",
                        )
                        break
                continue
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
                # "..." % tainted
                if isinstance(node.left, ast.Constant) and isinstance(
                    node.left.value, str
                ) and names_in(node.right):
                    yield Violation(
                        self.name, mod.relpath, node.lineno,
                        "secret-tainted value %-formatted into a string",
                    )
                continue
            if isinstance(node, ast.Raise) and node.exc is not None:
                if isinstance(node.exc, ast.Call) and any(
                    names_in(a) for a in node.exc.args
                ):
                    yield Violation(
                        self.name, mod.relpath, node.lineno,
                        "secret-tainted value in a raised exception "
                        "message (tracebacks are log output)",
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            arg_hit = any(names_in(a) for a in node.args) or any(
                kw.value is not None and names_in(kw.value)
                for kw in node.keywords
            )
            if not arg_hit:
                continue
            if isinstance(func, ast.Name):
                if func.id == "print":
                    yield Violation(
                        self.name, mod.relpath, node.lineno,
                        "secret-tainted value printed",
                    )
                elif func.id == "repr":
                    yield Violation(
                        self.name, mod.relpath, node.lineno,
                        "repr() of a secret-tainted value",
                    )
                elif func.id in _KEYSTORE_METHODS:
                    yield Violation(
                        self.name, mod.relpath, node.lineno,
                        f"secret-tainted value written via {func.id}() "
                        "(keystore I/O must carry an audited pragma)",
                    )
                continue
            if not isinstance(func, ast.Attribute):
                continue
            attr = func.attr
            base = func.value
            if attr in _LOG_ATTRS and (
                (isinstance(base, ast.Name) and base.id in _LOG_OBJECTS)
                or mod.is_module_ref(base, "charon_tpu_torch.app.log")
                or mod.is_module_ref(base, "logging")
            ):
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    f"secret-tainted value in a {attr}() log call",
                )
            elif attr in _WIRE_METHODS:
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    f"secret-tainted value handed to the wire "
                    f"({attr}()) — sealed share channels carry an "
                    "audited pragma",
                )
            elif attr in _METRIC_METHODS:
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    "secret-tainted value in a metrics label",
                )
            elif attr in _SPAN_METHODS:
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    "secret-tainted value in a tracer span attribute",
                )
            elif attr in _KEYSTORE_METHODS:
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    f"secret-tainted value written via .{attr}() "
                    "(keystore I/O must carry an audited pragma)",
                )
            elif attr in _RECORD_METHODS:
                yield Violation(
                    self.name, mod.relpath, node.lineno,
                    "secret-tainted value recorded into the flight "
                    "recorder (events are dumped to disk and served "
                    "at /debug/flight)",
                )
