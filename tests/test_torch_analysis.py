"""PyTorch port: the project-invariant machinery (charon_tpu_torch/analysis:
the lint framework and its six rules, the concurrency sanitizer, and the
wire-schema, metrics and flight-recorder checks), held against the JAX
package.

  * The JAX package's tests/test_promrated.py (testutil/promrated.py, the
    rated-effectiveness sidecar), test_analysis_checks.py,
    test_analysis_lint.py and test_analysis_sanitizer.py run on the port's
    modules (`reference_cases`), but three cases that the port replaces:
    - `test_jax_free_allows_guarded_and_function_scope_imports`: the
      port's jax-free rule flags jax in the package at every scope, so
      the case is inverted (jax flagged everywhere in the package, torch
      allowed behind a guard or in a function of a host module);
    - `test_repo_tree_lints_clean` lints `charon_tpu/` and the reference's
      benches; the port's gate lints `charon_tpu_torch/` and its root
      scripts, exactly as `python -m charon_tpu_torch.analysis.lint
      charon_tpu_torch/ chip_smoke.py kernel_ab.py plane_ab.py`;
    - `test_instrumented_point_caches_production_order_is_clean` wraps
      the reference's `tbls/tpu_impl.PointCache`; here it wraps the
      port's `tbls/torch_impl.PointCache`.
  * The port's jax-free rule flags a planted `import jax`, `from jax
    import numpy`, `import jaxlib`, `from charon_tpu import tbls` or an
    `importlib.import_module("charon_tpu...")` in any port module and in
    chip_smoke.py, kernel_ab.py and plane_ab.py, at module scope, in a function, behind `try/except
    ImportError` and under `if TYPE_CHECKING:`, and a host module whose
    import chain reaches torch; the same files without the plant lint
    clean.
  * `scope_key` keys on `charon_tpu_torch/`, so every scoped rule sees
    the port's paths.
  * The port's schema_check, flightrec_check and metrics_check accept the
    committed tests/testdata/wire_schema.json,
    tests/testdata/flightrec_schema.json and docs/metrics.md, and give the
    reference's snapshots (no case runs `--update`).

Every case but the sanitizer's deliberate leaks runs under the
thread/task leak guard of tests/test_torch_chaos.py. Tolerance: exact.
"""

from __future__ import annotations

import pathlib
import shutil
import textwrap
import threading

import pytest
from test_torch_chaos import bounded, no_leaks
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu.analysis import flightrec_check as ref_flightrec_check
from charon_tpu.analysis import metrics_check as ref_metrics_check
from charon_tpu.analysis import schema_check as ref_schema_check
from charon_tpu_torch.analysis import flightrec_check, lint, metrics_check, schema_check
from charon_tpu_torch.analysis.rule_jax_free import JaxFreeHost
from charon_tpu_torch.analysis.sanitizer import LockGraph, LockOrderError, instrument_lock_attr
from charon_tpu_torch.tbls.torch_impl import PointCache

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROMRATED_CASES = export_cases(bounded(reference_cases("test_promrated")), globals())
CHECKS_CASES = export_cases(reference_cases("test_analysis_checks"), globals())
LINT_CASES = export_cases(
    reference_cases("test_analysis_lint"),
    globals(),
    skip=("test_jax_free_allows_guarded_and_function_scope_imports", "test_repo_tree_lints_clean"),
)
SANITIZER_CASES = export_cases(
    reference_cases("test_analysis_sanitizer"),
    globals(),
    skip=("test_instrumented_point_caches_production_order_is_clean",),
)
# the sanitizer's self-tests that leak a thread or a task on purpose
_DELIBERATE_LEAKS = frozenset(
    {"test_leaked_thread_detected_and_clean_shutdown_passes", "test_unclosed_executor_is_a_leak",
     "test_task_leaks_inside_running_loop", "test_task_destroyed_watcher_catches_task_dropped_past_its_loop"}
)


@pytest.fixture(autouse=True)
def leak_guard(request):
    if request.node.name in _DELIBERATE_LEAKS:
        yield
        return
    with no_leaks():
        yield


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    cases = (PROMRATED_CASES, CHECKS_CASES, LINT_CASES, SANITIZER_CASES)
    assert [len([n for n in c if n.startswith("test_")]) for c in cases] == [4, 17, 49, 12]
    for names in cases:
        for name in names:
            if name.startswith("test_"):
                assert not reference_modules(globals()[name]), name


# -- the gate: the port's tree lints clean -------------------------------------


ROOT_SCRIPTS = ("chip_smoke.py", "kernel_ab.py", "plane_ab.py")


def test_repo_tree_lints_clean():
    """`python -m charon_tpu_torch.analysis.lint charon_tpu_torch/
    chip_smoke.py kernel_ab.py plane_ab.py` exits 0: every violation is
    fixed or carries an audited pragma."""
    paths = [str(ROOT / "charon_tpu_torch"), *(str(ROOT / s) for s in ROOT_SCRIPTS)]
    violations, n = lint.lint_paths(paths)
    assert n > 100  # the walk saw the tree
    assert violations == [], "\n".join(v.render() for v in violations)
    assert lint.main(paths) == 0


def test_scope_key_keys_on_the_port_package():
    for path, key in (
        ("/x/y/charon_tpu_torch/core/qbft.py", "charon_tpu_torch/core/qbft.py"),
        ("charon_tpu_torch/p2p/codec.py", "charon_tpu_torch/p2p/codec.py"),
        ("/x/y/chip_smoke.py", "chip_smoke.py"),
        ("/x/charon_tpu/core/qbft.py", "qbft.py"),
    ):
        assert lint.scope_key(path) == key
    # a scoped rule fires on the port's path, as it does on the reference's
    from charon_tpu_torch.analysis.rule_monotonic_clock import MonotonicClock

    mod = lint.LintModule("import time\nx = time.time()\n", relpath="/x/charon_tpu_torch/core/fake.py")
    assert [v.rule for v in lint.check_module(mod, [MonotonicClock()])] == ["monotonic-clock"]


# -- the port's jax-free rule ---------------------------------------------------

PLANTS = {
    "module": "import jax\n",
    "from": "from jax import numpy as jnp\n",
    "jaxlib": "import jaxlib\n",
    "reference": "from charon_tpu import tbls as ref_tbls\n",
    "reference-sub": "import charon_tpu.core.qbft\n",
    "function": "def _planted():\n    import jax\n    return jax\n",
    "guarded": "try:\n    from charon_tpu.crypto import bls\nexcept ImportError:\n    bls = None\n",
    "type-checking": "from typing import TYPE_CHECKING\nif TYPE_CHECKING:\n    import jax.numpy\n",
    "importlib": "import importlib\n_m = importlib.import_module('charon_tpu.ops.limb')\n",
}
TARGETS = ("charon_tpu_torch/core/qbft.py", "charon_tpu_torch/ops/limb.py", "charon_tpu_torch/p2p/codec.py",
           "charon_tpu_torch/analysis/lint.py", "chip_smoke.py")


def _copy_tree(tmp_path) -> pathlib.Path:
    dst = tmp_path / "repo"
    shutil.copytree(ROOT / "charon_tpu_torch", dst / "charon_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build", "*.cu", "*.cuh"))
    for script in ROOT_SCRIPTS:
        shutil.copy(ROOT / script, dst / script)
    return dst


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_jax_free_flags_a_planted_import_anywhere_in_the_port(tmp_path, plant):
    """A planted import of jax or of the JAX package, at any scope,
    guarded or not, in a core, ops, host or analysis module or in
    chip_smoke.py: flagged on the planted line, and nothing else is."""
    repo = _copy_tree(tmp_path)
    for rel in TARGETS:
        path = repo / rel
        original = path.read_text()
        lines = len(original.splitlines())
        path.write_text(original + "\n" + PLANTS[plant])
        violations, _ = lint.lint_paths([str(path)], [JaxFreeHost()])
        assert len(violations) == 1, (rel, [v.render() for v in violations])
        assert violations[0].line > lines
        path.write_text(original)
        assert lint.lint_paths([str(path)], [JaxFreeHost()])[0] == []


@pytest.mark.parametrize("plant", ["module", "reference", "function", "guarded"])
@pytest.mark.parametrize("script", ["kernel_ab.py", "plane_ab.py"])
def test_jax_free_covers_the_root_scripts_beside_chip_smoke(tmp_path, script, plant):
    """kernel_ab.py and plane_ab.py run on the card beside chip_smoke.py:
    a jax or charon_tpu import planted in either is flagged on its line."""
    path = _copy_tree(tmp_path) / script
    original = path.read_text()
    assert lint.lint_paths([str(path)], [JaxFreeHost()])[0] == []
    path.write_text(original + "\n" + PLANTS[plant])
    [v] = lint.lint_paths([str(path)], [JaxFreeHost()])[0]
    assert v.rule == "jax-free-host" and v.line > len(original.splitlines())


def test_jax_free_host_module_reaches_no_torch(tmp_path):
    """A host module (the codec) whose import chain reaches torch through
    a port module is flagged with the chain; a guarded or function-scope
    torch import is not; a device module may import torch."""
    repo = _copy_tree(tmp_path)
    pkg = repo / "charon_tpu_torch"
    (pkg / "helper.py").write_text("import torch\n")
    codec = pkg / "p2p" / "codec.py"
    original = codec.read_text()
    codec.write_text(original + "\nfrom charon_tpu_torch import helper\n")
    [v] = lint.lint_paths([str(codec)], [JaxFreeHost()])[0]
    assert "charon_tpu_torch.helper -> torch" in v.message
    codec.write_text(original + textwrap.dedent("""
        try:
            import torch
        except ImportError:
            torch = None
        def _device():
            import torch
            return torch
        """))
    assert lint.lint_paths([str(codec)], [JaxFreeHost()])[0] == []
    codec.write_text(original + "\nimport torch\n")
    assert len(lint.lint_paths([str(codec)], [JaxFreeHost()])[0]) == 1
    assert lint.lint_paths([str(pkg / "ops" / "limb.py")], [JaxFreeHost()])[0] == []


def test_jax_free_allows_guarded_and_function_scope_imports():
    """The reference's case, inverted for the port: in a port module jax
    is flagged at every scope (guarded, under TYPE_CHECKING, in a
    function); in a host module torch is allowed behind a guard or in a
    function."""
    src = """
        try:
            import jax
        except ImportError:
            jax = None
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            import jax.numpy
        def kernel():
            import jax
            return jax
        """
    mod = lint.LintModule(textwrap.dedent(src), relpath="charon_tpu_torch/p2p/codec.py")
    assert [v.rule for v in lint.check_module(mod, [JaxFreeHost()])] == ["jax-free-host"] * 3
    src = src.replace("jax.numpy", "torch.cuda").replace("jax", "torch")
    mod = lint.LintModule(textwrap.dedent(src), relpath="charon_tpu_torch/p2p/codec.py")
    assert lint.check_module(mod, [JaxFreeHost()]) == []


def test_instrumented_point_caches_production_order_is_clean():
    """The reference's case on the port's PointCache (tbls/torch_impl):
    the production nesting, each cache lock held alone, is clean; a seeded
    inversion from another thread is caught."""
    pub = PointCache(lambda k: ("pub", k), maxsize=8)
    msg = PointCache(lambda k: ("msg", k), maxsize=8)
    g = LockGraph("pointcaches")
    instrument_lock_attr(pub, "_lock", "pointcache:pub", g)
    instrument_lock_attr(msg, "_lock", "pointcache:msg", g)
    assert pub(b"k1") == ("pub", b"k1")
    assert msg(b"r1") == ("msg", b"r1")
    g.check()
    with pub._lock:
        with msg._lock:
            pass
    err: list = []

    def inverted():
        try:
            with msg._lock:
                with pub._lock:
                    pass
        except LockOrderError as e:
            err.append(e)

    t = threading.Thread(target=inverted)
    t.start()
    t.join()
    assert err and "pointcache" in str(err[0])


# -- the checks accept the committed goldens ------------------------------------


@pytest.mark.parametrize(
    "port, ref",
    [(schema_check, ref_schema_check), (flightrec_check, ref_flightrec_check)],
    ids=["wire-schema", "flightrec-schema"],
)
def test_checks_accept_the_committed_goldens(port, ref, capsys):
    assert port.GOLDEN.resolve() == ref.GOLDEN.resolve()
    before = port.GOLDEN.read_bytes()
    assert port.main([]) == 0
    assert "stable" in capsys.readouterr().out
    assert port.current_snapshot() == ref.current_snapshot()
    assert port.GOLDEN.read_bytes() == before


def test_metrics_check_accepts_the_committed_docs(capsys):
    assert metrics_check.DOCS.resolve() == ref_metrics_check.DOCS.resolve()
    assert metrics_check.main([]) == 0
    assert metrics_check.registered_families() == ref_metrics_check.registered_families()
