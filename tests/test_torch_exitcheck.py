"""PyTorch port: a process that ends with a slot plane's shard threads
mid-program (charon_tpu_torch/testutil/exitcheck.py over
charon_tpu_torch/parallel/mesh.py and core/cryptoplane.py).

Each case runs a child process holding a SlotCryptoPlane over two CPU
shards, as tests/test_torch_plane_concurrent.py builds one, with a
program in flight on both shard threads (the spin program: Fp2 squares
for a second), alone or under an open SlotCoalescer whose device lane runs
it; the child then returns from main, calls sys.exit(1) or raises, with
neither close(). It must exit with its own code (0, 1, 1), never a signal,
within exitcheck.TIME_BOUND s, with its program ended or raised and no
shard thread alive at exit. failures() is held on made-up results. The
`cuda` case runs the same checks on the card with the plane's h2c program
and a coalescer's verify flush in flight:

    python -m pytest tests/test_torch_exitcheck.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from charon_tpu_torch.testutil import exitcheck as X

CASES = [(c, e) for c in (False, True) for e in X.ENDS]


@pytest.fixture(scope="module")
def cpu_children():
    """One child a case, all at once: each spends most of its time
    importing torch."""
    results = X.run_checks("cpu", work="spin", seconds=1.0, parallel=len(CASES))
    return {(r["coalescer"], r["end"]): r for r in results}


@pytest.mark.parametrize("coalescer,end", CASES, ids=[f"{'coalescer' if c else 'plane'}-{e}" for c, e in CASES])
def test_child_ends_with_its_own_code_mid_program(cpu_children, coalescer, end):
    r = cpu_children[coalescer, end]
    assert X.failures([r]) == [], r
    assert r["rc"] == X.ENDS[end] and r["signal"] is None and not r["timed_out"]
    assert r["seconds"] < X.TIME_BOUND
    rep = r["report"]
    assert rep["outcome"] == "ended" or rep["outcome"].startswith("raised: ")
    assert not [t for t in rep["threads"] if t.startswith("plane-shard")]
    if end == "raise":
        assert "RuntimeError: the process ends with the plane's program in flight" in r["stderr"]


def _result(**kw):
    r = {"device": "cpu", "end": "return", "coalescer": False, "work": "spin", "rc": 0, "signal": None,
         "timed_out": False, "seconds": 3.0, "report": {"outcome": "ended", "threads": [], "launches": 0},
         "stderr": ""}
    r.update(kw)
    return r


@pytest.mark.parametrize("fault,want", [
    (dict(rc=-11, signal="SIGSEGV"), "signal SIGSEGV"),
    (dict(rc=1), "exit code 1"),
    (dict(end="exit", rc=0), "want 1"),
    (dict(rc=-9, signal="SIGKILL", timed_out=True, seconds=120.5), "timed out True"),
    (dict(report=None), "no exit report"),
    (dict(report={"outcome": "pending", "threads": [], "launches": 0}), "work pending"),
    (dict(report={"outcome": "ended", "threads": ["plane-shard0_0"], "launches": 0}), "plane-shard0_0"),
])
def test_failures_name_each_fault(fault, want):
    assert X.failures([_result()]) == []
    [line] = X.failures([_result(**fault)])
    assert want in line


@pytest.mark.cuda
def test_children_on_the_card_end_with_their_own_code():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plane's shards launch the kernels")
    results = X.run_checks("cuda:0")
    assert X.failures(results) == []
    assert all(r["report"]["launches"] > 0 for r in results)
