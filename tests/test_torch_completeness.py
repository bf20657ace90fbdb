"""PyTorch port: every module of the JAX package has its counterpart.

Each `.py` file under `charon_tpu/` has a file of the same path under
`charon_tpu_torch/`, or sits on `ACCOUNTED` with the reason it has none;
each counterpart named there exists. A module added to the JAX package, or
a port module removed, fails here until it is ported or accounted for.
"""

from __future__ import annotations

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "charon_tpu", ROOT / "charon_tpu_torch"

# reference module -> (the port's counterpart, or None, and why)
ACCOUNTED = {
    "ops/pallas_mont.py": ("ops/mont_kernels.py", "its Pallas kernels K1-K6 are the hand-written CUDA kernels of "
                           "csrc/, bound by ops/mont_kernels.py"),
    "tbls/tpu_impl.py": ("tbls/torch_impl.py", "the device tbls backend, TorchImpl in place of TPUImpl"),
    "jaxcache.py": (None, "nvcc builds are cached in charon_tpu_torch/_build/; there is no XLA compile cache"),
    "analysis/jaxpr_check.py": (None, "the port traces no jaxpr: its device code is torch and hand-written CUDA"),
    "tbls/resilient.py": (None, "the port has no degrade ladders: a backend or kernel error reaches its caller"),
}


def _modules(pkg: pathlib.Path) -> set[str]:
    return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py") if "_build" not in p.parts}


def test_every_reference_module_is_ported_or_accounted_for():
    missing = sorted(_modules(REF) - _modules(PORT) - set(ACCOUNTED))
    assert missing == [], f"reference modules with no port counterpart and no reason: {missing}"


@pytest.mark.parametrize("ref", sorted(ACCOUNTED))
def test_accounted_modules_exist_and_are_not_ported_twice(ref):
    counterpart, reason = ACCOUNTED[ref]
    assert (REF / ref).is_file() and reason
    assert not (PORT / ref).exists(), f"{ref} is ported: take it off the list"
    if counterpart is not None:
        assert (PORT / counterpart).is_file()
