"""No module under portbench/ imports jax, jaxlib, flax or the JAX package
charon_tpu (top-level names compared whole: charon_tpu_torch is the port,
not the JAX package), the reference's side imports nothing of the
program, and the port's modules that a run loads pull none of them in."""

import ast
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "charon_tpu"}
# the generator, the reference, the control and the yardstick: nothing of the program
INDEPENDENT = ("bls381.py", "gen.py", "reference.py", "work.py", "peaks.py", "control.py", "spec.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(top_level_imports(f) & FORBIDDEN) for f in files}
    assert not {f: names for f, names in bad.items() if names}


def test_the_names_are_compared_whole():
    assert "charon_tpu_torch" not in FORBIDDEN
    assert top_level_imports(PORTBENCH / "system.py") & {"charon_tpu_torch"}


def test_the_reference_side_imports_nothing_of_the_program():
    for name in INDEPENDENT:
        assert "charon_tpu_torch" not in top_level_imports(PORTBENCH / name), name


def test_the_program_a_run_loads_pulls_in_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.system\n"
        "from charon_tpu_torch.core import autotune, cryptoplane\n"
        "from charon_tpu_torch.ops import mont_kernels\n"
        "from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh\n"
        "from charon_tpu_torch.tbls import torch_impl\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n" % (str(ROOT), FORBIDDEN)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
