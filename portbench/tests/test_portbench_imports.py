"""Nothing of the benchmark imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), nothing reads the old benchmarks' folder, the reference and
the block files import nothing of the port, and a run without a card prints
no result."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SOURCES = [p for p in sorted(PKG.rglob("*.py")) if p != Path(__file__).resolve()]


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_old_benchmarks(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}
    strings = [n.value for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.Constant)
               and isinstance(n.value, str)]
    assert not any("benchmarks/" in s or s == "benchmarks" or "BENCH_koalja" in s for s in strings)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((PKG / "reference").glob("*.py")) + sorted((PKG / "blocks").glob("*.py")):
        assert not imported(path) & {"repro_torch", "repro"}, path


def test_without_a_card_no_result(tmp_path):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "stablelm-serve-prefill-4096", "--seed",
                           str(2**31 + 5), "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path),
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
