"""The runnable walkthroughs on the port: each document of
``tools/check_docs.py::WALKTHROUGHS`` runs through the JAX package as
written and through ``repro_torch`` with ``repro`` read as ``repro_torch``,
each in a process of its own (the runtime walkthrough forks workers), and
the two print the same lines once wall times, ``encode_wall_s``, temporary
paths and the journal's ``bytes_on_disk`` are masked (that last varies with
the length of the timestamps, run to run, in either package)."""

import importlib.util
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load_check_docs():
    spec = importlib.util.spec_from_file_location("check_docs", REPO / "tools" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECK_DOCS = _load_check_docs()

# runs one document's blocks in one namespace, as check_docs.run_walkthrough
# does; "torch" reads every ``repro`` as ``repro_torch`` first
_RUN = """
import importlib.util, re, sys
spec = importlib.util.spec_from_file_location("check_docs", {tool!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
blocks = mod.PY_BLOCK_RE.findall(open({doc!r}).read())
if {port!r}:
    blocks = [re.sub(r"\\brepro\\b", "repro_torch", b) for b in blocks]
sys.path.insert(0, {src!r})
ns = {{}}
for i, b in enumerate(blocks):
    exec(compile(b, {name!r} + "#block" + str(i + 1), "exec"), ns)
print("BLOCKS", len(blocks))
"""

MASKS = [
    (re.compile(r"\d+(\.\d+)? ms\b"), "<ms> ms"),
    (re.compile(r"'encode_wall_s': [0-9.e+-]+"), "'encode_wall_s': <s>"),
    (re.compile(r"'bytes_on_disk': \d+"), "'bytes_on_disk': <n>"),
    (re.compile(r"wall=[0-9.e+-]+s"), "wall=<s>"),
    (re.compile(re.escape(tempfile.gettempdir()) + r"/tmp\w+"), "<tmp>"),
]


def _masked(text: str) -> list:
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text.splitlines()


@pytest.mark.parametrize("doc", CHECK_DOCS.WALKTHROUGHS)
def test_walkthrough_runs_on_the_port_as_on_the_reference(doc):
    runs = {}
    for port in (False, True):
        code = _RUN.format(tool=str(REPO / "tools" / "check_docs.py"), doc=str(REPO / doc), port=port,
                           src=str(REPO / "src"), name=doc)
        runs[port] = subprocess.Popen([sys.executable, "-W", "ignore", "-c", code], cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for port, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{doc} ({'port' if port else 'reference'}):\n{stderr[-3000:]}"
        out[port] = stdout
    ref, got = _masked(out[False]), _masked(out[True])
    assert ref[-1].startswith("BLOCKS") and int(ref[-1].split()[1]) >= 4, ref[-1]
    assert got == ref, "\n".join(f"ref  {a}\nport {b}" for a, b in zip(ref, got) if a != b) or (ref, got)


def test_every_walkthrough_names_the_reference():
    """The port's reading of a walkthrough changes every block that imports
    the package, so the parity above runs the port's code."""
    for doc in CHECK_DOCS.WALKTHROUGHS:
        blocks = CHECK_DOCS.PY_BLOCK_RE.findall((REPO / doc).read_text())
        assert any(re.search(r"\brepro\b", b) for b in blocks), doc
