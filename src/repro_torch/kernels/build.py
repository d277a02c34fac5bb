"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/`` at the
repository root, under a name that carries a hash of the source and the
flags; a library already built for that hash is loaded as it is. All
missing sources are compiled at once, one ``nvcc`` process each. The
libraries are loaded with ``ctypes``: no PyTorch headers are compiled, so a
build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_attention", "flash_decode", "moe_gmm", "mamba_scan", "hash_tree")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(cand)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):  # a header change rebuilds every source
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns the compiler's report (registers, spills) for each name built."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, out, p) in procs.items():
        log, _ = p.communicate()
        reports[name] = log
        if p.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib
