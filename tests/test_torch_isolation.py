"""The port stands alone: no module of ``repro_torch`` nor any of its
examples (``examples/torch_*.py``) loads jax, ``repro`` or ``ml_dtypes``, and
its entry points never fall back to the CPU when CUDA is asked for."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.dist.step import make_serve_fns
from repro_torch.workspace import MeshExecutor
from repro_torch.launch import serve, train
from repro_torch.models.registry import build_model
from repro_torch.configs import get_config

SRC = Path(repro_torch.__file__).resolve().parents[1]


def test_no_module_imports_jax_or_repro():
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]
    assert "repro_torch.kernels.flash_decode" in names and "repro_torch.launch.serve" in names
    assert {"repro_torch.launch.train", "repro_torch.checkpoint.checkpoint", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.dist.ft", "repro_torch.launch.mesh",
            "repro_torch.tenancy.hub", "repro_torch.tenancy.memo", "repro_torch.launch.dryrun",
            "repro_torch.roofline", "repro_torch.roofline.model", "repro_torch.roofline.op_costs",
            "repro_torch.roofline.kernel_credit"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=SRC, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr


def test_importing_the_dry_run_starts_nothing():
    """The reference's dry-run sets XLA_FLAGS when imported; the port's
    sets no environment variable and starts no process group (the fake
    backend starts when a cell runs)."""
    code = (
        "import os, torch.distributed as dist\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.roofline\n"
        "assert dict(os.environ) == before, set(os.environ.items()) ^ set(before.items())\n"
        "assert not dist.is_initialized()\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=SRC, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("stablelm-1.6b").reduced())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_fns(model, device="cuda", max_len=16, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshExecutor()


EXAMPLES = ["torch_quickstart", "torch_wireframe_audit", "torch_twin_pipelines", "torch_train_lm"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_import_neither_jax_nor_repro(name):
    """Each port example loads (with everything its main reaches: the
    launch drivers, the workspace, the models) without jax or ``repro``."""
    path = SRC.parent / "examples" / f"{name}.py"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('example', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=SRC, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stdout + r.stderr
    source = path.read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|repro)\b", source, re.M), name
