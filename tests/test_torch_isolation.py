"""The port stands alone: no module of ``repro_torch`` loads jax, ``repro`` or
``ml_dtypes``, and its entry points never fall back to the CPU when CUDA is
asked for."""

import os
import pkgutil
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
            "repro_torch.tenancy.hub", "repro_torch.tenancy.memo"} <= set(names)
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
