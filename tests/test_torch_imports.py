"""The port stands alone: every module of ``repro_torch`` imports with
jax made unimportable and loads nothing of the reference package, and
its entry points run on the CUDA card unless the caller asks for the
CPU."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.engine.core import TrainState
from repro_torch.serve import FederationServer
from repro_torch.utils.device import resolve_device

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(len(names), leaked)
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    expected = len(list(pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")))
    assert int(n_modules) == expected > 20
    assert leaked == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    theta = {"h": np.zeros((4, 3), np.float32),
             "M": np.zeros((4, 68, 36), np.float32),
             "d": np.zeros((4, 36), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederationServer(SMOKE, theta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surf.solve_federation(SMOKE, TrainState(theta), np.eye(8), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surf.make_problem(SMOKE)
    assert resolve_device("cpu") == torch.device("cpu")
    assert FederationServer(SMOKE, theta, device="cpu").device.type == "cpu"
