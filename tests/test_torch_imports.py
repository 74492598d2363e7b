"""The port stands alone: it imports neither jax nor anything of the JAX
package, and its solver runs on CUDA unless asked for the CPU."""

import ast
import importlib
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "openr_tpu_torch"

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "openr_tpu" or name.startswith("openr_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())
import openr_tpu_torch
names = ["openr_tpu_torch"]
for m in pkgutil.walk_packages(openr_tpu_torch.__path__, "openr_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m.startswith(("jax.", "jaxlib", "openr_tpu."))
       or m == "openr_tpu"]
assert not bad, bad
print(" ".join(names))
"""

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def test_package_imports_without_jax_or_openr_tpu():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 20  # every submodule was imported
    assert {
        "openr_tpu_torch.probe_gather", "openr_tpu_torch.decision.artifact",
        "openr_tpu_torch.decision.linkstate", "openr_tpu_torch.ops.spf_split",
        "openr_tpu_torch.ops.election", "openr_tpu_torch.ops.ksp",
        "openr_tpu_torch.decision.ksp",
    } <= names


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_openr_tpu_import(path):
    for mod in _imports(REPO / path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "openr_tpu"), (path, mod)


def test_solver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from openr_tpu_torch import TorchSpfSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSpfSolver()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSpfSolver(device="cuda")
    assert TorchSpfSolver(device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("name", ["election", "ksp"])
def test_extern_c_signatures_match_argtypes(name):
    """Every C entry point of csrc/<name>.cu has as many parameters as the
    ctypes argtypes its wrapper module binds (the only check before a
    card), and the module binds no other."""
    mod = importlib.import_module(f"openr_tpu_torch.ops.{name}")
    src = (PKG / "csrc" / f"{name}.cu").read_text()
    sigs = {
        m.group(1): m.group(2)
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\s*\(([^)]*)\)', src)
    }
    assert set(sigs) == set(mod.ENTRY_POINTS)
    for fn, params in sigs.items():
        n_params = len([p for p in params.split(",") if p.strip()])
        assert n_params == len(mod.ENTRY_POINTS[fn][0]), fn
