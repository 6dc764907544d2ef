"""The PyTorch port stands alone: importing it pulls in neither jax nor any
module of the JAX reference package, and no source line imports them."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch, repro_torch.api
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""

_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""

# `import jax`, `from jax...`, `import repro`, `from repro.x import y`
# (but not repro_torch)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_import_loads_no_jax_and_no_reference_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.models", "repro_torch.serve",
                                    "repro_torch.launch.serve"])
def test_serving_modules_load_no_jax_alone(module):
    """Each serving entry point, imported on its own in a fresh process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.optim",
                                    "repro_torch.checkpoint"])
def test_training_modules_load_no_jax_alone(module):
    """Each training entry point, imported on its own in a fresh process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.fl.sharded",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.hostdevices",
                                    "repro_torch.launch.shardings",
                                    "repro_torch.launch.steps",
                                    "repro_torch.models.shardctx",
                                    "repro_torch.models.moe"])
def test_sharded_modules_load_no_jax_alone(module):
    """The sharded engines' modules (the round engine's and the LM mesh's),
    each imported on its own in a fresh process (a spawned rank imports
    them so)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.launch.hlo_stats",
                                    "repro_torch.launch.dryrun"])
def test_dryrun_modules_load_no_jax_alone(module):
    """The dry run's modules, each imported on its own in a fresh
    process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_FILE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_every_reference_example_has_a_torch_example():
    ref = {p.name for p in (ROOT / "examples").glob("*.py")
           if not p.name.startswith("torch_")}
    assert {p.name for p in EXAMPLES} == {f"torch_{n}" for n in ref}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_load_no_jax(path):
    """Each torch example, imported (not run) in a fresh process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_FILE, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_reference():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + EXAMPLES)
    assert len(files) > 20
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders
