"""PyTorch port: importing every module of `repro_torch` loads no JAX and
nothing of the reference package `repro`."""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(mods))
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # the package and its subpackages and modules were all imported
    assert int(res.stdout.strip()) >= 20, res.stdout
