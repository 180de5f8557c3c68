"""The port imports neither JAX, flax nor the JAX package, and every module
of it (the CUDA kernel module included) imports on a host with no nvcc."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, pkgutil, sys
import hypervla_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hypervla_tpu_torch.__path__,
                                               "hypervla_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hypervla_tpu"))
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15, out.stdout
    assert bad == "[]", out.stdout
