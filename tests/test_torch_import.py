"""The port imports neither JAX, flax, ml_collections, absl nor the JAX
package, and every module of it (the CUDA kernel module included) imports
on a host with no nvcc. No string in its code names a module of the JAX
package either: a ModuleSpec names its callable by import path and resolves
it only when the spec is instantiated, after any import walk."""
import ast
import re
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hypervla_tpu",
                                    "ml_collections", "absl"))
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


#: a dotted name in the JAX package ("hypervla_tpu.data.oxe..."), which
#: "hypervla_tpu_torch." and the "hypervla_tpu/..." paths that cite lines
#: do not match
_JAX_MODULE = re.compile(r"(?<![\w.])hypervla_tpu\.[A-Za-z_]")


def _docstrings(tree):
    """The string constants that are docstrings (of the module, classes
    and functions)."""
    nodes = [tree] + [n for n in ast.walk(tree) if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return {id(n.body[0].value) for n in nodes
            if n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


def test_no_string_names_a_jax_module():
    bad = []
    for path in sorted((ROOT / "hypervla_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and _JAX_MODULE.search(node.value)):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: "
                           f"{node.value!r}")
    assert not bad, bad


def test_module_specs_resolve_in_the_port():
    """Every standardize_fn of the OXE registry's mixes names a function of
    the port, and each resolves there."""
    from hypervla_tpu_torch.data.oxe import make_oxe_dataset_kwargs_and_weights
    from hypervla_tpu_torch.data.oxe.oxe_dataset_mixes import OXE_NAMED_MIXES
    from hypervla_tpu_torch.utils.spec import ModuleSpec

    for mix in ("oxe_magic_soup", *sorted(OXE_NAMED_MIXES)):
        kwargs_list, _ = make_oxe_dataset_kwargs_and_weights(
            mix, "", load_camera_views=("primary",))
        for kwargs in kwargs_list:
            spec = kwargs["standardize_fn"]
            assert spec["module"].startswith("hypervla_tpu_torch."), spec
            fn = ModuleSpec.instantiate(spec)
            assert fn.func.__module__.startswith("hypervla_tpu_torch.")
