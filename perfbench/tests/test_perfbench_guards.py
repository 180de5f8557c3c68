"""The run's guards: no card means no result; nothing the benchmark runs
imports JAX or the JAX package (top-level names compared whole); the
reference imports nothing of the program."""
import ast
import os
import shutil
import subprocess
import sys

from perfbench.harness import cell

BENCH = cell.BENCH_DIR
ROOT = cell.ROOT


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def sources(top):
    for base, _, names in os.walk(top):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_module_of_the_benchmark_imports_jax():
    for path in sources(BENCH):
        found = set(imports(path)) & set(cell.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert "hypervla_tpu_torch" not in set(imports(path)), path


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hypervla_tpu_torch_extra", object())
    assert "hypervla_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hypervla_tpu.models", object())
    assert "hypervla_tpu" in cell.forbidden_modules()


def test_a_tiny_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from perfbench.harness import cell\n"
        "from perfbench.tests.test_perfbench_line import tiny_files\n"
        "files = tiny_files('flagship.train_b256')\n"
        "cell.run_cell('flagship.train_b256', 3, 0.2, False, "
        "time.perf_counter(), 'cpu', files=files)\n"
        "print(cell.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=dict(
                             os.environ, USE_FLAX="0", USE_TF="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(capsys):
    if cell.check_devices(1) is None:
        return  # a card is here: the refusal cannot be seen
    rc = cell.main(["--workload", "flagship.train_b256", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_bare_checkout_fails_without_result(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ exits non-zero
    and prints nothing on standard output."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "flagship.train_b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
