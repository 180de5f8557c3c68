"""The benchmark of hypervla_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics (with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer ones), device, with --trace 1 a
breakdown, and last the checks (each number compared with its limit),
which standard error's last lines repeat."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run inside the checkout, at fixed paths (the port builds
# its kernels into build/kernels/ beside its package)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)
# libraries the port may load must not load JAX or TensorFlow behind it
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, ROOT)

from perfbench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
