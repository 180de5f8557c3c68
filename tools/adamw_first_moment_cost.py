#!/usr/bin/env python3
"""What the per-leaf AdamW update costs on the card with each way of
rounding its bf16 first moment.

    python tools/adamw_first_moment_cost.py [--repeats 2]

Needs one CUDA card. Builds the flagship's params (full width and depth,
from a seed) and the fast training preset's optimizer (per-leaf AdamW with
global-norm clipping), draws one set of gradients, and applies the
optimizer's update from one state with each version of
hypervla_tpu_torch/train/optimizer.py::_adamw, in turns:

  * "fp64, 3 passes": the function as it stands (the compiled JAX step's
    rounding);
  * "fp64, 7 passes": the same arithmetic with separate fp32 and fp64
    copies (its first version);
  * "eager": the product b1 * mu rounded to bf16 (optax's ops run one by
    one; the version before the repair).

For each it prints one line: device kernels and device busy ms of one
update (a torch.profiler trace of the device), ms per update (CUDA events,
the median of 5), the memory the update adds at its peak, and whether the
new first moment and the updates are bit-equal to the function as it
stands; then the card's name and power limit.
"""
import argparse
import copy
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SEED, device_busy  # noqa: E402
from hypervla_tpu_torch.configs import apply_fast_training_preset  # noqa: E402
from hypervla_tpu_torch.flagship import build_flagship  # noqa: E402
from hypervla_tpu_torch.train import optimizer  # noqa: E402


def fp64_seven_passes(g, mu, nu, p, c1, c2, step_size, wd, b1, b1_bf16,
                      b2, eps):
    b1_t = torch.tensor(b1_bf16, dtype=torch.bfloat16)
    decayed = b1_t.float() * mu.float()
    mu = (g.double() * float(optimizer._F(1 - b1))
          + decayed.double()).float()
    nu = (1 - b2) * g * g + b2 * nu
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    if wd:
        u = u + wd * p
    return step_size * u, mu.bfloat16(), nu


def eager(g, mu, nu, p, c1, c2, step_size, wd, b1, b1_bf16, b2, eps):
    mu = (1 - b1) * g + torch.tensor(b1_bf16, dtype=torch.bfloat16) * mu
    nu = (1 - b2) * g * g + b2 * nu
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    if wd:
        u = u + wd * p
    return step_size * u, mu.bfloat16(), nu


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    model, _ = build_flagship(seed=SEED, encoder_dtype="bfloat16",
                              training=True, device=device)
    config = apply_fast_training_preset(copy.deepcopy(model.config))
    params = {k: v.detach() for k, v in model.params.items()}
    tx, _, _, _ = optimizer.create_optimizer(
        params, optimizer.hn_param_type_tree(params), **config["optimizer"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    grads = {k: torch.randn(v.shape, generator=gen, device=device) * 1e-3
             for k, v in params.items()}
    _, state = tx.update(grads, tx.init(params), params)
    versions = {"fp64, 3 passes": optimizer._adamw,
                "fp64, 7 passes": fp64_seven_passes, "eager": eager}
    ref = None
    print(f"{len(params)} leaves, {sum(v.numel() for v in params.values())} "
          f"params; packed {config['optimizer'].get('packed', False)}")
    order = list(versions)
    for r in range(args.repeats):
        for name in order if r % 2 == 0 else order[::-1]:
            optimizer._adamw = versions[name]

            def update():
                return tx.update(grads, state, params)

            updates, new = update()
            if ref is None:
                ref = updates, new
            same = (all(torch.equal(updates[k], ref[0][k]) for k in updates)
                    and all(torch.equal(a, b) for a, b in zip(
                        _moments(new), _moments(ref[1]))))
            del updates, new
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            update()
            torch.cuda.synchronize()
            added = torch.cuda.max_memory_allocated() - base
            busy, kernels = device_busy(update, host=False)
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                update()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            print(f"{name} (turn {r + 1}): {kernels:.0f} device kernels, "
                  f"device busy ms {busy:.4f}, ms per update "
                  f"{statistics.median(times):.4f}, peak added "
                  f"{added / 2 ** 30:.4f} GiB, bit-equal to fp64, 3 passes "
                  f"{same}", flush=True)
    optimizer._adamw = versions["fp64, 3 passes"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def _moments(state):
    """The first moments of an optimizer state, in a fixed order."""
    inner = state.get("inner", state)
    return [inner["mu"][k] for k in sorted(inner["mu"])]


if __name__ == "__main__":
    raise SystemExit(main())
