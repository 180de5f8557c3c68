#!/usr/bin/env python3
"""How the port's AdamW rounds its bf16 first moment, against jitted optax.

    python tools/adamw_first_moment_rounding.py [--n 65536] [--updates 3]

Runs where JAX and optax are installed, on the CPU. Applies
`optax.adamw(mu_dtype=bfloat16)` jitted, as the JAX train step compiles
it, for a few updates of random gradients, and beside it three ways to
update the stored bf16 moment mu with b1 rounded to bf16:

  * eager: the product b1 * mu rounded to bf16 first (optax's ops run
    one by one);
  * separate: the product in fp32, then (1 - b1) * g added in fp32;
  * fma: (1 - b1) * g + b1 * mu rounded to fp32 once, as a fused
    multiply-add computes it (hypervla_tpu_torch/train/optimizer.py::
    _adamw).

Prints, after each update, each way's count of elements that differ from
optax's mu and their largest absolute difference.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1 << 16)
    parser.add_argument("--updates", type=int, default=3)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    b1 = 0.9
    rng = np.random.default_rng(0)
    opt = optax.adamw(1e-3, mu_dtype=jnp.bfloat16, weight_decay=0.0)
    params = jnp.asarray(rng.standard_normal(args.n), jnp.float32)
    state = opt.init(params)
    update = jax.jit(opt.update)
    b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16)
    c = float(np.float32(1 - b1))
    mus = {k: torch.zeros(args.n, dtype=torch.bfloat16)
           for k in ("eager", "separate", "fma")}
    for i in range(args.updates):
        g = rng.standard_normal(args.n).astype(np.float32) * 1e-4
        _, state = update(jnp.asarray(g), state, params)
        ref = np.asarray(state[0].mu).astype(np.float32)
        gt = torch.from_numpy(g)
        mus["eager"] = ((1 - b1) * gt
                        + (b1_bf16 * mus["eager"]).float()).bfloat16()
        mus["separate"] = ((1 - b1) * gt + b1_bf16.float()
                           * mus["separate"].float()).bfloat16()
        mus["fma"] = (gt.double() * c + (b1_bf16.float() * mus[
            "fma"].float()).double()).float().bfloat16()
        line = []
        for name, mu in mus.items():
            diff = np.abs(mu.float().numpy() - ref)
            line.append(f"{name} {int((diff > 0).sum())} of {args.n} "
                        f"(max abs {diff.max():.6g})")
        print(f"update {i + 1}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
