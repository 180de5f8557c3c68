#!/usr/bin/env python3
"""What cutting the hypernetwork's packed fan-out output into its blocks
costs on the card: one slice a block against one torch.split.

    python tools/generate_backward_cost.py [--repeats 2]

Needs one CUDA card. For the flagship with the mix head and with the
diffusion head (full width, from a seed, random fan-out kernels), in
turns: hypervla_tpu_torch/models/hypernetwork.py::HyperNetwork.generate
as it stands (torch.split) and the same function cutting with one slice a
block (its first version, kept here), (a) the generation's forward and
backward alone at batch 64 (the gradient of sum(generated * c) for a
fixed random c), and (b) the fast-preset train step at batch 64 from one
state (chip_smoke.py's heads phase setup). For each it prints device
kernels and device busy ms (a torch.profiler trace of the device), and
whether the gradients (a) or the new params (b) are bit-equal to the
split's; then the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SEED, TRAIN_BATCH, device_busy  # noqa: E402
from hypervla_tpu_torch.configs import (  # noqa: E402
    apply_fast_training_preset,
    flagship_pretrain_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch  # noqa: E402
from hypervla_tpu_torch.models import hypernetwork  # noqa: E402
from hypervla_tpu_torch.models.draws import dropout  # noqa: E402
from hypervla_tpu_torch.models.hypervla import HyperVLA  # noqa: E402
from hypervla_tpu_torch.models.weight_plan import WeightPlan  # noqa: E402
from hypervla_tpu_torch.train.optimizer import (  # noqa: E402
    create_optimizer,
    hn_param_type_tree,
)
from hypervla_tpu_torch.train.train_state import TrainState  # noqa: E402
from hypervla_tpu_torch.train.train_step import (  # noqa: E402
    make_train_step,
    to_tensors,
)
from hypervla_tpu_torch.train.trainer import build_frozen_encoders  # noqa

SPLIT = hypernetwork.HyperNetwork.generate


def sliced(self, params, context_embedding, draws=None):
    """HyperNetwork.generate's "block" path with one slice a block."""
    plan = self.plan
    batch = context_embedding.shape[0]
    out = {}
    final_rate = self.hk.get("final_dropout_rate")
    for i, (token, names) in enumerate(self.packed_groups):
        heads = [plan.head_name(n) for n in names]
        kernel = torch.cat([params[f"output_head_{h}/kernel"]
                            for h in heads], dim=1)
        packed = context_embedding[:, token] @ kernel
        if self.output_head_bias:
            packed = packed + torch.cat(
                [params[f"output_head_{h}/bias"] for h in heads])
        packed = dropout(packed, final_rate, draws, f"final_dropout/{i}")
        offset = 0
        for name in names:
            dim = plan.dim(name)
            out[name] = packed[:, offset:offset + dim].reshape(
                batch, *plan.param_shape[name])
            offset += dim
    for name in plan.names:
        if not plan.generation_flag[name]:
            out[name] = params[WeightPlan.flat_name(name)].reshape(
                plan.param_shape[name])
    return out


VERSIONS = {"split": SPLIT, "one slice a block": sliced}


def build(head, device):
    config = flagship_pretrain_config()
    config["base_net_kwargs"]["action_head_type"] = head
    config["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] = "bfloat16"
    config = apply_fast_training_preset(config)
    model = HyperVLA.from_config(config, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    for name, value in model.params.items():
        if name.startswith("output_head_") and name.endswith("/kernel"):
            value += 0.02 * torch.randn(value.shape, generator=gen,
                                        device=device)
    return model, config


def generation(model, device):
    """fn() -> gradients: generate forward and backward at batch 64."""
    hn = model.hypernet
    params = {k: v.detach().requires_grad_(k.startswith("output_head_"))
              for k, v in model.params.items()}
    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    ctx = torch.randn((TRAIN_BATCH, hn.layer_token_num, hn.context_dim),
                      generator=gen, device=device)
    weights = {}

    def fn():
        for p in params.values():
            p.grad = None
        out = hn.generate(params, ctx)
        loss = 0.0
        for name, value in out.items():
            if model.plan.generation_flag[name]:
                if name not in weights:
                    weights[name] = torch.randn(value.shape, generator=gen,
                                                device=device)
                loss = loss + (value * weights[name]).sum()
        loss.backward()
        return {k: p.grad for k, p in params.items() if p.grad is not None}

    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    encoders = None
    for head in ("mix", "diffusion"):
        model, config = build(head, device)
        plan = model.plan
        blocks = sum(len(names) for _, names in model.hypernet.packed_groups)
        width = sum(plan.dim(n) for _, names in model.hypernet.packed_groups
                    for n in names)
        print(f"{head}: {blocks} generated blocks in "
              f"{len(model.hypernet.packed_groups)} token group(s), "
              f"{width} generated params a sample", flush=True)
        if encoders is None:
            text, dino, t5, dino_params = build_frozen_encoders(
                config, device=device, seed=SEED + 1)
            encoders = {"t5": t5, "dino": dino_params}
        tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
            model.params, hn_param_type_tree(model.params),
            **config["optimizer"])
        step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                                  pnorm_fn, text_encode=text,
                                  dino_encode=dino)
        state0 = TrainState.create(model.params, tx, seed=SEED)
        warmup = config["optimizer"]["learning_rate"]["warmup_steps"]
        state0.step = warmup
        state0.opt_state["count"] = warmup

        def step():
            return step_fn(state0, batch, encoder_params=encoders,
                           with_metrics=False)[0]

        gen_fn = generation(model, device)
        ref_grads = ref_params = None
        order = list(VERSIONS)
        for r in range(args.repeats):
            for name in order if r % 2 == 0 else order[::-1]:
                hypernetwork.HyperNetwork.generate = VERSIONS[name]
                grads = gen_fn()
                if ref_grads is None:
                    ref_grads = {k: v.clone() for k, v in grads.items()}
                same_grads = all(torch.equal(grads[k], v)
                                 for k, v in ref_grads.items())
                del grads
                gen_busy, gen_kernels = device_busy(gen_fn, host=False)
                new = step()
                if ref_params is None:
                    ref_params = {k: v.detach().clone()
                                  for k, v in new.params.items()}
                same_params = all(torch.equal(new.params[k], v)
                                  for k, v in ref_params.items())
                del new
                busy, kernels = device_busy(step, host=False)
                print(f"{head}, {name} (turn {r + 1}): generate forward + "
                      f"backward {gen_kernels:.0f} device kernels, device "
                      f"busy ms {gen_busy:.4f}, gradients bit-equal to the "
                      f"split's {same_grads}; train step {kernels:.0f} "
                      f"device kernels, device busy ms {busy:.4f}, new "
                      f"params bit-equal to the split's {same_params}",
                      flush=True)
        hypernetwork.HyperNetwork.generate = SPLIT
        del model, state0, step_fn, tx, gen_fn, ref_grads, ref_params
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
