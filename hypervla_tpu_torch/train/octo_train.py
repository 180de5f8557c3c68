"""The Octo pretraining driver (counterpart of scripts/octo_train.py):

    python -m hypervla_tpu_torch.train.octo_train \\
        --config octo_pretrain_config:vit_s,oxe --save_dir <dir> [--cpu] \\
        [--config.<dotted.field>=<value> ...]

`run(config, save_dir=None, num_steps=None, dataset=None)` trains an
OctoModel (models/octo_model.py) as the JAX script does: the first batch
of the input pipeline (train/trainer.py::make_train_datasets, with
make_process_batch's tokenization) is the example batch the model is
built for (from the config's seed), the frozen T5 embeds each batch's
instructions inside the step, the "action" head's loss over the batch is
differentiated, the gradients clipped to their global norm
(optimizer.clip_gradient) and applied by AdamW (optax.adamw's arithmetic,
fp32 moments, weight_decay on every param) at the config's learning-rate
schedule; a checkpoint (save_pretrained) every save_interval steps.
Returns (model, the final params).

The training forward's random numbers (the diffusion head's steps and
noise, any dropout) come from one generator a step
(models/draws.py::draws_generator(seed, step)).

Under torchrun the ranks train data-parallel, as the JAX run's batch lies
on its mesh: each rank takes its rows of the global batch
(parallel/mesh.py::shard_batch) and its loss, weighted by its share of
the batch's valid action entries, so that the ranks' losses add up to the
loss over the global batch, and the gradients are summed over the ranks.
A group of one rank computes bit for bit what no group does. Only rank 0
logs and saves.
"""
import argparse
import logging
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hypervla_tpu_torch.models.action_heads import chunk_mask
from hypervla_tpu_torch.models.base_octo import OctoModule
from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.models.octo_model import OctoModel
from hypervla_tpu_torch.parallel.mesh import (
    batch_rows,
    create_mesh,
    init_distributed,
    process_index,
    shard_batch,
    to_device,
)
from hypervla_tpu_torch.train.main import apply_overrides, load_config
from hypervla_tpu_torch.train.optimizer import (
    clip_by_global_norm,
    create_lr_schedule,
    global_norm,
)
from hypervla_tpu_torch.train.trainer import (
    build_frozen_encoders,
    make_process_batch,
    make_train_datasets,
)
from hypervla_tpu_torch.utils.device import resolve_device

DEFAULT_CONFIG = "octo_pretrain_config:vit_s,oxe"

_F = np.float32


class AdamW:
    """optax.adamw(lr, weight_decay=wd): Adam's fp32 moments and bias
    corrections, plus wd * param on every param, times -lr(count), the
    schedule on the optimizer's own update count."""

    def __init__(self, schedule, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        """(updates, new state); the updates are added to params."""
        count_inc = state["count"] + 1
        c1 = float(_F(1) - _F(self.b1) ** _F(count_inc))
        c2 = float(_F(1) - _F(self.b2) ** _F(count_inc))
        step_size = float(-_F(self.schedule(state["count"])))
        updates, mu, nu = {}, {}, {}
        for name, g in grads.items():
            mu[name] = (1 - self.b1) * g + self.b1 * state["mu"][name]
            nu[name] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][name]
            u = (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + self.eps)
            updates[name] = step_size * (u + self.weight_decay
                                         * params[name])
        return updates, {"count": count_inc, "mu": mu, "nu": nu}


def _embed_task(task, t5_params, text_apply):
    """The task with the frozen T5's token embedding of its instruction
    (and a language pad mask where the batch has none)."""
    instr = dict(task["language_instruction"])
    with torch.no_grad():
        instr["token_embedding"] = text_apply(
            t5_params, instr["input_ids"], instr["attention_mask"]).float()
    task = dict(task, language_instruction=instr)
    if "pad_mask_dict" not in task:
        task["pad_mask_dict"] = {"language_instruction": torch.ones(
            instr["input_ids"].shape[0], dtype=torch.bool,
            device=instr["input_ids"].device)}
    return task


def _host_fields(batch):
    batch["task"].pop("instruction_string", None)
    batch.pop("dataset_name", None)
    return batch


def _all_sum(x):
    if dist.is_initialized():
        dist.all_reduce(x)
    return x


def step_draws(seed: int, step: int, device, rows=None) -> Draws:
    """The training forward's draws of step `step`."""
    return Draws(draws_generator(seed, step, device), rows=rows)


def make_train_step(model: OctoModel, config, text_apply, t5_params):
    """(AdamW, train_step): train_step(params, opt_state, batch, draws,
    n_global) runs one step in place on params (leaf tensors that require
    grad) over this rank's rows of a global batch of n_global rows and
    returns (the global batch's loss, the gradients' global norm before
    clipping, the new optimizer state)."""
    opt = config["optimizer"]
    tx = AdamW(create_lr_schedule(**opt["learning_rate"]),
               opt.get("weight_decay", 0.1))
    clip = opt.get("clip_gradient", 1.0)
    head = model.module.heads["action"]

    def loss_fn(params, batch, draws):
        task = _embed_task(batch["task"], t5_params, text_apply)
        pad = batch["observation"]["timestep_pad_mask"]
        outputs = model.module.octo_transformer(
            params, batch["observation"], task, pad, draws=draws)
        return head.loss(OctoModule.head_params(params, "action"),
                         outputs[head.readout_key], batch["action"], pad,
                         batch["action_pad_mask"], draws=draws,
                         per_sample=False)

    def train_step(params, opt_state, batch, draws, n_global):
        for p in params.values():
            p.grad = None
        local_loss, _ = loss_fn(params, batch, draws)
        weight = _rank_weight(batch, n_global, len(batch["action"]))
        (local_loss * weight).backward()
        grads = {k: _all_sum(p.grad) for k, p in params.items()}
        grad_norm = global_norm(grads)
        grads = clip_by_global_norm(grads, clip, norm=lambda _: grad_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        loss = _all_sum((local_loss * weight).detach())
        return loss, grad_norm, opt_state

    return tx, train_step


def run(config, save_dir=None, num_steps=None, dataset=None, device=None):
    """Trains an OctoModel; returns (model, the final params on the
    host). device: where it trains (None: the card)."""
    device = resolve_device(device)
    num_steps = num_steps if num_steps is not None else config["num_steps"]
    if dataset is None:
        dataset = make_train_datasets(config)
    process_batch = make_process_batch(config)
    text_apply, _, t5_params, _ = build_frozen_encoders(config, device)
    seed = config.get("seed", 0)

    data_iter = map(process_batch, iter(dataset.prefetch(2)))
    example_batch = _host_fields(next(data_iter))
    example_batch["task"] = _map_host(_embed_task(
        to_device(example_batch["task"], device), t5_params, text_apply))

    model = OctoModel.from_config(
        config, example_batch, rng=seed,
        dataset_statistics=getattr(dataset, "dataset_statistics", None),
        device=device)
    tx, train_step = make_train_step(model, config, text_apply, t5_params)
    mesh = create_mesh()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params.items()}
    opt_state = tx.init(params)
    for step in range(num_steps):
        batch = _host_fields(next(data_iter))
        n_global = len(batch["action"])
        batch = to_device(shard_batch(batch, mesh), device)
        rows = batch_rows(mesh, len(batch["action"]))
        loss, _, opt_state = train_step(
            params, opt_state, batch, step_draws(seed, step, device, rows),
            n_global)
        if (step + 1) % config.get("log_interval", 100) == 0 \
                and process_index() == 0:
            logging.info(f"step {step + 1}: loss={float(loss):.4f}")
        if save_dir and (step + 1) % config.get("save_interval", 10000) == 0:
            model.replace(params={k: v.detach() for k, v in params.items()}
                          ).save_pretrained(step=step + 1,
                                            checkpoint_path=save_dir)
    final = {k: v.detach().cpu() for k, v in params.items()}
    return model, final


def _map_host(tree):
    if isinstance(tree, dict):
        return {k: _map_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def _rank_weight(batch, n_global: int, n_local: int) -> float:
    """This rank's weight: its rows' share of the global batch's masked
    mean, max(M_r, 1e-5 N_r) / max(M, 1e-5 N) over the valid action
    entries M and all entries N of the loss mask (1.0 without a group)."""
    if not dist.is_initialized() or n_global == n_local:
        return 1.0
    mask = chunk_mask(batch["observation"]["timestep_pad_mask"].bool(),
                      batch["action_pad_mask"].bool())
    local = torch.tensor([float(mask.sum()), float(mask.numel())],
                         dtype=torch.float64, device=mask.device)
    total = _all_sum(local.clone())
    return float(max(local[0], 1e-5 * local[1])
                 / max(total[0], 1e-5 * total[1]))


def main(argv: Optional[List[str]] = None):
    """Parses argv (None: sys.argv) and trains; returns (model, params)."""
    parser = argparse.ArgumentParser(
        description="Train the Octo model with the PyTorch port.")
    parser.add_argument("--config", default=DEFAULT_CONFIG,
                        help="<file.py>:<string> or "
                        "octo_pretrain_config:<size>,<dataset>")
    parser.add_argument("--name", default="octo", help="experiment name")
    parser.add_argument("--save_dir", default=None,
                        help="checkpoint directory")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args, overrides = parser.parse_known_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    config = load_config(args.config)
    apply_overrides(config, overrides)
    created = init_distributed(cpu=args.cpu)
    try:
        return run(config, save_dir=args.save_dir,
                   device="cpu" if args.cpu else None)
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
