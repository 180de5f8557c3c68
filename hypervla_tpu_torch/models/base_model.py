"""BaseModel: the no-hypernetwork ablation (counterpart of
hypervla_tpu/models/base_model.py).

The base network alone, its params learned directly: `create_tasks`
returns them, so the serving wrappers take a BaseModel where they take a
HyperVLA. Its params are the base net's flat dict keyed by block path (the
JAX package's base-net tree, flattened by utils/convert.py), and `plan` is
the weight plan of its config (with share_all_params every block shared).

The JAX trainer trains a base_pretrain_config as a HyperVLA whose blocks
are all shared; so does the port's trainer. BaseModel is what serves, saves
and loads the ablation. Its checkpoint is the layout of
models/hypervla.py (config.json, example_batch.npz,
dataset_statistics.json, <step>/params.pt), the params the base net's;
tools/convert_checkpoint_to_torch.py writes it from a JAX BaseModel
checkpoint.

As in the JAX package, sample_actions needs an rng (the JAX model hands
flax `rngs={"dropout": rng}`, which refuses None with a ValueError),
whichever head reads it.
"""
import copy
import json
import os
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.models.hypervla import (
    DEFAULT_TOKEN_DIM,
    PARAMS_FILE,
    _as_tensor,
    _host_tensors,
    _jsonable,
    _map_tree,
    _unflatten,
    check_params,
    latest_step,
)
from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.weight_plan import (
    build_weight_plan,
    init_base_net,
    input_shapes,
)
from hypervla_tpu_torch.parallel.mesh import process_index
from hypervla_tpu_torch.utils.convert import flatten_tree
from hypervla_tpu_torch.utils.device import resolve_device


class BaseModel:
    def __init__(self, base_net, config: dict, params, example_batch: dict,
                 dataset_statistics: Optional[dict], plan=None, device=None):
        self.base_net = base_net
        self.config = config
        self.params = params
        self.example_batch = example_batch
        self.dataset_statistics = dataset_statistics
        self.plan = plan
        self.device = device

    def replace(self, **changes) -> "BaseModel":
        new = copy.copy(self)
        for name, value in changes.items():
            if not hasattr(self, name):
                raise AttributeError(f"BaseModel has no field {name!r}")
            setattr(new, name, value)
        return new

    def create_tasks(self, goals=None, instruction_dict: dict = None,
                     initial_state=None):
        """The learned params and no task (the JAX BaseModel returns
        (params, None, None); the port's HyperVLA returns (base_params,
        tasks), and so does this)."""
        return self.params, None

    @torch.no_grad()
    def sample_actions(self, images, instruction_dict, task,
                       timestep_pad_mask, base_params, train: bool = False,
                       rng=None, image_embeddings=None,
                       trunk_impl: str = "kernel", maps=None):
        """The base net's action chunks (B, horizon, action_dim), as
        HyperVLA.sample_actions computes them from base_params; rng (a
        torch.Generator or a models/draws.py::Draws) is required, as in
        the JAX BaseModel."""
        if rng is None:
            raise ValueError("The ``rngs`` argument passed to an apply "
                             "function should be a ``jax.PRNGKey`` or a "
                             "dictionary mapping strings to ``jax.PRNGKey``.")
        if train:
            raise NotImplementedError(
                "sample_actions(train=True): sampling with dropout on is not "
                "ported (serving samples with train=False)")
        if images is not None:
            images = _as_tensor(images, self.device)
        if image_embeddings is not None:
            image_embeddings = _as_tensor(image_embeddings,
                                          self.device).float()
        instruction = None
        if self.base_net.encoder.use_language_token:
            instruction = _as_tensor(
                instruction_dict["language_instruction"]["token_embedding"],
                self.device).float()
        return self.base_net.predict_action(
            base_params, images, trunk_impl, instruction, maps, rng,
            image_embeddings)

    @classmethod
    def from_config(cls, config: dict, example_batch: dict, rng=None,
                    dataset_statistics: Optional[dict] = None,
                    device=None) -> "BaseModel":
        """A fresh base net for the shapes of example_batch; rng is the
        init's seed (an int; None: 0)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(0 if rng is None else int(rng))
        example_batch = _map_tree(lambda x: np.asarray(x)[:1], example_batch)
        base_net, params, plan = init_base_net(config, gen, example_batch)
        params = {k: v.to(device) for k, v in params.items()}
        return cls(base_net, config, params, example_batch,
                   dataset_statistics, plan, device)

    def save_pretrained(self, step: int,
                        checkpoint_path: Optional[str] = None,
                        checkpoint_manager=None) -> None:
        """Writes <checkpoint_path>/<step>/params.pt, and config.json,
        example_batch.npz and dataset_statistics.json where they are not
        there yet; only rank 0 of a process group writes."""
        if (checkpoint_path is None) == (checkpoint_manager is None):
            raise ValueError("Provide exactly one of checkpoint_path or "
                             "checkpoint_manager.")
        if checkpoint_manager is not None:
            raise NotImplementedError(
                "an orbax CheckpointManager needs JAX: pass checkpoint_path")
        if process_index() != 0:
            return
        path = os.path.abspath(checkpoint_path)
        step_dir = os.path.join(path, str(step))
        os.makedirs(step_dir, exist_ok=True)
        torch.save(_host_tensors(self.params),
                   os.path.join(step_dir, PARAMS_FILE))
        config_path = os.path.join(path, "config.json")
        if not os.path.exists(config_path):
            with open(config_path, "w") as f:
                json.dump(_jsonable(self.config), f)
        batch_path = os.path.join(path, "example_batch.npz")
        if not os.path.exists(batch_path):
            np.savez(batch_path, **flatten_tree(self.example_batch))
        stats_path = os.path.join(path, "dataset_statistics.json")
        if (not os.path.exists(stats_path)
                and self.dataset_statistics is not None):
            with open(stats_path, "w") as f:
                json.dump(_map_tree(lambda x: np.asarray(x).tolist(),
                                    self.dataset_statistics), f)

    @classmethod
    def load_pretrained(cls, checkpoint_path: str, step: Optional[int] = None,
                        device=None) -> "BaseModel":
        """The model saved under checkpoint_path at `step` (None: the
        latest), on `device` (None: the CUDA card); an example batch
        without a token embedding gets a zero one of width 768, as in the
        JAX package."""
        device = resolve_device(device)
        path = os.path.abspath(checkpoint_path)
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        with np.load(os.path.join(path, "example_batch.npz"),
                     allow_pickle=False) as data:
            example_batch = _unflatten({k: data[k] for k in data.files})
        instr = example_batch["task"]["language_instruction"]
        if "token_embedding" not in instr:
            instr["token_embedding"] = np.zeros(
                (*instr["input_ids"].shape, DEFAULT_TOKEN_DIM))
        stats_path = os.path.join(path, "dataset_statistics.json")
        dataset_statistics = None
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                dataset_statistics = _map_tree(np.array, json.load(f))
        base_net = BaseNetwork(**config["base_net_kwargs"],
                               octo_kwargs=config.get("model"),
                               input_shapes=input_shapes(example_batch))
        plan = build_weight_plan(config, base_net)
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no <step>/{PARAMS_FILE} under {path}")
        params = torch.load(os.path.join(path, str(step), PARAMS_FILE),
                            map_location=device, weights_only=True)
        check_params(params, base_net.specs())
        return cls(base_net, config, params, example_batch,
                   dataset_statistics, plan, device)
