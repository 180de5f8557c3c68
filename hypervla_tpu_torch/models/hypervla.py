"""HyperVLA model facade (counterpart of hypervla_tpu/models/hypervla.py):
the hypernetwork, the base network, their params and the weight plan.

  * `from_config`: a fresh init with the bias-init protocol: output-head
    kernels start at zero and their biases hold a fresh base-net init, so
    at step 0 the hypernetwork emits exactly that base net for any task;
  * `create_tasks`: one hypernetwork forward per episode -> base params;
  * `sample_actions`: the base net alone, the per-step path;
  * `save_pretrained` / `load_pretrained`: the port's checkpoint, in the
    JAX package's layout with torch-native files:

        <dir>/config.json              the config, tuples as lists
        <dir>/example_batch.npz        the example batch, "/"-joined keys
        <dir>/dataset_statistics.json  the statistics, arrays as lists
        <dir>/<step>/params.pt         the flat params (utils/convert.py keys)
        <dir>/<step>/EMA_params.pt     {"EMA_<decay>": flat params}

    flax msgpack and orbax need JAX, which the GPU host lacks, so the
    example batch is an .npz and the params a torch.save'd dict, read back
    with weights_only=True. tools/convert_checkpoint_to_torch.py writes this
    layout from a JAX checkpoint.
"""
import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
from hypervla_tpu_torch.models.weight_plan import (
    VARIANCE_INIT,
    WeightPlan,
    build_weight_plan,
    init_base_net,
    input_shapes,
)
from hypervla_tpu_torch.parallel.mesh import process_index
from hypervla_tpu_torch.utils.convert import flatten_tree
from hypervla_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


#: the action head's settings a checkpoint from before they were configured
#: is read with (hypervla_tpu/models/hypervla.py::load_pretrained)
DEFAULT_ACTION_HEAD_KWARGS = dict(token_per_horizon=False,
                                  squash_continuous_action=True,
                                  clip_target=False, max_action=5.0)
#: the token width a checkpoint without a token embedding is read with
DEFAULT_TOKEN_DIM = 768
PARAMS_FILE = "params.pt"
EMA_FILE = "EMA_params.pt"


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _map_tree(fn, tree):
    """fn over the leaves of nested dicts (every non-dict is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dicts (utils/convert.py::flatten_tree's
    inverse)."""
    tree = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _param_specs(hypernet: HyperNetwork, config: dict, example_batch: dict):
    """The hypernetwork's param specs for the shapes of example_batch: the
    instruction's token embedding (B, L, token_dim) and, with
    initial-image conditioning, its patch embeddings (B, T, dim)."""
    tokens = example_batch["task"]["language_instruction"]["token_embedding"]
    patches = (example_batch.get("initial_state") or {}).get(
        "patch_embeddings")
    image_tokens = (patches.shape[1] if config["hypernet_kwargs"].get(
        "use_all_image_tokens", False) else 1)
    goal = example_batch["task"].get("image_primary")
    return hypernet.specs(
        instr_len=tokens.shape[1], token_dim=tokens.shape[-1],
        image_tokens=image_tokens,
        patch_dim=patches.shape[-1] if patches is not None else 0,
        goal_shape=None if goal is None else tuple(goal.shape[-3:-1]),
    )


def latest_step(checkpoint_path: str, filename: str = PARAMS_FILE):
    """The largest step directory of checkpoint_path holding `filename`,
    or None."""
    steps = [int(d) for d in os.listdir(checkpoint_path) if d.isdigit()
             and os.path.exists(os.path.join(checkpoint_path, d, filename))]
    return max(steps) if steps else None


def _host_tensors(params: Params) -> Params:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def save_ema_params(checkpoint_path: str, step: int, params: Params,
                    decay: float = 0.999) -> None:
    """Writes <step>/EMA_params.pt, {"EMA_<decay>": params}: the file the
    JAX trainer pickles as EMA_params.pkl (train/callbacks.py) and
    eval/model_loading.py::load_hypervla_policy swaps in."""
    step_dir = os.path.join(os.path.abspath(checkpoint_path), str(step))
    os.makedirs(step_dir, exist_ok=True)
    torch.save({f"EMA_{decay}": _host_tensors(params)},
               os.path.join(step_dir, EMA_FILE))


class HyperVLA:
    def __init__(self, hypernet: HyperNetwork, base_net, config: dict,
                 params: Params, plan: WeightPlan,
                 dataset_statistics: Optional[dict], device: torch.device,
                 example_batch: Optional[dict] = None):
        self.hypernet = hypernet
        self.base_net = base_net
        self.config = config
        self.params = params
        self.plan = plan
        self.dataset_statistics = dataset_statistics
        self.device = device
        # numpy, batch 1: the shapes the params were built for
        self.example_batch = example_batch

    def replace(self, **changes) -> "HyperVLA":
        """A copy with the given fields replaced (the JAX model's
        struct.dataclass replace), e.g. replace(params=ema_params)."""
        new = copy.copy(self)
        for name, value in changes.items():
            if not hasattr(self, name):
                raise AttributeError(f"HyperVLA has no field {name!r}")
            setattr(new, name, value)
        return new

    @classmethod
    def from_config(cls, config: dict, example_batch: dict, seed: int = 0,
                    dataset_statistics: Optional[dict] = None,
                    device=None) -> "HyperVLA":
        """example_batch gives the shapes the params depend on: the
        instruction's token embedding (B, L, token_dim), the frames
        (observation image_primary, B, window, H, W, 3; 224 x 224 where it
        has none), with initial-image conditioning the initial image's
        patch embeddings (B, T, dim) and with goal images the task's
        image_primary (B, H, W, 3)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        example_batch = _map_tree(lambda x: np.asarray(x)[:1], example_batch)
        base_net, init_params, plan = init_base_net(config, gen,
                                                    example_batch)
        hypernet = HyperNetwork(plan, config["hypernet_kwargs"])
        specs = _param_specs(hypernet, config, example_batch)
        params = {n: init(shape, gen).float()
                  for n, (shape, init) in specs.items()}

        def flat_init(init):
            return torch.cat([init[n].reshape(-1) for n in plan.names])

        # bias-init protocol (hypervla_tpu/models/hypervla.py:204-233): the
        # output heads' biases hold the fresh base net ("full": one flat
        # vector of every block; without output-head biases, each row of
        # the kernel a fresh base net of its own), the shared blocks their
        # own init; a VARIANCE_INIT head keeps its zero bias, and shared
        # TF heads take encoderblock_0's
        if hypernet.strategy == "full":
            if hypernet.output_head_bias:
                params["output_head/bias"] = flat_init(init_params)
            else:
                params["output_head/kernel"] = torch.stack(
                    [flat_init(init_base_net(config, gen, example_batch)[1])
                     for _ in range(hypernet.context_dim)])
        for name in plan.names:
            value = init_params[name].reshape(-1)
            if not plan.generation_flag[name]:
                params[WeightPlan.flat_name(name)] = value
                continue
            head = plan.head_name(name)
            if (hypernet.strategy != "block" or not hypernet.output_head_bias
                    or plan.output_head_info[head]["init_strategy"]
                    == VARIANCE_INIT):
                continue
            if (plan.share_tf_output_head and "encoderblock_" in name
                    and "encoderblock_0" not in name):
                continue  # only layer 0 seeds the shared head
            params[f"output_head_{head}/bias"] = value
        params = {k: v.to(device) for k, v in params.items()}
        return cls(hypernet, base_net, config, params, plan,
                   dataset_statistics, device, example_batch)

    # ------------------------- checkpoint contract -------------------------

    def save_pretrained(self, step: int, checkpoint_path: str) -> None:
        """Writes <checkpoint_path>/<step>/params.pt, and config.json,
        example_batch.npz and dataset_statistics.json where they are not
        there yet (the JAX package's save_pretrained writes them once per
        directory too). Under a process group only rank 0 writes, as the
        JAX package writes on process 0; the params must be whole there."""
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
        if not os.path.exists(batch_path) and self.example_batch is not None:
            np.savez(batch_path, **flatten_tree(self.example_batch))
        stats_path = os.path.join(path, "dataset_statistics.json")
        if (not os.path.exists(stats_path)
                and self.dataset_statistics is not None):
            with open(stats_path, "w") as f:
                json.dump(_map_tree(lambda x: np.asarray(x).tolist(),
                                    self.dataset_statistics), f)

    @classmethod
    def load_pretrained(cls, checkpoint_path: str, step: Optional[int] = None,
                        device=None) -> "HyperVLA":
        """The model saved under checkpoint_path at `step` (None: the
        latest step), on `device` (None: the CUDA card). Fills in what the
        JAX package's load_pretrained fills in for older checkpoints: the
        default action_head_kwargs and, where the example batch has no
        token embedding, a zero one of width 768."""
        device = resolve_device(device)
        path = os.path.abspath(checkpoint_path)
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        config["base_net_kwargs"].setdefault(
            "action_head_kwargs", dict(DEFAULT_ACTION_HEAD_KWARGS))
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
        hypernet = HyperNetwork(plan, config["hypernet_kwargs"])
        specs = _param_specs(hypernet, config, example_batch)
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no <step>/{PARAMS_FILE} under {path}")
        params = torch.load(os.path.join(path, str(step), PARAMS_FILE),
                            map_location=device, weights_only=True)
        check_params(params, specs)
        return cls(hypernet, base_net, config, params, plan,
                   dataset_statistics, device, example_batch)

    @torch.no_grad()
    def create_tasks(self, goals=None, instruction_dict: dict = None,
                     initial_state: Optional[dict] = None):
        """One hypernetwork forward for one task. goals are not read (the
        JAX create_tasks takes them and reads none either).

        instruction_dict["language_instruction"] holds `token_embedding`
        (1, L, token_dim) and `attention_mask` (1, L); initial_state holds
        `patch_embeddings` (1, T, dim) under initial-image conditioning. A
        model with include_goal_image reads the example batch's goal frame
        shape, zeros, padded out, as the JAX create_tasks fills every task
        key but the instruction. Returns (base_params, tasks): the per-task
        base params (no batch dim) and the task dict the hypernetwork
        read."""
        if instruction_dict is None:
            raise TypeError("create_tasks needs instruction_dict")
        instr = instruction_dict["language_instruction"]
        dev = self.device
        tokens = _as_tensor(instr["token_embedding"], dev).float()
        if tokens.shape[0] != 1:
            raise ValueError("create_tasks generates one task at a time")
        token_mask = _as_tensor(instr["attention_mask"], dev)
        pad_mask = torch.ones(tokens.shape[0], dtype=torch.bool, device=dev)
        patches = None
        if self.hypernet.use_initial_image:
            if initial_state is None:
                # the JAX hypernetwork subscripts the missing initial state:
                # the same exception type
                raise TypeError("this model conditions on the initial image:"
                                " create_tasks needs initial_state with "
                                "patch_embeddings")
            patches = _as_tensor(initial_state["patch_embeddings"],
                                 dev).float()
        tasks = {"language_instruction": instr,
                 "pad_mask_dict": {"language_instruction": pad_mask}}
        if self.hypernet.include_goal_image:
            goal = self.example_batch["task"]["image_primary"]
            tasks["image_primary"] = torch.zeros(
                goal.shape, dtype=torch.uint8, device=dev)
            tasks["pad_mask_dict"]["image_primary"] = torch.zeros_like(
                pad_mask)
        ctx = self.hypernet.context_embedding(
            self.params, tokens, token_mask, pad_mask, patches,
            tasks.get("image_primary"),
            tasks["pad_mask_dict"].get("image_primary"))
        generated = self.hypernet.generate(self.params, ctx)
        base_params = {
            n: (v[0] if self.plan.generation_flag[n] else v)
            for n, v in generated.items()
        }
        return base_params, tasks

    def shared_params(self, prefix: str = "encoder/image_encoder/",
                      params: Optional[Params] = None) -> Params:
        """The shared (task-independent) base-net blocks under `prefix`,
        reshaped from the hypernetwork's flat params (`params`, default the
        model's own) without running it (hypervla_tpu/models/
        hypernetwork.py::rebuild_shared_subtree). The reshapes are views,
        so gradients reach the flat params."""
        params = self.params if params is None else params
        return {
            n[len(prefix):]: params[WeightPlan.flat_name(n)].reshape(
                self.plan.param_shape[n])
            for n in self.plan.names
            if n.startswith(prefix) and not self.plan.generation_flag[n]
        }

    @torch.no_grad()
    def sample_actions(self, images, instruction_dict, task,
                       timestep_pad_mask, base_params: Params,
                       train: bool = False, rng=None, image_embeddings=None,
                       trunk_impl: str = "kernel",
                       maps: Optional[dict] = None):
        """images (B, 1, H, W, C) or (B, H, W, C) uint8 -> action chunks
        (B, horizon, action_dim), the JAX package's arguments in its order:
        instruction_dict["language_instruction"]["token_embedding"] (B, L,
        token_dim) feeds a policy with language tokens; task and
        timestep_pad_mask are taken and not read (the ViT base net reads
        neither, in both packages). rng is the diffusion head's: a
        torch.Generator, or a models/draws.py::Draws to replay; it raises
        without one, and the other heads do not read it. image_embeddings
        (B, patches, dim) stand in for the DINOv2 trunk's. train=True
        (sampling with dropout) raises NotImplementedError. trunk_impl
        picks the trunk (ops/serving.py::TRUNK_IMPLS); maps (a dict)
        receives the attention maps (models/base_vit.py::ViT.__call__; the
        trunk's on its layer loop: a per-layer trunk_impl)."""
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


def check_params(params: Params, specs: dict) -> None:
    """Raises ValueError unless params hold exactly the spec'd names at
    their shapes."""
    missing, extra = set(specs) - set(params), set(params) - set(specs)
    if missing or extra:
        raise ValueError(f"checkpoint params do not fit the config: missing "
                         f"{sorted(missing)[:5]}, unexpected "
                         f"{sorted(extra)[:5]}")
    for name, (shape, _) in specs.items():
        if tuple(params[name].shape) != tuple(shape):
            raise ValueError(f"checkpoint param {name} has shape "
                             f"{tuple(params[name].shape)}, the config "
                             f"{tuple(shape)}")


def _jsonable(obj):
    """A config tree as JSON builtins (hypervla_tpu/models/hypervla.py::
    _jsonable): tuples become lists."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
