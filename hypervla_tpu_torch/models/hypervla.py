"""HyperVLA model facade (counterpart of hypervla_tpu/models/hypervla.py):
the hypernetwork, the base network, their params and the weight plan.

  * `from_config`: a fresh init with the bias-init protocol: output-head
    kernels start at zero and their biases hold a fresh base-net init, so
    at step 0 the hypernetwork emits exactly that base net for any task;
  * `create_tasks`: one hypernetwork forward per episode -> base params;
  * `sample_actions`: the base net alone, the per-step path.

Checkpoints are not ported yet (ROADMAP.md, queue A2): a model is built
from a config and a seed, or takes JAX params through utils/convert.py.
"""
from typing import Dict, Optional

import numpy as np
import torch

from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
from hypervla_tpu_torch.models.weight_plan import WeightPlan, init_base_net

Params = Dict[str, torch.Tensor]


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class HyperVLA:
    def __init__(self, hypernet: HyperNetwork, base_net, config: dict,
                 params: Params, plan: WeightPlan,
                 dataset_statistics: Optional[dict], device: torch.device):
        self.hypernet = hypernet
        self.base_net = base_net
        self.config = config
        self.params = params
        self.plan = plan
        self.dataset_statistics = dataset_statistics
        self.device = device

    @classmethod
    def from_config(cls, config: dict, example_batch: dict, seed: int = 0,
                    dataset_statistics: Optional[dict] = None,
                    device="cpu") -> "HyperVLA":
        """example_batch gives the shapes the params depend on: the
        instruction's token embedding (B, L, token_dim) and, with
        initial-image conditioning, its patch embeddings (B, T, dim)."""
        device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        base_net, init_params, plan = init_base_net(config, gen)
        hypernet = HyperNetwork(plan, config["hypernet_kwargs"])
        tokens = example_batch["task"]["language_instruction"][
            "token_embedding"]
        patches = (example_batch.get("initial_state") or {}).get(
            "patch_embeddings")
        image_tokens = (patches.shape[1] if config["hypernet_kwargs"].get(
            "use_all_image_tokens", False) else 1)
        specs = hypernet.specs(
            instr_len=tokens.shape[1], token_dim=tokens.shape[-1],
            image_tokens=image_tokens,
            patch_dim=patches.shape[-1] if patches is not None else 0,
        )
        params = {n: init(shape, gen).float()
                  for n, (shape, init) in specs.items()}
        # bias-init protocol (hypervla_tpu/models/hypervla.py:211-231)
        for name in plan.names:
            flat = WeightPlan.flat_name(name)
            value = init_params[name].reshape(-1)
            if plan.generation_flag[name]:
                params[f"output_head_{flat}/bias"] = value
            else:
                params[flat] = value
        params = {k: v.to(device) for k, v in params.items()}
        return cls(hypernet, base_net, config, params, plan,
                   dataset_statistics, device)

    @torch.no_grad()
    def create_tasks(self, instruction_dict: dict,
                     initial_state: Optional[dict] = None):
        """One hypernetwork forward for one task.

        instruction_dict["language_instruction"] holds `token_embedding`
        (1, L, token_dim) and `attention_mask` (1, L); initial_state holds
        `patch_embeddings` (1, T, dim) under initial-image conditioning.
        Returns (base_params, tasks): the per-task base params (no batch
        dim) and the task dict the hypernetwork read."""
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
                raise ValueError("this model conditions on the initial image")
            patches = _as_tensor(initial_state["patch_embeddings"],
                                 dev).float()
        ctx = self.hypernet.context_embedding(self.params, tokens, token_mask,
                                              pad_mask, patches)
        generated = self.hypernet.generate(self.params, ctx)
        base_params = {
            n: (v[0] if self.plan.generation_flag[n] else v)
            for n, v in generated.items()
        }
        tasks = {"language_instruction": instr,
                 "pad_mask_dict": {"language_instruction": pad_mask}}
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
    def sample_actions(self, images, base_params: Params,
                       trunk_impl: str = "kernel"):
        """images (B, 1, H, W, C) or (B, H, W, C) uint8 -> action chunks
        (B, horizon, action_dim); the mix head's argmax decode needs no
        random numbers."""
        images = _as_tensor(images, self.device)
        return self.base_net.predict_action(base_params, images, trunk_impl)
