"""Closed-loop inference runtime (counterpart of
hypervla_tpu/eval/inference.py::InferenceWrapper, fused-serving path).

`reset` runs one hypernetwork forward (create_tasks), prepares the params
for serving (bf16 trunk; stacked layers, or with trunk_impl "layers" the
per-layer leaves) and clears the action history;
`step` runs the fused serving step (ops/serving.py) on the model's device
and applies the per-robot post-processing on the host (google-robot sticky
gripper, widowx binarisation, libero rescale).

The TPU package's per-step host path (multi-frame history, padded resize,
attention-map capture) is not ported yet: those options raise.
"""
import time
from enum import Enum
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.eval.action_space import euler2axangle
from hypervla_tpu_torch.models.base_vit import (
    DINO_IMAGE_MEAN,
    DINO_IMAGE_STD,
    RESOLUTION,
)
from hypervla_tpu_torch.models.encoders.dinov2 import dinov2_forward
from hypervla_tpu_torch.ops import preprocess
from hypervla_tpu_torch.ops.serving import (
    make_serving_step,
    per_layer_trunk,
    prepare_serving_params,
)


class NormalizationType(str, Enum):
    NORMAL = "normal"  # mean 0, std 1
    BOUNDS = "bounds"  # [-1, 1] from p01/p99


_DATASETS = {
    "google_robot": "fractal20220817_data",
    "widowx_bridge": "bridge_dataset",
    "libero": "libero",
    "metaworld": "metaworld",
}


class InferenceWrapper:
    def __init__(self, model, policy_setup: str = "libero",
                 horizon: int = 1, image_size: int = 224,
                 action_ensemble: bool = False, crop: bool = False,
                 padded_resize: bool = False,
                 save_attention_map: bool = False,
                 trunk_impl: str = "kernel") -> None:
        if horizon != 1 or padded_resize or save_attention_map:
            raise NotImplementedError(
                "only the fused serving path is ported: horizon=1, no padded "
                "resize, no attention-map capture (ROADMAP.md)"
            )
        if policy_setup not in _DATASETS:
            raise ValueError(f"Unknown policy setup: {policy_setup}")
        self.model = model
        self.policy_setup = policy_setup
        self.image_size = image_size
        self.action_ensemble = action_ensemble
        self.action_ensemble_temp = 0.0
        self.crop = crop
        self.trunk_impl = trunk_impl
        self.sticky_gripper_num_repeat = {
            "google_robot": 15, "widowx_bridge": 1}.get(policy_setup)
        dataset = _DATASETS[policy_setup]
        stats = model.dataset_statistics
        if stats is None:
            raise ValueError("the model carries no dataset statistics")
        if "action" in stats:
            self.unnormalization_statistics = stats["action"]
        elif dataset in stats:
            self.unnormalization_statistics = stats[dataset]["action"]
        else:
            raise ValueError(f"no action statistics for {dataset}")
        self.normalization_type = _find_normalization_type(model.config,
                                                           dataset)
        self._serving_step = None
        self.task = None
        self.task_description = None
        self._reset_gripper()

    def _reset_gripper(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        self.previous_gripper_action = None
        self.episode_step = 0

    def reset(self, task_description: str, instruction_dict: dict,
              initial_state: Optional[dict] = None) -> None:
        base_params, self.task = self.model.create_tasks(
            instruction_dict=instruction_dict, initial_state=initial_state
        )
        self.base_params = prepare_serving_params(
            self.model, base_params,
            stack_trunk=not per_layer_trunk(self.trunk_impl))
        self.instruction_dict = instruction_dict
        if self._serving_step is None:
            self._serving_step, self._init_history = make_serving_step(
                self.model,
                self.unnormalization_statistics,
                normalization_type=NormalizationType(
                    self.normalization_type).value,
                image_size=self.image_size,
                crop=self.crop,
                ensemble_temp=self.action_ensemble_temp,
                ensemble=self.action_ensemble,
                trunk_impl=self.trunk_impl,
            )
        self._serving_history = self._init_history()
        self.task_description = task_description
        self._reset_gripper()

    def step(self, image: np.ndarray, task_description: Optional[str] = None):
        """One control tick: uint8 (H, W, C) frame -> (raw_action, action,
        image, (task_description, task), seconds)."""
        if (task_description is not None
                and task_description != self.task_description):
            self.reset(task_description, self.instruction_dict)
        if image.dtype != np.uint8:
            raise ValueError(f"frames must be uint8, got {image.dtype}")
        start = time.perf_counter()
        raw_action, self._serving_history = self._serving_step(
            self.base_params, image, self._serving_history,
            self.episode_step,
        )
        raw_action = raw_action.cpu().numpy()
        seconds = time.perf_counter() - start
        action = self._postprocess(raw_action)
        self.episode_step += 1
        return raw_action, action, image, (self.task_description,
                                           self.task), seconds

    def _postprocess(self, raw_action):
        if self.policy_setup == "metaworld":
            action = raw_action.copy()
            action[-1] = 1 - action[-1]
            return action

        action = {"world_vector": raw_action[:3]}
        roll, pitch, yaw = np.asarray(raw_action[3:6], dtype=np.float64)
        ax, angle = euler2axangle(roll, pitch, yaw)
        action["rot_axangle"] = ax * angle

        if self.policy_setup == "google_robot":
            current_gripper_action = float(raw_action[-1])
            if self.previous_gripper_action is None:
                relative_gripper_action = 0
            else:
                relative_gripper_action = (
                    self.previous_gripper_action - current_gripper_action
                )  # google robot: 1 = close, -1 = open
            self.previous_gripper_action = current_gripper_action

            if (np.abs(relative_gripper_action) > 0.5
                    and self.sticky_action_is_on is False):
                self.sticky_action_is_on = True
                self.sticky_gripper_action = relative_gripper_action
            if self.sticky_action_is_on:
                self.gripper_action_repeat += 1
                relative_gripper_action = self.sticky_gripper_action
            if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
                self.sticky_action_is_on = False
                self.gripper_action_repeat = 0
                self.sticky_gripper_action = 0.0
            action["gripper"] = relative_gripper_action
        elif self.policy_setup == "widowx_bridge":
            action["gripper"] = 2.0 * (raw_action[-1] > 0.5) - 1.0
        elif self.policy_setup == "libero":
            action["gripper"] = 2 * raw_action[-1] - 1

        return np.concatenate(
            [
                action["world_vector"],
                action["rot_axangle"].astype(np.float32),
                np.array([action["gripper"]]).astype(np.float32),
            ]
        )


@torch.no_grad()
def initial_state(model, frame: np.ndarray) -> dict:
    """The initial-state dict of an episode's first frame: its fp32 DINOv2
    last hidden state (CLS + patches) from the model's shared image encoder
    (hypervla_tpu/eval/simpler.py::_initial_state does this in JAX)."""
    vit = model.base_net.encoder
    image = torch.as_tensor(frame, device=model.device)
    image = preprocess.resize_image(image, (RESOLUTION, RESOLUTION))[None]
    mean = torch.tensor(DINO_IMAGE_MEAN, device=model.device)
    std = torch.tensor(DINO_IMAGE_STD, device=model.device)
    pixels = (image.float() / 255.0 - mean) / std
    patches = dinov2_forward(vit.dino, model.shared_params(), pixels)
    return {"image_primary": image[:, None], "patch_embeddings": patches}


def _find_normalization_type(config, dataset):
    dk = config.get("dataset_kwargs", {})
    if "dataset_kwargs" in dk:
        return dk["dataset_kwargs"]["action_proprio_normalization_type"]
    for dataset_config in dk.get("dataset_kwargs_list", []):
        if dataset_config["name"] == dataset:
            return dataset_config["action_proprio_normalization_type"]
    return NormalizationType.NORMAL
