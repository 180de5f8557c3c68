"""SIMPLER inference wrapper for the Octo model (counterpart of
hypervla_tpu/eval/octo_inference.py::OctoInference).

The closed-loop contract of eval/inference.py::InferenceWrapper, driving
models/octo_model.py::OctoModel.sample_actions: a history of the last
`horizon` resized frames with its pad mask, the action chunk unnormalized
with the dataset's statistics and ensembled (ActionEnsembler), the
rotation turned from Euler angles to axis-angle, and the gripper as the
robot takes it: google_robot's relative gripper, held for 15 steps once
it flips ("sticky"), widowx_bridge's open/close from the sign of
raw - 0.5.

init_rng seeds the wrapper's random numbers: each step splits a seed off
a host generator seeded with init_rng and draws the step's numbers from a
generator on the model's device seeded with it (the JAX wrapper splits a
key off its PRNGKey(init_rng) a step). Two wrappers with one init_rng
serve the same actions.
"""
from collections import deque
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.eval.action_ensemble import ActionEnsembler
from hypervla_tpu_torch.eval.action_space import euler2axangle
from hypervla_tpu_torch.ops import preprocess


class OctoInference:
    def __init__(self, model, policy_setup: str = "google_robot",
                 horizon: int = 2, pred_action_horizon: int = 4,
                 image_size: int = 256, action_scale: float = 1.0,
                 init_rng: int = 0, action_ensemble: bool = True):
        self.model = model
        self.policy_setup = policy_setup
        self.horizon = horizon
        self.pred_action_horizon = pred_action_horizon
        self.image_size = image_size
        self.action_scale = action_scale
        self.rng = torch.Generator().manual_seed(init_rng)
        self._tick_generator = None

        if policy_setup == "google_robot":
            self.sticky_gripper_num_repeat = 15
            dataset = "fractal20220817_data"
        elif policy_setup == "widowx_bridge":
            self.sticky_gripper_num_repeat = 1
            dataset = "bridge_dataset"
        else:
            raise ValueError(f"Unknown policy setup {policy_setup}")
        stats = model.dataset_statistics
        self.action_stats = (stats[dataset]["action"] if dataset in stats
                             else stats["action"])

        self.action_ensemble = action_ensemble
        self.action_ensembler = (ActionEnsembler(pred_action_horizon)
                                 if action_ensemble else None)
        self.image_history = deque(maxlen=horizon)
        self.num_image_history = 0
        self.task = None
        self.task_description = None
        self._reset_gripper_state()

    def _reset_gripper_state(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        self.previous_gripper_action = None

    def reset(self, task_description: str):
        self.task = self.model.create_tasks(texts=[task_description])
        self.task_description = task_description
        self.image_history.clear()
        self.num_image_history = 0
        if self.action_ensembler is not None:
            self.action_ensembler.reset()
        self._reset_gripper_state()

    def _split_rng(self):
        """This step's generator, on the model's device: seeded with a
        seed split off the host generator (init_rng)."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.rng))
        if self._tick_generator is None:
            self._tick_generator = torch.Generator(device=self.model.device)
        return self._tick_generator.manual_seed(seed)

    def _resize(self, image: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(image),
                            device=self.model.device)
        return preprocess.resize_image(
            x, (self.image_size, self.image_size)).cpu().numpy()

    def step(self, image: np.ndarray, task_description: Optional[str] = None):
        """One control tick: uint8 (H, W, 3) frame -> (raw_action, the
        (7,) action the robot takes)."""
        if (task_description is not None
                and task_description != self.task_description):
            self.reset(task_description)
        self.image_history.append(self._resize(image))
        self.num_image_history = min(self.num_image_history + 1,
                                     self.horizon)
        images = np.stack(list(self.image_history))
        horizon = len(self.image_history)
        pad_mask = np.ones(horizon, dtype=np.float64)
        pad_mask[: horizon - self.num_image_history] = 0

        observations = {"image_primary": images[None],
                        "timestep_pad_mask": pad_mask[None]}
        raw_actions = self.model.sample_actions(
            observations, self.task,
            unnormalization_statistics=self.action_stats,
            rng=self._split_rng())
        raw_actions = np.asarray(raw_actions[0].cpu().numpy())
        if self.action_ensemble:
            raw_action = self.action_ensembler.ensemble_action(raw_actions)
        else:
            raw_action = raw_actions[0]

        action = {"world_vector": raw_action[:3] * self.action_scale}
        roll, pitch, yaw = np.asarray(raw_action[3:6], dtype=np.float64)
        ax, angle = euler2axangle(roll, pitch, yaw)
        action["rot_axangle"] = ax * angle * self.action_scale

        if self.policy_setup == "google_robot":
            current = float(raw_action[-1])
            relative = (0.0 if self.previous_gripper_action is None
                        else self.previous_gripper_action - current)
            self.previous_gripper_action = current
            if abs(relative) > 0.5 and not self.sticky_action_is_on:
                self.sticky_action_is_on = True
                self.sticky_gripper_action = relative
            if self.sticky_action_is_on:
                self.gripper_action_repeat += 1
                relative = self.sticky_gripper_action
            if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
                self._reset_gripper_state()
            action["gripper"] = relative
        else:
            action["gripper"] = 2.0 * (raw_action[-1] > 0.5) - 1.0

        flat = np.concatenate([
            action["world_vector"],
            action["rot_axangle"].astype(np.float32),
            np.array([action["gripper"]], dtype=np.float32)])
        return raw_action, flat
