"""OpenVLA baseline wrapper (counterpart of hypervla_tpu/eval/
openvla_interface.py, which is already torch + transformers).

Needs a local OpenVLA checkpoint; provides the same reset/step contract as
the other inference wrappers so the SIMPLER/LIBERO evaluators can run the
OpenVLA baseline side by side.
"""
from typing import Optional

import numpy as np

from hypervla_tpu_torch.eval.action_space import euler2axangle


class OpenVLAInference:
    def __init__(
        self,
        model_path: str = "openvla/openvla-7b",
        policy_setup: str = "google_robot",
        image_size: int = 224,
        action_scale: float = 1.0,
    ):
        import torch
        from transformers import AutoModelForVision2Seq, AutoProcessor

        self.torch = torch
        self.processor = AutoProcessor.from_pretrained(
            model_path, trust_remote_code=True, local_files_only=True
        )
        self.model = AutoModelForVision2Seq.from_pretrained(
            model_path,
            torch_dtype=torch.bfloat16,
            trust_remote_code=True,
            local_files_only=True,
        ).eval()
        self.policy_setup = policy_setup
        self.image_size = image_size
        self.action_scale = action_scale
        if policy_setup == "google_robot":
            self.unnorm_key = "fractal20220817_data"
            self.sticky_gripper_num_repeat = 15
        elif policy_setup == "widowx_bridge":
            self.unnorm_key = "bridge_orig"
            self.sticky_gripper_num_repeat = 1
        else:
            raise ValueError(f"Unknown policy setup {policy_setup}")
        self._reset_state()

    def _reset_state(self):
        self.task_description = None
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        self.previous_gripper_action = None

    def reset(self, task_description: str, *args, **kwargs):
        self._reset_state()
        self.task_description = task_description

    def step(self, image: np.ndarray,
             task_description: Optional[str] = None, *args, **kwargs):
        from PIL import Image

        if task_description is not None and task_description != self.task_description:
            self.reset(task_description)

        pil = Image.fromarray(image).resize(
            (self.image_size, self.image_size)
        )
        prompt = (
            f"In: What action should the robot take to "
            f"{self.task_description.lower()}?\nOut:"
        )
        inputs = self.processor(prompt, pil).to(
            self.model.device, dtype=self.torch.bfloat16
        )
        with self.torch.no_grad():
            raw_action = self.model.predict_action(
                **inputs, unnorm_key=self.unnorm_key, do_sample=False
            )
        raw_action = np.asarray(raw_action, dtype=np.float64)

        action = {}
        action["world_vector"] = raw_action[:3] * self.action_scale
        ax, angle = euler2axangle(*raw_action[3:6])
        action["rot_axangle"] = ax * angle * self.action_scale

        if self.policy_setup == "google_robot":
            current = float(raw_action[-1])
            relative = (
                0.0
                if self.previous_gripper_action is None
                else self.previous_gripper_action - current
            )
            self.previous_gripper_action = current
            if abs(relative) > 0.5 and not self.sticky_action_is_on:
                self.sticky_action_is_on = True
                self.sticky_gripper_action = relative
            if self.sticky_action_is_on:
                self.gripper_action_repeat += 1
                relative = self.sticky_gripper_action
            if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
                self.sticky_action_is_on = False
                self.gripper_action_repeat = 0
                self.sticky_gripper_action = 0.0
            action["gripper"] = relative
        else:
            action["gripper"] = 2.0 * (raw_action[-1] > 0.5) - 1.0

        flat = np.concatenate(
            [
                action["world_vector"],
                action["rot_axangle"],
                [action["gripper"]],
            ]
        ).astype(np.float32)
        return raw_action, flat, np.asarray(pil), None, 0.0
