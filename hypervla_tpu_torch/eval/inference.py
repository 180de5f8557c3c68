"""Closed-loop inference runtime (counterpart of
hypervla_tpu/eval/inference.py::InferenceWrapper).

`reset` runs one hypernetwork forward (create_tasks), prepares the params
for serving (bf16 trunk; stacked layers, or with a per-layer trunk_impl the
per-layer leaves) and clears the histories. `step` takes one of two paths,
chosen as the JAX wrapper chooses:

  * the host path (fused_serving=False, the default): the frame is resized
    (optionally padded to 256x320 first, and centre-cropped), pushed on the
    image history, and run through model.sample_actions; the action chunk is
    unnormalised and ensembled on the host (ActionEnsembler). The trunk runs
    as trunk_impl says, the stacked trunk kernel (kernel 1,
    ops/dino_layer.py::dino_layers_serving) by default; the JAX host path
    runs its layer loop, which trunk_impl "layers" selects;
  * the fused serving step (fused_serving=True, and no padded resize): one
    call of ops/serving.py's step on the model's device, the trunk as
    trunk_impl says.

Either way the per-robot post-processing (google-robot sticky gripper,
widowx binarisation, libero rescale) runs on the host.

A history window over one frame (horizon > 1) is the JAX wrapper's: the
host path keeps the last `horizon` frames and hands them to the base net,
whose ViT reads one frame, so the first step (one frame in the history)
runs and the second raises ValueError, in both packages; the fused step
takes no history, and horizon > 1 takes the host path.

save_attention_map=True leaves the fused step, as the JAX wrapper does,
and runs the host path with the trunk's layer loop (trunk_impl "layers"
for a bf16 trunk: the stacked trunk captures nothing); each step keeps
`dino_attention_map` (trunk layers, heads, patches), every trunk layer's
class-token row without itself, where the config captures the trunk's
maps (sow_dino_attention), and `head_attention_map` (policy layers, heads,
tokens - 1), every policy ViT layer's last row without itself.

init_rng seeds the wrapper's random numbers, which only the diffusion head
reads: each step splits a seed off a host generator seeded with init_rng
and draws the tick's numbers from a generator on the model's device seeded
with it (the JAX wrapper splits a key off its PRNGKey(init_rng) a step).
Two wrappers with one init_rng serve the same actions; the mix, continuous
and discrete heads serve the same actions under any.
"""
import logging
import time
from collections import deque
from enum import Enum
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.eval.action_ensemble import ActionEnsembler
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
    resolve_trunk_impl,
    trunk_impl_of,
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
#: the size resize_with_pad pads to before the square resize
PADDED_SIZE = (256, 320)


class InferenceWrapper:
    def __init__(self, model=None, policy_setup: str = "libero",
                 horizon: int = 1, pred_action_horizon: int = 1,
                 exec_horizon: int = 1, image_size: int = 256,
                 init_rng: int = 0, action_ensemble: bool = False,
                 crop: bool = False, save_attention_map: bool = False,
                 padded_resize: bool = False, fused_serving: bool = False,
                 trunk_kernel=False, trunk_impl=None) -> None:
        """The JAX wrapper's arguments with its defaults: image_size 256,
        at which a DINOv2 model's step fails (its trunk takes 224 x 224:
        an AssertionError, as in the JAX package), so a DINOv2 policy is
        served with image_size=224 (load_hypervla_policy's default).
        trunk_kernel takes the JAX values (ops/serving.py::trunk_impl_of:
        True or "pallas" is kernel 1, "scan" or "unroll" its plain
        version; False leaves the choice to trunk_impl) on either path.
        trunk_impl is one of ops/serving.py::TRUNK_IMPLS, or None
        (ops/serving.py::resolve_trunk_impl: the stacked trunk kernel for
        a DINOv2 model, nothing for a model with a generated conv stem,
        which takes no other value). exec_horizon is taken for the JAX
        signature: a step returns one action (receding-horizon execution
        is the environment loop's, so exec_horizon must be 1). init_rng
        seeds the diffusion head's draws (the module docstring). Without a
        model the wrapper holds its settings only, as the JAX one does.
        The JAX wrapper's pack_args, a TPU dispatch workaround, is not
        taken."""
        if exec_horizon != 1:
            raise ValueError(
                f"exec_horizon={exec_horizon}: a step returns one action; "
                "execute a chunk in the environment loop")
        if policy_setup not in _DATASETS:
            raise ValueError(f"Unknown policy setup: {policy_setup}")
        self.model = model
        self.policy_setup = policy_setup
        self.image_size = image_size
        self._rng = torch.Generator().manual_seed(int(init_rng))
        self._tick_generator = None
        self.horizon = horizon
        self.pred_action_horizon = pred_action_horizon
        self.action_ensemble = action_ensemble
        self.action_ensemble_temp = 0.0
        self.crop = crop
        self.padded_resize = padded_resize
        self.save_attention_map = save_attention_map
        # the JAX wrapper's rule (with the refusal above): the fused step
        # has no padded resize, no image history and no attention capture,
        # so those take the host path
        self.fused_serving = (fused_serving and horizon == 1
                              and not padded_resize
                              and not save_attention_map)
        self.image_history = deque(maxlen=self.horizon)
        self.num_image_history = 0
        self.action_ensembler = (
            ActionEnsembler(self.pred_action_horizon,
                            self.action_ensemble_temp)
            if self.action_ensemble else None)
        self._serving_step = None
        self.task = None
        self.task_description = None
        self.sticky_gripper_num_repeat = {
            "google_robot": 15, "widowx_bridge": 1}.get(policy_setup)
        self._reset_gripper()
        self.unnormalization_statistics = None
        self.trunk_impl = trunk_impl_of(trunk_kernel, trunk_impl)
        if model is None:
            return
        self.trunk_impl = resolve_trunk_impl(model, self.trunk_impl)
        if save_attention_map and self.trunk_impl is not None and (
                not per_layer_trunk(self.trunk_impl)):
            # the capture runs the trunk's layer loop
            self.trunk_impl = "layers"
        self.dino_attention_map = None
        self.head_attention_map = None
        dataset = _DATASETS[policy_setup]
        stats = model.dataset_statistics
        if stats is not None:
            if "action" in stats:
                self.unnormalization_statistics = stats["action"]
            elif dataset in stats:
                self.unnormalization_statistics = stats[dataset]["action"]
            else:
                fallback = sorted(stats.keys())[0]
                logging.warning(f"No statistics for {dataset}; falling back "
                                f"to {fallback} statistics.")
                self.unnormalization_statistics = stats[fallback]["action"]
        self.normalization_type = _find_normalization_type(model.config,
                                                           dataset)

    def _statistics(self) -> dict:
        if self.unnormalization_statistics is None:
            raise ValueError(
                "the model carries no dataset statistics, so its actions "
                "cannot be unnormalised; load a checkpoint with "
                "dataset_statistics.json or set model.dataset_statistics")
        return self.unnormalization_statistics

    def _reset_gripper(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        self.previous_gripper_action = None
        self.episode_step = 0

    # ------------------------------ images ------------------------------

    def _resize_image(self, image: np.ndarray) -> np.ndarray:
        size = (self.image_size, self.image_size)
        x = torch.as_tensor(image, device=self.model.device)
        if self.padded_resize:
            x = preprocess.resize_with_pad(x, *PADDED_SIZE)
        x = preprocess.resize_image(x, size)
        if self.crop:
            x = preprocess.center_crop(x, size)
        return x.cpu().numpy()

    def _add_image_to_history(self, image: np.ndarray) -> None:
        self.image_history.append(image)
        self.num_image_history = min(self.num_image_history + 1,
                                     self.horizon)

    def _obtain_image_history_and_mask(self):
        images = np.stack(self.image_history, axis=0)
        horizon = len(self.image_history)
        pad_mask = np.ones(horizon, dtype=np.float64)
        pad_mask[: horizon - min(horizon, self.num_image_history)] = 0
        return images, pad_mask

    # ------------------------------ control ------------------------------

    def reset(self, task_description: str, instruction_dict: dict,
              initial_state: Optional[dict] = None) -> None:
        base_params, self.task = self.model.create_tasks(
            instruction_dict=instruction_dict, initial_state=initial_state
        )
        self.base_params = prepare_serving_params(
            self.model, base_params,
            stack_trunk=not per_layer_trunk(self.trunk_impl))
        self.instruction_dict = instruction_dict
        if self.fused_serving:
            if self._serving_step is None:
                self._serving_step, self._init_history = make_serving_step(
                    self.model,
                    self._statistics(),
                    normalization_type=NormalizationType(
                        self.normalization_type).value,
                    image_size=self.image_size,
                    crop=self.crop,
                    ensemble_temp=self.action_ensemble_temp,
                    ensemble=self.action_ensemble,
                    trunk_impl=self.trunk_impl,
                )
            self._serving_history = self._init_history()
        self._token_embedding = (
            instruction_dict["language_instruction"]["token_embedding"]
            if self.model.base_net.encoder.use_language_token else None)
        self.task_description = task_description
        self.image_history.clear()
        if self.action_ensemble:
            self.action_ensembler.reset()
        self.num_image_history = 0
        self._reset_gripper()

    def _split_rng(self) -> torch.Generator:
        """This tick's generator, on the model's device: seeded with a seed
        split off the wrapper's host generator (init_rng)."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._rng))
        if self._tick_generator is None:
            self._tick_generator = torch.Generator(device=self.model.device)
        return self._tick_generator.manual_seed(seed)

    def step(self, image: np.ndarray, task_description: Optional[str] = None,
             image_embeddings=None, rng=None):
        """One control tick: uint8 (H, W, C) frame -> (raw_action, action,
        image, (task_description, task), seconds); the image is the
        resized frame on the host path, the frame itself on the fused
        one. image_embeddings (1, tokens, dim), the frame's precomputed
        patch embeddings (a Siglip policy's), reach the host path's
        sample_actions, as in the JAX wrapper (its fused path reads none).
        rng (a torch.Generator or a models/draws.py::Draws) stands in for
        the tick's own draws; the wrapper's stream splits all the same, so
        the ticks after it draw what they would have."""
        if (task_description is not None
                and task_description != self.task_description):
            self.reset(task_description, self.instruction_dict)
        if image.dtype != np.uint8:
            raise ValueError(f"frames must be uint8, got {image.dtype}")
        # a flipped view (LIBERO's upright frame) has negative strides,
        # which torch does not take
        image = np.ascontiguousarray(image)
        tick_rng = self._split_rng()
        if rng is not None:
            tick_rng = rng
        if self.fused_serving:
            return self._fused_step(image, tick_rng)
        image = self._resize_image(image)
        self._add_image_to_history(image)
        # the ViT base net reads no pad mask (and one frame: a longer
        # history raises there, as in the JAX package)
        images, _ = self._obtain_image_history_and_mask()

        start = time.perf_counter()
        maps = {} if self.save_attention_map else None
        raw_actions = self.model.sample_actions(
            images[None], self.instruction_dict, self.task, None,
            self.base_params, rng=tick_rng, image_embeddings=image_embeddings,
            trunk_impl=self.trunk_impl, maps=maps)
        raw_actions = raw_actions[0].cpu().numpy()
        seconds = time.perf_counter() - start
        if maps is not None:
            self._extract_attention_maps(maps)

        raw_actions = self._unnormalize(raw_actions)
        if raw_actions.shape != (self.pred_action_horizon, 7):
            raise ValueError(
                f"action chunk {raw_actions.shape}, want "
                f"({self.pred_action_horizon}, 7): pred_action_horizon must "
                "be the model's action_horizon")
        if self.action_ensemble:
            raw_action = self.action_ensembler.ensemble_action(raw_actions)
        else:
            raw_action = np.array(raw_actions[0])
        action = self._postprocess(raw_action)
        self.episode_step += 1
        return raw_action, action, image, (self.task_description,
                                           self.task), seconds

    def _fused_step(self, image: np.ndarray, rng):
        """One call of the fused serving step (ops/serving.py)."""
        start = time.perf_counter()
        raw_action, self._serving_history = self._serving_step(
            self.base_params, image, self._serving_history,
            self.episode_step, self._token_embedding, rng,
        )
        raw_action = raw_action.cpu().numpy()
        seconds = time.perf_counter() - start
        action = self._postprocess(raw_action)
        self.episode_step += 1
        return raw_action, action, image, (self.task_description,
                                           self.task), seconds

    def _extract_attention_maps(self, maps: dict) -> None:
        """The JAX wrapper's _extract_attention_maps over the maps of one
        step (batch 1)."""
        def rows(probs, row, cols):
            return torch.stack([p[0, :, row, cols] for p in probs]
                               ).float().cpu().numpy()

        if maps.get("dino"):
            self.dino_attention_map = rows(maps["dino"], 0, slice(1, None))
        self.head_attention_map = rows(maps["policy"], -1, slice(None, -1))

    # --------------------------- postprocessing ---------------------------

    def _unnormalize(self, raw_actions):
        stats = self._statistics()
        kind = NormalizationType(self.normalization_type)
        key = "mean" if kind == NormalizationType.NORMAL else "p01"
        mask = np.asarray(
            stats.get("mask", np.ones_like(stats[key], dtype=bool)))
        raw_actions = np.asarray(raw_actions)[..., : len(mask)]
        if kind == NormalizationType.NORMAL:
            return np.where(
                mask,
                raw_actions * np.asarray(stats["std"])
                + np.asarray(stats["mean"]),
                raw_actions,
            )
        p01, p99 = np.asarray(stats["p01"]), np.asarray(stats["p99"])
        return np.where(mask, (raw_actions + 1) * (p99 - p01 + 1e-8) / 2
                        + p01, raw_actions)

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
    last hidden state (CLS + patches) from the model's shared image
    encoder, the trunk the model serves with. Not the SIMPLER evaluator's
    encode: eval/simpler.py::_initial_state (like the JAX evaluator's)
    runs a separate DINOv2, the pretrained one or one from a seed, which
    differs from a trunk that training fine-tuned."""
    vit = model.base_net.encoder
    if not vit.has_trunk:
        raise ValueError("initial_state encodes with the model's DINOv2 "
                         f"trunk, and its image encoder is "
                         f"{vit.encoder_type}")
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
