"""Training callbacks (counterpart of hypervla_tpu/train/callbacks.py).

SaveCallback keeps the JAX package's two checkpoints: per-step params
through the model's save_pretrained (`<step>/params.pt`) with the EMA
beside them (`<step>/EMA_params.pt`), and one resumable TrainState
(`state/latest.pt`), written by rank 0 alone on a mesh and whole, so that
a checkpoint saved at N ranks restores at any other count.
ValidationCallback computes the held-out action MSE of
each validation dataset. VisualizationCallback runs the policy over
held-out trajectories and reports eval/visualization.py's manipulation
metrics; RolloutCallback runs closed-loop rollouts where an environment can
be built.
"""
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.hypernetwork import per_sample_view
from hypervla_tpu_torch.models.hypervla import save_ema_params
from hypervla_tpu_torch.ops.serving import prepare_serving_params
from hypervla_tpu_torch.parallel.mesh import process_index
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import to_tensors

STATE_FILE = "latest.pt"


def _to_host(tree):
    """A copy on the host of the tensors of a nested dict (ints and None
    as they are)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class SaveCallback:
    """Writes `<save_dir>/<step>/params.pt` (with config.json and the rest
    of save_pretrained's files), `<step>/EMA_params.pt` where the state
    tracks an EMA, and the resumable `<save_dir>/state/latest.pt`: step,
    params, optimizer state, EMA and seed, written to a temporary file and
    renamed, so a crash never leaves a torn resume point. The copy to the
    host is synchronous; the serialization and the disk writes run on one
    background thread, one save in flight at a time.

    On a mesh (`layout`, parallel/sharded.py::ShardLayout, and the
    optimizer `tx`, whose state it lays out), every rank calls it: the
    state is gathered whole, then rank 0 writes it, as the JAX callbacks
    write on process 0; `restore` reads the whole state and keeps this
    rank's shards."""

    def __init__(self, save_dir: Optional[str], layout=None, tx=None):
        self.save_dir = save_dir
        self.state_dir = os.path.join(save_dir, "state") if save_dir else None
        self.layout = layout
        self.tx = tx
        self._pending = None
        self._executor = None
        if self.save_dir is not None and process_index() == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt")

    def __call__(self, model, train_state: TrainState, step: int) -> None:
        if self.save_dir is None:
            return
        if self.layout is not None:
            train_state = self.layout.gather_state(train_state, self.tx)
        if process_index() != 0:
            return
        self.wait()
        payload = {
            "step": int(train_state.step),
            "params": _to_host(train_state.params),
            "opt_state": _to_host(train_state.opt_state),
            "ema_params": _to_host(train_state.ema_params),
            "seed": int(train_state.seed),
        }

        def write():
            model.replace(params=payload["params"]).save_pretrained(
                step=step, checkpoint_path=self.save_dir)
            if payload["ema_params"] is not None:
                save_ema_params(self.save_dir, step, payload["ema_params"],
                                decay=model.config.get("EMA_decay", 0.999))
            os.makedirs(self.state_dir, exist_ok=True)
            path = os.path.join(self.state_dir, STATE_FILE)
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            logging.info(f"Saved checkpoint at step {step} to "
                         f"{self.save_dir}")

        self._pending = self._executor.submit(write)

    def wait(self) -> None:
        """Blocks until the save in flight has landed; re-raises its
        error."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.wait()
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def restore(self, train_state: TrainState):
        """(state, step): the state read back from state/latest.pt onto the
        device of train_state's params (weights_only), or (train_state,
        None) where there is none."""
        self.wait()
        path = os.path.join(self.state_dir, STATE_FILE)
        if not os.path.exists(path):
            return train_state, None
        device = next(iter(train_state.params.values())).device
        payload = torch.load(path, map_location=device, weights_only=True)
        restored = TrainState(
            step=payload["step"],
            params={k: v.requires_grad_(True)
                    for k, v in payload["params"].items()},
            opt_state=payload["opt_state"],
            ema_params=payload["ema_params"],
            seed=payload["seed"],
        )
        if self.layout is not None:
            restored = self.layout.shard_state(restored, self.tx)
        return restored, payload["step"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class VisualizationCallback:
    """Offline manipulation metrics and action-vs-prediction plots on
    held-out trajectories (the JAX package's VisualizationCallback).

    visualizers: {name: eval/visualization.py::Visualizer} over
    chunked-trajectory validation datasets. text_encode(input_ids,
    attention_mask) and dino_encode(uint8 images) take tensors on the
    model's device, as the trainer's encoders do.

    The policy is the model's create_tasks and one batched sample_actions
    over a trajectory's frames, as in the JAX callback, on the params
    InferenceWrapper serves with (ops/serving.py::prepare_serving_params:
    a bf16 DINOv2 trunk runs the stacked trunk kernel, one launch a frame).
    The JAX callback draws with PRNGKey(step); the port's draws come from a
    generator seeded with the step, anew for each trajectory (only the
    diffusion head reads them)."""

    def __init__(self, model, text_encode: Callable, visualizers: dict,
                 n_trajs: int = 4, use_initial_image: bool = False,
                 dino_encode: Optional[Callable] = None,
                 make_plots: bool = False):
        self.model = model
        self.text_encode = text_encode
        self.visualizers = visualizers
        self.n_trajs = n_trajs
        self.use_initial_image = use_initial_image
        self.dino_encode = dino_encode
        self.make_plots = make_plots

    def _policy_fn(self, params, step: int, trunk_impl: str = "kernel"):
        """The policy over a trajectory's frames; trunk_impl is
        sample_actions' ("reference": kernel 1's plain version)."""
        model = self.model.replace(params=params)
        device = model.device

        def tensor(x):
            return torch.as_tensor(np.asarray(x), device=device)

        @torch.no_grad()
        def policy(observations, tasks):
            instr = {k: np.asarray(v)[:1]
                     for k, v in tasks["language_instruction"].items()}
            if "token_embedding" not in instr:
                instr["token_embedding"] = _host(self.text_encode(
                    tensor(instr["input_ids"]),
                    tensor(instr["attention_mask"])))
            instruction_dict = {"language_instruction": instr}
            initial_state = None
            if self.use_initial_image and "initial_state" in tasks:
                initial_state = {k: np.asarray(v)[:1]
                                 for k, v in tasks["initial_state"].items()}
                if ("patch_embeddings" not in initial_state
                        and self.dino_encode is not None):
                    initial_state["patch_embeddings"] = _host(
                        self.dino_encode(tensor(
                            initial_state["image_primary"].squeeze(1))))
            base_params, hn_tasks = model.create_tasks(
                instruction_dict=instruction_dict,
                initial_state=initial_state)
            base_params = prepare_serving_params(model, base_params)
            images = np.asarray(observations["image_primary"])
            num_frames = images.shape[0]
            pad = np.asarray(observations["timestep_pad_mask"])
            frame_instr = {"language_instruction": {
                k: np.broadcast_to(v, (num_frames,) + v.shape[1:])
                for k, v in instr.items()}}
            rng = torch.Generator(device=device).manual_seed(int(step))
            return _host(model.sample_actions(
                images, frame_instr, hn_tasks, pad, base_params, rng=rng,
                trunk_impl=trunk_impl))

        return policy

    def __call__(self, params, step: int) -> dict:
        metrics = {}
        for name, viz in self.visualizers.items():
            policy_fn = self._policy_fn(params, step)
            for k, v in viz.metrics_for_wandb(
                    policy_fn, n_trajs=self.n_trajs).items():
                metrics[f"visualizer/{name}/{k}"] = v
            if self.make_plots:
                for k, fig in viz.visualize_for_wandb(
                        policy_fn, n_trajs=min(2, self.n_trajs)).items():
                    metrics[f"visualizer/{name}/{k}"] = fig
        return metrics


class RolloutCallback:
    """Closed-loop rollouts during training (the JAX package's
    RolloutCallback). A rollout whose environment cannot be built or dies
    is skipped with a logged warning."""

    def __init__(self, rollout_visualizers, policy_fn_builder,
                 n_rollouts: int = 5):
        """rollout_visualizers: a list of eval/visualization.py::
        RolloutVisualizer. policy_fn_builder(params) -> policy_fn(stacked
        observation) -> action chunk."""
        self.rollout_visualizers = rollout_visualizers
        self.policy_fn_builder = policy_fn_builder
        self.n_rollouts = n_rollouts

    def __call__(self, params, step: int) -> dict:
        metrics = {}
        policy_fn = self.policy_fn_builder(params)
        for rv in self.rollout_visualizers:
            try:
                m, _ = rv.run_rollouts(policy_fn, n_rollouts=self.n_rollouts)
                metrics.update(m)
            except Exception as e:  # no simulator, or the env died
                logging.warning(f"rollout {rv.name} skipped: {e!r}")
        return metrics


class ValidationCallback:
    """The held-out MSE of the last window step's action chunk under the
    policy's predict_action (argmax gripper), against the clipped target,
    times the action dim, as the JAX callback computes it, averaged over up
    to num_val_batches batches of each validation iterator."""

    def __init__(self, model, text_encode: Optional[Callable],
                 val_iterators: dict, num_val_batches: int = 8,
                 use_initial_image: bool = False,
                 dino_encode: Optional[Callable] = None):
        self.model = model
        self.text_encode = text_encode
        self.val_iterators = val_iterators
        self.num_val_batches = num_val_batches
        self.use_initial_image = use_initial_image
        self.dino_encode = dino_encode

    @torch.no_grad()
    def _mse(self, params, batch, draws: Draws) -> float:
        """One batch's MSE; draws are the diffusion head's sampler's."""
        model = self.model
        batch = to_tensors(batch, model.device)
        instr = dict(batch["task"]["language_instruction"])
        if self.text_encode is not None:
            instr["token_embedding"] = self.text_encode(
                instr["input_ids"], instr["attention_mask"])
        patches = None
        if self.use_initial_image:
            patches = (batch.get("initial_state") or {}).get(
                "patch_embeddings")
            if self.dino_encode is not None:
                patches = self.dino_encode(
                    batch["initial_state"]["image_primary"].squeeze(1))
        images = batch["observation"]["image_primary"].squeeze(1)
        encoder = model.base_net.encoder
        emb = encoder.train_image_embeddings(
            model.shared_params(params=params), images)
        ctx = model.hypernet.task_context(
            params, dict(batch["task"], language_instruction=instr),
            instr["token_embedding"], patches)
        view = per_sample_view(model.plan,
                               model.hypernet.generate(params, ctx))
        tokens = encoder(view, image_embeddings=emb)
        predicted = model.base_net.action_head.predict_action(
            view, tokens[:, None], draws, argmax=True)
        target = torch.clamp(batch["action"], -5.0, 5.0)[:, -1]
        mse = ((predicted.reshape(target.shape) - target) ** 2).mean()
        return float(mse) * target.shape[-1]

    def __call__(self, params, step: int) -> dict:
        # the JAX callback seeds its draws with the step; only the
        # diffusion head's sampler reads them (validation runs with
        # train=False, so nothing else draws)
        draws = Draws(torch.Generator(device=self.model.device).manual_seed(
            int(step)))
        metrics = {}
        for name, iterator in self.val_iterators.items():
            losses = []
            for _ in range(self.num_val_batches):
                try:
                    batch = next(iterator)
                except StopIteration:
                    break
                losses.append(self._mse(params, batch, draws))
            if losses:
                metrics[f"validation/{name}/mse"] = float(np.mean(losses))
        return metrics
