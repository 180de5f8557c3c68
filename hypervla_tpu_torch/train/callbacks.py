"""Training callbacks (counterpart of hypervla_tpu/train/callbacks.py).

SaveCallback keeps the JAX package's two checkpoints: per-step params
through the model's save_pretrained (`<step>/params.pt`) with the EMA
beside them (`<step>/EMA_params.pt`), and one resumable TrainState
(`state/latest.pt`). ValidationCallback computes the held-out action MSE of
each validation dataset. The visualization and rollout callbacks need
eval/visualization.py, which is not ported (ROADMAP.md A12.3).
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
    background thread, one save in flight at a time."""

    def __init__(self, save_dir: Optional[str]):
        self.save_dir = save_dir
        self.state_dir = os.path.join(save_dir, "state") if save_dir else None
        self._pending = None
        self._executor = None
        if self.save_dir is not None:
            os.makedirs(self.save_dir, exist_ok=True)
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt")

    def __call__(self, model, train_state: TrainState, step: int) -> None:
        if self.save_dir is None:
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
        return restored, payload["step"]


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
            view, tokens[:, None], draws)
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
