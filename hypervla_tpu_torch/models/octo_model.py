"""OctoModel: the Octo model's serving and checkpoint facade (counterpart
of hypervla_tpu/models/octo_model.py).

  * `from_config(config, example_batch, ...)`: an OctoModule
    (models/base_octo.py) from config["model"] and a fresh init of its
    params for the example batch's shapes (from `rng`, a seed);
  * `create_tasks(goals=None, texts=None)`: the task dict, instructions
    tokenized by the text processor and embedded by `text_embed_fn` (the
    frozen T5);
  * `run_transformer` / `sample_actions`: the transformer, then the
    "action" head's prediction, unnormalized with the dataset statistics
    (NORMAL or BOUNDS, under the statistics' mask);
  * `save_pretrained` / `load_pretrained`: the port's checkpoint, the
    layout of models/hypervla.py (config.json, example_batch.npz,
    dataset_statistics.json, <step>/params.pt), from a directory or an
    `hf://org/repo` snapshot in the local HuggingFace cache (no download:
    a snapshot that is not there raises FileNotFoundError).
    tools/convert_checkpoint_to_torch.py writes this layout from a JAX
    OctoModel checkpoint.

Inputs are numpy arrays or tensors; the model moves them to its device.
The sampling heads draw from `rng` (a torch.Generator, or a
models/draws.py::Draws to replay); the entry points run on the card unless
`device` says otherwise.
"""
import copy
import json
import logging
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from hypervla_tpu_torch.data.data_utils import NormalizationType
from hypervla_tpu_torch.models.base_octo import OctoModule
from hypervla_tpu_torch.models.draws import as_draws
from hypervla_tpu_torch.models.hypervla import (
    PARAMS_FILE,
    _host_tensors,
    _jsonable,
    _map_tree,
    _unflatten,
    check_params,
    latest_step,
)
from hypervla_tpu_torch.models.layers import init_params
from hypervla_tpu_torch.parallel.mesh import process_index, to_device
from hypervla_tpu_torch.utils.convert import flatten_tree
from hypervla_tpu_torch.utils.device import resolve_device
from hypervla_tpu_torch.utils.spec import ModuleSpec


def _first_rows(tree):
    return _map_tree(lambda x: np.asarray(x)[:1], tree)


class OctoModel:
    def __init__(self, module: OctoModule, text_processor: Any, config: dict,
                 params, example_batch: dict,
                 dataset_statistics: Optional[dict],
                 text_embed_fn: Any = None, device=None):
        self.module = module
        self.text_processor = text_processor
        self.config = config
        self.params = params
        self.example_batch = example_batch
        self.dataset_statistics = dataset_statistics
        self.text_embed_fn = text_embed_fn
        self.device = device

    def replace(self, **changes) -> "OctoModel":
        out = copy.copy(self)
        for k, v in changes.items():
            setattr(out, k, v)
        return out

    def create_tasks(self, goals: Optional[dict] = None,
                     texts: Optional[Sequence[str]] = None):
        """The task dict of goal images and/or texts (numpy)."""
        assert goals is not None or texts is not None
        tasks = {"pad_mask_dict": {}}
        if goals is not None:
            tasks.update(goals)
            tasks["pad_mask_dict"].update(
                {k: np.ones(np.shape(v)[:1], dtype=bool)
                 for k, v in goals.items()})
        else:
            batch_size = len(texts)
            tasks.update({
                k: np.zeros((batch_size, *np.shape(v)[1:]),
                            dtype=np.asarray(v).dtype)
                for k, v in self.example_batch["task"].items()
                if k not in ("pad_mask_dict", "language_instruction")})
            tasks["pad_mask_dict"].update(
                {k: np.zeros(batch_size, dtype=bool)
                 for k in tasks.keys() if k != "pad_mask_dict"})
        if texts is not None:
            tasks["pad_mask_dict"]["language_instruction"] = np.ones(
                len(texts), dtype=bool)
        else:
            batch_size = len(np.asarray(next(iter(goals.values()))))
            texts = [""] * batch_size
            tasks["pad_mask_dict"]["language_instruction"] = np.zeros(
                batch_size, dtype=bool)
        assert self.text_processor is not None, "need a text processor"
        tokens = self.text_processor.encode(texts)
        instruction = dict(tokens)
        if self.text_embed_fn is not None:
            embedding = self.text_embed_fn(tokens["input_ids"],
                                           tokens["attention_mask"])
            if isinstance(embedding, torch.Tensor):
                embedding = embedding.detach().cpu().numpy()
            instruction["token_embedding"] = np.asarray(embedding)
        tasks["language_instruction"] = instruction
        return tasks

    def run_transformer(self, observations, tasks, timestep_pad_mask,
                        train: bool = False):
        """The transformer's outputs ({group: TokenGroup}); observations
        are held to the example batch's shapes past the batch and window
        axes (AssertionError where they differ). It draws no dropout
        (train is the JAX signature's; the Octo configs' rates are 0, and
        octo_train.py runs the module with its draws)."""
        _verify_shapes(observations, "observations",
                       self.example_batch["observation"], starting_dim=2)
        dev = torch.device(self.device)
        return self.module.octo_transformer(
            self.params, to_device(observations, dev), to_device(tasks, dev),
            to_device(timestep_pad_mask, dev))

    @torch.no_grad()
    def sample_actions(self, observations, tasks,
                       unnormalization_statistics: Optional[dict] = None,
                       normalization_type: NormalizationType = (
                           NormalizationType.NORMAL),
                       timestep_pad_mask=None, train: bool = False,
                       argmax: bool = False, sample_shape: Tuple[int, ...] = (),
                       rng=None, temperature: float = 1.0):
        """The "action" head's actions for the last window step (every
        step's for the U-Net head), unnormalized where statistics are
        given; a tensor on the model's device."""
        if timestep_pad_mask is None:
            timestep_pad_mask = observations["timestep_pad_mask"]
        outputs = self.run_transformer(observations, tasks,
                                       timestep_pad_mask, train=train)
        head = self.module.heads["action"]
        stats = (None if unnormalization_statistics is None else
                 {k: torch.as_tensor(np.asarray(v), device=self.device)
                  for k, v in unnormalization_statistics.items()})
        action = head.predict_action(
            self.module.head_params(self.params, "action"),
            outputs[head.readout_key], as_draws(rng),
            embodiment_action_dim=(len(stats["mean"]) if stats is not None
                                   else None),
            sample_shape=tuple(sample_shape), argmax=argmax,
            temperature=temperature)
        if stats is None:
            return action
        if normalization_type == NormalizationType.NORMAL:
            mask = stats.get("mask", torch.ones_like(stats["mean"],
                                                     dtype=torch.bool))
            action = action[..., :len(mask)]
            return torch.where(mask.bool(),
                               action * stats["std"] + stats["mean"], action)
        if normalization_type == NormalizationType.BOUNDS:
            mask = stats.get("mask", torch.ones_like(stats["p01"],
                                                     dtype=torch.bool))
            action = action[..., :len(mask)]
            return torch.where(
                mask.bool(),
                (action + 1) * (stats["p99"] - stats["p01"]) / 2
                + stats["p01"], action)
        raise ValueError(f"Unknown normalization type: {normalization_type}")

    @classmethod
    def from_config(cls, config: dict, example_batch: dict,
                    text_processor: Optional[Any] = None,
                    verbose: bool = False, rng: Optional[int] = None,
                    dataset_statistics: Optional[dict] = None,
                    text_embed_fn: Optional[Any] = None,
                    device=None) -> "OctoModel":
        """A fresh model; rng is the init's seed (None: 0)."""
        device = resolve_device(device)
        module = OctoModule.create(**config["model"])
        example_batch = _first_rows(example_batch)
        specs = module.specs(example_batch["observation"],
                             example_batch["task"])
        if verbose:
            logging.info("OctoModel params: %d",
                         sum(int(np.prod(s)) for s, _ in specs.values()))
        params = init_params(specs, 0 if rng is None else int(rng), device)
        return cls(module, text_processor, config, params, example_batch,
                   dataset_statistics, text_embed_fn, device)

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
            np.savez(batch_path, **flatten_tree(_map_tree(
                np.asarray, self.example_batch)))
        stats_path = os.path.join(path, "dataset_statistics.json")
        if (not os.path.exists(stats_path)
                and self.dataset_statistics is not None):
            with open(stats_path, "w") as f:
                json.dump(_map_tree(lambda x: np.asarray(x).tolist(),
                                    self.dataset_statistics), f)

    @classmethod
    def load_pretrained(cls, checkpoint_path: str,
                        step: Optional[int] = None,
                        device=None) -> "OctoModel":
        """The model saved under checkpoint_path (a directory, or
        `hf://org/repo` in the local HuggingFace cache) at `step` (None:
        the latest), on `device` (None: the CUDA card)."""
        if checkpoint_path.startswith("hf://"):
            if step is not None:
                raise ValueError(
                    "step cannot be set when loading from HuggingFace; "
                    "hub snapshots pin their own revision")
            checkpoint_path = _resolve_hf_checkpoint(
                checkpoint_path[len("hf://"):])
        device = resolve_device(device)
        path = os.path.abspath(checkpoint_path)
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        with np.load(os.path.join(path, "example_batch.npz"),
                     allow_pickle=False) as data:
            example_batch = _unflatten({k: data[k] for k in data.files})
        if "tasks" in example_batch:
            example_batch["task"] = example_batch.pop("tasks")
        if "timestep_pad_mask" not in example_batch["observation"]:
            example_batch["observation"]["timestep_pad_mask"] = (
                example_batch["observation"]["pad_mask"])
        stats_path = os.path.join(path, "dataset_statistics.json")
        dataset_statistics = None
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                dataset_statistics = _map_tree(np.array, json.load(f))
        module = OctoModule.create(**config["model"])
        specs = module.specs(example_batch["observation"],
                             example_batch["task"])
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no <step>/{PARAMS_FILE} under {path}")
        params = torch.load(os.path.join(path, str(step), PARAMS_FILE),
                            map_location=device, weights_only=True)
        check_params(params, specs)
        text_processor = None
        if config.get("text_processor") is not None:
            text_processor = ModuleSpec.instantiate(
                config["text_processor"])()
        return cls(module, text_processor, config, params, example_batch,
                   dataset_statistics, None, device)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _verify_shapes(pytree, name: str, example_pytree, starting_dim: int = 0,
                   strict: bool = False, raise_error: bool = True,
                   silent: bool = False) -> bool:
    """Whether a batch dict has the example batch's keys and trailing
    shapes (from starting_dim): missing or extra keys warn (and fail under
    strict), a shape that differs fails; a failure raises AssertionError
    with raise_error."""
    weak_fail, fail = False, False
    flat, example = _flat(pytree), _flat(example_pytree)
    missing = set(example) - set(flat)
    if missing and not silent:
        logging.warning(f"{name} is missing keys: {missing}")
        weak_fail = True
    extra = set(flat) - set(example)
    if extra and not silent:
        logging.warning(f"{name} has extra keys: {extra}")
        weak_fail = True
    mismatched = [
        (k, tuple(np.shape(v)), tuple(np.shape(example[k])))
        for k, v in flat.items()
        if k in example and getattr(v, "shape", None) is not None
        and tuple(v.shape)[starting_dim:]
        != tuple(np.shape(example[k]))[starting_dim:]]
    if mismatched:
        if not silent:
            for k, shape, expected in mismatched:
                logging.error(f"{name} has mismatched shape for {k}: "
                              f"{shape} vs {expected}")
        fail = True
    if raise_error and (fail or (weak_fail and strict)):
        raise AssertionError(f"{name} does not match the example batch.")
    return weak_fail or fail


def _hf_cache_dir() -> str:
    """The HuggingFace hub cache: $HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub (huggingface_hub's own order)."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def _resolve_hf_checkpoint(repo_id: str) -> str:
    """The local snapshot of an hf:// model repo in the HuggingFace cache
    (`snapshot_download(repo_id, local_files_only=True)`'s lookup: the
    commit refs/main names under snapshots/). Nothing is downloaded: a
    repo that is not cached raises FileNotFoundError."""
    cache = _hf_cache_dir()
    repo = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    snapshot = None
    if os.path.isfile(ref):
        with open(ref) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
    if snapshot is None or not os.path.isdir(snapshot):
        raise FileNotFoundError(
            f"hf://{repo_id} is not in the local HuggingFace cache "
            f"({cache}), and the port does not download it. On a host with "
            "egress: `python -c \"from huggingface_hub import "
            f"snapshot_download; snapshot_download('{repo_id}')\"` then copy "
            "$HF_HUB_CACHE here.")
    return snapshot
