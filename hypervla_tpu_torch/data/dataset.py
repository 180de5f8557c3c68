"""Dataset construction (parity: octo/data/dataset.py) on the threaded
Pipeline engine instead of tf.data.

make_dataset_from_rlds  - loads one dataset (native .npz shards or TFDS/RLDS
                          tfrecords, auto-detected) into the standardized
                          trajectory format, computes/caches statistics,
                          normalizes actions.
apply_trajectory_transforms / apply_frame_transforms - the same transform
                          stacks as the reference.
make_single_dataset / make_interleaved_dataset - the top-level entry points.

The port's copy of hypervla_tpu/data/dataset.py: only its imports differ,
and the frame transforms are the port's (data/obs_transforms.py).
"""
import json
import logging
import os
import re
from functools import partial
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from hypervla_tpu_torch.data import goal_relabeling, obs_transforms, task_augmentation
from hypervla_tpu_torch.data import traj_transforms as tt
from hypervla_tpu_torch.data.data_utils import (
    NormalizationType,
    allocate_threads,
    get_dataset_statistics,
    normalize_action_and_proprio,
    pprint_data_mixture,
    sample_match_keys_uniform,
    tree_map,
)
from hypervla_tpu_torch.data.pipeline import Pipeline
from hypervla_tpu_torch.data.sources import NpzTrajectorySource, RldsTfrecordSource
from hypervla_tpu_torch.utils.spec import ModuleSpec


def _resolve_source(name: str, data_dir: str, train: bool, val_fraction=0.05):
    """Auto-detects the storage backend and applies a 95/5 train/val split
    over shard files (mirroring the reference's train[:95%]/train[95%:])."""
    base = os.path.join(data_dir, name)
    if os.path.isdir(base):
        entries = sorted(os.listdir(base))
        # TFDS layout: <data_dir>/<name>/<version>/...
        version_dirs = [e for e in entries if re.match(r"\d+\.\d+\.\d+", e)]
        if version_dirs:
            base = os.path.join(base, version_dirs[0])
    if not os.path.isdir(base):
        raise FileNotFoundError(f"dataset {name} not found under {data_dir}")
    has_npz = any(f.endswith(".npz") for f in os.listdir(base))

    cls = NpzTrajectorySource if has_npz else RldsTfrecordSource
    probe = cls(base)
    n = len(probe.files)
    split_point = max(int(n * (1 - val_fraction)), 1)
    if n == 1:
        sl = slice(None)  # too few shards to split
    elif train:
        sl = slice(0, split_point)
    else:
        sl = slice(split_point, None)
    return cls(base, split_slice=sl)


def make_dataset_from_rlds(
    name: str,
    data_dir: str,
    *,
    train: bool,
    standardize_fn: Optional[ModuleSpec] = None,
    shuffle: bool = True,
    image_obs_keys: Mapping[str, Optional[str]] = {},
    depth_obs_keys: Mapping[str, Optional[str]] = {},
    proprio_obs_key: Optional[str] = None,
    language_key: Optional[str] = None,
    action_proprio_normalization_type: NormalizationType = NormalizationType.NORMAL,
    dataset_statistics: Optional[Union[dict, str]] = None,
    force_recompute_dataset_statistics: bool = False,
    action_normalization_mask: Optional[Sequence[bool]] = None,
    filter_functions: Sequence[ModuleSpec] = (),
    skip_norm: bool = False,
    ignore_errors: bool = False,
    add_initial_image: bool = False,
    random_initial_image: bool = False,
    initial_image_range: int = 0,
    num_parallel_reads: int = -1,
    num_parallel_calls: int = -1,
    filter_single_task: Optional[str] = None,
    seed: Optional[int] = None,
) -> Tuple[Pipeline, dict]:
    """Loads a dataset of standardized trajectories (see the reference's
    docstring at octo/data/dataset.py:284-348 for the exact contract)."""
    rng = np.random.default_rng(seed)

    def restructure(traj):
        if standardize_fn is not None:
            traj = ModuleSpec.instantiate(standardize_fn)(traj)
        required = {"observation", "action"}
        if not all(k in traj for k in required):
            raise ValueError(
                f"Trajectory missing keys: {required - set(traj.keys())}. "
                "Did you write a standardize_fn?"
            )
        traj_len = len(traj["action"])
        old_obs = traj["observation"]
        new_obs = {}
        for new, old in image_obs_keys.items():
            if old is None:
                new_obs[f"image_{new}"] = np.array([b""] * traj_len, dtype=object)
            else:
                new_obs[f"image_{new}"] = old_obs[old]
        for new, old in depth_obs_keys.items():
            if old is None:
                new_obs[f"depth_{new}"] = np.array([b""] * traj_len, dtype=object)
            else:
                new_obs[f"depth_{new}"] = old_obs[old]
        if proprio_obs_key is not None:
            new_obs["proprio"] = np.asarray(
                old_obs[proprio_obs_key], dtype=np.float32
            )
        new_obs["timestep"] = np.arange(traj_len)

        task = {}
        if language_key is not None:
            task["language_instruction"] = np.asarray(
                sample_match_keys_uniform(traj, language_key, rng), dtype=object
            )

        out = {
            "observation": new_obs,
            "task": task,
            "action": np.asarray(traj["action"], dtype=np.float32),
            "dataset_name": np.array([name] * traj_len, dtype=object),
        }
        if add_initial_image:
            if random_initial_image:
                rand = rng.random(traj_len)
                low = np.zeros(traj_len)
                high = np.arange(traj_len, dtype=np.float64)
                if initial_image_range > 0:
                    high = np.minimum(high, initial_image_range)
                start_idxs = np.minimum(
                    (rand * (high - low) + low).astype(np.int64), traj_len - 1
                )
                out["initial_state"] = {
                    "image_primary": out["observation"]["image_primary"][
                        start_idxs
                    ][:, None],
                }
            else:
                initial = out["observation"]["image_primary"][0]
                out["initial_state"] = {
                    "image_primary": np.tile(
                        np.asarray(initial)[None, None], (traj_len, 1)
                    )
                    if not isinstance(initial, np.ndarray)
                    else np.repeat(initial[None, None], traj_len, axis=0),
                }
        return out

    def is_nonzero_length(traj):
        return len(traj["action"]) > 0

    source = _resolve_source(name, data_dir, train=train)

    if isinstance(dataset_statistics, str):
        with open(dataset_statistics) as f:
            dataset_statistics = json.load(f)
    elif dataset_statistics is None:
        full_source = _resolve_source(name, data_dir, train=True,
                                      val_fraction=0.0)
        full = Pipeline.from_iterable(
            lambda: full_source.trajectories(shuffle=False)
        )
        for spec in filter_functions:
            full = full.filter(ModuleSpec.instantiate(spec))
        if ignore_errors:
            full = full.ignore_errors()
        full = full.map(restructure).filter(is_nonzero_length)
        dataset_statistics = get_dataset_statistics(
            iter(full),
            hash_dependencies=(
                name,
                str(proprio_obs_key),
                ModuleSpec.to_string(standardize_fn)
                if standardize_fn is not None
                else "",
                *map(ModuleSpec.to_string, filter_functions),
            ),
            save_dir=os.path.join(data_dir, name),
            force_recompute=force_recompute_dataset_statistics,
        )
    dataset_statistics = tree_map(np.array, dataset_statistics)

    if action_normalization_mask is not None:
        if (
            len(action_normalization_mask)
            != dataset_statistics["action"]["mean"].shape[-1]
        ):
            raise ValueError(
                f"Length of action_normalization_mask "
                f"({len(action_normalization_mask)}) does not match action "
                f"dim ({dataset_statistics['action']['mean'].shape[-1]})."
            )
        dataset_statistics["action"]["mask"] = np.array(
            action_normalization_mask
        )

    dataset = Pipeline.from_iterable(
        lambda: source.trajectories(shuffle=shuffle, seed=seed)
    )
    for spec in filter_functions:
        dataset = dataset.filter(ModuleSpec.instantiate(spec))
    if ignore_errors:
        dataset = dataset.ignore_errors()

    if filter_single_task is not None:
        dataset = dataset.filter(
            partial(_filter_task, filter_single_task=filter_single_task)
        )

    dataset = dataset.map(restructure).filter(is_nonzero_length)

    if not skip_norm:
        dataset = dataset.map(
            partial(
                normalize_action_and_proprio,
                metadata=dataset_statistics,
                normalization_type=action_proprio_normalization_type,
            )
        )
    else:
        logging.warning("Dataset normalization turned off.")

    return dataset, dataset_statistics


def _filter_task(traj, filter_single_task: str) -> bool:
    """Single-task filtering for SIMPLER-style evals
    (parity: octo/data/dataset.py:486-513)."""

    def _decode(x):
        return x.decode("utf-8") if isinstance(x, bytes) else str(x)

    instruction = _decode(
        np.asarray(traj["observation"]["natural_language_instruction"]).reshape(
            -1
        )[0]
    )

    def is_pick(instr):
        return bool(re.fullmatch(r"pick.*", instr)) and not bool(
            re.fullmatch(r".*from.*", instr)
        )

    def is_move(instr):
        return bool(re.fullmatch(r"move.*", instr))

    def is_drawer(instr):
        return bool(re.fullmatch(r"close (top|middle|bottom) drawer", instr))

    if filter_single_task == "simpler_google_robot":
        return is_pick(instruction) or is_move(instruction) or is_drawer(
            instruction
        )
    elif filter_single_task == "pick object":
        return is_pick(instruction)
    elif filter_single_task == "move near":
        return is_move(instruction)
    elif filter_single_task == "close drawer":
        return is_drawer(instruction)
    return all(
        _decode(x) == filter_single_task
        for x in np.asarray(
            traj["observation"]["natural_language_instruction"]
        ).reshape(-1)
    )


def apply_trajectory_transforms(
    dataset: Pipeline,
    *,
    train: bool,
    goal_relabeling_strategy: Optional[str] = None,
    goal_relabeling_kwargs: dict = {},
    window_size: int = 1,
    action_horizon: int = 1,
    subsample_length: Optional[int] = None,
    skip_unlabeled: bool = False,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    task_augment_strategy: Optional[str] = None,
    task_augment_kwargs: dict = {},
    max_action_dim: Optional[int] = None,
    max_proprio_dim: Optional[int] = None,
    post_chunk_transforms: Sequence[ModuleSpec] = (),
    num_parallel_calls: int = -1,
    seed: Optional[int] = None,
) -> Pipeline:
    """Trajectory-level transform stack (parity: octo/data/dataset.py:26-158)."""
    rng = np.random.default_rng(seed)
    if skip_unlabeled:
        dataset = dataset.filter(
            lambda x: "language_instruction" in x["task"]
            and all(
                len(s) != 0
                for s in np.asarray(x["task"]["language_instruction"]).reshape(-1)
            )
        )
    if max_action is not None:
        dataset = dataset.filter(
            lambda x: np.all(np.abs(x["action"]) <= max_action)
        )
    if max_proprio is not None:
        dataset = dataset.filter(
            lambda x: "proprio" not in x["observation"]
            or np.all(np.abs(x["observation"]["proprio"]) <= max_proprio)
        )

    dataset = dataset.map(tt.add_pad_mask_dict)
    dataset = dataset.map(
        partial(
            tt.pad_actions_and_proprio,
            max_action_dim=max_action_dim,
            max_proprio_dim=max_proprio_dim,
        )
    )
    if goal_relabeling_strategy is not None:
        dataset = dataset.map(
            partial(
                getattr(goal_relabeling, goal_relabeling_strategy),
                rng=rng,
                **goal_relabeling_kwargs,
            )
        )
    if task_augment_strategy is not None:
        dataset = dataset.map(
            partial(
                getattr(task_augmentation, task_augment_strategy),
                rng=rng,
                **task_augment_kwargs,
            )
        )
    dataset = dataset.map(
        partial(
            tt.chunk_act_obs,
            window_size=window_size,
            action_horizon=action_horizon,
        )
    )
    if train and subsample_length is not None:
        dataset = dataset.map(
            partial(tt.subsample, subsample_length=subsample_length, rng=rng)
        )
    for transform_spec in post_chunk_transforms:
        dataset = dataset.map(ModuleSpec.instantiate(transform_spec))
    return dataset


def apply_frame_transforms(
    dataset: Pipeline,
    *,
    train: bool,
    image_augment_kwargs: Union[dict, Mapping[str, dict]] = {},
    resize_size: Union[Tuple[int, int], Mapping[str, Tuple[int, int]]] = {},
    depth_resize_size: Union[Tuple[int, int], Mapping[str, Tuple[int, int]]] = {},
    image_dropout_prob: float = 0.0,
    image_dropout_keep_key: Optional[str] = None,
    num_parallel_calls: int = -1,
    apply_image_augmentation: bool = True,
    image_aug_style: str = "octo",
    seed: Optional[int] = None,
) -> Pipeline:
    """Frame-level transform stack (parity: octo/data/dataset.py:161-256).
    CPU decode happens here; resize/augment run through ops/preprocess.py
    on CPU tensors."""
    rng = np.random.default_rng(seed)
    threads = num_parallel_calls if num_parallel_calls > 0 else 4

    def apply_obs_transform(fn, frame):
        frame["task"] = fn(frame["task"])
        frame["observation"] = _vmap_obs(fn, frame["observation"])
        if "initial_state" in frame:
            frame["initial_state"] = _vmap_obs(fn, frame["initial_state"])
        return frame

    def frame_map(fn, item):
        """Applies a per-frame fn. Items may be single frames (after
        flatten) or whole trajectories of chunked frames (make_single_dataset
        keeps trajectories, matching dlimp frame_map semantics)."""
        from hypervla_tpu_torch.data.pipeline import _index_tree, _stack_tree

        if item["action"].ndim == 4:  # (traj, window, horizon, dim)
            frames = [
                fn(_index_tree(item, i)) for i in range(len(item["action"]))
            ]
            return _stack_tree(frames)
        return fn(item)

    if image_aug_style == "rtx":
        fn = partial(
            apply_obs_transform,
            partial(
                obs_transforms.decode_and_crop_and_resize,
                resize_size=_to_tuple(resize_size),
                depth_resize_size=_to_tuple(depth_resize_size),
                train=train,
            ),
        )
        return dataset.map(partial(frame_map, fn), num_threads=threads)

    decode_fn = partial(
        apply_obs_transform,
        partial(
            obs_transforms.decode_and_resize,
            resize_size=_to_tuple(resize_size),
            depth_resize_size=_to_tuple(depth_resize_size),
        ),
    )
    dataset = dataset.map(partial(frame_map, decode_fn), num_threads=threads)

    if train and apply_image_augmentation:

        def aug_and_dropout(frame):
            frame_seed = int(rng.integers(2**31))
            dropout_fn = partial(
                obs_transforms.image_dropout,
                seed=frame_seed,
                dropout_prob=image_dropout_prob,
                always_keep_key=image_dropout_keep_key,
            )
            aug_fn = partial(
                obs_transforms.augment,
                seed=frame_seed,
                augment_kwargs=image_augment_kwargs,
            )
            frame = apply_obs_transform(dropout_fn, frame)
            frame = apply_obs_transform(aug_fn, frame)
            return frame

        if image_dropout_prob > 0 or image_augment_kwargs:
            dataset = dataset.map(
                partial(frame_map, aug_and_dropout), num_threads=threads
            )
    return dataset


def _vmap_obs(fn, obs):
    """Applies a per-frame obs transform along the chunked window axis."""
    length = None
    for v in obs.values():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and not isinstance(v, dict):
            length = v.shape[0]
            break
    if length is None:
        return fn(obs)
    results = []
    for i in range(length):
        frame_i = {
            k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in v.items()})
            for k, v in obs.items()
        }
        results.append(fn(frame_i))
    out = {}
    for k in results[0]:
        if isinstance(results[0][k], dict):
            out[k] = {
                kk: np.stack([r[k][kk] for r in results])
                for kk in results[0][k]
            }
        else:
            out[k] = np.stack([np.asarray(r[k]) for r in results])
    return out


def _to_tuple(x):
    if isinstance(x, dict):
        return {k: tuple(v) for k, v in x.items()}
    return tuple(x) if x else {}


def make_single_dataset(
    dataset_kwargs: dict,
    *,
    train: bool,
    traj_transform_kwargs: dict = {},
    frame_transform_kwargs: dict = {},
) -> Pipeline:
    """Single dataset of transformed trajectories (parity: dataset.py:536-563)."""
    dataset, dataset_statistics = make_dataset_from_rlds(
        **dataset_kwargs, train=train
    )
    dataset = apply_trajectory_transforms(
        dataset, **traj_transform_kwargs, train=train
    )
    dataset = apply_frame_transforms(
        dataset, **frame_transform_kwargs, train=train
    )
    dataset.dataset_statistics = dataset_statistics
    return dataset


def make_interleaved_dataset(
    dataset_kwargs_list: Sequence[dict],
    sample_weights: Optional[Sequence[float]] = None,
    *,
    train: bool,
    shuffle_buffer_size: int,
    traj_transform_kwargs: dict = {},
    frame_transform_kwargs: dict = {},
    batch_size: Optional[int] = None,
    balance_weights: bool = False,
    traj_transform_threads: Optional[int] = None,
    traj_read_threads: Optional[int] = None,
    random_initial_image: bool = False,
    initial_image_range: int = 0,
    seed: Optional[int] = None,
) -> Pipeline:
    """Weighted interleave of datasets -> frame shuffle -> frame transforms ->
    batch (parity: octo/data/dataset.py:566-679)."""
    if not sample_weights:
        sample_weights = [1.0] * len(dataset_kwargs_list)
    if len(sample_weights) != len(dataset_kwargs_list):
        raise ValueError(
            f"sample_weights must have length {len(dataset_kwargs_list)}."
        )

    # an explicit seed argument wins over per-dataset kwargs
    dataset_kwargs_list = [
        {k: v for k, v in kw.items() if k != "seed"}
        for kw in dataset_kwargs_list
    ]

    dataset_sizes = []
    all_dataset_statistics = {}
    for dataset_kwargs in dataset_kwargs_list:
        _, stats = make_dataset_from_rlds(
            **dataset_kwargs,
            train=train,
            random_initial_image=random_initial_image,
            initial_image_range=initial_image_range,
        )
        dataset_sizes.append(stats["num_transitions"])
        assert dataset_kwargs["name"] not in all_dataset_statistics, (
            f"Duplicate name {dataset_kwargs['name']}"
        )
        all_dataset_statistics[dataset_kwargs["name"]] = stats

    if balance_weights:
        sample_weights = np.array(sample_weights) * np.array(dataset_sizes)
    sample_weights = np.array(sample_weights) / np.sum(sample_weights)
    pprint_data_mixture(dataset_kwargs_list, sample_weights)

    threads_per_dataset = allocate_threads(
        traj_transform_threads, sample_weights
    )
    reads_per_dataset = allocate_threads(traj_read_threads, sample_weights)
    logging.info("Threads per dataset: %s", threads_per_dataset)
    logging.info("Reads per dataset: %s", reads_per_dataset)

    datasets = []
    for dataset_kwargs, threads, reads in zip(
        dataset_kwargs_list, threads_per_dataset, reads_per_dataset
    ):
        dataset, _ = make_dataset_from_rlds(
            **dataset_kwargs,
            train=train,
            num_parallel_calls=int(threads),
            num_parallel_reads=int(reads),
            dataset_statistics=tree_map(
                lambda x: x.tolist() if isinstance(x, np.ndarray) else x,
                all_dataset_statistics[dataset_kwargs["name"]],
            ),
            random_initial_image=random_initial_image,
            initial_image_range=initial_image_range,
            seed=seed,
        )
        dataset = apply_trajectory_transforms(
            dataset.repeat(),
            **traj_transform_kwargs,
            num_parallel_calls=int(threads),
            train=train,
            seed=seed,
        ).flatten_frames()
        # each component dataset reads/transforms on its own thread so the
        # weighted sampler never blocks on a slow source
        datasets.append(dataset.prefetch(max(int(reads), 2)))

    dataset = Pipeline.sample_from_pipelines(
        datasets, sample_weights, seed=seed
    ).shuffle(shuffle_buffer_size, seed=seed)

    dataset = apply_frame_transforms(
        dataset, **frame_transform_kwargs, train=train, seed=seed
    )

    if batch_size is not None:
        dataset = dataset.batch(batch_size)

    dataset = dataset.ignore_errors(log_warning=True)
    dataset.dataset_statistics = all_dataset_statistics
    dataset.sample_weights = sample_weights
    return dataset
