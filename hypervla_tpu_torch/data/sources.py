"""Trajectory sources.

Two storage backends produce raw trajectory dicts (arrays with a shared
leading trajectory-length axis; images may be encoded bytes):

  * NpzTrajectorySource — the native shard format: one .npz per trajectory,
    nested keys flattened with '/'. Fast, memory-mappable, written by the
    RLDS converter (scripts/convert_rlds.py).
  * RldsTfrecordSource — reads TFDS/RLDS tfrecord shards directly using the
    pure-Python codec in data/tfrecord.py (C++ reader in native/ for
    throughput). Feature shapes/dtypes come from the TFDS features.json.

Both expose: trajectories(shuffle, seed) -> iterator, and cardinality.

The port's copy of hypervla_tpu/data/sources.py: only its imports differ.
"""
import glob
import json
import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from hypervla_tpu_torch.data.tfrecord import parse_example, read_tfrecord


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def unflatten_tree(flat):
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class NpzTrajectorySource:
    """Directory of one-.npz-per-trajectory shards."""

    def __init__(self, data_dir: str, split_slice: slice = slice(None)):
        self.data_dir = data_dir
        self.files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))[
            split_slice
        ]
        if not self.files:
            raise FileNotFoundError(f"no .npz trajectories under {data_dir}")

    @property
    def cardinality(self) -> int:
        return len(self.files)

    def trajectories(self, shuffle: bool = False,
                     seed: Optional[int] = None) -> Iterator[dict]:
        files = list(self.files)
        if shuffle:
            random.Random(seed).shuffle(files)
        for path in files:
            with np.load(path, allow_pickle=True) as data:
                flat = {}
                for k in data.files:
                    v = data[k]
                    if v.dtype.kind == "O" and v.ndim == 0:
                        v = v.item()
                    flat[k] = v
                yield unflatten_tree(flat)

    @staticmethod
    def write_trajectory(path: str, traj: dict):
        flat = flatten_tree(traj)
        np.savez_compressed(path, **flat)


class RldsTfrecordSource:
    """Reads TFDS-serialized RLDS episodes without TensorFlow.

    Each tfrecord Example holds one episode; step fields are flattened as
    'steps/<path>' with values concatenated over steps. features.json gives
    per-field shapes and dtypes for reconstruction.
    """

    def __init__(self, dataset_dir: str, split_slice: slice = slice(None)):
        self.dataset_dir = dataset_dir
        with open(os.path.join(dataset_dir, "features.json")) as f:
            self.features = json.load(f)
        self.step_specs, self.episode_specs = _parse_rlds_features(self.features)
        self.files = sorted(
            p
            for p in glob.glob(os.path.join(dataset_dir, "*.tfrecord*"))
            if ".json" not in os.path.basename(p)
        )[split_slice]
        if not self.files:
            raise FileNotFoundError(f"no tfrecord shards under {dataset_dir}")

    @property
    def cardinality(self) -> int:
        return -1  # unknown without a full pass

    def trajectories(self, shuffle: bool = False,
                     seed: Optional[int] = None) -> Iterator[dict]:
        files = list(self.files)
        if shuffle:
            random.Random(seed).shuffle(files)
        for path in files:
            for record in read_tfrecord(path):
                yield self._decode_episode(parse_example(record))

    def _decode_episode(self, raw: Dict) -> dict:
        flat = {}
        n_steps = None
        for key, value in raw.items():
            if key.startswith("steps/"):
                spec = self.step_specs.get(key)
                decoded = _decode_field(value, spec)
                if n_steps is None and hasattr(decoded, "__len__"):
                    n_steps = len(decoded)
                flat[key[len("steps/"):]] = decoded
            else:
                spec = self.episode_specs.get(key)
                flat[key] = _decode_field(value, spec, leading_axis=False)
        return unflatten_tree(flat)


def _decode_field(value, spec, leading_axis: bool = True):
    """Reshapes a flat parsed feature using its (shape, dtype) spec. Encoded
    images / strings stay as object arrays of bytes."""
    if isinstance(value, list):  # BytesList
        arr = np.array(value, dtype=object)
        if not leading_axis and len(arr) == 1:
            return arr[0]
        return arr
    arr = np.asarray(value)
    if spec is not None:
        shape, dtype = spec
        if dtype is not None:
            arr = arr.astype(dtype)
        if shape:
            try:
                arr = arr.reshape((-1, *shape) if leading_axis else shape)
            except ValueError:
                pass
    elif leading_axis:
        pass
    return arr


def _parse_rlds_features(features_json: dict):
    """Extracts {flattened_key: (shape, dtype)} for step and episode fields
    from a TFDS features.json."""
    step_specs: Dict[str, tuple] = {}
    episode_specs: Dict[str, tuple] = {}

    def walk(node, prefix, sink):
        if not isinstance(node, dict):
            return
        if "featuresDict" in node:
            for name, sub in node["featuresDict"].get("features", {}).items():
                walk(sub, f"{prefix}/{name}" if prefix else name, sink)
        elif "sequence" in node:
            walk(node["sequence"].get("feature", {}), prefix, sink)
        elif "tensor" in node:
            t = node["tensor"]
            shape = [
                int(d)
                for d in t.get("shape", {}).get("dimensions", [])
            ]
            sink[prefix] = (shape, _np_dtype(t.get("dtype")))
        elif "image" in node:
            sink[prefix] = (None, "image")
        elif "text" in node or "Text" in str(node.get("pythonClassName", "")):
            sink[prefix] = (None, "text")
        elif "scalar" in node:
            sink[prefix] = ([], _np_dtype(node["scalar"].get("dtype")))

    top = features_json.get("featuresDict", {}).get("features", {})
    for name, node in top.items():
        if name == "steps":
            walk(node, "steps", step_specs)
        else:
            walk(node, name, episode_specs)
    return step_specs, episode_specs


def _np_dtype(name: Optional[str]):
    if name is None:
        return None
    mapping = {
        "float32": np.float32, "float64": np.float64, "int32": np.int32,
        "int64": np.int64, "uint8": np.uint8, "bool": np.bool_,
        "string": None,
    }
    return mapping.get(name)
