#!/usr/bin/env python3
"""Converts a checkpoint of the JAX package into the PyTorch port's format.

    python tools/convert_checkpoint_to_torch.py <jax_dir> <torch_dir> [--step N]

Runs where JAX is installed (orbax restores the params). Reads what the JAX
trainer writes: config.json, example_batch.msgpack, dataset_statistics.json,
the orbax step directories and <step>/EMA_params.pkl. Writes the layout of
hypervla_tpu_torch/models/hypervla.py: config.json and
dataset_statistics.json copied as they are, example_batch.npz ("/"-joined
keys), <step>/params.pt and <step>/EMA_params.pt (flat {name: tensor}
dicts in the keys of hypervla_tpu_torch/utils/convert.py, a scanned trunk
unstacked into per-layer keys). Every step
directory is converted unless --step names one. The port then serves the
result where JAX is absent:

    python -m hypervla_tpu_torch.eval.policy_server --checkpoint <torch_dir>

A checkpoint of the JAX OctoModel (save_pretrained: its params, config.json,
example_batch.msgpack, dataset_statistics.json; a config whose model_class
is "octo", or without hypernet_kwargs) converts into the layout of
hypervla_tpu_torch/models/octo_model.py, its config's ModuleSpecs pointed
at the port's modules; the port loads it with
`OctoModel.load_pretrained(<torch_dir>)`.

A checkpoint of the JAX BaseModel (the no-hypernetwork ablation's
save_pretrained: a config whose model_class is "base_model" and params
that are the base net's tree, "encoder" and "action_head") converts its
base-net params as they are; the port loads it with
`BaseModel.load_pretrained(<torch_dir>)`. The JAX trainer trains that
config as a HyperVLA whose blocks are all shared, and its checkpoints
convert as any HyperVLA's.
"""
import argparse
import json
import os
import pickle
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hypervla_tpu.models.base_model import BaseModel  # noqa: E402
from hypervla_tpu.models.hypervla import HyperVLA  # noqa: E402
from hypervla_tpu.models.octo_model import OctoModel  # noqa: E402
from hypervla_tpu_torch.models.hypervla import EMA_FILE, PARAMS_FILE  # noqa: E402
from hypervla_tpu_torch.utils.convert import (  # noqa: E402
    drop_unread_params,
    flatten_tree,
    from_jax_params,
    port_module_specs,
    trunk_depth,
)


def is_octo(config: dict) -> bool:
    """Whether a checkpoint's config is an OctoModel's."""
    return (config.get("model_class") == "octo"
            or "hypernet_kwargs" not in config)


def _convert_octo(src: str, dst: str, steps: list) -> None:
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(port_module_specs(config), f)
    for s in steps:
        out = os.path.join(dst, str(s))
        os.makedirs(out, exist_ok=True)
        model = OctoModel.load_pretrained(src, step=s)
        torch.save(from_jax_params(model.params),
                   os.path.join(out, PARAMS_FILE))


#: the top-level keys of a base net's param tree
BASE_NET_KEYS = {"encoder", "action_head"}


def is_base_model(src: str, config: dict, step: int) -> bool:
    """Whether the checkpoint at src holds a JAX BaseModel's params (the
    base net's tree) at `step`, rather than a HyperVLA's."""
    if config.get("model_class") != "base_model":
        return False
    import orbax.checkpoint as ocp

    tree = ocp.CheckpointManager(os.path.abspath(src)).restore(step)
    return set(tree) <= BASE_NET_KEYS


def _convert_base_model(src: str, dst: str, steps: list) -> None:
    for s in steps:
        out = os.path.join(dst, str(s))
        os.makedirs(out, exist_ok=True)
        model = BaseModel.load_pretrained(src, step=s)
        torch.save(from_jax_params(model.params),
                   os.path.join(out, PARAMS_FILE))


def convert(src: str, dst: str, step=None) -> list:
    """Converts the step `step` (None: every step directory) of the JAX
    checkpoint at src into the port's layout at dst; returns the steps."""
    import flax.serialization

    src, dst = os.path.abspath(src), os.path.abspath(dst)
    os.makedirs(dst, exist_ok=True)
    for name in ("config.json", "dataset_statistics.json"):
        if os.path.exists(os.path.join(src, name)):
            shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "example_batch.msgpack"), "rb") as f:
        batch = flax.serialization.msgpack_restore(f.read())
    np.savez(os.path.join(dst, "example_batch.npz"),
             **{k: np.asarray(v) for k, v in flatten_tree(batch).items()})

    steps = ([step] if step is not None else
             sorted(int(d) for d in os.listdir(src) if d.isdigit()))
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    if is_octo(config):
        _convert_octo(src, dst, steps)
        return steps
    if steps and is_base_model(src, config, steps[0]):
        _convert_base_model(src, dst, steps)
        return steps
    for s in steps:
        out = os.path.join(dst, str(s))
        os.makedirs(out, exist_ok=True)
        model = HyperVLA.load_pretrained(src, step=s)
        layers = trunk_depth(model.config)
        torch.save(drop_unread_params(from_jax_params(model.params,
                                                      layers=layers),
                                      model.config),
                   os.path.join(out, PARAMS_FILE))
        ema_path = os.path.join(src, str(s), "EMA_params.pkl")
        if os.path.exists(ema_path):
            with open(ema_path, "rb") as f:
                ema = pickle.load(f)
            torch.save({key: drop_unread_params(
                from_jax_params(tree, layers=layers), model.config)
                        for key, tree in ema.items()},
                       os.path.join(out, EMA_FILE))
    return steps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="the JAX checkpoint directory")
    parser.add_argument("dst", help="where to write the port's checkpoint")
    parser.add_argument("--step", type=int, default=None,
                        help="the one step to convert (default: every step)")
    args = parser.parse_args()
    steps = convert(args.src, args.dst, args.step)
    print(f"converted steps {steps} of {args.src} into {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
