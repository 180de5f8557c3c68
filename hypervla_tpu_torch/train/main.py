"""The port's training command line (counterpart of scripts/train.py):

    python -m hypervla_tpu_torch.train.main --config vit_t,oxe,fast \\
        --config.dataset_kwargs.data_dir=<dir> --save_dir <dir> [--cpu]

`--config` is `<file.py>:<string>`, whose `get_config(string)` returns a
dict or anything with `.to_dict()`, or the built-in config:
`<size>,<dataset>[,fast]` alone or after `hypervla_pretrain_config:` (or
the JAX command line's path to that file, whose copy it is:
configs.py::hypervla_pretrain_config). Every `--config.<dotted.field>=
<value>` overrides an existing field; the value is parsed with
ast.literal_eval and kept as a string where that fails. The trainer runs on
the card unless `--cpu` is given. argparse stands in for absl and
ml_collections, which the GPU host lacks.
"""
import argparse
import ast
import importlib.util
import logging
import os
from typing import Any, Dict, List, Optional

from hypervla_tpu_torch.configs import hypervla_pretrain_config

#: the built-in config's name: the JAX command line's config file, whose
#: copy the port holds
BUILTIN_CONFIG = "hypervla_pretrain_config"
DEFAULT_CONFIG = "vit_t,oxe"
OVERRIDE_PREFIX = "--config."


def load_config(spec: str) -> Dict[str, Any]:
    """The config that `--config` names: `<file.py>:<string>` or the
    built-in config string."""
    path, sep, string = spec.partition(":")
    if not sep:
        return hypervla_pretrain_config(spec)
    if os.path.splitext(os.path.basename(path))[0] == BUILTIN_CONFIG:
        return hypervla_pretrain_config(string)
    if not path.endswith(".py"):
        raise ValueError(f"--config {spec}: {path} is neither a .py file "
                         f"nor {BUILTIN_CONFIG}")
    module_spec = importlib.util.spec_from_file_location(
        "hypervla_train_config", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    config = module.get_config(string)
    if hasattr(config, "to_dict"):
        config = config.to_dict()
    return dict(config)


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(config: Dict[str, Any], overrides: List[str]) -> None:
    """Sets each `--config.<a.b.c>=<value>` on config, in place; the field
    must exist, as with ml_collections' config flags."""
    for arg in overrides:
        if not arg.startswith(OVERRIDE_PREFIX) or "=" not in arg:
            raise ValueError(f"unrecognized argument {arg!r}: overrides are "
                             "--config.<dotted.field>=<value>")
        dotted, _, text = arg[len(OVERRIDE_PREFIX):].partition("=")
        *parents, last = dotted.split(".")
        node = config
        for key in parents:
            node = node[key]
        if not isinstance(node, dict) or last not in node:
            raise KeyError(f"--config.{dotted}: no such field in the config")
        node[last] = _parse_value(text)


def _wandb_run(args, config):
    if not args.wandb:
        return None
    try:
        import wandb

        return wandb.init(
            project=args.wandb_project, name=args.name, config=config,
            id=args.wandb_resume_id,
            resume="must" if args.wandb_resume_id else None)
    except Exception as e:  # an optional logger: training goes on without
        logging.warning(f"wandb unavailable ({e}); continuing without it.")
        return None


def main(argv: Optional[List[str]] = None):
    """Parses argv (None: sys.argv), runs the trainer; returns the final
    TrainState."""
    parser = argparse.ArgumentParser(
        description="Train HyperVLA with the PyTorch port.")
    parser.add_argument("--config", default=DEFAULT_CONFIG,
                        help="<file.py>:<string> or <size>,<dataset>[,fast]")
    parser.add_argument("--name", default="hypervla",
                        help="experiment name")
    parser.add_argument("--save_dir", default=None,
                        help="checkpoint directory")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="FSDP axis size (only 1 is ported)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel axis size (only 1 is ported)")
    parser.add_argument("--wandb", action="store_true",
                        help="log to wandb where it is installed")
    parser.add_argument("--wandb_project", default="hypervla_tpu")
    parser.add_argument("--wandb_resume_id", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args, overrides = parser.parse_known_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    config = load_config(args.config)
    apply_overrides(config, overrides)

    from hypervla_tpu_torch.train.trainer import train

    return train(config, save_dir=args.save_dir,
                 wandb_run=_wandb_run(args, config), fsdp=args.fsdp,
                 tp=args.tp, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
