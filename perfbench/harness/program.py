"""The system under test, built from a configuration file and the
benchmark's weights: the port's HyperVLA, its training step and optimizer
as `train/trainer.py` builds them, and its frozen encoders. Only the
weights are the benchmark's; every module, step and kernel is the
program's."""
import copy
from typing import Dict

import torch


def model_config(cfg: dict) -> dict:
    """The program's config dict of a configuration file."""
    from hypervla_tpu_torch.configs import disable_unused_attention_capture

    return disable_unused_attention_capture(copy.deepcopy(cfg["config"]))


def check_geometry(cfg: dict) -> None:
    """The sizes the file states are the ones the program runs."""
    from hypervla_tpu_torch.configs import dinov2_config

    vk = cfg["config"]["base_net_kwargs"]["vit_kwargs"]
    if "dinov2" in cfg:
        table = dinov2_config(vk.get("pretrained_encoder_name",
                                     "dinov2-base")).__dict__
        for key, value in cfg["dinov2"].items():
            if table[key] != value:
                raise ValueError(f"dinov2 {key}: the file states {value}, "
                                 f"the program runs {table[key]}")


def build_model(cfg: dict, params: Dict[str, torch.Tensor], instr_len: int,
                token_dim: int, device):
    """The program's HyperVLA over `params`, with a check that they are
    exactly the params its config asks for."""
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA, check_params
    from hypervla_tpu_torch.models.weight_plan import build_weight_plan
    from hypervla_tpu_torch.utils.device import resolve_device

    # as the port's entry points set the card up (cuDNN's fp32 without TF32)
    device = resolve_device(device)
    check_geometry(cfg)
    config = model_config(cfg)
    base_net = BaseNetwork(**config["base_net_kwargs"], input_shapes={
        "image": (224, 224), "instruction": (instr_len, token_dim)})
    plan = build_weight_plan(config, base_net)
    hypernet = HyperNetwork(plan, config["hypernet_kwargs"])
    width = cfg.get("dinov2", {}).get("hidden_size", 0)
    check_params(params, hypernet.specs(
        instr_len=instr_len, token_dim=token_dim, image_tokens=1,
        patch_dim=width))
    return HyperVLA(hypernet, base_net, config, params, plan, None, device)


def frozen_encoders(cfg: dict, config: dict, dino_params, device):
    """(text_apply, dino_apply, dino_params): the frozen T5 and DINOv2 as
    train/trainer.py::build_frozen_encoders makes them, over the given
    weights (that function draws its own)."""
    from hypervla_tpu_torch.configs import dinov2_config
    from hypervla_tpu_torch.models.base_vit import normalize_pixels
    from hypervla_tpu_torch.models.encoders.dinov2 import (
        dinov2_forward,
        pack_frozen_layers,
    )
    from hypervla_tpu_torch.models.encoders.t5 import T5Config, t5_encode
    from hypervla_tpu_torch.train.trainer import frozen_layer_kernel

    t5 = T5Config(**cfg["t5"])

    def text_apply(params, input_ids, attention_mask):
        return t5_encode(t5, params, input_ids, attention_mask)

    if not config["hypernet_kwargs"].get("use_initial_image", False):
        return text_apply, None, None
    vk = config["base_net_kwargs"]["vit_kwargs"]
    dino = dinov2_config(vk.get("pretrained_encoder_name", "dinov2-base"))
    dtype = (torch.bfloat16 if vk.get("encoder_dtype") == "bfloat16"
             else torch.float32)
    layer_kernel = frozen_layer_kernel(config)
    fused_ln = vk.get("fused_layer_norm", False)
    if layer_kernel:
        dino_params = pack_frozen_layers(dino, dino_params)

    def dino_apply(params, images):
        return dinov2_forward(dino, params, normalize_pixels(images), dtype,
                              layer_kernel=layer_kernel, fused_ln=fused_ln)

    return text_apply, dino_apply, dino_params


def build_train(cfg: dict, weights: dict, instr_len: int, token_dim: int,
                first_step: int, seed: int, device):
    """(step_fn, state, encoder_params): the training step of
    train/trainer.py (make_train_step over create_optimizer's per-leaf
    AdamW, the EMA as the config says) with the frozen encoders inside it,
    its state at `first_step` updates (the LR schedules read the count)."""
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import make_train_step

    model = build_model(cfg, weights["params"], instr_len, token_dim, device)
    config = model.config
    text_apply, dino_apply, dino_params = frozen_encoders(
        cfg, config, weights.get("dino"), device)
    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **config["optimizer"])
    state = TrainState.create(model.params, tx,
                              track_ema=config.get("save_param_EMA", False),
                              seed=seed)
    state.step = first_step
    state.opt_state["count"] = first_step
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                              text_encode=text_apply, dino_encode=dino_apply)
    return step_fn, state, {"t5": weights["t5"], "dino": dino_params}
