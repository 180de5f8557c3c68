"""Configs and DINOv2 geometries for the port.

Plain-dict copies of hypervla_tpu/configs/defaults.py (`pretrain_config`,
`flagship_pretrain_config`, `tiny_test_config`, `apply_fast_training_preset`,
`disable_unused_attention_capture`), keeping the keys the serving path, the
training step and the trainer read, of the DINOv2 geometries in
hypervla_tpu/models/encoders/dinov2.py, and of the command line's built-in
config, scripts/configs/hypervla_pretrain_config.py::get_config
(`hypervla_pretrain_config`). The JAX configs module imports flax and the
command line's config ml_collections, so the port keeps its own copy.
"""
import copy
import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 518  # resolution the position grid was trained at
    num_channels: int = 3
    layerscale_value: float = 1.0
    layer_norm_eps: float = 1e-6
    use_mask_token: bool = True
    initializer_range: float = 0.02


_DINOV2_CONFIGS = {
    "dinov2-base": DINOv2Config(hidden_size=768, num_attention_heads=12),
    # tiny geometry for CPU tests
    "dinov2-test": DINOv2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        image_size=224,
    ),
    # smallest geometry the stacked trunk takes (head dim 64)
    "dinov2-test-wide": DINOv2Config(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        image_size=224,
    ),
}


def dinov2_config(name: str) -> DINOv2Config:
    key = name.split("/")[-1]
    if key not in _DINOV2_CONFIGS:
        raise ValueError(f"unknown DINOv2 config {name}")
    return _DINOV2_CONFIGS[key]


#: the dropout rates the JAX package reads, by the config section that holds
#: them (hypervla_tpu/models/hypernetwork.py, models/base_vit.py)
DROPOUT_KEYS = {
    "hypernet_kwargs": ("image_dropout", "embedding_dropout_rate",
                        "final_dropout_rate"),
    "hypernet_kwargs context_encoder_kwargs": ("dropout_rate",
                                               "attention_dropout_rate"),
    "vit_kwargs": ("dropout_rate",),
}


def refuse_dropout(section: str, kwargs: Dict[str, Any]) -> None:
    """Raises NotImplementedError for a nonzero dropout rate among the keys
    of `section` (a key of DROPOUT_KEYS): the port has no dropout, and a
    rate it dropped without a word would train another model than the JAX
    package does. A rate of 0, None or an absent key passes."""
    for key in DROPOUT_KEYS[section]:
        if kwargs.get(key):
            raise NotImplementedError(
                f"{section} {key}={kwargs[key]!r}: dropout is not ported "
                "(ROADMAP.md A8, the rest of the train step); set the rate "
                "to 0")


def pretrain_config() -> Dict[str, Any]:
    """The reference defaults, cut to the keys the serving path, the
    training step and the trainer read (the dropout, CNN and octo keys are
    not copied)."""
    def schedule(peak):
        return {"name": "rsqrt", "init_value": 0.0, "peak_value": peak,
                "warmup_steps": 2000, "timescale": 10000}

    return {
        "seed": 42,
        "num_steps": 300000,
        "window_size": 1,
        "save_interval": 10000,
        "eval_interval": 5000,
        "log_interval": 100,
        "pretrained_checkpoint_path": None,
        "pretrained_checkpoint_step": None,
        "save_param_EMA": False,
        "EMA_start_step": 5000,
        "EMA_decay": 0.999,
        "optimizer": {
            "learning_rate": schedule(3e-4),
            "base_learning_rate": schedule(3e-5),
            "weight_decay": 0.1,
            "base_weight_decay": 0.0,
            "weight_decay_strategy": "v1",
            "clip_gradient": 1.0,
            "frozen_keys": tuple(),
            "grad_accumulation_steps": 1,
        },
        "hypernet_kwargs": {
            "context_embedding_dim": 128,
            "context_encoder_kwargs": {
                "num_layers": 1,
                "mlp_dim": 256,
                "num_attention_heads": 4,
                "add_position_embedding": False,
            },
            "attend_to_padding": False,
            "task_attend_to_layer": False,
            "scale_context_embedding": False,
            "output_head_bias": True,
            "generation_strategy": "full",
            "shared_modules": tuple(),
            "include_goal_image": False,
            "use_initial_image": False,
            "use_all_image_tokens": False,
            "share_TF_output_head": False,
            "init_strategy": 0,
            "share_all_params": False,
            "share_layer_index": False,
        },
        "base_net_kwargs": {
            "model_type": "cnn",
            "action_head_type": "diffusion",
            "action_horizon": 4,
            "action_dim": 7,
            "vit_kwargs": {
                "encoder_type": "SmallStem",
                "hidden_dim": 64,
                "num_layers": 4,
                "num_heads": 4,
                "mlp_dim": 128,
                "use_language_token": False,
                "use_differential_transformer": False,
                "add_positional_embedding": True,
                "include_class_token": False,
                "fine_tune_pretrained_image_encoder": False,
                "image_embedding_noise": 0.0,
                "return_attention_map": False,
            },
            "action_head_kwargs": {
                "token_per_horizon": False,
                "squash_continuous_action": True,
                "tanh_scaling_factor": 5.0,
                "clip_target": False,
                "max_action": 5.0,
                "hidden_dims": tuple(),
            },
        },
        "auxiliary_loss": {
            "HN_regularizer": 0.0,
            "close_drawer_weight": 1.0,
            "attention_map_alignment": 0.0,
            "attention_entropy": 0.0,
            "rephrase_strategy": None,
            "rephrase_alignment_coef": 1.0,
        },
        "dataset_kwargs": {
            "batch_size": 256,
            "shuffle_buffer_size": 250000,
            "oxe_mix": "oxe_magic_soup",
            "text_tokenizer": "t5-base",
            "tokenizer_max_length": 32,
            "resize_size": {"primary": (224, 224)},
        },
    }


def flagship_pretrain_config() -> Dict[str, Any]:
    """The README vit_t,oxe recipe: DINOv2-base encoder shared, block
    generation off one shared layer token, mix action head."""
    config = pretrain_config()
    config["num_steps"] = 100000
    config["optimizer"].update(
        weight_decay_strategy="v5", weight_decay=0.05, base_weight_decay=0.0
    )
    config["hypernet_kwargs"].update(
        context_embedding_dim=128,
        context_encoder_kwargs={
            "num_layers": 6,
            "mlp_dim": 512,
            "num_attention_heads": 4,
            "add_position_embedding": False,
        },
        scale_context_embedding=True,
        generation_strategy="block",
        attend_to_padding=False,
        share_layer_index=True,
        shared_modules=("image_encoder",),
        use_initial_image=True,
        share_TF_output_head=False,
    )
    config["base_net_kwargs"].update(model_type="vit", action_head_type="mix")
    config["base_net_kwargs"]["vit_kwargs"].update(
        encoder_type="DINOv2",
        num_layers=4,
        hidden_dim=64,
        num_heads=4,
        mlp_dim=128,
        use_differential_transformer=False,
        add_positional_embedding=True,
        use_language_token=False,
        fine_tune_pretrained_image_encoder=True,
    )
    config["base_net_kwargs"]["action_head_kwargs"].update(
        clip_target=True, squash_continuous_action=True,
        tanh_scaling_factor=5.0
    )
    config["auxiliary_loss"]["rephrase_strategy"] = "replace"
    config["save_param_EMA"] = True
    config["seed"] = 2025
    return config


def tiny_test_config(**overrides) -> Dict[str, Any]:
    """A shrunken config for CPU tests: tiny context encoder, tiny base net,
    tiny DINOv2 (`dinov2-test`); the JAX twin is
    `tiny_test_config(encoder_type="DINOv2")`."""
    config = pretrain_config()
    config["hypernet_kwargs"].update(
        context_embedding_dim=16,
        context_encoder_kwargs={
            "num_layers": 1,
            "mlp_dim": 32,
            "num_attention_heads": 2,
            "add_position_embedding": False,
        },
        generation_strategy="block",
    )
    config["base_net_kwargs"].update(
        model_type="vit", action_head_type="mix", action_horizon=2,
        action_dim=7,
    )
    config["base_net_kwargs"]["vit_kwargs"].update(
        encoder_type="DINOv2",
        hidden_dim=16,
        num_layers=2,
        num_heads=2,
        mlp_dim=32,
    )
    config["hypernet_kwargs"].update(
        shared_modules=("image_encoder",),
        share_layer_index=True,
        use_initial_image=True,
        scale_context_embedding=True,
    )
    config["base_net_kwargs"]["vit_kwargs"][
        "pretrained_encoder_name"
    ] = "dinov2-test"
    hk_overrides = overrides.pop("hypernet_kwargs", {})
    config["hypernet_kwargs"].update(hk_overrides)
    config.update(copy.deepcopy(overrides))
    return config


def disable_unused_attention_capture(config):
    """Turns off DINO attention-map capture when nothing consumes it (no
    aux loss, no return_attention_map)."""
    aux = config["auxiliary_loss"]
    if (
        aux.get("attention_map_alignment", 0.0) == 0.0
        and aux.get("attention_entropy", 0.0) == 0.0
        and not config["base_net_kwargs"]["vit_kwargs"].get(
            "return_attention_map", False
        )
    ):
        config["base_net_kwargs"]["vit_kwargs"].setdefault(
            "sow_dino_attention", False
        )
    return config


def apply_fast_training_preset(config):
    """The training fast path: a bfloat16 trunk, the fused training
    attention in the trunk (ops/fused_attention.py) and the no-residual
    layer forward for the frozen conditioning encoder
    (ops/dino_layer_train.py), no unused attention capture."""
    vk = config["base_net_kwargs"]["vit_kwargs"]
    vk["encoder_dtype"] = "bfloat16"
    vk["dino_fused_attention"] = True
    config["frozen_encoder_layer_kernel"] = True
    disable_unused_attention_capture(config)
    return config


def hypervla_pretrain_config(config_string: str = "vit_t,oxe"
                             ) -> Dict[str, Any]:
    """The training command line's built-in config, "<size>,<dataset>
    [,fast]": vit_t,oxe is the flagship recipe, over the oxe_magic_soup mix
    unless dataset_kwargs say otherwise; another dataset name leaves the
    mix off for a dataset_kwargs_list; "fast" applies the training fast
    preset. The size names the octo transformer of the JAX config, whose
    keys the port does not carry, so any size other than vit_t gives the
    reference defaults."""
    tokens = config_string.split(",")
    fast = "fast" in tokens
    tokens = [t for t in tokens if t != "fast"]
    model_size, dataset = (tokens + ["oxe"])[:2]
    if model_size == "vit_t" and dataset == "oxe":
        config = flagship_pretrain_config()
    else:
        config = pretrain_config()
    dk = config["dataset_kwargs"]
    dk["dataset"] = dataset
    if dataset == "oxe":
        dk.setdefault("oxe_mix", "oxe_magic_soup")
        dk.setdefault("data_dir", "")
        dk.setdefault("skip_unlabeled", True)
    else:
        dk["oxe_mix"] = None
        dk.setdefault("data_dir", "")
        dk.setdefault("dataset_kwargs_list", [])
    if fast:
        apply_fast_training_preset(config)
    return config
