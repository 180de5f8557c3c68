"""Configs and DINOv2 geometries for the port.

Plain-dict copies of hypervla_tpu/configs/defaults.py (`pretrain_config`,
`flagship_pretrain_config`, `tiny_test_config`), keeping only the keys the
serving path reads, and of the DINOv2 geometries in
hypervla_tpu/models/encoders/dinov2.py. The JAX configs module imports
flax, so the port keeps its own copy.
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


def pretrain_config() -> Dict[str, Any]:
    """The reference defaults, cut to the keys the serving path reads
    (training, data, dropout and octo keys are not copied)."""
    return {
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
            },
            "action_head_kwargs": {
                "token_per_horizon": False,
                "squash_continuous_action": True,
                "tanh_scaling_factor": 5.0,
                "max_action": 5.0,
                "hidden_dims": tuple(),
            },
        },
    }


def flagship_pretrain_config() -> Dict[str, Any]:
    """The README vit_t,oxe recipe: DINOv2-base encoder shared, block
    generation off one shared layer token, mix action head."""
    config = pretrain_config()
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
    )
    config["base_net_kwargs"]["action_head_kwargs"].update(
        squash_continuous_action=True, tanh_scaling_factor=5.0
    )
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
