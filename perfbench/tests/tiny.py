"""Tiny twins of the benchmark's configurations, for the CPU tests: the
same topology at CPU sizes (the program's tiny DINOv2 `dinov2-test`, a
small T5, a small policy), in the configuration file's layout."""
import copy
import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TINY_T5 = {"vocab_size": 97, "d_model": 32, "d_kv": 8, "d_ff": 64,
           "num_layers": 2, "num_heads": 4,
           "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128,
           "layer_norm_epsilon": 1e-6, "initializer_factor": 1.0}


def load_config(name: str) -> dict:
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as f:
        return json.load(f)


def tiny_flagship() -> dict:
    from hypervla_tpu_torch.configs import dinov2_config

    cfg = copy.deepcopy(load_config("hypervla_vit_t_oxe_fast"))
    c = cfg["config"]
    c["hypernet_kwargs"]["context_embedding_dim"] = 16
    c["hypernet_kwargs"]["context_encoder_kwargs"].update(
        num_layers=2, mlp_dim=32, num_attention_heads=2)
    c["base_net_kwargs"]["vit_kwargs"].update(
        hidden_dim=16, num_layers=2, num_heads=2, mlp_dim=32,
        pretrained_encoder_name="dinov2-test")
    cfg["dinov2"] = dataclasses.asdict(dinov2_config("dinov2-test"))
    cfg["t5"] = dict(TINY_T5)
    return cfg


def tiny_smallstem() -> dict:
    cfg = copy.deepcopy(load_config("hypervla_smallstem_vit_t_libero"))
    c = cfg["config"]
    c["hypernet_kwargs"]["context_embedding_dim"] = 16
    c["hypernet_kwargs"]["context_encoder_kwargs"].update(
        num_layers=1, mlp_dim=32, num_attention_heads=2)
    c["base_net_kwargs"]["vit_kwargs"].update(
        hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=32,
        cnn_channels=[32, 32, 32, 32])
    cfg["t5"] = dict(TINY_T5)
    return cfg


TINY_TRAIN_MIX = {"kind": "train", "batch_size": 4, "distinct_batches": 3,
                  "instruction_tokens": 8, "instruction_length": [3, 8],
                  "token_ids": [2, 97], "image_size": 224, "arm_std": 1.0,
                  "first_step": 10000, "checked_steps": 3,
                  "reference_rows": 2, "trace_units": 2}


def tiny_replay_mix() -> dict:
    mix = load_json_mix("replay_b256")
    mix.update(instruction_tokens=8, instruction_length=[3, 8],
               token_ids=[2, 97], instruction_pool=4, frame_pool=16,
               lengths=[5, 16], cycles=2, chunk=8,
               warmup_lengths=[5, 16], trace_units=2, checked_requests=2,
               calibrate_seconds=0.5)
    return mix


def load_json_mix(name: str) -> dict:
    with open(os.path.join(ROOT, "traffic", f"{name}.json")) as f:
        return json.load(f)


#: the limits of the tiny twins' comparisons on the CPU, set from their
#: readings there as the cells' limits are from the card's (PERF.md): the
#: program's readings below, the control's (perfbench/tests/
#: test_perfbench_control.py) above
TINY_LIMITS = {
    "flagship.train_b256": {"loss": 0.01, "grad": 0.045,
                            "grad_median": 0.007, "change": 0.06,
                            "change_median": 0.0025, "ema": 0.06,
                            "ema_median": 0.0025},
    "smallstem.train_b256": {"loss1": 1e-5, "grad": 0.002,
                             "grad_median": 1e-4, "change": 0.01,
                             "change_median": 0.002},
    "flagship.replay_b256": {"arm": 0.09, "grip": 0.044},
}
