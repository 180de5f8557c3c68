"""The plain reference held to the port on the CPU at the tiny twins:
the first training steps of both configurations (with the port's trunk in
fp32, so that only summation order differs) and the served forward."""
import copy

import pytest
import torch

from perfbench.harness import program, traffic, weights
from perfbench.harness.train_driver import TrainDriver, compare
from perfbench.reference.hypervla import HyperVLAReference, t5_shapes
from perfbench.tests.tiny import (
    TINY_TRAIN_MIX,
    tiny_flagship,
    tiny_replay_mix,
    tiny_smallstem,
)


def fp32_flagship():
    cfg = tiny_flagship()
    vk = cfg["config"]["base_net_kwargs"]["vit_kwargs"]
    vk.update(encoder_dtype="float32", dino_fused_attention=False)
    cfg["config"]["frozen_encoder_layer_kernel"] = False
    return cfg


@pytest.mark.parametrize("make", [fp32_flagship, tiny_smallstem],
                         ids=["flagship", "smallstem"])
def test_train_steps_agree(make):
    drv = TrainDriver(make(), dict(TINY_TRAIN_MIX), 2 ** 31 + 11, "cpu")
    drv.setup()
    got = compare(drv.side(), drv.reference())
    assert got["loss1"] < 1e-5
    assert got["grad"] < 1e-3
    assert got["grad_median"] < 1e-5
    # Adam's first updates are nearly signs: rounding-level gradients of
    # leaves that barely move flip them, so the changes agree less closely
    assert got["change_median"] < 1e-3
    assert got["change"] < 0.05


def test_fast_preset_trunk_stays_near_the_reference():
    """The configuration as run (bf16 trunk, the port's kernels on the
    card, their plain versions here) against the fp32 reference."""
    drv = TrainDriver(tiny_flagship(), dict(TINY_TRAIN_MIX), 3, "cpu")
    drv.setup()
    got = compare(drv.side(), drv.reference())
    assert got["loss1"] < 1e-2 and got["grad_median"] < 1e-2


def test_served_forward_agrees():
    from hypervla_tpu_torch.eval.inference import initial_state
    from hypervla_tpu_torch.models.encoders.t5 import T5Config, t5_encode
    from hypervla_tpu_torch.ops import preprocess

    cfg = fp32_flagship()
    mix = tiny_replay_mix()
    ref = HyperVLAReference(cfg)
    layout = weights.plan(ref.param_shapes(8, cfg["t5"]["d_model"]),
                          ref.blocks, ref.order,
                          {"t5": t5_shapes(cfg["t5"])}, cfg["t5"]["d_kv"])
    w = weights.make(layout, 5, "cpu")
    ids, mask, pool = traffic.replay_data(mix, 5, "cpu")
    serving = copy.deepcopy(cfg)
    serving["config"]["base_net_kwargs"]["vit_kwargs"].update(
        mix["serving_switches"])
    model = program.build_model(serving, w["params"], 8, cfg["t5"]["d_model"],
                                "cpu")
    frames = pool[3:13]
    with torch.no_grad():
        emb = t5_encode(T5Config(**cfg["t5"]), w["t5"], ids[1:2], mask[1:2])
        instr = {"language_instruction": {"token_embedding": emb,
                                          "attention_mask": mask[1:2]}}
        base, task = model.create_tasks(instruction_dict=instr,
                                        initial_state=initial_state(
                                            model, pool[3]))
        x = preprocess.center_crop(preprocess.resize_image(
            frames, (224, 224)), (224, 224))
        served = model.sample_actions(x, instr, task, None, base,
                                      trunk_impl="layers")
    arm, grip = ref.serve(w["params"], w["t5"], ids[1], mask[1], pool[3],
                          frames)
    assert float((served[..., :-1] - arm).abs().max()) < 1e-3
    sure = grip.abs() > 1e-3
    assert bool(((served[..., -1] >= 0.5) == (grip >= 0))[sure].all())
