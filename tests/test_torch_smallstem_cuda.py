"""The SmallStem HyperVLA's serving step on the card against the same step
on the CPU: the tiny SmallStem config (64-px frames resized from 80 x 96,
a 32-channel generated stem) under both generation strategies, built from
a seed with random fan-out kernels, the fused step and the host path for a
few ticks, each action within 1e-4 of the CPU's (fp32 on both, TF32 off on
the card). No kernel of the port runs on this path; the test holds the
convolutions, the GroupNorm and the per-sample layouts to the CPU.

Skips where there is no CUDA device. On a GPU host without JAX:
`python -m pytest --noconftest -q tests/test_torch_smallstem_cuda.py`.
"""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.models.hypervla import HyperVLA
from test_torch_harness import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda

SIZE, TICKS = 64, 4
STATS = {"mean": np.arange(7, dtype=np.float32) / 10,
         "std": 1 + np.arange(7, dtype=np.float32) / 7,
         "mask": np.array([True] * 6 + [False])}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(strategy, head, device):
    rng = np.random.default_rng(0)
    batch = {
        "observation": {"image_primary": np.zeros((1, 1, SIZE, SIZE, 3),
                                                  np.uint8)},
        "task": {"language_instruction": {
            "token_embedding": rng.standard_normal((1, 8, 768)).astype(
                np.float32),
            "attention_mask": np.ones((1, 8), np.int32)}},
    }
    config = tiny_test_config("SmallStem", action_head_type=head,
                              hypernet_kwargs=dict(
                                  generation_strategy=strategy))
    model = HyperVLA.from_config(config, batch, seed=0, device="cpu",
                                 dataset_statistics={"action": STATS})
    gen = torch.Generator().manual_seed(1)
    for name, value in model.params.items():
        if name.startswith("output_head") and name.endswith("kernel"):
            value += torch.randn(value.shape, generator=gen) * 0.02
    card = model.replace(params={k: v.to(device)
                                 for k, v in model.params.items()},
                         device=device)
    return model, card, {"language_instruction":
                         batch["task"]["language_instruction"]}


@pytest.mark.parametrize("strategy,head", [("block", "mix"),
                                           ("full", "continuous")])
@pytest.mark.parametrize("fused", [True, False])
def test_serving_step_on_the_card_matches_the_cpu(device, strategy, head,
                                                   fused):
    model, card, instruction = _model(strategy, head, device)
    kwargs = dict(policy_setup="libero", image_size=SIZE, crop=True,
                  action_ensemble=True, pred_action_horizon=2,
                  fused_serving=fused)
    frames = np.random.default_rng(2).integers(0, 256, (TICKS, 80, 96, 3),
                                               dtype=np.uint8)
    out = []
    for m in (model, card):
        wrapper = InferenceWrapper(m, **kwargs)
        wrapper.reset("pick up the cube", instruction)
        out.append([wrapper.step(frame)[:2] for frame in frames])
    for (raw_c, act_c), (raw_g, act_g) in zip(*out):
        assert np.isfinite(raw_g).all()
        np.testing.assert_allclose(raw_g, raw_c, atol=1e-4)
        np.testing.assert_allclose(act_g, act_c, atol=1e-4)
