"""The port's OpenVLA baseline wrapper (hypervla_tpu_torch/eval/
openvla_interface.py) against the JAX package's, with the mocked HF
processor and model of tests/test_openvla.py (the 7B checkpoint is not
here): the same prompt, raw action, converted action, resized image and
sticky-gripper state, step by step, for both robot setups."""
import numpy as np
import pytest

from hypervla_tpu.eval import openvla_interface as jopenvla
from hypervla_tpu_torch.eval import openvla_interface as openvla
from test_torch_harness import torch_threads  # noqa: F401

RAWS = [np.array([0.01, 0.02, 0.03, 0.1, 0.2, 0.3, 1.0]),
        np.array([0, 0, 0, 0, 0, 0, 0.0]),
        np.array([0.05, -0.02, 0.0, -0.4, 0.1, 2.0, 0.3]),
        np.array([0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.9])]


class _Inputs(dict):
    def to(self, device, dtype=None):
        return self


class _MockProcessor:
    def __init__(self):
        self.prompts = []

    def __call__(self, prompt, image):
        self.prompts.append(prompt)
        return _Inputs()


class _MockModel:
    device = "cpu"

    def __init__(self, unnorm_key):
        self.unnorm_key = unnorm_key
        self.raw = RAWS[0]

    def eval(self):
        return self

    def predict_action(self, unnorm_key=None, do_sample=False, **inputs):
        assert unnorm_key == self.unnorm_key and do_sample is False
        return self.raw


@pytest.mark.parametrize("setup,key", [
    ("google_robot", "fractal20220817_data"),
    ("widowx_bridge", "bridge_orig"),
])
def test_openvla_wrapper_matches_jax(monkeypatch, setup, key):
    import transformers

    runs = {}
    for name, module in (("jax", jopenvla), ("port", openvla)):
        proc, model = _MockProcessor(), _MockModel(key)
        monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                            classmethod(lambda cls, *a, **k: proc))
        monkeypatch.setattr(transformers.AutoModelForVision2Seq,
                            "from_pretrained",
                            classmethod(lambda cls, *a, **k: model))
        policy = module.OpenVLAInference(policy_setup=setup, image_size=32)
        policy.reset("Pick Up The Block")
        frame = np.arange(64 * 64 * 3, dtype=np.uint8).reshape(64, 64, 3)
        steps = []
        for i, raw in enumerate(RAWS):
            model.raw = raw
            task = "Open The Drawer" if i == 3 else None
            out = policy.step(frame, task)
            steps.append((out, policy.sticky_action_is_on,
                          policy.gripper_action_repeat))
        runs[name] = (steps, proc.prompts)
    (got, prompts), (ref, jprompts) = runs["port"], runs["jax"]
    assert prompts == jprompts
    assert prompts[0] == ("In: What action should the robot take to pick up "
                          "the block?\nOut:")
    assert prompts[-1].endswith("open the drawer?\nOut:")
    for (out, *state), (jout, *jstate) in zip(got, ref):
        assert state == jstate
        raw, flat, img, attn, seconds = out
        np.testing.assert_array_equal(raw, jout[0])
        np.testing.assert_array_equal(flat, jout[1])
        np.testing.assert_array_equal(img, jout[2])
        assert flat.shape == (7,) and flat.dtype == np.float32
        assert img.shape == (32, 32, 3)
        assert attn is None and seconds == 0.0
    if setup == "google_robot":
        assert got[1][1] and got[1][0][1][-1] == 1.0  # the sticky gripper
    else:
        assert [s[0][1][-1] for s in got] == [1.0, -1.0, -1.0, 1.0]


def test_an_unknown_setup_raises_as_in_jax(monkeypatch):
    import transformers

    monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                        classmethod(lambda cls, *a, **k: _MockProcessor()))
    monkeypatch.setattr(transformers.AutoModelForVision2Seq,
                        "from_pretrained",
                        classmethod(lambda cls, *a, **k: _MockModel("x")))
    for module in (jopenvla, openvla):
        with pytest.raises(ValueError, match="Unknown policy setup"):
            module.OpenVLAInference(policy_setup="libero")
