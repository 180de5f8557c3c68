"""The port's VisualizationCallback (hypervla_tpu_torch/train/
callbacks.py) against the JAX package's, on the CPU, and the port's
trainer logging it.

The two callbacks run the tiny DINOv2 twins of tests/test_torch_jax_draws.
py::build_pair (one set of params, converted with utils/convert.py), with
and without the initial-image conditioning, over the same held-out
trajectories, with the same text encoder (a table lookup, numpy) and, for
the initial image, the same DINOv2 weights: each package's own
Visualizer, tokenizer and DINOv2 forward. The metrics have the same keys
and agree to 1e-5. A third case runs both twins with a bf16 DINOv2 trunk of head dim 64
(`dinov2-test-wide`):
the port's callback then serves through the stacked trunk (kernel 1's
plain version on the CPU, one frame a launch) and JAX through its batched
bf16 trunk; the actions and the metrics agree to the bf16 bound of
tests/test_torch_serving.py, BF16_BOUND * max(|JAX|, 1).

A trajectory as the data pipeline makes it keeps its initial frame at
trajectory["initial_state"], where neither callback looks (they read
trajectory["task"]["initial_state"]): on a model conditioned on the
initial image both fail at create_tasks with a TypeError. So the trainer
run below, `train()` with `viz_datasets` for 2 steps, is of the model
without that conditioning; it logs `visualizer/<name>/<metric>`."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypervla_tpu.data.text_processing import HFTokenizer as JaxTokenizer
from hypervla_tpu.eval.visualization import Visualizer as JaxVisualizer
from hypervla_tpu.eval.visualization import (
    run_policy_on_trajectory as jax_run_policy,
)
from hypervla_tpu.models.base_vit import DINO_IMAGE_MEAN, DINO_IMAGE_STD
from hypervla_tpu.models.encoders import dinov2 as jdino
from hypervla_tpu.train.callbacks import (
    VisualizationCallback as JaxCallback,
)
from hypervla_tpu_torch.configs import dinov2_config, tiny_test_config
from hypervla_tpu_torch.data.sources import NpzTrajectorySource
from hypervla_tpu_torch.data.text_processing import HFTokenizer
from hypervla_tpu_torch.eval.visualization import (
    Visualizer,
    run_policy_on_trajectory,
)
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders.dinov2 import dinov2_forward
from hypervla_tpu_torch.train import trainer
from hypervla_tpu_torch.train.callbacks import VisualizationCallback
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads, within  # noqa: F401
from test_torch_jax_draws import PAIR_BATCH, build_pair

FRAMES = 5
N_TRAJS = 2
TOKEN_DIM = 768
#: tests/test_torch_serving.py's bound for a bf16 trunk against JAX's
BF16_BOUND = 0.05
TABLE = np.random.default_rng(7).standard_normal(
    (32000, TOKEN_DIM)).astype(np.float32) * 0.1
STATS = {"action": {"mean": np.full(7, 0.1), "std": np.full(7, 2.0),
                    "mask": np.array([True] * 6 + [False])}}


def text_encode(ids, mask):
    """The instruction's token embeddings: a table lookup (both
    packages)."""
    ids, mask = np.asarray(ids), np.asarray(mask)
    return TABLE[ids] * mask[..., None]


class _Trajectories(list):
    dataset_statistics = STATS


def _trajectories(initial_in_task):
    rng = np.random.default_rng(3)
    out = []
    for i in range(N_TRAJS):
        frames = rng.integers(0, 256, (FRAMES, 1, 224, 224, 3),
                              dtype=np.uint8)
        task = {"language_instruction": np.array(
            [b"close top drawer" if i else b"pick up the cube"] * FRAMES,
            dtype=object)}
        initial = {"image_primary": np.repeat(frames[:1], FRAMES, axis=0)}
        traj = {
            "observation": {"image_primary": frames,
                            "timestep_pad_mask": np.ones((FRAMES, 1), bool)},
            "task": task,
            "action": rng.standard_normal(
                (FRAMES, 1, 2, 7)).astype(np.float32),
        }
        if initial_in_task:
            task["initial_state"] = initial
        else:
            traj["initial_state"] = initial
        out.append(traj)
    return _Trajectories(out)


def _tokenizer_kwargs():
    return {"max_length": PAIR_BATCH["instr_len"], "padding": "max_length",
            "truncation": True, "return_tensors": "np"}


@pytest.fixture(scope="module")
def dino_encoders():
    """(JAX dino_encode, port dino_encode) over one set of DINOv2 weights,
    shared by the cases."""
    dino = jdino.DINOv2Model(config=jdino.dinov2_config("dinov2-test"))
    dino_params = dino.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 224, 224, 3)))["params"]

    def jax_dino(images):
        raw = (jnp.asarray(images, jnp.float32) / 255.0
               - jnp.array(DINO_IMAGE_MEAN)) / jnp.array(DINO_IMAGE_STD)
        return dino.apply({"params": dino_params}, raw).last_hidden_state

    port_dino_params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, dino_params))

    def port_dino(images):
        return dinov2_forward(dinov2_config("dinov2-test"), port_dino_params,
                              normalize_pixels(images))

    return jax_dino, port_dino


def _callbacks(conditioned, encoder_dtype, trajectories, dino_encoders):
    """(JAX callback, port callback, JAX params, port params)."""
    def change(config):
        config["hypernet_kwargs"]["use_initial_image"] = conditioned
        if encoder_dtype == "bfloat16":
            # head dim 64, the stacked trunk's shape
            config["base_net_kwargs"]["vit_kwargs"].update(
                encoder_dtype=encoder_dtype,
                pretrained_encoder_name="dinov2-test-wide")

    jmodel, _, model, _, _, _ = build_pair(change)
    jax_dino, port_dino = dino_encoders
    jcb = JaxCallback(
        jmodel, text_encode,
        {"fixture": JaxVisualizer(trajectories, text_processor=JaxTokenizer(
            "t5-base", _tokenizer_kwargs()))},
        n_trajs=N_TRAJS, use_initial_image=conditioned, dino_encode=jax_dino)
    cb = VisualizationCallback(
        model, text_encode,
        {"fixture": Visualizer(trajectories, text_processor=HFTokenizer(
            "t5-base", _tokenizer_kwargs()))},
        n_trajs=N_TRAJS, use_initial_image=conditioned, dino_encode=port_dino)
    return jcb, cb, jmodel.params, model.params


@pytest.mark.parametrize("conditioned,encoder_dtype", [
    (False, "float32"), (True, "float32"), (False, "bfloat16")],
    ids=["False", "True", "bf16"])
def test_visualization_metrics_match_jax(conditioned, encoder_dtype,
                                         dino_encoders):
    trajectories = _trajectories(True)
    jcb, cb, jparams, params = _callbacks(conditioned, encoder_dtype,
                                          trajectories, dino_encoders)
    ref = jcb(jparams, step=3)
    got = cb(params, step=3)
    assert set(got) == set(ref)
    assert "visualizer/fixture/mse" in got and len(got) > 20
    if encoder_dtype == "bfloat16":
        # the policies' actions on one trajectory, then every metric
        viz = next(iter(cb.visualizers.values()))
        jviz = next(iter(jcb.visualizers.values()))
        want = jax_run_policy(jcb._policy_fn(jparams, 3), trajectories[0],
                              text_processor=jviz.text_processor)
        actions = run_policy_on_trajectory(
            cb._policy_fn(params, 3), trajectories[0],
            text_processor=viz.text_processor)["pred_actions"]
        want = want["pred_actions"]
        assert np.isfinite(actions).all()
        assert (np.abs(actions - want).max()
                < BF16_BOUND * max(np.abs(want).max(), 1.0))
        for key in ref:
            assert (abs(got[key] - ref[key])
                    < BF16_BOUND * max(abs(ref[key]), 1.0)), key
        return
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                   err_msg=key)
    if conditioned:
        # the pipeline's layout: the initial frame beside the task, which
        # neither callback reads
        for name, callback, p in (("jax", jcb, jparams),
                                  ("port", cb, params)):
            viz = next(iter(callback.visualizers.values()))
            viz._cached.clear()
            viz.dataset = _trajectories(False)
            with pytest.raises(TypeError):
                callback(p, step=3)


def _fixture(root):
    import io

    from PIL import Image

    rng = np.random.RandomState(0)
    data = os.path.join(root, "fixture_train")
    os.makedirs(data)
    for ep in range(2):
        frames = []
        for _ in range(6):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (224, 224, 3)).astype(
                np.uint8)).save(buf, format="JPEG")
            frames.append(buf.getvalue())
        NpzTrajectorySource.write_trajectory(
            os.path.join(data, f"ep_{ep:03d}.npz"),
            {"observation": {"image": np.array(frames, dtype=object)},
             "action": rng.randn(6, 7).astype(np.float32),
             "language_instruction": np.array([b"close top drawer"] * 6,
                                              dtype=object)})


class _Recorder:
    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def test_trainer_logs_the_visualizer_metrics(tmp_path, monkeypatch):
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    _fixture(str(tmp_path))
    config = tiny_test_config(hypernet_kwargs={"use_initial_image": False})
    config["dataset_kwargs"] = {
        "batch_size": 4, "shuffle_buffer_size": 8,
        "text_tokenizer": "t5-base", "tokenizer_max_length": 8,
        "resize_size": {"primary": (224, 224)},
        "dataset_kwargs_list": [dict(
            name="fixture_train", data_dir=str(tmp_path),
            image_obs_keys={"primary": "image"},
            language_key="language_instruction",
            action_proprio_normalization_type="normal")],
    }
    config.update(num_steps=2, log_interval=1, viz_datasets=["fixture_train"],
                  viz_interval=2, viz_num_trajs=2, seed=3)
    log = _Recorder()
    state = within(600, trainer.train, config, wandb_run=log, device="cpu")
    assert state.step == 2
    assert not any(k.startswith("visualizer/") for k in log.logs[1])
    viz = {k: v for k, v in log.logs[2].items()
           if k.startswith("visualizer/fixture_train/")}
    for key in ("mse", "mse_xyz", "gripper_correct", "xyz_angle", "moving"):
        assert f"visualizer/fixture_train/{key}" in viz
    assert all(np.isfinite(v) for v in viz.values())
    assert "timer/visualize" in log.logs[2]
