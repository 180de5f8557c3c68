"""The port's OctoModel and OctoInference against the JAX package's on the
CPU, fp32, on one tiny Octo model (a one-layer 16-wide transformer, an
ImageTokenizer over a two-stage SmallStem16 with the goal image stacked,
the diffusion head; 64-px frames), its params the JAX init perturbed and
carried across by utils/convert.py::from_jax_params, with the JAX draws
replayed, each to 1e-5: run_transformer, sample_actions (NORMAL and
BOUNDS, under the statistics' mask, a sample_shape), create_tasks, a
checkpoint round trip in the port's format, an hf:// snapshot in the local
HuggingFace cache, a JAX save_pretrained directory through
tools/convert_checkpoint_to_torch.py, six OctoInference steps and the
widowx gripper, the JAX default image_size failing a 64-px model in both
packages, and the port's copy of the Octo pretraining config.
"""
import copy

import flax
import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.eval.octo_inference import OctoInference as JaxInference
from hypervla_tpu.models.octo_model import OctoModel as JaxOcto
from hypervla_tpu.utils.spec import ModuleSpec as JaxSpec
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.data.data_utils import NormalizationType
from hypervla_tpu_torch.data.text_processing import FallbackTokenizer
from hypervla_tpu_torch.eval.octo_inference import OctoInference
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.octo_model import OctoModel
from hypervla_tpu_torch.utils.convert import (
    from_jax_params,
    port_module_specs,
)
from test_torch_harness import torch_threads  # noqa: F401
from tools.convert_checkpoint_to_torch import convert

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON, DIM = 2, 7
FLAT = HORIZON * DIM
STEPS = 20
STATS = {
    "mean": np.arange(DIM, dtype=np.float32) / 10,
    "std": 1 + np.arange(DIM, dtype=np.float32) / 7,
    "p01": -1 - np.arange(DIM, dtype=np.float32) / 10,
    "p99": 1 + np.arange(DIM, dtype=np.float32) / 5,
    "mask": np.array([True] * 6 + [False]),
}
EMBED = np.random.default_rng(9).standard_normal((32000, 12)).astype(
    np.float32)


class TextProcessor:
    def __init__(self):
        self.tok = FallbackTokenizer()

    def encode(self, strings):
        return self.tok(strings, max_length=6)


def text_embed(ids, mask):
    return EMBED[np.asarray(ids)] * np.asarray(mask)[..., None]


def octo_config():
    encoder = JaxSpec.create(
        "hypervla_tpu.models.vit_encoders:SmallStem16", features=(32, 32),
        kernel_sizes=(3, 3), strides=(8, 2), padding=(1, 1),
        num_features=16)
    return {
        "model": {
            "observation_tokenizers": {"primary": JaxSpec.create(
                "hypervla_tpu.models.tokenizers:ImageTokenizer",
                obs_stack_keys=["image_primary"],
                task_stack_keys=["image_primary"], encoder=encoder)},
            "heads": {"action": JaxSpec.create(
                "hypervla_tpu.models.action_heads:DiffusionActionHead",
                readout_key="readout_action", use_map=False,
                action_horizon=HORIZON, action_dim=DIM,
                n_diffusion_samples=1, time_dim=8, num_blocks=1,
                hidden_dim=16)},
            "readouts": {"action": 1},
            "token_embedding_size": 16,
            "transformer_kwargs": dict(
                num_layers=1, mlp_dim=32, num_attention_heads=2,
                dropout_rate=0.0, attention_dropout_rate=0.0,
                add_position_embedding=False, learnable_norm=True),
            "max_horizon": 4,
            "repeat_task_tokens": True,
            "use_correct_attention": True,
        },
        "text_processor": None,
    }


def example_batch(batch=1, window=HORIZON, seed=0, size=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 100, (batch, 6)).astype(np.int32)
    mask = np.ones((batch, 6), np.int32)
    return {
        "observation": {
            "image_primary": rng.integers(0, 256, (batch, window, size, size,
                                                   3), dtype=np.uint8),
            "timestep_pad_mask": np.ones((batch, window), bool),
        },
        "task": {
            "image_primary": rng.integers(0, 256, (batch, size, size, 3),
                                          dtype=np.uint8),
            "language_instruction": {
                "input_ids": ids, "attention_mask": mask,
                "token_embedding": text_embed(ids, mask)},
            "pad_mask_dict": {"language_instruction": np.ones(batch, bool),
                              "image_primary": np.ones(batch, bool)},
        },
    }


def sampler_draws(rng, shape, steps=STEPS):
    rng, key = jax.random.split(rng)
    out = {"action_head/x_T": np.asarray(jax.random.normal(key, shape))}
    for t in range(steps - 1, -1, -1):
        rng, key = jax.random.split(rng)
        out[f"action_head/z/{t}"] = np.asarray(jax.random.normal(key, shape))
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) on the same (perturbed) params."""
    config = octo_config()
    jmodel = JaxOcto.from_config(config, example_batch(),
                                 text_processor=TextProcessor(),
                                 text_embed_fn=text_embed)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(np.shape(v)) * 0.05)
        .astype(np.float32), flax.core.unfreeze(jmodel.params))
    stats = {"fractal20220817_data": {"action": STATS},
             "bridge_dataset": {"action": STATS}}
    jmodel = jmodel.replace(params=params,
                            dataset_statistics=static_dict(stats))
    model = OctoModel.from_config(port_module_specs(copy.deepcopy(config)),
                                  example_batch(),
                                  text_processor=TextProcessor(),
                                  text_embed_fn=text_embed,
                                  dataset_statistics=stats, device="cpu")
    ported = from_jax_params(params)
    assert set(ported) == set(model.params)
    for name, value in model.params.items():
        assert ported[name].shape == value.shape, name
    model.params = ported
    return jmodel, model


def _padded_batch():
    batch = example_batch(batch=2, seed=1)
    batch["observation"]["timestep_pad_mask"][0, 0] = False
    batch["task"]["pad_mask_dict"]["image_primary"][1] = False
    return batch


def test_run_transformer_matches_jax(pair):
    jmodel, model = pair
    batch = _padded_batch()
    args = (batch["observation"], batch["task"],
            batch["observation"]["timestep_pad_mask"])
    want, got = jmodel.run_transformer(*args), model.run_transformer(*args)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].tokens.numpy(),
                                   np.asarray(want[name].tokens), **TOL,
                                   err_msg=name)
        np.testing.assert_array_equal(got[name].mask.numpy(),
                                      np.asarray(want[name].mask))


@pytest.mark.parametrize("norm", ["normal", "bounds", None])
def test_sample_actions_matches_jax(pair, norm):
    """The JAX sample_actions is jitted with normalization_type not
    static, so it takes only its default (NORMAL); BOUNDS is held to its
    formula over the JAX model's raw actions."""
    jmodel, model = pair
    batch = _padded_batch()
    key = jax.random.PRNGKey(4)
    args = (batch["observation"], batch["task"])
    stats = {"unnormalization_statistics": STATS}
    want = np.asarray(jmodel.sample_actions(
        *args, rng=key, sample_shape=(2,),
        **(stats if norm == "normal" else {})))
    if norm == "bounds":
        mask = STATS["mask"]
        want = np.where(mask, (want + 1) * (STATS["p99"] - STATS["p01"]) / 2
                        + STATS["p01"], want)
    kwargs = {} if norm is None else dict(
        stats, normalization_type=NormalizationType(norm))
    got = model.sample_actions(
        *args, sample_shape=(2,),
        rng=Draws(replay=sampler_draws(key, (2, 2, HORIZON, FLAT))),
        **kwargs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_create_tasks_matches_jax(pair):
    jmodel, model = pair
    goals = {"image_primary": example_batch(seed=3)["task"]["image_primary"]}
    for kwargs in ({"texts": ["pick up the fork", "open the drawer"]},
                   {"goals": goals},
                   {"goals": goals, "texts": ["pick up the fork"]}):
        want, got = jmodel.create_tasks(**kwargs), model.create_tasks(**kwargs)
        flat_want = flax.traverse_util.flatten_dict(want)
        flat_got = flax.traverse_util.flatten_dict(got)
        assert set(flat_got) == set(flat_want)
        for k, v in flat_want.items():
            np.testing.assert_array_equal(np.asarray(flat_got[k]),
                                          np.asarray(v), err_msg=str(k))


def _check_same(model, loaded, batch):
    assert set(loaded.params) == set(model.params)
    for name, value in model.params.items():
        assert torch.equal(loaded.params[name], value), name
    draws = sampler_draws(jax.random.PRNGKey(2), (1, HORIZON, FLAT))
    args = (batch["observation"], batch["task"])
    assert torch.equal(
        loaded.sample_actions(*args, rng=Draws(replay=draws)),
        model.sample_actions(*args, rng=Draws(replay=draws)))


def test_checkpoint_round_trip(pair, tmp_path):
    _, model = pair
    path = str(tmp_path / "octo")
    model.save_pretrained(step=3, checkpoint_path=path)
    loaded = OctoModel.load_pretrained(path, device="cpu")
    _check_same(model, loaded, example_batch(seed=5))
    assert loaded.dataset_statistics["bridge_dataset"]["action"][
        "std"].tolist() == STATS["std"].tolist()
    with pytest.raises(ValueError, match="exactly one"):
        model.save_pretrained(step=1)


def test_hf_uri_reads_the_local_cache(pair, tmp_path, monkeypatch):
    _, model = pair
    cache = tmp_path / "hf_cache"
    repo = cache / "models--test-org--tiny-octo"
    snapshot = repo / "snapshots" / "abcdef123456"
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abcdef123456")
    model.save_pretrained(step=1, checkpoint_path=str(snapshot))
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    loaded = OctoModel.load_pretrained("hf://test-org/tiny-octo",
                                       device="cpu")
    _check_same(model, loaded, example_batch(seed=6))
    with pytest.raises(ValueError, match="hub snapshots pin"):
        OctoModel.load_pretrained("hf://test-org/tiny-octo", step=1)
    with pytest.raises(FileNotFoundError, match="not in the local"):
        OctoModel.load_pretrained("hf://test-org/definitely-absent")


def test_a_jax_checkpoint_converts_and_serves_the_same_actions(pair,
                                                               tmp_path):
    jmodel, _ = pair
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel.replace(dataset_statistics=None).save_pretrained(
        step=2, checkpoint_path=src)
    assert convert(src, dst) == [2]
    loaded = OctoModel.load_pretrained(dst, device="cpu")
    assert loaded.config["model"]["heads"]["action"]["module"] == (
        "hypervla_tpu_torch.models.action_heads")
    batch = example_batch(seed=7)
    key = jax.random.PRNGKey(8)
    want = jmodel.sample_actions(batch["observation"], batch["task"],
                                 unnormalization_statistics=STATS, rng=key)
    got = loaded.sample_actions(
        batch["observation"], batch["task"],
        unnormalization_statistics=STATS,
        rng=Draws(replay=sampler_draws(key, (1, HORIZON, FLAT))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tick_draws(jwrapper, width):
    """The sampler draws of the key the JAX wrapper's next step splits
    off, over a history of `width` frames."""
    _, key = jax.random.split(jwrapper.rng)
    return Draws(replay=sampler_draws(key, (1, width, FLAT)))


@pytest.mark.parametrize("setup,steps", [("google_robot", 6),
                                         ("widowx_bridge", 2)])
def test_octo_inference_matches_jax(pair, setup, steps):
    jmodel, model = pair
    kw = dict(policy_setup=setup, horizon=2, pred_action_horizon=HORIZON,
              image_size=64, init_rng=0, action_ensemble=True)
    jwrapper, wrapper = JaxInference(jmodel, **kw), OctoInference(model,
                                                                  **kw)
    for w in (jwrapper, wrapper):
        w.reset("pick up the coke can")
    frames = np.random.default_rng(3).integers(0, 256, (steps, 64, 64, 3),
                                               dtype=np.uint8)
    for i, frame in enumerate(frames):
        draws = _tick_draws(jwrapper, min(i + 1, 2))
        wrapper._split_rng = lambda: draws
        raw_j, act_j = jwrapper.step(frame)
        raw, act = wrapper.step(frame)
        # the sampler's first reverse step multiplies the score network's
        # rounding by 1 / sqrt(alpha_19) = 31.6 (beta_19 = 0.999): each
        # step is held to 1e-5 of its largest action entry
        for got, want in ((raw, raw_j), (act, act_j)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    assert wrapper.num_image_history == jwrapper.num_image_history


def test_init_rng_seeds_the_wrapper(pair):
    _, model = pair
    frames = np.random.default_rng(4).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)

    def serve(init_rng):
        wrapper = OctoInference(model, image_size=64, init_rng=init_rng,
                                pred_action_horizon=HORIZON)
        wrapper.reset("pick up the coke can")
        return [wrapper.step(f)[0] for f in frames]

    first, again, other = serve(1), serve(1), serve(2)
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not all(np.array_equal(a, b) for a, b in zip(first, other))


def test_default_image_size_fails_a_smaller_model_as_in_jax(pair):
    """A model built for 64-px frames served at the JAX default of 256 px
    fails the example batch's shape check in both packages."""
    jmodel, model = pair
    frame = np.zeros((64, 64, 3), np.uint8)
    for cls, m in ((JaxInference, jmodel), (OctoInference, model)):
        wrapper = cls(m, pred_action_horizon=HORIZON)
        assert wrapper.image_size == 256
        wrapper.reset("pick up the coke can")
        with pytest.raises(AssertionError, match="does not match"):
            wrapper.step(frame)


def test_octo_pretrain_config_is_the_jax_one():
    from hypervla_tpu_torch.configs import octo_pretrain_config
    from hypervla_tpu_torch.train.main import load_config
    from scripts.configs.octo_pretrain_config import get_config

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and v:
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = (list(v) if isinstance(v, tuple)
                                       else v)
        return out

    for string in ("vit_s,oxe", "vit_b,fixture"):
        ref = get_config(string).to_dict()
        got = octo_pretrain_config(string)
        assert flat(port_module_specs(ref["model"])) == flat(got["model"])
        ref_flat = flat(ref)
        for key, value in flat(got).items():
            if not key.startswith("model."):
                assert key in ref_flat and ref_flat[key] == value, key
        assert load_config(
            f"scripts/configs/octo_pretrain_config.py:{string}") == got
