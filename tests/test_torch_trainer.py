"""The port's trainer (hypervla_tpu_torch/train/trainer.py, callbacks.py,
main.py) as a whole, against the JAX package's trainer on the CPU.

Both trainers read one fixture written here (npz trajectories of 224x224
JPEG frames, one of the two instructions a drawer task, so per-task losses
are logged) with the tiny DINOv2 configs: the port's tiny_test_config() and
the JAX tiny_test_config(encoder_type="DINOv2"). They start from the same
weights: the JAX trainer, run for 0 steps with save_param_EMA, writes step
0 with its EMA pickle; tools/convert_checkpoint_to_torch.py converts it; both
warm-start from it. The frozen T5 and DINOv2 are the JAX trainer's PRNGKey(0)
init, handed to the port as `$HYPERVLA_PRETRAINED_DIR/<name>.pt`. Both
pipelines tokenize with FallbackTokenizer, in this one process.

Then three steps each: training_loss and the task_loss_* entries agree per
step to 1e-5 relative, the final params as tests/test_torch_train_step.py
holds one step (updates at cosine > 0.999). Adam turns the rounding of a
gradient near zero into a whole step of either sign, so the cosine leaves
out the elements whose reference gradient is rounding noise, and a param
may differ between the trainers by ~2e-4 where its update's cosine holds,
and the EMA by 1e-3 of that; the EMA is held to what follows from the
params: the port's stored EMA is the JAX step's formula over the port's
own param trajectory bit for bit (the JAX one over its own to an ulp), and
its move from the warm start agrees with the JAX EMA's move by the params'
rule. Also: resume from state/latest.pt bit for bit, the
trained checkpoint serving a finite action, the command line and device
augmentation (the mesh, the profile window and the command line under
ranks: tests/test_torch_parallel_step.py). Every call passes
the CPU: the port's default is the card; every call that waits on the
pipeline's worker process runs under a deadline
(tests/test_torch_harness.py::within)."""
import copy
import io
import itertools
import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.data.sources import NpzTrajectorySource
from hypervla_tpu.train import trainer as jtrainer
from hypervla_tpu_torch.configs import FROZEN_KEYS_BY_MODE, tiny_test_config
from hypervla_tpu_torch.eval.model_loading import (
    build_text_encoder,
    load_hypervla_policy,
)
from hypervla_tpu_torch.models.hypervla import EMA_FILE, PARAMS_FILE
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train import trainer
from hypervla_tpu_torch.train.callbacks import STATE_FILE, SaveCallback
from hypervla_tpu_torch.train.main import apply_overrides, load_config, main
from hypervla_tpu_torch.train.train_step import (
    augment_generator,
    augment_specs,
    device_augment,
)
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_data_pipeline import assert_tree_equal
from test_torch_harness import within
from tools.convert_checkpoint_to_torch import convert
from test_torch_harness import torch_threads  # noqa: F401

STEPS = 3
#: seconds a call that waits on the pipeline's worker process may take
DEADLINE = 600
INSTRUCTIONS = [b"close top drawer", b"pick up the block"]
CHAIN = dict(
    augment_order=["random_resized_crop", "random_brightness",
                   "random_contrast", "random_saturation", "random_hue"],
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1], random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1], random_hue=[0.05])


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


class Recorder:
    """A stand-in for a wandb run: the logged dicts by step."""

    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def _dataset_kwargs(root):
    return {
        "batch_size": 8,  # the JAX mesh has 8 CPU devices
        "shuffle_buffer_size": 16,
        "text_tokenizer": "t5-base",
        "tokenizer_max_length": 8,
        "resize_size": {"primary": (224, 224)},
        "dataset_kwargs_list": [dict(
            name="fixture_train", data_dir=root,
            image_obs_keys={"primary": "image"},
            language_key="language_instruction",
            action_proprio_normalization_type="normal",
            add_initial_image=True)],
    }


def _settings(config, root):
    config["dataset_kwargs"] = _dataset_kwargs(root)
    config["optimizer"]["learning_rate"] = {
        "name": "rsqrt", "init_value": 0.0, "peak_value": 3e-4,
        "warmup_steps": 1, "timescale": 10000}
    config.update(log_interval=1, save_interval=1000, save_param_EMA=True,
                  EMA_start_step=0, seed=7)
    return config


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fixture, the frozen encoders' weights and the step-0 checkpoint
    in both formats. The JAX trainer's frozen encoders are built once for
    the file (a deterministic PRNGKey(0) init) and handed to each of its
    runs."""
    with pytest.MonkeyPatch.context() as mp:
        encoders = jtrainer.build_frozen_encoders(
            _settings(jax_tiny_config(encoder_type="DINOv2"), ""))
        mp.setattr(jtrainer, "build_frozen_encoders",
                   lambda config: encoders)
        yield _setup(tmp_path_factory, encoders)


def _setup(tmp_path_factory, encoders):
    root = tmp_path_factory.mktemp("trainer")
    data = str(root / "data")
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(data, "fixture_train"))
    for ep in range(4):
        n = 8
        NpzTrajectorySource.write_trajectory(
            os.path.join(data, "fixture_train", f"ep_{ep:03d}.npz"),
            {"observation": {"image": np.array(
                [_jpeg(rng.randint(0, 255, (224, 224, 3)).astype(np.uint8))
                 for _ in range(n)], dtype=object)},
             "action": rng.randn(n, 7).astype(np.float32),
             "language_instruction": np.array([INSTRUCTIONS[ep % 2]] * n,
                                              dtype=object)})
    jconfig = _settings(jax_tiny_config(encoder_type="DINOv2"), data)
    _, _, t5, dino = encoders
    pretrained = root / "pretrained"
    os.makedirs(pretrained)
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, t5)),
               pretrained / "t5-base.pt")
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, dino)),
               pretrained / "dinov2-test.pt")
    jdir, tdir = str(root / "jax_init"), str(root / "torch_init")
    jtrainer.train(copy.deepcopy(jconfig), save_dir=jdir, num_steps=0)
    assert convert(jdir, tdir, step=0) == [0]
    return dict(root=root, data=data, jconfig=jconfig, jdir=jdir, tdir=tdir,
                pretrained=str(pretrained))


@pytest.fixture
def pretrained_dir(setup, monkeypatch):
    monkeypatch.setenv("HYPERVLA_PRETRAINED_DIR", setup["pretrained"])


def _port_config(setup, **changes):
    config = _settings(tiny_test_config(), setup["data"])
    config.update(pretrained_checkpoint_path=setup["tdir"],
                  pretrained_checkpoint_step=0)
    config.update(changes)
    return config


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if n == 0 and np.allclose(a, b) else float(a @ b / n)


#: a reference gradient element below this share of its leaf's median
#: first moment is rounding noise, which Adam steps either way (_update_ok)
NOISE = 1e-3


def _recording_steps(monkeypatch, module, record):
    """Patches module.make_train_step (the trainer's) to record
    record(new state) after each step; returns the list they go to."""
    trajectory = []
    make = module.make_train_step

    def recording(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def step(*a, **kw):
            state, info = step_fn(*a, **kw)
            trajectory.append(record(state))
            return state, info

        return step

    monkeypatch.setattr(module, "make_train_step", recording)
    return trajectory


def _adam_mu(opt_state):
    """The JAX trainer's Adam first moments by leaf name, in fp32."""
    out = {}
    for node in jax.tree_util.tree_leaves(
            opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(node, optax.ScaleByAdamState):
            for path, v in jax.tree_util.tree_flatten_with_path(node.mu)[0]:
                out["/".join(str(p.key) for p in path)] = np.asarray(
                    v, np.float32)
    return out


def _noise(name, mus):
    """The elements of leaf `name` whose reference first moment is rounding
    noise at some step: below NOISE of the leaf's median nonzero moment
    there (a leaf with no gradient yet, as the context encoder's before the
    zero-init output head has moved, has no such step)."""
    noise = np.zeros(mus[0][name].shape, bool)
    for mu in mus:
        m = np.abs(mu[name])
        if m.any():
            noise |= m < NOISE * np.median(m[m > 0])
    return noise


def _update_ok(name, got_u, ref_u, typical, noise):
    """The per-leaf rule for a move from the warm start: the key bias's
    exact gradient is 0 (softmax ignores a uniform key shift), so both
    steps move it by rounding noise, which Adam's normalisation scales up,
    and the port's must stay as small; a leaf the JAX trainer barely moves
    the port must barely move; any other at cosine > 0.999 over its
    elements whose reference gradient is not noise. Adam steps an element
    by lr * m / sqrt(v) whatever the gradient's size, so the sign of a
    gradient within rounding of 0 decides a whole step (the context
    encoder's leaves take one step of +-lr each: one such element in 512
    costs their cosine 0.002); those elements may step either way, by no
    more than twice the leaf's largest reference move."""
    if "key/bias" in name or "key_bias" in name:
        return max(np.linalg.norm(got_u), np.linalg.norm(ref_u)) < (
            0.1 * typical)
    if np.linalg.norm(ref_u) < 1e-3 * typical:
        return np.linalg.norm(got_u) < 1e-2 * typical
    keep = ~noise
    return (_cosine(got_u[keep], ref_u[keep]) > 0.999
            and np.abs(got_u[noise]).max(initial=0.0)
            <= 2.0 * np.abs(ref_u).max())


def test_trainer_matches_jax(setup, pretrained_dir, tmp_path, monkeypatch):
    """Three steps of each trainer from the same warm start: per-step
    losses and per-task losses to 1e-5 relative, the final params' updates
    at cosine > 0.999 (rounding-noise gradients aside, _update_ok), each
    stored EMA the formula over its own trainer's param trajectory (the
    port's bit for bit) and the EMAs' moves from the warm start by the
    params' rule."""
    jconfig = copy.deepcopy(setup["jconfig"])
    jconfig.update(pretrained_checkpoint_path=setup["jdir"],
                   pretrained_checkpoint_step=0)
    jlog, log = Recorder(), Recorder()
    jtrajectory = _recording_steps(
        monkeypatch, jtrainer,
        lambda s: ({k: np.asarray(v) for k, v in flatten_tree(
            jax.device_get(s.params)).items()},
            _adam_mu(jax.device_get(s.opt_state))))
    jstate = jtrainer.train(jconfig, num_steps=STEPS, wandb_run=jlog)
    save_dir = str(tmp_path / "run")
    trajectory = _recording_steps(
        monkeypatch, trainer,
        lambda s: ({k: v.detach().numpy().copy()
                    for k, v in s.params.items()}, None))
    config = _port_config(setup)
    state = within(DEADLINE, trainer.train, config, save_dir=save_dir,
                   num_steps=STEPS, wandb_run=log, device="cpu")
    assert len(trajectory) == len(jtrajectory) == STEPS
    assert state.step == STEPS and set(log.logs) == set(range(1, STEPS + 1))
    for step in range(1, STEPS + 1):
        got, ref = log.logs[step], jlog.logs[step]
        keys = ["training_loss"] + [k for k in ref if k.startswith("task_")]
        assert "task_loss_close top drawer" in keys
        assert set(k for k in got if k.startswith("task_")) == set(keys[1:])
        for key in keys:
            np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
        assert got["task_loss_close middle drawer"] == 0.0
        assert {"timer/dataset", "timer/train", "timer/total"} <= set(got)

    init = torch.load(os.path.join(setup["tdir"], "0", EMA_FILE),
                      weights_only=True)["EMA_0.999"]
    ref_params = flatten_tree(jax.device_get(jstate.params))
    ref_ema = flatten_tree(jax.device_get(jstate.ema_params))
    assert set(state.params) == set(ref_params)
    typical = np.median([np.linalg.norm(np.asarray(ref_params[k])
                                        - init[k].numpy())
                         for k in ref_params])
    decay = config["EMA_decay"]
    mus = [mu for _, mu in jtrajectory]
    bad = []
    for name, ref in ref_params.items():
        old = init[name].numpy()
        noise = _noise(name, mus)
        got_u = state.params[name].detach().numpy() - old
        ref_u = np.asarray(ref) - old
        if not _update_ok(name, got_u, ref_u, typical, noise):
            bad.append(("params", name, _cosine(got_u, ref_u),
                        int(noise.sum()), np.linalg.norm(got_u),
                        np.linalg.norm(ref_u)))
        replays, moves = [], []
        for steps in (trajectory, jtrajectory):
            # the JAX step's ema_decay * e + (1 - ema_decay) * p
            # (EMA_start_step 0) over the trainer's own params in fp32, and
            # the same sum's move from the warm start in float64 (an fp32
            # EMA of a ~0.05 weight resolves its 1e-3-scaled move only to a
            # few percent)
            replay = old
            for params, _ in steps:
                replay = decay * replay + (1.0 - decay) * params[name]
            replays.append(replay)
            moves.append(sum(
                (1.0 - decay) * decay ** (STEPS - 1 - i)
                * (params[name].astype(np.float64) - old)
                for i, (params, _) in enumerate(steps)))
        np.testing.assert_array_equal(state.ema_params[name].numpy(),
                                      replays[0], err_msg=name)
        # the JAX step's to its rounding (XLA fuses the formula): an ulp
        # of the value a step, and 1e-6 of the leaf's move where the sum
        # cancels to near 0
        ref_ema_f64 = np.asarray(ref_ema[name]).astype(np.float64)
        bound = (STEPS * np.spacing(np.maximum(np.abs(old),
                                               np.abs(replays[1])))
                 + 1e-6 * np.abs(replays[1].astype(np.float64) - old).max())
        assert (np.abs(ref_ema_f64 - replays[1]) <= bound).all(), name
        if not _update_ok(name, *moves, (1.0 - decay) * typical, noise):
            bad.append(("EMA", name, _cosine(*moves), int(noise.sum()),
                        np.linalg.norm(moves[0]), np.linalg.norm(moves[1])))
    assert not bad, (typical, bad)

    # the trained checkpoint, as a user serves it
    for name in (PARAMS_FILE, EMA_FILE):
        assert os.path.exists(os.path.join(save_dir, str(STEPS), name))
    policy = load_hypervla_policy(save_dir, image_size=224, crop=False,
                                  device="cpu")
    encode = build_text_encoder(policy.model, device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (224, 224, 3),
                                              dtype=np.uint8)
    _, dino_apply, _, dino_params = trainer.build_frozen_encoders(
        policy.model.config, device="cpu")
    with torch.no_grad():
        patches = dino_apply(dino_params, torch.tensor(frame)[None])
    policy.reset("close top drawer", encode("close top drawer"),
                 {"patch_embeddings": patches.numpy()})
    _, action, *_ = policy.step(frame)
    assert action.shape == (7,) and np.isfinite(action).all()


def _assert_tree_equal(got, want, path=""):
    """Nested dicts of tensors and ints, equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(
            got.detach(), want.detach()), path
    else:
        assert got == want, path


def _assert_state_equal(got, want):
    """Step, seed, params, EMA and the whole optimizer state (moments,
    counts, and an accumulation's running mean and counters), bit for
    bit."""
    assert got.step == want.step and got.seed == want.seed
    _assert_tree_equal(got.params, want.params, "params")
    _assert_tree_equal(got.ema_params, want.ema_params, "ema")
    _assert_tree_equal(got.opt_state, want.opt_state, "opt_state")


def test_save_and_resume_bit_for_bit(setup, pretrained_dir, tmp_path):
    """A run of 1 step, then one of 2 from the same save_dir: the second
    resumes at 1 and ends at 2; the state read back from state/latest.pt
    is the saved one bit for bit."""
    save_dir = str(tmp_path / "resume")
    config = _port_config(setup, save_interval=1, eval_datasets=[
        "fixture_train"], eval_interval=1)
    log = Recorder()
    first = within(DEADLINE, trainer.train, copy.deepcopy(config),
                   save_dir=save_dir, num_steps=1, wandb_run=log,
                   device="cpu")
    mse = log.logs[1]["validation/fixture_train/mse"]
    assert np.isfinite(mse) and mse > 0
    assert os.path.exists(os.path.join(save_dir, "state", STATE_FILE))
    blank = copy.deepcopy(first)
    blank.step = 0
    restored, step = SaveCallback(save_dir).restore(blank)
    assert step == 1
    _assert_state_equal(restored, first)
    assert all(p.requires_grad for p in restored.params.values())
    second = within(DEADLINE, trainer.train, copy.deepcopy(config),
                    save_dir=save_dir, num_steps=2, device="cpu")
    assert second.step == 2 and second.opt_state["count"] == 2
    _assert_state_equal(SaveCallback(save_dir).restore(blank)[0], second)


def _first_states(monkeypatch):
    """Patches the trainer's make_train_step to keep the state each run's
    first step is given; returns the list they go to."""
    firsts = []
    make = trainer.make_train_step

    def keeping(*args, **kwargs):
        step_fn = make(*args, **kwargs)
        calls = []

        def step(state, *a, **kw):
            if not calls:
                firsts.append(copy.deepcopy(state))
            calls.append(1)
            return step_fn(state, *a, **kw)

        return step

    monkeypatch.setattr(trainer, "make_train_step", keeping)
    return firsts


def _tiny_overrides(setup):
    """The tiny model and the fixture data as command-line overrides of
    whole fields of a full-size config."""
    tiny = tiny_test_config()
    return [f"--config.{key}={tiny[key]!r}"
            for key in ("base_net_kwargs", "hypernet_kwargs")] + [
        f"--config.dataset_kwargs={_dataset_kwargs(setup['data'])!r}"]


def test_finetune_command_line(setup, pretrained_dir, tmp_path,
                               monkeypatch):
    """The JAX package's fine-tune config through the command line,
    head_only with gradient accumulation over 2 steps, warm-started from a
    checkpoint of the port's own trainer: the frozen params stay the warm
    start's bit for bit, the trainable ones hold still at step 1 and move
    at step 2; a run resumed from the save at step 3, in the middle of an
    accumulation, starts from that state bit for bit (the running mean
    and its counters included)."""
    pretrained = str(tmp_path / "pretrained_run")
    within(DEADLINE, trainer.train, _port_config(setup), save_dir=pretrained,
           num_steps=1, device="cpu")
    warm = torch.load(os.path.join(pretrained, "1", EMA_FILE),
                      weights_only=True)["EMA_0.999"]
    save_dir = str(tmp_path / "finetune")

    def argv(steps):
        return ["--config",
                "scripts/configs/finetune_config.py:vit_t,fixture,head_only",
                "--save_dir", save_dir, "--cpu",
                f"--config.pretrained_checkpoint_path={pretrained!r}",
                "--config.pretrained_checkpoint_step=1",
                "--config.optimizer.grad_accumulation_steps=2",
                # the LR at its peak from the first applied update
                "--config.optimizer.learning_rate.warmup_steps=0",
                f"--config.num_steps={steps}", "--config.save_interval=1",
                "--config.log_interval=1", *_tiny_overrides(setup)]

    firsts = _first_states(monkeypatch)
    state = within(DEADLINE, main, argv(3))
    assert state.step == 3 and state.opt_state["mini_step"] == 1
    frozen = topt.frozen_names(warm, FROZEN_KEYS_BY_MODE["head_only"])
    assert frozen and set(warm) - frozen
    assert set(state.opt_state["inner"]["mu"]) == set(warm) - frozen
    _assert_tree_equal(firsts[0].params, warm, "warm start")
    by_step = {step: torch.load(os.path.join(save_dir, str(step),
                                             PARAMS_FILE),
                                weights_only=True) for step in (1, 2, 3)}
    for name, value in warm.items():
        assert torch.equal(state.params[name].detach(), value) == (
            name in frozen), name
        assert torch.equal(by_step[1][name], value), name
        assert torch.equal(by_step[2][name], value) == (name in frozen), name
        assert torch.equal(by_step[3][name], by_step[2][name]), name

    # resume from the save at step 3, mid-accumulation
    blank = copy.deepcopy(state)
    blank.step = 0
    restored, step = SaveCallback(save_dir).restore(blank)
    assert step == 3
    _assert_state_equal(restored, state)
    resumed = within(DEADLINE, main, argv(4))
    _assert_state_equal(firsts[1], state)
    assert resumed.step == 4 and resumed.opt_state["mini_step"] == 0
    assert resumed.opt_state["inner"]["count"] == 2


def test_packed_run_resumes_bit_for_bit(setup, pretrained_dir, tmp_path,
                                        monkeypatch):
    """optimizer.packed=True in the trainer: state/latest.pt holds the
    packed optimizer state ({group: flat moments}), and a run resumed from
    it starts from the saved state bit for bit."""
    save_dir = str(tmp_path / "packed")
    config = _port_config(setup, save_interval=1)
    config["optimizer"]["packed"] = True
    firsts = _first_states(monkeypatch)
    first = within(DEADLINE, trainer.train, copy.deepcopy(config),
                   save_dir=save_dir, num_steps=1, device="cpu")
    assert all(k.startswith("(") and v["mu"].dim() == 1
               for k, v in first.opt_state.items())
    blank = copy.deepcopy(first)
    blank.step = 0
    _assert_state_equal(SaveCallback(save_dir).restore(blank)[0], first)
    second = within(DEADLINE, trainer.train, copy.deepcopy(config),
                    save_dir=save_dir, num_steps=2, device="cpu")
    _assert_state_equal(firsts[1], first)
    assert second.step == 2 and all(v["count"] == 2
                                    for v in second.opt_state.values())


def test_command_line_runs_a_config_file(setup, pretrained_dir, tmp_path):
    """`main` on a config file whose get_config returns a dict, with
    overrides of existing fields; the built-in string is the port's copy of
    scripts/configs/hypervla_pretrain_config.py."""
    config = _port_config(setup)
    path = tmp_path / "config.py"
    path.write_text(f"def get_config(s):\n    return {config!r}\n")
    save_dir = str(tmp_path / "cli")
    state = within(DEADLINE, main, [
        "--config", f"{path}:x", "--save_dir", save_dir, "--cpu",
        "--config.num_steps=1", "--config.seed=3"])
    assert state.step == 1 and state.seed == 3
    assert os.path.exists(os.path.join(save_dir, "1", PARAMS_FILE))

    fast = load_config("vit_t,oxe,fast")
    assert fast["dataset_kwargs"]["oxe_mix"] == "oxe_magic_soup"
    assert fast["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] == (
        "bfloat16") and fast["frozen_encoder_layer_kernel"]
    for name in ("hypervla_pretrain_config",
                 "scripts/configs/hypervla_pretrain_config.py"):
        assert load_config(f"{name}:vit_t,oxe,fast") == fast
    with pytest.raises(ValueError, match="neither a .py file"):
        load_config("no_such_config:vit_t,oxe")
    apply_overrides(fast, ["--config.dataset_kwargs.data_dir=/data/oxe",
                           "--config.dataset_kwargs.batch_size=64"])
    assert fast["dataset_kwargs"]["data_dir"] == "/data/oxe"
    assert fast["dataset_kwargs"]["batch_size"] == 64
    with pytest.raises(KeyError, match="no such field"):
        apply_overrides(fast, ["--config.dataset_kwargs.no_field=1"])


def test_device_augment_runs_and_repeats(setup, pretrained_dir):
    """device_augment: the host only resizes, the step augments each
    camera's frames from a generator of (seed, step): not the identity, the
    same under the same seed and step, different at another step; a step
    of the trainer runs with it."""
    config = _port_config(setup)
    config["dataset_kwargs"].update(device_augment=True,
                                    image_augment_kwargs=CHAIN)
    specs = augment_specs(config)
    assert specs == {"primary": CHAIN}
    frames = torch.randint(0, 256, (4, 1, 224, 224, 3), dtype=torch.uint8)

    def augmented(step):
        batch = {"observation": {"image_primary": frames.clone()}}
        device_augment(batch, specs, augment_generator(7, step, "cpu"))
        return batch["observation"]["image_primary"]

    a = augmented(5)
    assert a.shape == frames.shape and a.dtype == torch.uint8
    assert not torch.equal(a, frames)
    assert torch.equal(a, augmented(5)) and not torch.equal(a, augmented(6))
    log = Recorder()
    state = within(DEADLINE, trainer.train, config, num_steps=1,
                   wandb_run=log, device="cpu")
    assert state.step == 1 and np.isfinite(log.logs[1]["training_loss"])


def test_train_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is that card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        within(DEADLINE, trainer.train, _port_config(setup), num_steps=1)


def test_jax_step0_checkpoint_is_the_warm_start(setup):
    """The converted step-0 EMA is the JAX pickle, bit for bit."""
    with open(os.path.join(setup["jdir"], "0", "EMA_params.pkl"), "rb") as f:
        ref = from_jax_params(pickle.load(f)["EMA_0.999"])
    got = torch.load(os.path.join(setup["tdir"], "0", EMA_FILE),
                     weights_only=True)["EMA_0.999"]
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_pipeline_process_matches_in_thread(setup):
    """train()'s pipeline in a worker process gives the batches and the
    statistics of the same pipeline run here; close() stops the worker."""
    config = _port_config(setup)
    ref = trainer.make_train_datasets(copy.deepcopy(config))
    pipeline = within(DEADLINE, trainer.PipelineProcess,
                      copy.deepcopy(config))
    try:
        assert_tree_equal(pipeline.dataset_statistics,
                          ref.dataset_statistics)
        batches = within(DEADLINE, lambda: list(itertools.islice(pipeline,
                                                                 3)))
        for got, want in zip(batches, itertools.islice(ref, 3)):
            assert_tree_equal(got, want)
    finally:
        within(DEADLINE, pipeline.close)
    assert not pipeline._proc.is_alive()


def test_pipeline_process_closes_while_the_worker_sends(setup):
    """close() as the worker sends the batches after the ones taken (the
    trainer closes its pipeline so after every run): whatever the worker
    was writing, close() returns and the worker has ended. A worker that
    ended mid-message used to leave close() waiting on the pipe for the
    rest of it."""
    config = _port_config(setup)
    for taken in (0, 1, 3):
        pipeline = within(DEADLINE, trainer.PipelineProcess,
                          copy.deepcopy(config))
        within(DEADLINE, lambda: list(itertools.islice(pipeline, taken)))
        within(DEADLINE, pipeline.close)
        assert not pipeline._proc.is_alive()


def test_pipeline_process_fails_a_silent_worker(setup, monkeypatch):
    """A worker that sends nothing for BATCH_TIMEOUT seconds fails the
    wait with a RuntimeError instead of holding the trainer."""
    monkeypatch.setattr(trainer, "_pipeline_worker", _silent_worker)
    monkeypatch.setattr(trainer, "BATCH_TIMEOUT", 2.0)
    with pytest.raises(RuntimeError, match="sent nothing in 2.0"):
        within(DEADLINE, trainer.PipelineProcess, _port_config(setup))


def _silent_worker(*args):
    """A pipeline worker that sends nothing until it is told to stop (its
    last argument is the stop event)."""
    args[-1].wait(600)


def test_pipeline_process_reports_worker_errors(setup, tmp_path):
    config = _port_config(setup)
    config["dataset_kwargs"]["dataset_kwargs_list"][0]["data_dir"] = str(
        tmp_path / "missing")
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        within(DEADLINE, trainer.PipelineProcess, config)
