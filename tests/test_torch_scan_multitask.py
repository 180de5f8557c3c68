"""The port's K-tick and multi-task serving steps
(hypervla_tpu_torch/ops/serving.py::make_scan_serving_step,
make_multitask_serving_step) against the JAX package's on the CPU, with the
same params (a tiny fp32 DINOv2 model, tests/test_torch_serving.py::_build)
and the same 224x224 frames (no crop, so the resize is the identity and no
uint8 rounding enters): actions and histories to 1e-5. Each is also held
bit for bit against the port's own per-tick step, which it calls; the
multi-task step also on a tiny bf16 model whose image encoder is generated,
so that each task's stacked trunk is its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import serving as jserving
from hypervla_tpu_torch.ops import serving
from test_torch_host_path import TRUNK, build_bf16
from test_torch_serving import STATS, _build
from test_torch_harness import torch_threads  # noqa: F401

K = 4
CALLS = 2
TASKS = 3
STEP = dict(crop=False, ensemble=True, ensemble_temp=0.5)


@pytest.fixture(scope="module")
def fp32():
    jmodel, jbase, model, base, _, tok = _build({}, 32)
    frames = np.random.default_rng(11).integers(
        0, 256, (K * CALLS, 224, 224, 3), dtype=np.uint8)
    return jmodel, jbase, model, base, frames, tok


def test_scan_step_matches_jax(fp32):
    jmodel, jbase, model, base, frames, tok = fp32
    jscan, jinit = jserving.make_scan_serving_step(jmodel, STATS, K, **STEP)
    scan, init = serving.make_scan_serving_step(model, STATS, K, **STEP)
    jhist, hist = jinit(), init()
    for c in range(CALLS):
        chunk = frames[c * K:(c + 1) * K]
        ref, jhist = jscan(jbase, jnp.asarray(chunk), tok, jhist, c * K,
                           jax.random.PRNGKey(0))
        got, hist = scan(base, chunk, hist, c * K)
        assert got.shape == (K, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), atol=1e-5)


def test_scan_step_equals_per_tick_calls(fp32):
    _, _, model, base, frames, _ = fp32
    scan, init = serving.make_scan_serving_step(model, STATS, K, **STEP)
    tick, _ = serving.make_serving_step(model, STATS, **STEP)
    hist, ticked = init(), init()
    for c in range(CALLS):
        got, hist = scan(base, frames[c * K:(c + 1) * K], hist, c * K)
        for i in range(K):
            action, ticked = tick(base, frames[c * K + i], ticked, c * K + i)
            assert torch.equal(got[i], action)
    assert torch.equal(hist, ticked)
    with pytest.raises(ValueError, match="k=4"):
        scan(base, frames[:K - 1], init(), 0)


def _tasks(jmodel, model, tok):
    """TASKS episodes with different instructions: each side's generated
    params and the token embeddings."""
    rng = np.random.default_rng(12)
    init = model.example_batch["initial_state"]
    jparams, params, tokens = [], [], []
    for _ in range(TASKS):
        emb = rng.standard_normal(tok.shape).astype(np.float32)
        instruction = {"language_instruction": {
            "input_ids": np.ones(tok.shape[:2], np.int32),
            "attention_mask": np.ones(tok.shape[:2], np.int32),
            "token_embedding": emb}}
        jparams.append(jmodel.create_tasks(instruction_dict=instruction,
                                           initial_state=init)[0])
        params.append(model.create_tasks(instruction_dict=instruction,
                                         initial_state=init)[0])
        tokens.append(emb)
    return jparams, params, np.concatenate(tokens)


def test_multitask_step_matches_jax_and_single_task(fp32):
    """N = 3 tasks a tick, two ticks: each task's action against the JAX
    multi-task step to 1e-5, and bit for bit against the port's
    single-task step on that task's params."""
    jmodel, _, model, _, frames, tok = fp32
    jparams, params, tokens = _tasks(jmodel, model, tok)
    jmulti, jinit, jstack = jserving.make_multitask_serving_step(
        jmodel, STATS, **STEP)
    multi, init, stack = serving.make_multitask_serving_step(
        model, STATS, **STEP)
    tick, _ = serving.make_serving_step(model, STATS, **STEP)
    stacked = stack(params)
    flags = model.plan.generation_flag
    for name, value in stacked.items():
        want = (TASKS, *params[0][name].shape) if flags[name] else (
            params[0][name].shape)
        assert value.shape == want, name
    jstacked = jstack(jparams)
    rngs = jax.random.split(jax.random.PRNGKey(0), TASKS)
    jhist = jnp.stack([jinit()] * TASKS)
    hist = torch.stack([init()] * TASKS)
    single = [init() for _ in range(TASKS)]
    for t in range(2):
        tick_frames = frames[t * TASKS:(t + 1) * TASKS]
        ref, jhist = jmulti(jstacked, jnp.asarray(tick_frames),
                            jnp.asarray(tokens[:, None]), jhist,
                            jnp.full(TASKS, t, jnp.int32), rngs)
        got, hist = multi(stacked, tick_frames, hist,
                          np.full(TASKS, t))
        assert got.shape == (TASKS, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        for i in range(TASKS):
            action, single[i] = tick(params[i], tick_frames[i], single[i], t)
            assert torch.equal(got[i], action)
            assert torch.equal(hist[i], single[i])
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), atol=1e-5)


def test_multitask_step_serves_each_task_its_generated_trunk():
    """With the image encoder generated (not in shared_modules) each task
    has its own DINOv2 weights: on a bf16 trunk the stacked trunk's
    (w, b, p) carry a task axis, and each task's action equals its
    single-task step bit for bit, never task 0's trunk."""
    model, instruction, init = build_bf16(shared_modules=())
    lang = instruction["language_instruction"]
    rng = np.random.default_rng(13)
    params = []
    for _ in range(TASKS):
        emb = rng.standard_normal(lang["token_embedding"].shape).astype(
            np.float32)
        base, _ = model.create_tasks(
            instruction_dict={"language_instruction": dict(
                lang, token_embedding=emb)}, initial_state=init)
        params.append(serving.prepare_serving_params(model, base))
    assert not torch.equal(params[0][TRUNK + "w"], params[1][TRUNK + "w"])
    multi, init_history, stack = serving.make_multitask_serving_step(
        model, STATS, **STEP)
    tick, _ = serving.make_serving_step(model, STATS, **STEP)
    stacked = stack(params)
    for leaf in "wbp":
        assert stacked[TRUNK + leaf].shape == (
            TASKS, *params[0][TRUNK + leaf].shape)
    frames = np.random.default_rng(14).integers(0, 256, (TASKS, 224, 224, 3),
                                                dtype=np.uint8)
    got, _ = multi(stacked, frames, torch.stack([init_history()] * TASKS),
                   np.zeros(TASKS, int))
    for i in range(TASKS):
        action, _ = tick(params[i], frames[i], init_history(), 0)
        assert torch.equal(got[i], action)
