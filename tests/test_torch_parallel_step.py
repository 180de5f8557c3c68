"""The port's train step on a mesh of gloo ranks (hypervla_tpu_torch/
parallel/) against the JAX package's GSPMD step on the same mesh over the
virtual CPU devices of tests/conftest.py, and against the port's own step
on one process, on the tiny flagship (fp32 trunk) at batch 8 from the
JAX init's params, both optimizers from update count 1000:

  * one step at 2, 4 and 8 ranks, on the JAX dry run's layouts ((fsdp 1,
    tp 1) at 2, (2, 1) at 4, (2, 2) and the dcn_data=2 mesh (2, 1) at 8):
    the loss and grad_norm within rtol 2e-4, atol 1e-5 (the JAX package's
    bound between meshes) of both, the per-task loss of a drawer task whose
    mask differs from rank to rank too, the updated params by
    tests/test_torch_train_step.py's rule (each leaf's move at cosine >
    0.999, a leaf the reference barely moves barely moved), and every
    leaf's shards bit-equal on the ranks that hold the same shard;
  * gradient accumulation (k = 2) on the (2, 2) mesh: no param moves at
    the first step, the accumulated update lands at the second; packed
    AdamW bit-equal to the per-leaf AdamW there;
  * the draws: dropout at every site, the trunk's embedding noise and the
    device augmentation at 4 ranks give the one-process step (each draw
    made at the global batch's shape and sliced to the rank's rows);
  * the SmallStem HyperVLA at 2 ranks against the port on one process and
    the JAX step on one device (the JAX step's SmallStem loss depends on
    its mesh: ROADMAP.md queue C);
  * a checkpoint saved at 2 ranks (fsdp 2) restores bit-equal at 1 rank
    and at 4 ranks (fsdp 2, tp 2), and the step after it gives the same
    loss on each;
  * the trainer's check that the ranks' pipelines agree refuses ranks
    whose first batches differ.

The ranks are one group of 8 spawned processes (parallel/dryrun.py::
mesh_steps, a job a mesh over the first N ranks), run while this process
computes the references.
"""
import concurrent.futures
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import make_example_batch
from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.parallel import mesh as jmesh
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu.train.train_state import TrainState as JaxTrainState
from hypervla_tpu.train.train_step import make_train_step as jax_make_step
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.models.hypervla import _unflatten
from hypervla_tpu_torch.parallel.dryrun import (
    build_state,
    run_ranks,
    to_numpy,
)
from hypervla_tpu_torch.train.callbacks import SaveCallback
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import within
from test_torch_smallstem_slice import (
    SIZE,
    jax_config,
    perturbed_kernels,
    port_config,
)
from test_torch_train_step import _with_count
from test_torch_harness import torch_threads  # noqa: F401
from torch_rank_targets import steps_and_agreement

STEP0 = 1000
BATCH = dict(batch_size=8, instr_len=8, action_horizon=2,
             initial_patch_dim=32)
#: a drawer task's mask over the global batch: 3, 1 / 2, 1, 0, 1 rows a rank
TASKS = {"close top drawer": np.array([1, 1, 1, 0, 0, 0, 0, 1], np.float32)}
#: name -> the mesh over the first N ranks
LAYOUTS = {"n2": dict(devices=[0, 1]),
           "n4": dict(devices=[0, 1, 2, 3], fsdp=2),
           "n8": dict(fsdp=2, tp=2),
           "n8_dcn": dict(fsdp=2, dcn_data=2)}
BOUND = dict(rtol=2e-4, atol=1e-5)
#: seconds the group of ranks may take
DEADLINE = 900
#: leaves whose exact gradient is 0 (tests/test_torch_smallstem_train_step)
DEGENERATE = re.compile(r"key[/_]bias|StdConv_\d[/_]bias")
DRAWS = dict(rate=0.1, augment=dict(
    augment_order=["random_resized_crop", "random_brightness"],
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1]))


def _with_draws(config):
    """Dropout at every site, the trunk's embedding noise and the device
    augmentation on."""
    r = DRAWS["rate"]
    hk = config["hypernet_kwargs"]
    hk.update(image_dropout=r, embedding_dropout_rate=r, final_dropout_rate=r)
    hk["context_encoder_kwargs"].update(dropout_rate=r,
                                        attention_dropout_rate=r)
    config["base_net_kwargs"]["vit_kwargs"].update(dropout_rate=r,
                                                   image_embedding_noise=r)
    config["dataset_kwargs"].update(device_augment=True,
                                    image_augment_kwargs=DRAWS["augment"])
    return config


def _jax_mesh(layout):
    n = len(layout.get("devices", range(8)))
    return jmesh.create_mesh(jax.devices()[:n], fsdp=layout.get("fsdp", 1),
                             tp=layout.get("tp", 1),
                             dcn_data=layout.get("dcn_data"))


def _jax_step(jmodel, config, batch, mesh, task_index=None):
    """One JAX step on `mesh` from update count STEP0, the state laid out
    as the JAX trainer lays it out; (new params, info)."""
    tx, lr_fn, base_lr_fn, pnorm_fn = jopt.create_optimizer(
        jmodel.params, jopt.hn_param_type_tree(jmodel.params),
        **config["optimizer"])
    step_fn = jax_make_step(jmodel, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                            mesh=mesh, donate=False)
    state = JaxTrainState.create(jax.random.PRNGKey(0), jmodel.params, tx,
                                 track_ema=True)
    state = state.replace(step=jnp.asarray(STEP0),
                          opt_state=_with_count(state.opt_state, STEP0))
    if mesh.shape["fsdp"] > 1 or "model" in mesh.shape:
        state = jax.tree_util.tree_map(jax.device_put, state,
                                       jmesh.fsdp_sharding(mesh, state))
    else:
        state = jax.device_put(state, jmesh.replicated(mesh))
    new, info = step_fn(state, jmesh.shard_batch(copy.deepcopy(batch), mesh),
                        None if task_index is None
                        else jmesh.shard_batch(task_index, mesh))
    return (flatten_tree(jax.device_get(new.params)),
            {k: float(v) for k, v in info.items()})


def _port_one(job, steps=None):
    """The job's steps on one process: (infos, [whole state before and
    after each step])."""
    _, _, make_step, state = build_state(job)
    step_fn = make_step()
    states = [to_numpy(state.params)]
    infos = []
    for _ in range(steps or job.get("steps", 1)):
        state, info = step_fn(state, job["batch"], job.get("task_index"))
        infos.append({k: float(v) for k, v in info.items()})
        states.append(to_numpy(state.params))
    return infos, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's per-rank results, the one-process references and the
    JAX references."""
    jmodel, _ = jax_build(tiny=True, training=True)
    jconfig = copy.deepcopy(jmodel.config)
    jconfig["EMA_start_step"] = 0
    jmodel = jmodel.replace(config=jconfig)
    model, example = build_flagship(tiny=True, training=True,
                                    encoder_dtype=None, device="cpu")
    config = copy.deepcopy(model.config)
    config["EMA_start_step"] = 0
    base = dict(config=config, example_batch=example,
                params=to_numpy(from_jax_params(jmodel.params)),
                batch=make_flagship_batch(**BATCH), task_index=TASKS,
                step0=STEP0, steps=1)
    accumulating = copy.deepcopy(config)
    accumulating["optimizer"]["grad_accumulation_steps"] = 2
    packed = copy.deepcopy(config)
    packed["optimizer"]["packed"] = True

    # the SmallStem twin (full generation, continuous head) at 64 px
    ss_batch = make_example_batch(batch_size=8, image_size=SIZE)
    ss_jconfig = jax_config("full", "continuous")
    ss_jconfig["EMA_start_step"] = 0
    ss_jmodel = JaxHyperVLA.from_config(ss_jconfig, ss_batch,
                                        jax.random.PRNGKey(0))
    ss_flat = perturbed_kernels(flatten_tree(jax.tree_util.tree_map(
        np.asarray, ss_jmodel.params)))
    ss_jmodel = ss_jmodel.replace(params=_unflatten(ss_flat))
    ss_config = port_config("full", "continuous")
    ss_config["EMA_start_step"] = 0

    ckpt = str(tmp_path_factory.mktemp("parallel_ckpt"))
    jobs = {name: dict(base, mesh=layout) for name, layout in LAYOUTS.items()}
    jobs.update(
        accumulate=dict(base, config=accumulating, mesh=LAYOUTS["n8"],
                        steps=2, keep=True),
        packed=dict(base, config=packed, mesh=LAYOUTS["n8"]),
        draws=dict(base, config=_with_draws(copy.deepcopy(config)),
                   mesh=LAYOUTS["n4"]),
        smallstem=dict(
            config=ss_config, example_batch=make_example_batch(
                batch_size=1, image_size=SIZE),
            params=to_numpy(from_jax_params(ss_jmodel.params)),
            batch=ss_batch, step0=STEP0, steps=1, mesh=LAYOUTS["n2"]),
        save=dict(base, mesh=dict(devices=[0, 1], fsdp=2), steps=2,
                  keep=True, save_dir=ckpt, save_after=1),
        restore=dict(base, mesh=dict(devices=[0, 1, 2, 3], fsdp=2, tp=2),
                     restore_dir=ckpt, keep=True),
    )
    names = list(jobs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(run_ranks, 8, steps_and_agreement,
                              [jobs[n] for n in names], timeout=DEADLINE)
        ref = {"one": _port_one(base),
               "accumulate": _port_one(jobs["accumulate"]),
               "draws": _port_one(jobs["draws"]),
               "draws_off": _port_one(dict(base, task_index=None)),
               "smallstem": _port_one(jobs["smallstem"]),
               "jax": {name: _jax_step(jmodel, jconfig, jax_batch(**BATCH),
                                       _jax_mesh(layout), TASKS)
                       for name, layout in LAYOUTS.items()},
               "jax_smallstem": {
                   n: _jax_step(ss_jmodel, ss_jconfig, ss_batch,
                                jmesh.create_mesh(jax.devices()[:n]))[1]
                   for n in (1, 2)}}
        results = within(DEADLINE, pending.result)
    ranks = {name: [r[0][i] for r in results if r[0][i] is not None]
             for i, name in enumerate(names)}
    return dict(ranks=ranks, ref=ref, base=base, ckpt=ckpt,
                refused=[r[1] for r in results])


def _rule(name, got, ref, typical):
    """tests/test_torch_train_step.py's per-leaf rule for a move."""
    if DEGENERATE.search(name):
        return max(np.linalg.norm(got), np.linalg.norm(ref)) < 0.1 * typical
    if np.linalg.norm(ref) < 1e-3 * typical:
        return np.linalg.norm(got) < 1e-2 * typical
    a, b = got.ravel().astype(np.float64), ref.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.999


def _assert_moves(got, ref, start):
    moves = {n: (got[n] - start[n], np.asarray(ref[n]) - start[n])
             for n in start}
    typical = np.median([np.linalg.norm(r) for _, r in moves.values()])
    bad = [n for n, (g, r) in moves.items() if not _rule(n, g, r, typical)]
    assert not bad, bad


def _assert_shards_agree(per_rank):
    """Ranks that hold the same shard of a leaf hold it bit for bit."""
    specs = per_rank[0]["specs"]
    for name in per_rank[0]["shards"]:
        axes = [a for a in (specs[name] if specs else ()) if a]
        groups = {}
        for r in per_rank:
            key = tuple(r["coords"][a] for a in axes)
            groups.setdefault(key, []).append(r["shards"][name])
        for shards in groups.values():
            for s in shards[1:]:
                np.testing.assert_array_equal(s, shards[0], err_msg=name)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_matches_jax_and_one_rank(runs, name):
    per_rank = runs["ranks"][name]
    n = len(LAYOUTS[name].get("devices", range(8)))
    assert len(per_rank) == n
    infos = [r["infos"][0] for r in per_rank]
    assert all(i == infos[0] for i in infos), "ranks disagree on the info"
    info = infos[0]
    ref_params, ref_info = runs["ref"]["jax"][name]
    one_info = runs["ref"]["one"][0][0]
    for key in ("training_loss", "grad_norm"):
        np.testing.assert_allclose(info[key], ref_info[key], **BOUND,
                                   err_msg=f"{key} against JAX")
        np.testing.assert_allclose(info[key], one_info[key], **BOUND,
                                   err_msg=f"{key} against one rank")
    for key in ("update_norm", "param_norm", "continuous_loss",
                "gripper_loss", "base_params_norm", "learning_rate"):
        np.testing.assert_allclose(info[key], one_info[key], rtol=1e-4,
                                   err_msg=key)
    start = runs["base"]["params"]
    got = per_rank[0]["states"][-1]["params"]
    _assert_moves(got, ref_params, start)
    _assert_moves(got, runs["ref"]["one"][1][-1], start)
    _assert_shards_agree(per_rank)
    for r in per_rank[1:]:
        for leaf, value in r["states"][-1]["params"].items():
            np.testing.assert_array_equal(value, got[leaf], err_msg=leaf)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_task_losses_are_global(runs, name):
    """The drawer task's loss is a global sum over a global count: its
    rows lie unevenly over the ranks (none at all on some at 4 and 8)."""
    key = "task_loss_close top drawer"
    info = runs["ranks"][name][0]["infos"][0]
    np.testing.assert_allclose(info[key], runs["ref"]["jax"][name][1][key],
                               **BOUND)
    np.testing.assert_allclose(info[key], runs["ref"]["one"][0][0][key],
                               **BOUND)
    row_groups = {"n2": 2, "n4": 4, "n8": 4, "n8_dcn": 8}[name]
    per_group = TASKS["close top drawer"].reshape(row_groups, -1).sum(1)
    assert len(set(per_group.tolist())) > 1


def test_grad_accumulation_applies_every_second_step(runs):
    per_rank = runs["ranks"]["accumulate"]
    states = per_rank[0]["states"]
    infos, one = runs["ref"]["accumulate"]
    for leaf, value in states[0]["params"].items():
        np.testing.assert_array_equal(states[1]["params"][leaf], value,
                                      err_msg=leaf)
    changed = sum(not np.array_equal(states[2]["params"][k], v)
                  for k, v in states[1]["params"].items())
    assert changed > 0, "the accumulated update never landed"
    for got, ref in zip(per_rank[0]["infos"], infos):
        np.testing.assert_allclose(got["training_loss"],
                                   ref["training_loss"], **BOUND)
    _assert_moves(states[2]["params"], one[2], one[0])
    _assert_shards_agree(per_rank)


def test_packed_adamw_is_the_per_leaf_one_on_a_mesh(runs):
    """Each rank packs its own shards of a group's leaves: the packed
    update is the per-leaf one bit for bit on the (2, 2) mesh, as on one
    process."""
    packed = runs["ranks"]["packed"]
    per_leaf = runs["ranks"]["n8"]
    for got, want in zip(packed, per_leaf):
        assert got["coords"] == want["coords"]
        for leaf, value in want["shards"].items():
            np.testing.assert_array_equal(got["shards"][leaf], value,
                                          err_msg=leaf)


def test_draws_are_the_one_process_draws(runs):
    per_rank = runs["ranks"]["draws"]
    infos, one = runs["ref"]["draws"]
    loss = per_rank[0]["infos"][0]["training_loss"]
    np.testing.assert_allclose(loss, infos[0]["training_loss"], **BOUND)
    # the draws move the loss far beyond the bound: they were made
    off = runs["ref"]["draws_off"][0][0]["training_loss"]
    assert abs(loss - off) > 100 * (BOUND["atol"] + BOUND["rtol"] * abs(off))
    _assert_moves(per_rank[0]["states"][-1]["params"], one[1], one[0])
    _assert_shards_agree(per_rank)


def test_smallstem_step_at_two_ranks(runs):
    per_rank = runs["ranks"]["smallstem"]
    loss = per_rank[0]["infos"][0]["training_loss"]
    infos, one = runs["ref"]["smallstem"]
    np.testing.assert_allclose(loss, infos[0]["training_loss"], **BOUND)
    jax_losses = {n: i["training_loss"]
                  for n, i in runs["ref"]["jax_smallstem"].items()}
    np.testing.assert_allclose(loss, jax_losses[1], **BOUND)
    print(f"SmallStem loss: port at 2 ranks {loss!r}, JAX on 1 device "
          f"{jax_losses[1]!r}, on 2 devices {jax_losses[2]!r}")
    _assert_moves(per_rank[0]["states"][-1]["params"], one[1], one[0])


def test_checkpoint_restores_at_any_rank_count(runs):
    """Saved after a step at 2 ranks (fsdp 2): restored at 1 rank and at 4
    (fsdp 2, tp 2) bit for bit (params, EMA, optimizer state), and the next
    step gives each the 2 ranks' loss."""
    saved = runs["ranks"]["save"][0]["states"][1]
    _, _, make_step, fresh = build_state(runs["base"])
    restored, step = SaveCallback(runs["ckpt"]).restore(fresh)
    assert step == STEP0 + 1
    one = {"params": to_numpy(restored.params),
           "ema": to_numpy(restored.ema_params),
           "opt_state": to_numpy(restored.opt_state)}
    four = runs["ranks"]["restore"][0]["states"][0]
    for whole in (one, four):
        for part in ("params", "ema"):
            for leaf, value in saved[part].items():
                np.testing.assert_array_equal(whole[part][leaf], value,
                                              err_msg=f"{part} {leaf}")
        assert whole["opt_state"]["count"] == saved["opt_state"]["count"]
        for moment in ("mu", "nu"):
            for leaf, value in saved["opt_state"][moment].items():
                np.testing.assert_array_equal(
                    whole["opt_state"][moment][leaf], value, err_msg=leaf)
    _, info = make_step()(restored, runs["base"]["batch"], TASKS)
    two_loss = runs["ranks"]["save"][0]["infos"][1]["training_loss"]
    four_loss = runs["ranks"]["restore"][0]["infos"][0]["training_loss"]
    np.testing.assert_allclose(float(info["training_loss"]), two_loss,
                               **BOUND)
    np.testing.assert_allclose(four_loss, two_loss, **BOUND)


def test_ranks_with_different_batches_are_refused(runs):
    """Every rank's pipeline yields the global batch and keeps its rows:
    ranks whose first batches differ (a tokenizer that hashes words, under
    different hash seeds) are refused on every rank rather than trained."""
    assert len(runs["refused"]) == 8
    assert all("different global batches" in m for m in runs["refused"])
