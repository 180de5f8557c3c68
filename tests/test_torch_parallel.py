"""The port's mesh (hypervla_tpu_torch/parallel/mesh.py) against the JAX
package's (hypervla_tpu/parallel/mesh.py) on the 8 virtual CPU devices of
tests/conftest.py, the counterparts of tests/test_parallel.py:

  * create_mesh's shape and rank layout at (fsdp, tp) in (1, 1), (2, 1),
    (1, 2), (2, 2), (4, 2) and the dcn_data=2 mesh, each against the JAX
    mesh over the same devices, and the JAX AssertionError where n does
    not divide;
  * fsdp_sharding's spec of every leaf of the tiny flagship's TrainState
    against the JAX fsdp_sharding's PartitionSpec of a leaf of its shape
    on the same mesh;
  * shard_batch's rows on every rank, device_prefetch's order and error;
  * dryrun_multichip(4) and (8): gloo ranks in spawned processes, each
    layout's loss pinned to the one-process step, and the fan-out check
    with its negative case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.parallel import mesh as jmesh
from hypervla_tpu_torch.flagship import build_flagship
from hypervla_tpu_torch.parallel import dryrun
from hypervla_tpu_torch.parallel import mesh as tmesh
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from test_torch_harness import within
from test_torch_harness import torch_threads  # noqa: F401

#: (fsdp, tp, dcn_data) of the meshes held to the JAX ones
LAYOUTS = [(1, 1, None), (2, 1, None), (1, 2, None), (2, 2, None),
           (4, 2, None), (2, 1, 2)]
#: seconds a dry run of spawned ranks may take
DEADLINE = 600


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("fsdp,tp,dcn", LAYOUTS)
def test_create_mesh_matches_jax(fsdp, tp, dcn):
    ref = jmesh.create_mesh(jax.devices(), fsdp=fsdp, tp=tp, dcn_data=dcn)
    got = tmesh.create_mesh(range(8), fsdp=fsdp, tp=tp, dcn_data=dcn)
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    np.testing.assert_array_equal(got.devices, _ids(ref))
    assert got.coords == dict.fromkeys(got.axis_names, 0)


def test_create_mesh_refuses_an_indivisible_count():
    with pytest.raises(AssertionError) as ref:
        jmesh.create_mesh(jax.devices()[:6], fsdp=4)
    with pytest.raises(AssertionError) as got:
        tmesh.create_mesh(range(6), fsdp=4)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def state():
    """The port's tiny flagship TrainState (fp32 trunk, EMA tracked)."""
    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    tx, *_ = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **model.config["optimizer"])
    return TrainState.create(model.params, tx, track_ema=True)


@pytest.mark.parametrize("fsdp,tp,dcn", LAYOUTS[1:])
def test_fsdp_sharding_matches_jax(state, fsdp, tp, dcn):
    """Every leaf of the state (params, EMA, both moments) laid out as the
    JAX package's fsdp_sharding lays out a leaf of its shape on the same
    mesh (the JAX twin's leaves have the port's names and shapes,
    tests/test_torch_train_step.py)."""
    ref_mesh = jmesh.create_mesh(jax.devices(), fsdp=fsdp, tp=tp,
                                 dcn_data=dcn)
    mesh = tmesh.create_mesh(range(8), fsdp=fsdp, tp=tp, dcn_data=dcn)
    got = tmesh.fsdp_sharding(mesh, state)
    want = jax.tree_util.tree_map(
        lambda s: tuple(s.spec), jmesh.fsdp_sharding(ref_mesh, {
            k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
            for k, v in state.params.items()}))
    for tree in (got["params"], got["ema_params"], got["opt_state"]["mu"],
                 got["opt_state"]["nu"]):
        assert {k: v.spec for k, v in tree.items()} == want
    assert sum(bool(s) for s in want.values()) > 0
    assert got["step"].spec == ()


def test_fsdp_sharding_rules_of_the_jax_tests():
    """tests/test_parallel.py's rule cases: a divisible leaf on "fsdp", an
    indivisible one and a scalar replicated; under tp the fan-out-shaped
    kernel ("model", "fsdp"), a bias replicated, a square on both."""
    mesh = tmesh.create_mesh(range(8), fsdp=2)
    got = tmesh.fsdp_sharding(mesh, {"big": torch.zeros(16, 4),
                                     "tiny": torch.zeros(3),
                                     "scalar": torch.zeros(())})
    assert got["big"].spec == ("fsdp",)
    assert got["tiny"] == tmesh.replicated(mesh)
    assert got["scalar"].spec == ()
    mesh = tmesh.create_mesh(range(8), fsdp=2, tp=2)
    got = tmesh.fsdp_sharding(mesh, {"fanout_kernel": np.zeros((128, 2016)),
                                     "bias": np.zeros((7,)),
                                     "square": np.zeros((64, 64))})
    assert got["fanout_kernel"].spec == ("model", "fsdp")
    assert got["bias"].spec == ()
    assert set(got["square"].spec) == {"fsdp", "model"}
    mesh = tmesh.create_mesh(range(8), tp=2)
    assert tmesh.fsdp_sharding(mesh, {"k": np.zeros((128, 2016))})[
        "k"].spec == (None, "model")


@pytest.mark.parametrize("fsdp,tp", [(1, 1), (2, 1), (2, 2)])
def test_shard_batch_rows(monkeypatch, fsdp, tp):
    """Each rank's rows: its block along ("data", "fsdp"), the same on the
    ranks of "model"; together every row once."""
    batch = {"x": np.arange(16, dtype=np.float32).reshape(16, 1),
             "nested": {"s": np.array([str(i) for i in range(16)])}}
    seen = {}
    for rank in range(8):
        monkeypatch.setattr(tmesh, "process_index", lambda r=rank: r)
        mesh = tmesh.create_mesh(range(8), fsdp=fsdp, tp=tp)
        rows = tmesh.shard_batch(batch, mesh)
        first, last, total = tmesh.batch_rows(mesh, len(rows["x"]))
        assert total == 16
        np.testing.assert_array_equal(rows["x"][:, 0],
                                      np.arange(first, last))
        assert list(rows["nested"]["s"]) == [str(i)
                                             for i in range(first, last)]
        key = tuple(mesh.coords[a] for a in tmesh.ROW_AXES)
        seen.setdefault(key, rows["x"][:, 0].tolist())
        assert seen[key] == rows["x"][:, 0].tolist()
    assert sorted(sum(seen.values(), [])) == list(range(16))
    assert tmesh.batch_sharding(mesh).spec == (("data", "fsdp"),)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch({"x": np.zeros((3, 1))}, mesh)


def test_device_prefetch_preserves_order_and_errors():
    mesh = tmesh.create_mesh()

    def gen():
        for i in range(5):
            yield {"x": np.full((8, 1), i, np.float32)}

    out = [int(b["x"][0, 0]) for b in tmesh.device_prefetch(gen(), mesh)]
    assert out == [0, 1, 2, 3, 4]

    def bad():
        yield {"x": np.zeros((8, 1), np.float32)}
        raise RuntimeError("source died")

    it = tmesh.device_prefetch(bad(), mesh)
    next(it)
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n, capsys):
    report = within(DEADLINE, dryrun.dryrun_multichip, n)
    assert [r["layout"] for r in report] == dryrun.dryrun_layouts(n)
    out = capsys.readouterr().out
    assert "baseline OK" in out and out.count(f"dryrun_multichip({n})") == \
        len(report)
    if n == 8:
        fanout = report[0]["fanout"]
        assert report[0]["layout"] == {"fsdp": 2, "tp": 2}
        # the largest fan-out kernel: rows on "model", columns on "fsdp";
        # held at a quarter, multiplied at its "model" half, never whole
        rows, cols = fanout["global_shape"]
        assert fanout["local_shape"] == [rows // 2, cols // 2]
        assert fanout["multiplied_shapes"] == [(rows // 2, cols)]
        assert report[1]["layout"] == {"fsdp": 2, "tp": 1, "dcn_data": 2}


def test_fanout_check_detects_a_whole_kernel():
    """check_fanout_partitioned passes a split record and fails where the
    kernel is held or multiplied at its global shape."""
    params = {"output_head_a/kernel": np.zeros((64, 4096), np.float32),
              "b": np.zeros((7,), np.float32)}
    shape = {"data": 2, "fsdp": 2, "model": 2}
    name = "output_head_a/kernel"
    summary = dryrun.check_fanout_partitioned(
        [(name, (32, 4096))], {name: (32, 2048)}, shape, params)
    assert summary["local_shape"] == [32, 2048]
    with pytest.raises(AssertionError, match="full global shape"):
        dryrun.check_fanout_partitioned(
            [(name, (32, 4096)), (name, (64, 4096))], {name: (32, 2048)},
            shape, params)
    with pytest.raises(AssertionError, match="held at"):
        dryrun.check_fanout_partitioned(
            [(name, (32, 4096))], {name: (64, 4096)}, shape, params)
    with pytest.raises(AssertionError, match="did not take effect"):
        dryrun.check_fanout_partitioned([], {name: (32, 2048)}, shape,
                                        params)
    jax_text = "f32[32,2048] dot f32[64,4096] all-reduce f32[32,2048]"
    from hypervla_tpu.parallel.hlo_checks import check_fanout_partitioned

    with pytest.raises(AssertionError, match="full global shape"):
        check_fanout_partitioned(
            jax_text, jmesh.create_mesh(jax.devices(), fsdp=2, tp=2),
            {"fanout_kernel": jnp.zeros((64, 4096), jnp.float32)})
