"""The port's hypervla_tpu_torch/entry.py against __graft_entry__.py on the
CPU, fp32: the closed-loop step `fn` of `entry()` (the hypernetwork's
weights from the task and the initial state, then the generated base
net's action chunk) on the same example args and the same weights (the
JAX model's params, converted), actions to 1e-5:

  * the tiny twin, both packages' build_flagship pointed at it, on two
    seeds of make_flagship_batch;
  * the real entry() of both packages at full width (the flagship, fp32
    trunk), whose example args are also held leaf for leaf to the JAX
    ones: names, shapes and dtypes.

Also: entry() refuses to fall back to the CPU without a card, and
dryrun_multichip is parallel/dryrun.py's.
"""
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import hypervla_tpu.flagship as jflagship
import hypervla_tpu_torch.flagship as flagship
from hypervla_tpu_torch import entry as tentry
from hypervla_tpu_torch.parallel import dryrun
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

#: the port's fp32 bar on the actions
ACTION_TOL = 1e-5
#: the tiny twin's example batch (hypervla_tpu/flagship.py::build_flagship)
TINY_BATCH = dict(instr_len=8, action_horizon=2, initial_patch_dim=32)


def _converted(jparams):
    return from_jax_params(jax.device_get(jparams))


def _actions_of_both(jfn, jargs, fn, args):
    """(JAX actions, the port's) of each package's fn on its own example
    args, the port's fn over the JAX params converted. The JAX fn runs
    jitted (__graft_entry__.py's fn is written to be jitted)."""
    ref = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(_converted(jargs[0]), *args[1:])
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    return ref, got.numpy()


@pytest.fixture(scope="module")
def full_width():
    """Both packages' entry() at full width: (JAX fn, JAX args, the port's
    fn, the port's args). The port's build (its draws, one torch thread)
    runs in a thread beside the JAX one; both come first in the file, as
    the JAX tiny twin's build after them takes two thirds of its time
    alone."""
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(tentry.entry, device="cpu")
        jfn, jargs = jentry.entry()
        fn, args = port.result()
    return jfn, jargs, fn, args


def test_full_width_fn_matches_jax(full_width):
    ref, got = _actions_of_both(*full_width)
    assert got.shape == ref.shape == (1, 4, 7)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=ACTION_TOL, atol=ACTION_TOL)


@pytest.fixture(scope="module")
def tiny_models():
    jmodel, _ = jflagship.build_flagship(tiny=True)
    model, _ = flagship.build_flagship(tiny=True, device="cpu")
    return jmodel, model


@pytest.mark.parametrize("seed", [0, 7])
def test_tiny_twin_fn_matches_jax(tiny_models, seed, monkeypatch):
    jmodel, model = tiny_models
    monkeypatch.setattr(jflagship, "build_flagship", lambda: (
        jmodel, jflagship.make_flagship_batch(seed=seed, **TINY_BATCH)))
    monkeypatch.setattr(flagship, "build_flagship", lambda device=None: (
        model, flagship.make_flagship_batch(seed=seed, **TINY_BATCH)))
    ref, got = _actions_of_both(*jentry.entry(), *tentry.entry(device="cpu"))
    assert got.shape == ref.shape == (1, TINY_BATCH["action_horizon"], 7)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=ACTION_TOL, atol=ACTION_TOL)


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def test_example_args_are_the_jax_ones_leaf_for_leaf(full_width):
    _, jargs, _, args = full_width
    assert len(args) == len(jargs) == 6
    params, jparams = args[0], _converted(jargs[0])
    assert set(params) == set(jparams)
    for name, value in jparams.items():
        assert params[name].shape == value.shape, name
        assert params[name].dtype == value.dtype, name
    for i in (1, 2, 3, 4):  # tasks, initial_state, images, timestep_pad_mask
        ref = flatten_tree(jargs[i]) if isinstance(jargs[i], dict) else {
            "": jargs[i]}
        got = flatten_tree(args[i]) if isinstance(args[i], dict) else {
            "": args[i]}
        assert set(got) == set(ref), i
        for name, value in ref.items():
            value = np.asarray(value)
            assert isinstance(got[name], torch.Tensor), (i, name)
            assert tuple(got[name].shape) == value.shape, (i, name)
            assert got[name].dtype == _torch_dtype(value.dtype), (i, name)
            assert got[name].device.type == "cpu"
    rng = args[5]
    assert isinstance(rng, torch.Generator) and rng.device.type == "cpu"
    assert rng.initial_seed() == 0


def test_entry_refuses_the_cpu_without_a_card(monkeypatch):
    def build(*args, **kwargs):
        raise AssertionError("entry() built a model without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(flagship, "build_flagship", build)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_multichip_is_the_dryrun_modules():
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_builds_the_flagship_with_no_arguments(monkeypatch):
    """entry() asks build_flagship for the flagship's defaults (full
    width, the fp32 trunk, attention capture on), as the JAX entry()."""
    calls = []

    def build(*args, **kwargs):
        calls.append((args, kwargs))
        stub = types.SimpleNamespace(params={}, plan=None, hypernet=None,
                                     base_net=None)
        return stub, flagship.make_flagship_batch(**TINY_BATCH)

    monkeypatch.setattr(flagship, "build_flagship", build)
    tentry.entry(device="cpu")
    assert calls == [((), {"device": torch.device("cpu")})]
