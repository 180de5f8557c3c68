"""init_strategy VARIANCE_INIT (hypervla_tpu/models/weight_plan.py:34,
247-256; hypernetwork.py:123; hypervla.py:217-218) against the JAX package
on the tiny DINOv2 twin ("block" generation, one context token per block)
on the CPU: the plan's heads (strategy, fan-in variance) as the JAX
plan's, one step from the JAX package's initial params as
tests/test_torch_hypernet_options.py::check_pair holds it, and the port's
own init: a VARIANCE_INIT head's kernel drawn at its standard deviation
and its bias left at zero, a BIAS_INIT head's bias the fresh base net."""
import numpy as np
import pytest

from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.models.weight_plan import BIAS_INIT, VARIANCE_INIT
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_hypernet_options import BATCH, check_pair
from test_torch_jax_draws import PAIR_BATCH, build_pair


def _variance(config):
    config["hypernet_kwargs"].update(init_strategy=VARIANCE_INIT,
                                     share_layer_index=False)


@pytest.fixture(scope="module")
def pair():
    return build_pair(_variance, batch_size=BATCH)


def test_variance_init_matches_jax(pair):
    model = check_pair(pair)
    strategies = {i["init_strategy"]
                  for i in model.plan.output_head_info.values()}
    assert strategies == {BIAS_INIT, VARIANCE_INIT}


def test_port_init_draws_each_head_at_its_variance():
    config = tiny_test_config()
    _variance(config)
    model = HyperVLA.from_config(config, make_flagship_batch(**PAIR_BATCH),
                                 seed=3, device="cpu")
    plan = model.plan
    checked = 0
    for head, info in plan.output_head_info.items():
        if not info["generation_flag"]:
            continue
        kernel = model.params[f"output_head_{head}/kernel"].numpy()
        bias = model.params[f"output_head_{head}/bias"].numpy()
        if info["init_strategy"] == VARIANCE_INIT and info["init_variance"]:
            std = info["init_variance"] ** 0.5
            # flax's truncated_normal(std): within 2 std, of std 0.88 std
            assert np.abs(kernel).max() <= 2 * std * (1 + 1e-6), head
            if kernel.size >= 1000:
                np.testing.assert_allclose(kernel.std(), 0.8796 * std,
                                           rtol=0.1, err_msg=head)
                checked += 1
            assert not bias.any(), head
        else:
            assert not kernel.any(), head
    assert checked
