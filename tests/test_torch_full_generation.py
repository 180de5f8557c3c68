""""full" generation without output-head biases (output_head_bias=False;
hypervla_tpu/models/hypernetwork.py:97-101, hypervla.py:219-226) against
the JAX package on the tiny DINOv2 twin on the CPU: one output head over
every base-net param, no bias, its kernel's rows each a fresh base-net
init in the JAX package's init and in the port's; one step from the JAX
package's initial params as tests/test_torch_hypernet_options.py::
check_pair holds it."""
import numpy as np
import pytest

from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_hypernet_options import BATCH, check_pair
from test_torch_jax_draws import PAIR_BATCH, build_pair


def _full(config):
    # a context width of 2: the JAX init draws one base net per kernel row
    config["hypernet_kwargs"].update(generation_strategy="full",
                                     output_head_bias=False,
                                     context_embedding_dim=2)


@pytest.fixture(scope="module")
def pair():
    return build_pair(_full, batch_size=BATCH)


def test_full_generation_without_bias_matches_jax(pair):
    model = check_pair(pair)
    assert "output_head/bias" not in model.params
    assert model.params["output_head/kernel"].shape == (
        2, model.plan.total_param_num)


def test_port_init_fills_the_kernel_rows_with_fresh_base_nets():
    config = tiny_test_config()
    _full(config)
    model = HyperVLA.from_config(config, make_flagship_batch(**PAIR_BATCH),
                                 seed=1, device="cpu")
    plan = model.plan
    kernel = model.params["output_head/kernel"].numpy()
    offset = 0
    for name in plan.names:
        dim = plan.dim(name)
        rows = kernel[:, offset:offset + dim]
        if name.endswith("LayerNorm_0/scale"):
            assert (rows == 1).all(), name  # an init's unit scales
        if name.endswith("/kernel") and dim >= 64:
            # every row its own draw
            assert len({r.tobytes() for r in rows}) == rows.shape[0], name
        offset += dim
    assert offset == kernel.shape[1]
