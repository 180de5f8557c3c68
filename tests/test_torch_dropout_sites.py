"""Each dropout rate of the hypernetwork alone at 0.1 on the tiny DINOv2
twin, the JAX draws replayed in the port
(tests/test_torch_dropout.py::check_rate): image_dropout,
embedding_dropout_rate, final_dropout_rate, and the context encoder's
dropout_rate and attention_dropout_rate."""
import pytest

from test_torch_dropout import BATCH, _all_rates, check_rate
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import build_pair

KEYS = ("image_dropout", "embedding_dropout_rate", "final_dropout_rate",
        "dropout_rate (context encoder)", "attention_dropout_rate")


@pytest.fixture(scope="module")
def all_rates():
    return build_pair(_all_rates, batch_size=BATCH)


@pytest.mark.parametrize("key", KEYS)
def test_each_rate_matches_jax(all_rates, key):
    check_rate(all_rates, key)
