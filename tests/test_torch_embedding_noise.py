"""The policy ViT's side of the training draws on the tiny DINOv2 twin,
the JAX draws replayed in the port (tests/test_torch_dropout.py::
check_rate): the ViT's dropout_rate alone at 0.1, and
image_embedding_noise alone at 0.1 (hypervla_tpu/models/base_vit.py:
168-172: noise * N(0, 1) on the trunk's embeddings in training, drawn
from the embedding_noise key split from each sample's dropout key), added
per sample after the port's batched trunk. With the layer-kernel trunk
the noise stays refused, as in the JAX package
(tests/test_torch_train_layer_kernel.py::
test_layer_kernel_needs_the_hoisted_trunk)."""
import pytest

from test_torch_dropout import BATCH, _all_rates, check_rate
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import build_pair


@pytest.fixture(scope="module")
def all_rates():
    return build_pair(_all_rates, batch_size=BATCH)


@pytest.mark.parametrize("key", ["dropout_rate (policy ViT)",
                                 "image_embedding_noise"])
def test_each_rate_matches_jax(all_rates, key):
    check_rate(all_rates, key)
