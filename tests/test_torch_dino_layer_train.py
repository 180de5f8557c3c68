"""The port's no-residual DINOv2 layer forward
(hypervla_tpu_torch/ops/dino_layer_train.py: CPU tensors take the plain
PyTorch version) against the JAX package's Pallas `dino_layer_train` in
interpret mode (its backward: tests/test_torch_dino_layer_train_bwd.py), and the frozen-encoder route through it (the port's
`dinov2_forward(layer_kernel=True)`) against JAX's
DINOv2Model(layers_impl="pallas_train") on dinov2-test-wide."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import dinov2 as jd
from hypervla_tpu.ops.dino_layer_train import dino_layer_train as jax_layer
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.ops import dino_layer_train as tdl
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

HIDDEN, HEADS, MLP = 128, 2, 512


def _operands(batch, seq, seed=0):
    rng = np.random.default_rng(seed)

    def w(shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    x = (rng.standard_normal((batch, seq, HIDDEN)) * 0.5).astype(np.float32)
    weights = [w((HIDDEN, HIDDEN)) for _ in range(4)] + [
        w((HIDDEN, MLP)), w((MLP, HIDDEN))]
    pv = np.concatenate([
        0.02 * rng.standard_normal((5, HIDDEN)),
        1 + 0.1 * rng.standard_normal((1, HIDDEN)),
        0.1 * rng.standard_normal((1, HIDDEN)),
        1 + 0.1 * rng.standard_normal((1, HIDDEN)),
        0.1 * rng.standard_normal((1, HIDDEN)),
        0.5 + 0.1 * rng.standard_normal((2, HIDDEN)),
    ]).astype(np.float32)
    b1 = (0.02 * rng.standard_normal((1, MLP))).astype(np.float32)
    return x, weights, pv, b1


@pytest.mark.parametrize("batch,seq", [(4, 17), (3, 33)])
def test_layer_forward_matches_pallas(batch, seq):
    x, weights, pv, b1 = _operands(batch, seq)
    bf = jnp.bfloat16
    ref = jax_layer(jnp.asarray(x, bf), *(jnp.asarray(w, bf) for w in weights),
                    jnp.asarray(pv), jnp.asarray(b1), HEADS, 1e-6)
    tb = torch.bfloat16
    got = tdl.dino_layer_train(
        torch.tensor(x).to(tb), *(torch.tensor(w).to(tb) for w in weights),
        torch.tensor(pv), torch.tensor(b1), HEADS, 1e-6)
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    scale = np.abs(ref).max()
    assert np.isfinite(got).all() and got.shape == (batch, seq, HIDDEN)
    # the bound tests/test_dino_layer_train.py holds the kernel to
    assert np.abs(got - ref).max() < 0.03 * max(scale, 1.0), (
        np.abs(got - ref).max(), scale)


def test_layer_refuses_gradients():
    """With no gradient asked for (no operand requires one, or under
    no_grad) the layer records no graph: it runs the no-residual forward
    and saves nothing. Asked for one, it returns the same values with a
    graph, and the gradients reach every operand in its own dtype."""
    x, weights, pv, b1 = _operands(2, 5)
    tb = torch.bfloat16

    def args(requires_grad):
        leaves = [torch.tensor(x).to(tb),
                  *(torch.tensor(w).to(tb) for w in weights),
                  torch.tensor(pv), torch.tensor(b1)]
        return [t.requires_grad_(requires_grad) for t in leaves]

    plain = tdl.dino_layer_train(*args(False), HEADS, 1e-6)
    assert plain.grad_fn is None
    with torch.no_grad():
        frozen = tdl.dino_layer_train(*args(True), HEADS, 1e-6)
    assert frozen.grad_fn is None and torch.equal(frozen, plain)
    leaves = args(True)
    out = tdl.dino_layer_train(*leaves, HEADS, 1e-6)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    out.float().sum().backward()
    for leaf in leaves:
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype
        assert leaf.grad.shape == leaf.shape
        assert torch.isfinite(leaf.grad.float()).all()


def test_frozen_encoder_route_matches_jax():
    """bf16 embeddings, every layer through the no-residual forward, the
    final LayerNorm with its fp32 output: against the JAX package's frozen
    encoder on the same params and pixels."""
    cfg = jd.dinov2_config("dinov2-test-wide")
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    model = jd.DINOv2Model(config=cfg, dtype=jnp.bfloat16,
                           layers_impl="pallas_train")
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(rng.standard_normal(v.shape),
                                        v.dtype) if v.ndim == 1 else v,
        params)
    ref = np.asarray(model.apply({"params": params},
                                 jnp.asarray(pixels)).last_hidden_state)
    tcfg = configs.dinov2_config("dinov2-test-wide")
    with torch.no_grad():
        got = td.dinov2_forward(
            tcfg, td.pack_frozen_layers(tcfg, from_jax_params(params)),
            torch.tensor(pixels), torch.bfloat16, layer_kernel=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() < 0.03 * max(scale, 1.0), (
        np.abs(got.numpy() - ref).max(), scale)
