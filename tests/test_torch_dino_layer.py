"""The port's stacked DINOv2 serving trunk (hypervla_tpu_torch/ops/
dino_layer.py) against the JAX package's (hypervla_tpu/ops/dino_layer.py),
on the CPU: the stacking exactly, the plain trunk against the XLA scan
trunk at dinov2-base width and against the Pallas kernel in interpret mode
at width 128."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import dino_layer as jdl
from hypervla_tpu_torch.ops import dino_layer as tdl
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401


def _layer_tree(rng, layers, hidden):
    """Per-layer params in the JAX package's encoder/layer layout."""
    def a(*shape, scale=0.02, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    tree = {}
    for i in range(layers):
        dense = lambda fin, fout: {"kernel": a(fin, fout), "bias": a(fout)}
        tree[str(i)] = {
            "attention": {
                "attention": {n: dense(hidden, hidden)
                              for n in ("query", "key", "value")},
                "output": {"dense": dense(hidden, hidden)},
            },
            "mlp": {"fc1": dense(hidden, 4 * hidden),
                    "fc2": dense(4 * hidden, hidden)},
            "norm1": {"scale": a(hidden, scale=0.1, shift=1.0),
                      "bias": a(hidden, scale=0.1)},
            "norm2": {"scale": a(hidden, scale=0.1, shift=1.0),
                      "bias": a(hidden, scale=0.1)},
            "layer_scale1": {"lambda1": a(hidden, shift=0.1)},
            "layer_scale2": {"lambda1": a(hidden, shift=0.1)},
        }
    return tree


def _stacks(layers, hidden, seed=0):
    rng = np.random.default_rng(seed)
    tree = _layer_tree(rng, layers, hidden)
    x = (0.5 * rng.standard_normal((257, hidden))).astype(np.float32)
    jw, jb, jp = jdl.stack_serving_layer_params(tree, layerscale_value=0.5)
    tw, tb, tp = tdl.stack_serving_layer_params(from_jax_params(tree),
                                                layerscale_value=0.5)
    return x, (jw, jb, jp), (tw, tb, tp)


def _to_np(t):
    return t.float().numpy()


def test_stacking_matches_jax_exactly():
    _, (jw, jb, jp), (tw, tb, tp) = _stacks(3, 128)
    assert tw.dtype == torch.bfloat16 and tb.dtype == tp.dtype == torch.float32
    np.testing.assert_array_equal(_to_np(tw), np.asarray(jw, np.float32))
    np.testing.assert_array_equal(_to_np(tb), np.asarray(jb))
    np.testing.assert_array_equal(_to_np(tp), np.asarray(jp))


def _compare(got, ref, rel):
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    err = np.abs(_to_np(got) - ref).max()
    assert np.isfinite(_to_np(got)).all()
    assert err <= rel * max(scale, 1.0), (err, scale)


def test_plain_trunk_matches_jax_scan_at_base_width():
    """dinov2-base width, 2 layers, seq 257. The bound is the one JAX holds
    between its own trunks (tests/test_dino_layer_kernel.py:81)."""
    x, (jw, jb, jp), (tw, tb, tp) = _stacks(2, 768)
    ref = jdl.dino_layers_serving_scan(jnp.asarray(x), jw, jb, jp)
    got = tdl.dino_layers_serving(torch.tensor(x).bfloat16(), tw, tb, tp)
    _compare(got, ref, 0.01)


def test_plain_trunk_matches_pallas_interpret():
    """The Pallas kernel itself, in interpret mode, at width 128."""
    x, (jw, jb, jp), (tw, tb, tp) = _stacks(2, 128, seed=1)
    ref = jdl.dino_layers_serving(jnp.asarray(x), jw, jb, jp, interpret=True)
    got = tdl.dino_layers_serving(torch.tensor(x).bfloat16(), tw, tb, tp)
    _compare(got, ref, 0.01)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and launch nothing."""
    x, _, (tw, tb, tp) = _stacks(1, 128, seed=2)
    xb = torch.tensor(x).bfloat16()
    tdl.reset_launch_counts()
    got = tdl.dino_layers_serving(xb, tw, tb, tp)
    ref = tdl.dino_layers_serving_reference(xb, tw, tb, tp)
    assert torch.equal(got, ref)
    assert set(tdl.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_trunk_rejects_bad_arguments(bad):
    x, _, (tw, tb, tp) = _stacks(1, 128, seed=3)
    xb = torch.tensor(x).bfloat16()
    if bad == "dtype":
        tw = tw.float()
    else:
        tb = tb[:, :2]
    with pytest.raises(ValueError):
        tdl.dino_layers_serving(xb, tw, tb, tp)
