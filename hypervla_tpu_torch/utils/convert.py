"""The weight bridge from the JAX package's param trees to the port.

A flax param tree (nested dicts of arrays) becomes a flat dict keyed by the
JAX key path joined with "/", for example
"encoder/image_encoder/encoder/layer/3/mlp/fc1/kernel". Dense kernels keep
flax's (in, out) layout and the port applies them as `x @ W`, and conv
kernels (SmallStem's StdConv_<i>, embedding) keep flax's HWIO layout and
are laid out for torch's convolution at the conv
(models/layers.py::conv2d), so the generated weights, which arrive as flat
slices reshaped to JAX shapes, are never transposed in the param dict.

The trunk switches change no key: the JAX package's fused modules
(`_FusedLayerNorm`, `_PallasTrainLayerNorm`, `_FusedAddLayerNorm`,
`_LayerScaleVector`, the layer kernel's collection) keep nn.LayerNorm's
"scale"/"bias" and _LayerScale's "lambda1" under the same module names, so
a tree from a model built with any of them converts as it is. The one
switch that does change the keys, scan_dino_layers (one stacked
encoder/layers/layer subtree), is refused here as in
models/base_vit.py::check_trunk_switches.
"""
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf}, keys in the nesting order."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def from_jax_params(tree: Any, device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """A tree of numpy arrays (a flax param tree moved to the host) ->
    the port's flat param dict of tensors on `device`."""
    out = {}
    for path, leaf in flatten_tree(tree).items():
        if "encoder/layers/layer/" in path:
            raise NotImplementedError(
                f"{path}: a tree built with scan_dino_layers=True stacks the "
                "trunk's layers under encoder/layers/layer, a layout the "
                "port does not read; unstack it first with the JAX "
                "package's unstack_layer_params")
        t = torch.from_numpy(np.array(leaf, copy=True))
        out[path] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def subtree(params: Params, prefix: str) -> Params:
    """The entries under `prefix` ("a/b/"), with the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}
