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
switch that does change the keys, scan_dino_layers, stacks the trunk's
layers into one encoder/layers/layer subtree whose leaves carry a leading
layer axis (in a HyperVLA's params, flat shared leaves
"<...>encoder_layers_layer_<leaf>" of the layers' values one after the
other); `from_jax_params` unstacks them into the port's per-layer keys
(encoder/layer/<i>/..., "<...>encoder_layer_<i>_<leaf>"), which the
port's scanned trunk reads as its layer loop does. Another scan's
stack, the diffusion head's score-network blocks
(action_head/diffusion_model/trunk/blocks/..., a leading depth axis), is
carried as it is: the port's score network reads its blocks stacked
(models/diffusion.py).
"""
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from hypervla_tpu_torch.configs import dinov2_config

#: a base-net tree's stacked trunk layers, and a HyperVLA's flat ones
STACKED = re.compile(r"^((?:.*/)?encoder)/layers/layer/(.*)$")
STACKED_FLAT = re.compile(r"^(.*encoder_image_encoder_encoder)_layers_layer_"
                          r"(.*)$")

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


def trunk_depth(config: dict) -> int:
    """The DINOv2 trunk's layer count of a HyperVLA config."""
    return dinov2_config(config["base_net_kwargs"]["vit_kwargs"].get(
        "pretrained_encoder_name", "dinov2-base")).num_hidden_layers


def unstack_trunk(flat: Dict[str, Any],
                  layers: Optional[int] = None) -> Dict[str, Any]:
    """A flat {path: array} dict with the JAX package's scanned trunk ->
    the same with per-layer keys (a tree without one comes back as it
    is). A base-net tree's stacked leaves carry their layer axis; a
    HyperVLA's flat ones do not, and are split into `layers` parts
    (`trunk_depth` of its config)."""
    out = {}
    for path, leaf in flat.items():
        stacked, flat_leaf = STACKED.match(path), STACKED_FLAT.match(path)
        if stacked:
            leaf = np.asarray(leaf)
            for i in range(leaf.shape[0]):
                out[f"{stacked.group(1)}/layer/{i}/{stacked.group(2)}"] = (
                    leaf[i])
        elif flat_leaf:
            if layers is None:
                raise ValueError(
                    f"{path} holds a scanned trunk's layers one after the "
                    "other: pass the trunk's layer count (trunk_depth)")
            for i, part in enumerate(np.split(np.asarray(leaf).reshape(-1),
                                              layers)):
                out[f"{flat_leaf.group(1)}_layer_{i}_{flat_leaf.group(2)}"] = (
                    part)
        else:
            out[path] = leaf
    return out


def from_jax_params(tree: Any, device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None,
                    layers: Optional[int] = None) -> Params:
    """A tree of numpy arrays (a flax param tree moved to the host) ->
    the port's flat param dict of tensors on `device`, a scanned trunk
    unstacked (`unstack_trunk`, which needs `layers` for a HyperVLA's)."""
    out = {}
    for path, leaf in unstack_trunk(flatten_tree(tree), layers).items():
        t = torch.from_numpy(np.array(leaf, copy=True))
        out[path] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def drop_unread_params(params: Params, config: dict) -> Params:
    """A HyperVLA's converted params without the leaves its JAX model never
    reads: under "block" generation with output_head_bias=False the JAX
    bias-init protocol still writes each output head's bias
    (hypervla_tpu/models/hypervla.py:216-229), which no module declares."""
    hk = config["hypernet_kwargs"]
    if (hk.get("generation_strategy", "full") != "block"
            or hk.get("output_head_bias", True)):
        return params
    return {k: v for k, v in params.items()
            if not (k.startswith("output_head_") and k.endswith("/bias"))}


def subtree(params: Params, prefix: str) -> Params:
    """The entries under `prefix` ("a/b/"), with the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


#: the JAX package's module path prefix, and the port's
JAX_PACKAGE, PORT_PACKAGE = "hypervla_tpu.", "hypervla_tpu_torch."


def port_module_specs(tree: Any) -> Any:
    """A config with every ModuleSpec ({module, name, args, kwargs}) that
    names a module of the JAX package pointed at the port's module of the
    same path (hypervla_tpu.models.tokenizers -> hypervla_tpu_torch.models.
    tokenizers), nested specs too; the rest as it is."""
    if isinstance(tree, dict):
        out = {k: port_module_specs(v) for k, v in tree.items()}
        module = out.get("module")
        if (set(out) == {"module", "name", "args", "kwargs"}
                and isinstance(module, str)
                and module.startswith(JAX_PACKAGE)):
            out["module"] = PORT_PACKAGE + module[len(JAX_PACKAGE):]
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(port_module_specs(v) for v in tree)
    return tree
