"""The conv + MLP policy, the JAX package's non-transformer ablation
baseline (counterpart of hypervla_tpu/models/base_cnn.py::CNN): four
stages of a weight-standardized convolution, GroupNorm and ReLU over the
[-1, 1]-normalised image, flattened in NHWC order into a ReLU MLP that
regresses a flat action vector.

No path builds it, because none does in the JAX package: its BaseNetwork
calls the encoder with arguments CNN.__call__ does not take, so
model_type "cnn" fails at init there and raises the same TypeError here
(models/base_network.py). It runs as a module on its own.

Params keep the JAX names (StdConv_<i>, GroupNorm_<i>, Dense_<j>) and
layouts (HWIO conv kernels, (in, out) dense kernels).
"""
import dataclasses
from typing import Dict, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.vit_encoders import (
    _conv_specs,
    _output_side,
    normalize_images,
    std_conv,
)


@dataclasses.dataclass(frozen=True)
class CNN:
    output_dim: int = 4
    features: tuple = (32, 64, 128, 256)
    kernel_sizes: tuple = (3, 3, 3, 3)
    strides: tuple = (2, 2, 2, 2)
    padding: tuple = (1, 1, 1, 1)
    mlp_hidden_sizes: tuple = (32, 32)

    def _stages(self):
        return zip(self.kernel_sizes, self.strides, self.features,
                   self.padding)

    def __call__(self, params: Dict[str, torch.Tensor], images):
        """uint8 (B, H, W, 3) -> (B, output_dim)."""
        x = normalize_images(images).permute(0, 3, 1, 2)
        for i, (_, stride, _, padding) in enumerate(self._stages()):
            x = std_conv(params, f"StdConv_{i}", x, stride, padding)
            x = torch.relu(layers.group_norm(
                x, params[f"GroupNorm_{i}/scale"],
                params[f"GroupNorm_{i}/bias"]))
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        n_hidden = len(self.mlp_hidden_sizes)
        for j in range(n_hidden):
            h = torch.relu(layers.dense(h, params[f"Dense_{j}/kernel"],
                                        params[f"Dense_{j}/bias"]))
        return layers.dense(h, params[f"Dense_{n_hidden}/kernel"],
                            params[f"Dense_{n_hidden}/bias"])

    def specs(self, image_shape: Tuple[int, int]
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers for (H, W) frames."""
        specs = {}
        (height, width), c_in = image_shape, 3
        for i, (kernel, stride, f, padding) in enumerate(self._stages()):
            specs.update(_conv_specs(f"StdConv_{i}", kernel, c_in, f))
            specs[f"GroupNorm_{i}/bias"] = ((f,), layers.zeros)
            specs[f"GroupNorm_{i}/scale"] = ((f,), layers.ones)
            height = _output_side(height, kernel, stride, padding)
            width = _output_side(width, kernel, stride, padding)
            c_in = f
        fan_in = height * width * c_in
        for j, size in enumerate(self.mlp_hidden_sizes + (self.output_dim,)):
            specs[f"Dense_{j}/bias"] = ((size,), layers.zeros)
            specs[f"Dense_{j}/kernel"] = ((fan_in, size), layers.lecun_normal)
            fan_in = size
        return specs
