"""Feature-wise linear modulation (counterpart of
hypervla_tpu/models/film.py::FilmConditioning): a feature map times (1 +
scale(z)) plus shift(z), scale and shift two zero-initialized Dense
projections of the conditioning vector z (Dense_0 the multiplicative term,
Dense_1 the additive one), so the layer starts as the identity.
"""
from typing import Dict, Tuple

from hypervla_tpu_torch.models import layers


def film_conditioning(params, prefix: str, conv_filters, conditioning):
    """conv_filters (B, C, H, W) NCHW, conditioning (B, D) -> (B, C, H,
    W)."""
    scale, shift = (
        layers.dense(conditioning, params[f"{prefix}/{name}/kernel"],
                     params[f"{prefix}/{name}/bias"])[:, :, None, None]
        for name in ("Dense_0", "Dense_1"))
    return conv_filters * (1 + scale) + shift


def film_specs(prefix: str, cond_dim: int, channels: int
               ) -> Dict[str, Tuple[tuple, layers.Init]]:
    specs = {}
    for name in ("Dense_0", "Dense_1"):
        specs[f"{prefix}/{name}/bias"] = ((channels,), layers.zeros)
        specs[f"{prefix}/{name}/kernel"] = ((cond_dim, channels),
                                            layers.zeros)
    return specs
