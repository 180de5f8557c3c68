"""Frame-level observation transforms (parity: octo/data/obs_transforms.py);
the port's counterpart of hypervla_tpu/data/obs_transforms.py.

Host side: JPEG/PNG decode (PIL, imported only where a frame is encoded).
The math (resize, augmentation) is ops/preprocess.py's, run here on CPU
tensors: the host pipeline works on the host, as the JAX package runs the
same ops on its CPU backend, while the card runs the train step. This is
the pipeline's design, not a fallback; `device_augment` moves the
augmentation onto the card instead (train/train_step.py).

Each camera's augmentation draws from a torch.Generator seeded with
`seed + i`, where the JAX package uses PRNGKey(seed + i): the draws differ
between the packages, the functions do not.
"""
import io
import logging
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from hypervla_tpu_torch.ops import preprocess


def _as_bytes(value) -> bytes:
    """Extracts raw bytes from bytes / np.bytes_ / 0-d object arrays."""
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            value = value.item()
        else:
            value = value.reshape(-1)[0]
    if isinstance(value, str):
        return value.encode("utf-8")
    return bytes(value)


def _resize(image: np.ndarray, size) -> np.ndarray:
    """The lanczos3 resize of one uint8 frame on the host."""
    return preprocess.resize_image(
        torch.tensor(np.asarray(image)), tuple(size)).numpy()


def decode_image(value, dtype=np.uint8) -> np.ndarray:
    """Decodes a serialized image (bytes) to an array; passes arrays through."""
    if isinstance(value, (bytes, np.bytes_)):
        if len(value) == 0:
            return None
        from PIL import Image

        img = Image.open(io.BytesIO(value))
        return np.asarray(img, dtype=dtype)
    return np.asarray(value)


def augment(obs: dict, seed, augment_kwargs: Union[dict, Mapping[str, dict]]) -> dict:
    """Augments each image key (skipping padding images), seeding each key
    differently like the reference (obs_transforms.py:29-42)."""
    if not hasattr(augment_kwargs, "items"):
        raise ValueError(
            "augment_kwargs must be a dict keyed by image name or a single "
            "dict with an 'augment_order' key."
        )
    image_names = {key[6:] for key in obs if key.startswith("image_")}
    if "augment_order" in augment_kwargs:
        augment_kwargs = {name: augment_kwargs for name in image_names}

    for i, name in enumerate(sorted(image_names)):
        if name not in augment_kwargs:
            continue
        kwargs = dict(augment_kwargs[name])
        if obs["pad_mask_dict"][f"image_{name}"]:
            gen = torch.Generator().manual_seed(int(seed) + i)
            params = preprocess.sample_augment_params(1, generator=gen,
                                                      **kwargs)
            image = torch.tensor(np.asarray(obs[f"image_{name}"]))
            obs[f"image_{name}"] = preprocess.augment_image(
                image[None], params, **kwargs)[0].numpy()
    return obs


def image_dropout(
    obs: dict,
    seed,
    dropout_prob: float,
    always_keep_key: Optional[str] = None,
) -> dict:
    """Independently drops image keys but always keeps at least one."""
    image_keys = [key for key in obs if key.startswith("image_")]
    if not image_keys:
        return obs
    rng = np.random.default_rng(int(seed))
    pad_mask = np.stack([obs["pad_mask_dict"][key] for key in image_keys])
    if always_keep_key:
        assert always_keep_key in image_keys, (
            f"always_keep_key {always_keep_key} not in {image_keys}"
        )
        always_keep_index = image_keys.index(always_keep_key)
    else:
        nonpad = np.nonzero(pad_mask)[0]
        always_keep_index = int(rng.choice(nonpad)) if len(nonpad) else 0

    rands = rng.random(len(image_keys))
    pad_mask = pad_mask & (
        (np.arange(len(image_keys)) == always_keep_index)
        | (rands > dropout_prob)
    )
    for i, key in enumerate(image_keys):
        obs["pad_mask_dict"][key] = pad_mask[i]
        if not pad_mask[i]:
            obs[key] = np.zeros_like(obs[key])
    return obs


def decode_and_resize(
    obs: dict,
    resize_size: Union[Tuple[int, int], Mapping[str, Tuple[int, int]]],
    depth_resize_size: Union[Tuple[int, int], Mapping[str, Tuple[int, int]]],
) -> dict:
    """Decodes images/depth and resizes (lanczos3); empty strings become
    zero padding images at the target size."""
    image_names = {key[6:] for key in obs if key.startswith("image_")}
    depth_names = {key[6:] for key in obs if key.startswith("depth_")}
    if isinstance(resize_size, tuple):
        resize_size = {name: resize_size for name in image_names}
    if isinstance(depth_resize_size, tuple):
        depth_resize_size = {name: depth_resize_size for name in depth_names}

    for name in image_names:
        if name not in resize_size:
            logging.warning(
                f"No resize_size provided for image_{name}; 1x1 padding images."
            )
        image = obs[f"image_{name}"]
        if isinstance(image, (bytes, np.bytes_)) or (
            isinstance(image, np.ndarray) and image.dtype.kind in ("S", "O", "U")
        ):
            raw = _as_bytes(image)
            if len(raw) == 0:
                image = np.zeros(
                    (*resize_size.get(name, (1, 1)), 3), dtype=np.uint8
                )
            else:
                image = decode_image(raw)
        elif image.dtype != np.uint8:
            raise ValueError(f"Unsupported image dtype: {image.dtype}")
        if name in resize_size:
            image = _resize(image, resize_size[name])
        obs[f"image_{name}"] = image

    for name in depth_names:
        depth = obs[f"depth_{name}"]
        if isinstance(depth, (bytes, np.bytes_)) or (
            isinstance(depth, np.ndarray) and depth.dtype.kind in ("S", "O", "U")
        ):
            depth = _as_bytes(depth)
            if len(depth) == 0:
                depth = np.zeros(
                    (*depth_resize_size.get(name, (1, 1)), 1), dtype=np.float32
                )
            else:
                depth = decode_image(depth, dtype=np.float32)[..., 0]
        elif depth.dtype != np.float32:
            raise ValueError(f"Unsupported depth dtype: {depth.dtype}")
        if name in depth_resize_size:
            depth = preprocess.resize_depth_image(
                torch.tensor(depth), tuple(depth_resize_size[name])
            ).numpy()
        obs[f"depth_{name}"] = depth
    return obs


def decode_and_crop_and_resize(
    obs: dict,
    resize_size,
    depth_resize_size,
    train: bool,
    seed: Optional[int] = None,
) -> dict:
    """The "rtx" variant: decode, pad 256x320 by (20, 50) + random crop at
    train time, then resize."""
    image_names = {key[6:] for key in obs if key.startswith("image_")}
    if isinstance(resize_size, tuple):
        resize_size = {name: resize_size for name in image_names}

    for name in image_names:
        image = obs[f"image_{name}"]
        if isinstance(image, (bytes, np.bytes_)) or (
            isinstance(image, np.ndarray) and image.dtype.kind in ("S", "O", "U")
        ):
            raw = _as_bytes(image)
            if len(raw) == 0:
                image = np.zeros(
                    (*resize_size.get(name, (1, 1)), 3), dtype=np.uint8
                )
            else:
                image = decode_image(raw)
        if train:
            gen = torch.Generator().manual_seed(
                seed if seed is not None else np.random.randint(2**31)
            )
            off_y, off_x = preprocess.sample_rtx_offsets(gen)
            image = preprocess.rtx_pad_crop(
                torch.tensor(np.asarray(image)), off_y, off_x
            ).numpy()
        if name in resize_size:
            image = _resize(image, resize_size[name])
        obs[f"image_{name}"] = image

    return decode_and_resize(obs, {}, depth_resize_size)
