"""Task augmentation (parity: octo/data/utils/task_augmentation.py) — numpy.

delete_task_conditioning randomly drops goal images or the language
instruction per frame; rephrase_instruction swaps instructions with
precomputed paraphrases from a local pickle/JSON table (the reference pulls
the table from the HuggingFace hub; we accept a local path so TPU hosts
without egress can still use it).

The port's copy of hypervla_tpu/data/task_augmentation.py: only its imports differ.
"""
import logging
import os
import pickle
import re
from functools import lru_cache
from typing import Optional

import numpy as np

from hypervla_tpu_torch.data.data_utils import to_padding


@lru_cache(maxsize=4)
def _load_paraphrase_table(path: str):
    if not os.path.exists(path):
        logging.warning(f"Paraphrase table {path} not found; rephrase disabled.")
        return {}
    with open(path, "rb") as f:
        if path.endswith(".json"):
            import json

            return json.load(f)
        return pickle.load(f)


def delete_and_rephrase(
    traj,
    paraphrases_path: str,
    rephrase_prob: float,
    keep_image_prob: float,
    rng: Optional[np.random.Generator] = None,
):
    rng = rng or np.random.default_rng()
    traj = rephrase_instruction(traj, paraphrases_path, rephrase_prob, rng)
    traj = delete_task_conditioning(traj, keep_image_prob, rng)
    return traj


def rephrase_instruction(
    traj: dict,
    paraphrases_path: str,
    rephrase_prob: float,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """Randomly swaps in one of the precomputed paraphrases; writes the result
    into traj["rephrased_task"]["language_instruction"] like the reference
    (task_augmentation.py:99-106)."""
    rng = rng or np.random.default_rng()
    if "language_instruction" not in traj.get("task", {}):
        return traj
    original = traj["task"]["language_instruction"]
    table = _load_paraphrase_table(paraphrases_path)

    def _as_str(x):
        return x.decode("utf-8") if isinstance(x, bytes) else str(x)

    first = _as_str(original[0])
    if table and all(len(_as_str(x)) > 0 for x in original):
        rephrased = table.get(first, "")
        rephrased = _as_str(rephrased)
        combined = first + "." + rephrased if len(rephrased) > 0 else first
        combined = re.sub(r"\.\s+\.", ".", combined)
        options = [s for s in combined.split(".") if len(s) > 0]
        idx = rng.integers(0, len(options), size=len(original))
        sampled = np.array(
            [options[i].encode("utf-8") for i in idx], dtype=object
        )
        if rng.random() >= rephrase_prob:
            sampled = np.asarray(original, dtype=object)
        traj["rephrased_task"] = {"language_instruction": sampled}
    else:
        traj["rephrased_task"] = {
            "language_instruction": np.asarray(original, dtype=object)
        }
    return traj


def delete_task_conditioning(
    traj: dict, keep_image_prob: float, rng: Optional[np.random.Generator] = None
):
    """Per-frame drops either goal images or the language instruction (only
    meaningful when both are present)."""
    rng = rng or np.random.default_rng()
    if "language_instruction" not in traj.get("task", {}):
        return traj
    image_keys = {
        key
        for key in traj["task"].keys()
        if key.startswith("image_") or key.startswith("depth_")
    }
    if not image_keys:
        return traj

    traj_len = traj["action"].shape[0]
    should_keep_images = rng.random(traj_len) < keep_image_prob
    should_keep_images |= ~traj["task"]["pad_mask_dict"]["language_instruction"]
    lengths = np.array(
        [
            len(x) if x is not None else 0
            for x in np.asarray(traj["task"]["language_instruction"]).reshape(-1)
        ]
    )
    should_keep_images |= lengths == 0

    for key in image_keys | {"language_instruction"}:
        should_keep = (
            should_keep_images if key in image_keys else ~should_keep_images
        )
        arr = np.asarray(traj["task"][key])
        pad = to_padding(arr)
        expand = should_keep.reshape(
            (-1,) + (1,) * (arr.ndim - 1)
        )
        traj["task"][key] = np.where(expand, arr, pad)
        traj["task"]["pad_mask_dict"][key] = np.where(
            should_keep,
            traj["task"]["pad_mask_dict"][key],
            np.zeros_like(traj["task"]["pad_mask_dict"][key]),
        )

    traj["task"]["timestep"] = np.where(
        should_keep_images, traj["task"]["timestep"], traj_len - 1
    )
    return traj
