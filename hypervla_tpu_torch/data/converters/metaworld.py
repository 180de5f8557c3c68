"""MetaWorld demo converter (counterpart of
hypervla_tpu/data/converters/metaworld.py).

Writes pickled MetaWorld demonstrations straight into the native .npz
shard format that data/sources.py::NpzTrajectorySource reads (JPEG frames
at quality 95, float32 states and actions, a language instruction a step),
without TFDS.

Expected input: a directory of .pkl files, each holding an episode dict or
a list of them, with keys {"images" or "observations", "actions",
"language" or "language_instruction", optionally "states"}.

    python -m hypervla_tpu_torch.data.converters.metaworld --src <pkl_dir> \
        --dst <npz_dir> [--max_episodes N]
"""
import glob
import io
import os
import pickle

import numpy as np

from hypervla_tpu_torch.data.sources import NpzTrajectorySource


def _encode_jpeg(frame: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame.astype(np.uint8)).save(buf, format="JPEG",
                                                 quality=95)
    return buf.getvalue()


def convert_episode(episode: dict) -> dict:
    """One episode dict -> the trajectory dict the .npz shards hold."""
    frames = np.asarray(episode.get("images", episode.get("observations")))
    n = len(frames)
    language = episode.get("language", episode.get("language_instruction",
                                                   ""))
    if isinstance(language, (str, bytes)):
        language = [language] * n
    traj = {
        "observation": {
            "image": np.array([_encode_jpeg(f) for f in frames],
                              dtype=object),
        },
        "action": np.asarray(episode["actions"], np.float32),
        "language_instruction": np.array(
            [s.encode("utf-8") if isinstance(s, str) else bytes(s)
             for s in language], dtype=object),
    }
    if "states" in episode:
        traj["observation"]["state"] = np.asarray(episode["states"],
                                                  np.float32)
    return traj


def convert_directory(src_dir: str, dst_dir: str, max_episodes=None) -> int:
    """Every episode of src_dir's .pkl files (in name order) as
    dst_dir/episode_<n>.npz; returns the number written."""
    os.makedirs(dst_dir, exist_ok=True)
    count = 0
    for pkl_path in sorted(glob.glob(os.path.join(src_dir, "*.pkl"))):
        with open(pkl_path, "rb") as f:
            episodes = pickle.load(f)
        if isinstance(episodes, dict):
            episodes = [episodes]
        for episode in episodes:
            NpzTrajectorySource.write_trajectory(
                os.path.join(dst_dir, f"episode_{count:06d}.npz"),
                convert_episode(episode))
            count += 1
            if max_episodes is not None and count >= max_episodes:
                return count
    return count


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--max_episodes", type=int, default=None)
    args = parser.parse_args()
    n = convert_directory(args.src, args.dst, args.max_episodes)
    print(f"converted {n} episodes")
