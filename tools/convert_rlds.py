"""Converts a TFDS/RLDS dataset into the native .npz trajectory shards
(counterpart of scripts/convert_rlds.py), without TensorFlow.

One compressed .npz a trajectory, nested keys joined by '/', encoded
images kept as bytes: what hypervla_tpu_torch/data/sources.py::
NpzTrajectorySource reads. The tfrecords are read by RldsTfrecordSource of
the same module, which the input pipeline can also read directly; the
conversion pays off over repeated epochs.

    python tools/convert_rlds.py --src <tfds_dir>/<name>/<version> \
        --dst <out_dir>/<name> [--max_episodes N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from hypervla_tpu_torch.data.sources import (  # noqa: E402
    NpzTrajectorySource,
    RldsTfrecordSource,
)


def convert(src: str, dst: str, max_episodes=None, validate_crc=False) -> int:
    """Every episode of the RLDS dataset at src, in shard order, as
    dst/episode_<n>.npz; returns the number written. validate_crc is taken
    and not read, as in the JAX script (RldsTfrecordSource reads without
    the CRC checks)."""
    os.makedirs(dst, exist_ok=True)
    count = 0
    for traj in RldsTfrecordSource(src).trajectories(shuffle=False):
        NpzTrajectorySource.write_trajectory(
            os.path.join(dst, f"episode_{count:06d}.npz"), traj)
        count += 1
        if count % 100 == 0:
            print(f"converted {count} episodes")
        if max_episodes is not None and count >= max_episodes:
            break
    print(f"done: {count} episodes -> {dst}")
    return count


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="TFDS dataset version dir")
    parser.add_argument("--dst", required=True, help="output npz directory")
    parser.add_argument("--max_episodes", type=int, default=None)
    args = parser.parse_args()
    convert(args.src, args.dst, args.max_episodes)
