"""The port's converters against the JAX package's, on the same inputs
written inside the test: hypervla_tpu_torch/data/converters/metaworld.py
against hypervla_tpu/data/converters/metaworld.py over pickled episodes,
and tools/convert_rlds.py against scripts/convert_rlds.py over a TFDS-style
RLDS dataset (features.json and a tfrecord shard, as
tests/test_rlds_source.py writes one). Every shard of the port holds the
JAX shard's keys, arrays and JPEG byte strings, equal; the RLDS tool runs
from its command line without JAX, TensorFlow or the JAX package."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hypervla_tpu.data.converters import metaworld as jmetaworld
from hypervla_tpu.data.tfrecord import encode_example, write_tfrecord
from hypervla_tpu_torch.data.converters import metaworld
from scripts import convert_rlds as jconvert_rlds
from test_rlds_source import _features_json, _jpeg
from test_torch_harness import torch_threads  # noqa: F401
from tools import convert_rlds

ROOT = Path(__file__).resolve().parent.parent


def _shards(directory):
    """{file name: {key: array}} of every .npz under directory."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with np.load(os.path.join(directory, name), allow_pickle=True) as f:
            out[name] = {k: f[k] for k in f.files}
    return out


def assert_same_shards(got_dir, want_dir):
    got, want = _shards(got_dir), _shards(want_dir)
    assert list(got) == list(want) and want
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays), name
        for key, value in arrays.items():
            other = got[name][key]
            assert other.dtype == value.dtype and other.shape == value.shape
            if value.dtype.kind == "O":  # JPEG and instruction bytes
                assert [bytes(b) for b in other.ravel()] == [
                    bytes(b) for b in value.ravel()], (name, key)
            else:
                np.testing.assert_array_equal(other, value, err_msg=key)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """Two .pkl files: a list of two episodes (frames under "images",
    states, one instruction string) and one episode dict (frames under
    "observations", no states, an instruction a step as bytes)."""
    root = tmp_path_factory.mktemp("metaworld")
    rng = np.random.default_rng(0)

    def frames(n):
        return rng.integers(0, 256, (n, 24, 32, 3), dtype=np.uint8)

    episodes = [{"images": frames(n), "states": rng.standard_normal((n, 5)),
                 "actions": rng.standard_normal((n, 4)),
                 "language": "push the puck"} for n in (3, 5)]
    with open(root / "a.pkl", "wb") as f:
        pickle.dump(episodes, f)
    with open(root / "b.pkl", "wb") as f:
        pickle.dump({"observations": frames(4).astype(np.float64),
                     "actions": rng.standard_normal((4, 4)).astype(
                         np.float32),
                     "language_instruction": [b"open the door"] * 4}, f)
    return str(root)


@pytest.mark.parametrize("max_episodes", [None, 2])
def test_metaworld_shards_equal_the_jax_converters(pickles, tmp_path,
                                                   max_episodes):
    want = jmetaworld.convert_directory(pickles, str(tmp_path / "jax"),
                                        max_episodes)
    got = metaworld.convert_directory(pickles, str(tmp_path / "port"),
                                      max_episodes)
    assert got == want == (3 if max_episodes is None else 2)
    assert_same_shards(tmp_path / "port", tmp_path / "jax")


@pytest.fixture(scope="module")
def rlds_dir(tmp_path_factory):
    """Three episodes of a TFDS-style RLDS dataset in one tfrecord shard."""
    root = tmp_path_factory.mktemp("rlds") / "synthetic_rlds" / "1.0.0"
    os.makedirs(root)
    with open(root / "features.json", "w") as f:
        json.dump(_features_json(), f)
    rng = np.random.RandomState(1)
    records = []
    for ep, n in enumerate((4, 6, 3)):
        records.append(encode_example({
            "steps/observation/image": [
                _jpeg(rng.randint(0, 255, (32, 32, 3)).astype(np.uint8))
                for _ in range(n)],
            "steps/observation/state": rng.randn(n, 8).astype(
                np.float32).reshape(-1),
            "steps/action": rng.randn(n, 7).astype(np.float32).reshape(-1),
            "steps/language_instruction": [b"stack the blocks"] * n,
            "steps/is_last": np.array([0] * (n - 1) + [1], np.int64),
            "episode_id": np.array([ep], np.int64),
        }))
    write_tfrecord(str(root / "synthetic_rlds-train.tfrecord-00000-of-00001"),
                   records)
    return str(root)


@pytest.mark.parametrize("max_episodes", [None, 2])
def test_rlds_shards_equal_the_jax_script(rlds_dir, tmp_path, max_episodes):
    jconvert_rlds.convert(rlds_dir, str(tmp_path / "jax"), max_episodes)
    count = convert_rlds.convert(rlds_dir, str(tmp_path / "port"),
                                 max_episodes)
    assert count == (3 if max_episodes is None else 2)
    assert_same_shards(tmp_path / "port", tmp_path / "jax")


_CLI = """
import runpy, sys
sys.argv = ["tools/convert_rlds.py", "--src", sys.argv[1], "--dst",
            sys.argv[2]]
runpy.run_path("tools/convert_rlds.py", run_name="__main__")
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "hypervla_tpu", "tensorflow")))
"""


def test_rlds_tool_runs_without_jax(rlds_dir, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _CLI, rlds_dir, str(tmp_path / "cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "[]", out.stdout
    assert "done: 3 episodes" in out.stdout
    jconvert_rlds.convert(rlds_dir, str(tmp_path / "jax"))
    assert_same_shards(tmp_path / "cli", tmp_path / "jax")
