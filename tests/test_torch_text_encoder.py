"""The port's instruction encoder against the JAX package's on the CPU:
the tokenizer copies (hypervla_tpu_torch/data/text_processing.py), the
pretrained-weights lookup (models/encoders/pretrained.py) and
eval/model_loading.py::build_text_encoder over the port's T5.

Without weights the JAX package inits T5 from PRNGKey(0), which a
torch.Generator cannot reproduce, so the parity test hands the port that
same init (converted) through its load_t5_weights. Both packages tokenize
with FallbackTokenizer here (no tokenizer files are in the repository); its
ids come from Python's salted `hash`, the same within this one process. The
T5 is t5-small (d_model 512) to keep the file to seconds."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.data import text_processing as jtext
from hypervla_tpu.eval.model_loading import (
    build_text_encoder as jax_build_text_encoder,
)
from hypervla_tpu.models.encoders import t5 as jt5
from hypervla_tpu_torch.data import text_processing as text
from hypervla_tpu_torch.eval import model_loading
from hypervla_tpu_torch.models.encoders.pretrained import load_t5_weights
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

STRINGS = ["pick up the coke can", b"open the TOP drawer",
           "put the spoon on the towel and then close the drawer slowly"]


def _model(instr_len):
    """A stand-in carrying only the example batch build_text_encoder
    reads."""
    ids = np.ones((1, instr_len), np.int32)
    return types.SimpleNamespace(example_batch={"task": {
        "language_instruction": {"input_ids": ids}}}, device="cpu")


@pytest.mark.parametrize("max_length", [4, 16])
def test_fallback_tokenizer_matches_jax(max_length):
    got = text.FallbackTokenizer()(STRINGS, max_length=max_length)
    ref = jtext.FallbackTokenizer()(STRINGS, max_length=max_length)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], ref[key])
    assert (got["input_ids"][:, 0] >= 2).all()


def test_hf_tokenizer_matches_jax():
    kwargs = {"max_length": 12, "padding": "max_length", "truncation": True,
              "return_tensors": "np"}
    got = text.HFTokenizer("t5-base", kwargs).encode(STRINGS)
    ref = jtext.HFTokenizer("t5-base", kwargs).encode(STRINGS)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def test_t5_weights_come_from_the_pretrained_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    assert load_t5_weights("t5-small") is None
    monkeypatch.setenv("HYPERVLA_PRETRAINED_DIR", str(tmp_path))
    assert load_t5_weights("t5-small") is None
    weights = {"final_layer_norm/weight": torch.arange(4.0)}
    torch.save(weights, tmp_path / "t5-small.pt")
    got = load_t5_weights("t5-small")
    assert torch.equal(got["final_layer_norm/weight"], torch.arange(4.0))


def test_text_encoder_matches_jax(monkeypatch):
    """The same T5 params: ids and mask equal, embeddings to 1e-5, the
    instruction length taken from the model's example batch."""
    length = 9
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    encoder = jt5.T5EncoderModel(config=jt5.t5_config("t5-small"))
    jax_init = encoder.init(jax.random.PRNGKey(0),
                            jnp.ones((1, length), jnp.int32))["params"]
    monkeypatch.setattr(
        model_loading, "load_t5_weights",
        lambda name, device=None: from_jax_params(
            jax.tree_util.tree_map(np.asarray, jax_init), device))
    got = model_loading.build_text_encoder(_model(length), "t5-small")
    ref = jax_build_text_encoder(_model(length), "t5-small")
    for strings in (STRINGS[0], STRINGS):
        g, r = (f(strings)["language_instruction"] for f in (got, ref))
        assert g["input_ids"].shape == (len(np.atleast_1d(strings)), length)
        np.testing.assert_array_equal(g["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(g["attention_mask"],
                                      r["attention_mask"])
        assert g["token_embedding"].dtype == np.float32
        np.testing.assert_allclose(g["token_embedding"],
                                   np.asarray(r["token_embedding"]),
                                   atol=1e-5)


def test_text_encoder_without_weights_is_seeded(monkeypatch):
    """No weights: T5 is drawn from a fixed seed, so two encoders agree;
    without an example batch the length is 32, as in the JAX package."""
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    a = model_loading.build_text_encoder(None, "t5-small", device="cpu")
    b = model_loading.build_text_encoder(None, "t5-small", device="cpu")
    ea = a("pick up the cube")["language_instruction"]
    eb = b("pick up the cube")["language_instruction"]
    assert ea["input_ids"].shape == (1, 32)
    assert ea["token_embedding"].shape == (1, 32, 512)
    np.testing.assert_array_equal(ea["token_embedding"],
                                  eb["token_embedding"])
