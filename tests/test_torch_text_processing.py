"""The port's text processors (hypervla_tpu_torch/data/text_processing.py)
against the JAX package's, on the CPU, with nothing downloaded:

  * MuseEmbedding over an .npz table written here, and its hash fallback
    (Python's salted `hash`, the same within this one process): equal;
  * HFTokenizer(encode_with_model=True) on a tiny encoder-only model that
    transformers writes here (a BERT, its tokenizer built from
    `tokenizers`), with its Flax weights saved beside the torch ones so
    that both packages load one directory: the JAX package runs the Flax
    model, the port the torch one; last_hidden_state to 1e-5. A T5 there
    (an encoder-decoder) fails in both with a ValueError: its model wants
    decoder inputs;
  * CLIPTextProcessor with CLIPProcessor.from_pretrained patched to a
    processor over a tiny local vocab: equal dicts, position_ids included.
"""
import json
import os

import numpy as np
import pytest

from hypervla_tpu.data import text_processing as jtext
from hypervla_tpu_torch.data import text_processing as text
from test_torch_harness import torch_threads  # noqa: F401

STRINGS = ["pick up the cube", b"open the top drawer", "put the cube down"]
WORDS = ["[PAD]", "[UNK]", "pick", "up", "the", "cube", "open", "top",
         "drawer", "put", "down"]
KWARGS = {"max_length": 7, "padding": "max_length", "truncation": True,
          "return_tensors": "np"}


def test_muse_table_and_fallback_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "muse.npz")
    np.savez(path, strings=np.array([b"pick up the cube", "open the drawer"],
                                    dtype=object),
             embeddings=rng.standard_normal((2, 24)).astype(np.float32))
    strings = ["pick up the cube", b"open the drawer", "an unknown one",
               "an unknown one"]
    got = text.MuseEmbedding(path).encode(strings)
    ref = jtext.MuseEmbedding(path).encode(strings)
    assert got.shape == (4, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(np.linalg.norm(got[2]), 1.0, rtol=1e-6)
    # the table from $HYPERVLA_MUSE_PATH; without one, the fallback's dim
    monkeypatch.setenv("HYPERVLA_MUSE_PATH", path)
    assert text.MuseEmbedding().dim == jtext.MuseEmbedding().dim == 24
    monkeypatch.delenv("HYPERVLA_MUSE_PATH")
    got = text.MuseEmbedding(dim=8).encode(strings[:3])
    np.testing.assert_array_equal(got,
                                  jtext.MuseEmbedding(dim=8).encode(
                                      strings[:3]))
    assert got.shape == (3, 8)


def _tokenizer(directory, input_names):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                            unk_token="[UNK]",
                            model_input_names=input_names
                            ).save_pretrained(directory)


def _both_formats(model, directory):
    """Saves a torch model and its Flax twin into one directory."""
    from transformers import FlaxAutoModel

    model.save_pretrained(directory)
    FlaxAutoModel.from_pretrained(directory, from_pt=True).save_pretrained(
        directory)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    import torch
    from transformers import BertConfig, BertModel

    directory = str(tmp_path_factory.mktemp("tiny_bert"))
    _tokenizer(directory, ["input_ids", "token_type_ids", "attention_mask"])
    torch.manual_seed(0)
    _both_formats(BertModel(BertConfig(
        vocab_size=len(WORDS), hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=16)), directory)
    return directory


def test_encode_with_model_matches_jax(bert_dir):
    got = text.HFTokenizer(bert_dir, dict(KWARGS), encode_with_model=True,
                           device="cpu")
    ref = jtext.HFTokenizer(bert_dir, dict(KWARGS), encode_with_model=True)
    assert not isinstance(got.tokenizer, text.FallbackTokenizer)
    emb = got.encode(STRINGS)
    assert emb.shape == (3, 7, 16) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, np.asarray(ref.encode(STRINGS)),
                               atol=1e-5)
    # without the model: the same token dicts
    plain = text.HFTokenizer(bert_dir, dict(KWARGS)).encode(STRINGS)
    jplain = jtext.HFTokenizer(bert_dir, dict(KWARGS)).encode(STRINGS)
    assert plain.keys() == jplain.keys()
    for key in plain:
        np.testing.assert_array_equal(plain[key], jplain[key])


def test_encode_with_model_defaults_to_the_card(bert_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is that card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.HFTokenizer(bert_dir, dict(KWARGS), encode_with_model=True)


def test_encode_with_a_t5_fails_in_both(tmp_path):
    """The JAX package hands the tokenizer's output to the whole model; a
    T5 is an encoder-decoder, whose model wants decoder inputs: a
    ValueError in both packages."""
    from transformers import T5Config, T5Model

    directory = str(tmp_path)
    _tokenizer(directory, ["input_ids", "attention_mask"])
    _both_formats(T5Model(T5Config(
        vocab_size=len(WORDS), d_model=16, d_kv=8, d_ff=32, num_layers=1,
        num_heads=2, decoder_start_token_id=0)), directory)
    for tokenizer in (
            jtext.HFTokenizer(directory, dict(KWARGS),
                              encode_with_model=True),
            text.HFTokenizer(directory, dict(KWARGS),
                             encode_with_model=True, device="cpu")):
        with pytest.raises(ValueError, match="decoder_input"):
            tokenizer.encode(STRINGS[:1])


def _clip_processor(directory):
    """A CLIPProcessor over a byte-level vocab without merges (every
    character a token)."""
    from transformers import CLIPImageProcessor, CLIPProcessor, CLIPTokenizer
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + [
        "<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tokenizer = CLIPTokenizer(os.path.join(directory, "vocab.json"),
                              os.path.join(directory, "merges.txt"))
    return CLIPProcessor(image_processor=CLIPImageProcessor(),
                         tokenizer=tokenizer)


def test_clip_text_processor_matches_jax(tmp_path, monkeypatch):
    import transformers

    processor = _clip_processor(str(tmp_path))
    asked = []

    def from_pretrained(cls, name, *args, **kwargs):
        asked.append(name)
        return processor

    monkeypatch.setattr(transformers.CLIPProcessor, "from_pretrained",
                        classmethod(from_pretrained))
    strings = ["pick up the cube", "open the top drawer"]
    for kwargs in (None, dict(KWARGS, max_length=12)):
        got = text.CLIPTextProcessor(kwargs).encode(strings)
        ref = jtext.CLIPTextProcessor(kwargs).encode(strings)
        assert set(got) == set(ref) == {"input_ids", "attention_mask",
                                        "position_ids"}
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
        n = 64 if kwargs is None else 12
        np.testing.assert_array_equal(got["position_ids"],
                                      np.tile(np.arange(n), (2, 1)))
    assert asked == ["openai/clip-vit-base-patch32"] * 4
