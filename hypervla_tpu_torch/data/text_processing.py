"""Text tokenization (copy of hypervla_tpu/data/text_processing.py; numpy
only).

HFTokenizer wraps a HuggingFace tokenizer when its files are cached
locally; otherwise FallbackTokenizer, a whitespace + hash stand-in with the
same (input_ids, attention_mask) interface, keeps serving runnable on a
host without the files or without `transformers` (the GPU host has none).
Its ids come from Python's `hash`, which is salted per process: they agree
within one process, and across processes only under a fixed
PYTHONHASHSEED.

Not carried yet (ROADMAP.md A12, breadth): encoding with the tokenizer's own
model (`encode_with_model`), MuseEmbedding and CLIPTextProcessor.
"""
import logging
import os
from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np


class TextProcessor(ABC):
    @abstractmethod
    def encode(self, strings: Sequence[str]):
        raise NotImplementedError


class FallbackTokenizer:
    """Deterministic whitespace+hash tokenizer standing in for a missing
    pretrained tokenizer. Matches the (input_ids, attention_mask)
    interface."""

    def __init__(self, vocab_size: int = 32000, eos_id: int = 1,
                 pad_id: int = 0):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.pad_id = pad_id

    def __call__(self, strings, max_length=32, padding="max_length",
                 truncation=True, return_tensors="np", **kwargs):
        if isinstance(strings, (str, bytes)):
            strings = [strings]
        ids = np.full((len(strings), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(strings), max_length), dtype=np.int32)
        for row, s in enumerate(strings):
            if isinstance(s, bytes):
                s = s.decode("utf-8")
            tokens = [2 + (hash(w) % (self.vocab_size - 2))
                      for w in s.lower().split()]
            tokens = tokens[: max_length - 1] + [self.eos_id]
            ids[row, : len(tokens)] = tokens
            mask[row, : len(tokens)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HFTokenizer(TextProcessor):
    def __init__(self, tokenizer_name: str,
                 tokenizer_kwargs: Optional[dict] = None,
                 encode_with_model: bool = False):
        if encode_with_model:
            raise NotImplementedError(
                "HFTokenizer encode_with_model=True is not ported (ROADMAP.md "
                "A12, breadth): it runs the tokenizer's own Flax model")
        self.tokenizer_kwargs = tokenizer_kwargs or {
            "max_length": 64,
            "padding": "max_length",
            "truncation": True,
            "return_tensors": "np",
        }
        try:
            # fail fast when files aren't cached locally: no network retries
            os.environ.setdefault("HF_HUB_OFFLINE", "1")
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                tokenizer_name, local_files_only=True)
        except Exception as e:
            logging.warning(
                f"Could not load tokenizer {tokenizer_name} ({e}); "
                "using deterministic fallback tokenizer.")
            self.tokenizer = FallbackTokenizer()

    def encode(self, strings: Sequence[str]):
        strings = [s.decode("utf-8") if isinstance(s, bytes) else s
                   for s in strings]
        return dict(self.tokenizer(strings, **self.tokenizer_kwargs))
