"""Text processors (counterpart of hypervla_tpu/data/text_processing.py).

HFTokenizer wraps a HuggingFace tokenizer when its files are cached
locally; otherwise FallbackTokenizer, a whitespace + hash stand-in with the
same (input_ids, attention_mask) interface, keeps serving runnable on a
host without the files or without `transformers` (the GPU host has
transformers but no tokenizer files).
Its ids come from Python's `hash`, which is salted per process: they agree
within one process, and across processes only under a fixed
PYTHONHASHSEED. With encode_with_model, HFTokenizer runs the tokenizer's
own model (torch's `AutoModel` from the same name or directory, where the
JAX package runs the Flax one) and returns its last hidden state.

MuseEmbedding reads sentence embeddings from a precomputed `.npz` table
and falls back to a unit-norm embedding from a seed of the string's
`hash` (salted too); CLIPTextProcessor runs CLIP's processor and adds
position ids. Only HFTokenizer's model runs torch: the rest is numpy.
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
                 encode_with_model: bool = False, device=None):
        """device is where the model of encode_with_model runs (None: the
        CUDA card, utils/device.py::resolve_device); the tokenizer alone
        reads none."""
        self.tokenizer_kwargs = tokenizer_kwargs or {
            "max_length": 64,
            "padding": "max_length",
            "truncation": True,
            "return_tensors": "np",
        }
        self.encode_with_model = encode_with_model
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
        if self.encode_with_model:
            from transformers import AutoModel

            from hypervla_tpu_torch.utils.device import resolve_device

            self.device = resolve_device(device)
            self.model = AutoModel.from_pretrained(tokenizer_name).to(
                self.device).eval()

    def encode(self, strings: Sequence[str]):
        strings = [s.decode("utf-8") if isinstance(s, bytes) else s
                   for s in strings]
        inputs = self.tokenizer(strings, **self.tokenizer_kwargs)
        if self.encode_with_model:
            import torch

            with torch.no_grad():
                out = self.model(**{
                    k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in inputs.items()})
            return out.last_hidden_state.float().cpu().numpy()
        return dict(inputs)


class MuseEmbedding(TextProcessor):
    """Sentence-level MUSE embeddings from a precomputed table: an .npz
    with `strings` (array of utf-8/bytes) and `embeddings` (N, dim), path
    from `table_path` or $HYPERVLA_MUSE_PATH. Unknown strings fall back to
    a deterministic hash embedding (unit norm) so pipelines keep running; a
    warning is logged once per string."""

    def __init__(self, table_path: Optional[str] = None, dim: int = 512):
        self.dim = dim
        self.table = {}
        path = table_path or os.environ.get("HYPERVLA_MUSE_PATH")
        if path and os.path.exists(path):
            data = np.load(path, allow_pickle=True)
            strings, embeddings = data["strings"], data["embeddings"]
            self.dim = embeddings.shape[-1]
            for s, e in zip(strings, embeddings):
                key = s.decode("utf-8") if isinstance(s, bytes) else str(s)
                self.table[key] = np.asarray(e, np.float32)
        self._warned = set()

    def _fallback(self, s: str) -> np.ndarray:
        rng = np.random.RandomState(np.uint32(hash(s) & 0xFFFFFFFF))
        v = rng.randn(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def encode(self, strings: Sequence[str]) -> np.ndarray:
        out = []
        for s in strings:
            if isinstance(s, bytes):
                s = s.decode("utf-8")
            if s in self.table:
                out.append(self.table[s])
            else:
                if s not in self._warned:
                    logging.warning(
                        f"MuseEmbedding: no precomputed embedding for {s!r}; "
                        "using deterministic hash fallback")
                    self._warned.add(s)
                out.append(self._fallback(s))
        return np.stack(out)


class CLIPTextProcessor(TextProcessor):
    def __init__(self, tokenizer_kwargs: Optional[dict] = None):
        from transformers import CLIPProcessor

        self.processor = CLIPProcessor.from_pretrained(
            "openai/clip-vit-base-patch32")
        self.kwargs = tokenizer_kwargs or {
            "max_length": 64,
            "padding": "max_length",
            "truncation": True,
            "return_tensors": "np",
        }

    def encode(self, strings: Sequence[str]):
        inputs = self.processor(text=strings, **self.kwargs)
        inputs["position_ids"] = np.expand_dims(
            np.arange(inputs["input_ids"].shape[1]), axis=0
        ).repeat(inputs["input_ids"].shape[0], axis=0)
        return inputs
