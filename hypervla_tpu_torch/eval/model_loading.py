"""Eval-side model loading (counterpart of
hypervla_tpu/eval/model_loading.py).

`load_hypervla_policy` builds an InferenceWrapper from a checkpoint in the
port's format (models/hypervla.py; tools/convert_checkpoint_to_torch.py
writes it from a JAX checkpoint), with the EMA params swapped in where the
step directory has them; `build_text_encoder` returns the instruction
encoder: tokenizer -> T5 -> token embeddings.
"""
import logging
import os
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.data.text_processing import HFTokenizer
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.models.encoders.pretrained import load_t5_weights
from hypervla_tpu_torch.models.encoders.t5 import (
    t5_config,
    t5_encode,
    t5_specs,
)
from hypervla_tpu_torch.models.hypervla import (
    EMA_FILE,
    HyperVLA,
    check_params,
    latest_step,
)
from hypervla_tpu_torch.models.layers import init_params
from hypervla_tpu_torch.utils.device import resolve_device

#: the instruction length of a model whose example batch has no input ids
DEFAULT_MAX_LENGTH = 32


def load_hypervla_policy(
    checkpoint_path: str,
    step: Optional[int] = None,
    policy_setup: str = "google_robot",
    image_size: int = 224,
    action_ensemble: bool = True,
    crop: bool = True,
    ema_decay: Optional[float] = 0.999,
    horizon: int = 1,
    device=None,
    fused_serving: bool = False,
    trunk_impl=None,
):
    """Loads a checkpoint into a closed-loop InferenceWrapper on `device`
    (None: the CUDA card): by default the host path, as the JAX function
    builds it, or with fused_serving the fused serving step; either runs
    the trunk as trunk_impl says (eval/inference.py; None: the stacked
    trunk kernel for a DINOv2 model, nothing for a generated conv stem).
    With ema_decay set,
    the params of <step>/EMA_params.pt under the key "EMA_<ema_decay>"
    replace the trained ones; step None reads the latest step directory
    that has an EMA file."""
    device = resolve_device(device)
    model = HyperVLA.load_pretrained(checkpoint_path, step=step,
                                     device=device)
    if ema_decay is not None:
        ema_step = step if step is not None else latest_step(
            checkpoint_path, EMA_FILE)
        ema_path = os.path.join(checkpoint_path, str(ema_step), EMA_FILE)
        if ema_step is not None and os.path.exists(ema_path):
            ema_params = torch.load(ema_path, map_location=device,
                                    weights_only=True)
            key = f"EMA_{ema_decay}"
            if key in ema_params:
                logging.info(f"Using {key} parameters from {ema_path}")
                check_params(ema_params[key], {
                    k: (v.shape, None) for k, v in model.params.items()})
                model = model.replace(params=ema_params[key])

    action_horizon = model.config["base_net_kwargs"]["action_horizon"]
    return InferenceWrapper(
        model=model,
        policy_setup=policy_setup,
        horizon=horizon,
        pred_action_horizon=action_horizon,
        image_size=image_size,
        action_ensemble=action_ensemble,
        crop=crop,
        fused_serving=fused_serving,
        trunk_impl=trunk_impl,
    )


def build_text_encoder(model, tokenizer_name: str = "t5-base",
                       max_length: Optional[int] = None, device=None):
    """Returns encode(str | list[str]) -> instruction dict (numpy
    input_ids, attention_mask, token_embedding) through the port's T5 on
    `device` (None: the model's device, else the CUDA card).

    max_length defaults to the instruction length of model.example_batch:
    the hypernetwork's task position embedding is sized to it. Without
    pretrained weights (models/encoders/pretrained.py) T5 is drawn from
    seed 0 by a torch.Generator, an init that cannot equal the JAX
    package's PRNGKey(0) one."""
    if max_length is None:
        try:
            max_length = int(model.example_batch["task"][
                "language_instruction"]["input_ids"].shape[-1])
        except (AttributeError, KeyError, TypeError):
            max_length = DEFAULT_MAX_LENGTH
    if device is None:
        device = getattr(model, "device", None)
    device = resolve_device(device)

    tokenizer = HFTokenizer(
        tokenizer_name=tokenizer_name,
        tokenizer_kwargs={
            "max_length": max_length,
            "padding": "max_length",
            "truncation": True,
            "return_tensors": "np",
        },
    )
    config = t5_config(tokenizer_name)
    params = load_t5_weights(tokenizer_name, device=device)
    if params is None:
        params = init_params(t5_specs(config), 0, device)

    @torch.no_grad()
    def encode(strings):
        if isinstance(strings, (str, bytes)):
            strings = [strings]
        tokens = tokenizer.encode(strings)
        embedding = t5_encode(
            config, params,
            torch.as_tensor(tokens["input_ids"], device=device),
            torch.as_tensor(tokens["attention_mask"], device=device))
        return {
            "language_instruction": {
                "input_ids": tokens["input_ids"],
                "attention_mask": tokens["attention_mask"],
                "token_embedding": np.asarray(embedding.cpu()),
            }
        }

    return encode
