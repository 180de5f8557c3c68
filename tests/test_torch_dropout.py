"""Dropout at the six sites of the JAX package (hypervla_tpu/models/
hypernetwork.py: image_dropout, embedding_dropout_rate,
final_dropout_rate, the context encoder's dropout_rate and
attention_dropout_rate; hypervla_tpu/models/base_vit.py: the policy ViT's
dropout_rate), on the tiny DINOv2 twin on the CPU, the JAX draws replayed
in the port (tests/test_torch_jax_draws.py::jax_reference, which
tests/test_torch_dropout_step.py holds to the JAX step itself):

  * all six rates at 0.1: the generated params, the loss and every
    gradient of one training step, to 1e-5;
  * each rate alone at 0.1, and image_embedding_noise at 0.1 (the noise
    drawn by JAX): `check_rate`, run by tests/test_torch_dropout_sites.py
    and tests/test_torch_embedding_noise.py;
  * the port's own draws of a step: every site kept at its rate (within 4
    sigma), the same step bit for bit twice, another step otherwise.
"""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.models.hypernetwork import per_sample_view
from hypervla_tpu_torch.train.train_step import to_tensors
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
    with_config,
)

RATE = 0.1
BATCH = 4
#: each rate: (how to set it, the port sites it draws at)
RATES = {
    "image_dropout": (lambda c: c["hypernet_kwargs"].update(
        image_dropout=RATE), ("image_dropout",)),
    "embedding_dropout_rate": (lambda c: c["hypernet_kwargs"].update(
        embedding_dropout_rate=RATE), ("embedding_dropout",)),
    "final_dropout_rate": (lambda c: c["hypernet_kwargs"].update(
        final_dropout_rate=RATE), ("final_dropout/0",)),
    "dropout_rate (context encoder)": (
        lambda c: c["hypernet_kwargs"]["context_encoder_kwargs"].update(
            dropout_rate=RATE),
        ("context_encoder/encoderblock_0/Dropout_0",
         "context_encoder/encoderblock_0/MlpBlock_0/Dropout_0",
         "context_encoder/encoderblock_0/MlpBlock_0/Dropout_1")),
    "attention_dropout_rate": (
        lambda c: c["hypernet_kwargs"]["context_encoder_kwargs"].update(
            attention_dropout_rate=RATE),
        ("context_encoder/encoderblock_0/MultiHeadAttention_0",)),
    "dropout_rate (policy ViT)": (
        lambda c: c["base_net_kwargs"]["vit_kwargs"].update(
            dropout_rate=RATE),
        ("encoder/Dropout_0",
         *(f"encoder/Transformer_0/encoderblock_{i}/{site}"
           for i in range(2) for site in (
               "Dropout_0", "MlpBlock_0/Dropout_0", "MlpBlock_0/Dropout_1")))),
    "image_embedding_noise": (
        lambda c: c["base_net_kwargs"]["vit_kwargs"].update(
            image_embedding_noise=RATE), ("embedding_noise",)),
}
DROPOUT = [k for k in RATES if k != "image_embedding_noise"]


def _all_rates(config):
    for key in DROPOUT:
        RATES[key][0](config)


def _only(key):
    """No rate but `key`'s."""
    def change(config):
        hk = config["hypernet_kwargs"]
        hk.update(image_dropout=0.0, embedding_dropout_rate=0.0,
                  final_dropout_rate=None)
        hk["context_encoder_kwargs"].update(dropout_rate=0.0,
                                            attention_dropout_rate=0.0)
        config["base_net_kwargs"]["vit_kwargs"].update(
            dropout_rate=0.0, image_embedding_noise=0.0)
        RATES[key][0](config)
    return change


def _keys(batch_size):
    """The step's per-sample dropout keys, of a JAX TrainState created
    from PRNGKey(0) (create keeps the key it is given)."""
    import jax

    return dropout_keys(jax.random.PRNGKey(0), batch_size)


def _generated(model, batch, draws):
    """The port's generated base params (per sample) with `draws`."""
    batch = to_tensors(batch, "cpu")
    task = batch["task"]
    with torch.no_grad():
        ctx = model.hypernet.task_context(
            model.params, task, task["language_instruction"][
                "token_embedding"],
            batch["initial_state"]["patch_embeddings"], draws)
        out = model.hypernet.generate(model.params, ctx, draws)
    return {k: v.numpy() for k, v in out.items()
            if model.plan.generation_flag[k]}


def _assert_generated_close(got, ref):
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.fixture(scope="module")
def all_rates():
    return build_pair(_all_rates, batch_size=BATCH)


def test_the_six_rates_are_the_jax_package_dropout_keys():
    from hypervla_tpu_torch.configs import DROPOUT_KEYS

    assert sum(len(v) for v in DROPOUT_KEYS.values()) == len(DROPOUT) == 6


def test_dropout_step_matches_jax(all_rates):
    jmodel, jconfig, model, config, jbatch, batch = all_rates
    ref = jax_reference(jmodel, jconfig, jbatch, _keys(BATCH))
    assert set(ref["sites"]) == {s for key in DROPOUT
                                 for s in RATES[key][1]}
    info, got = port_step_grads(model, config, batch,
                                Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    assert_grads_close(got, ref["grads"])
    _assert_generated_close(
        _generated(model, batch, Draws(replay=ref["sites"])),
        ref["generated"])


def check_rate(pair, key):
    """`key` alone at 0.1 on `pair` (built with the six rates on): the
    replayed sites are that rate's, the per-sample losses and the
    generated params agree with JAX's to 1e-5."""
    jmodel, jconfig, model, config, jbatch, batch = with_config(
        pair, _only(key))
    ref = jax_reference(jmodel, jconfig, jbatch, _keys(BATCH), grad=False)
    assert set(ref["sites"]) == set(RATES[key][1])
    batch_t = to_tensors(batch, "cpu")
    draws = Draws(replay=ref["sites"])
    task = batch_t["task"]
    with torch.no_grad():
        emb = model.base_net.encoder.train_image_embeddings(
            model.shared_params(),
            batch_t["observation"]["image_primary"].squeeze(1), draws)
        ctx = model.hypernet.task_context(
            model.params, task, task["language_instruction"][
                "token_embedding"],
            batch_t["initial_state"]["patch_embeddings"], draws)
        base = model.hypernet.generate(model.params, ctx, draws)
        got, _ = model.base_net.loss(
            per_sample_view(model.plan, base), batch_t, emb,
            task["language_instruction"]["token_embedding"].float(), draws)
    np.testing.assert_allclose(got.numpy(), ref["losses"], rtol=1e-5,
                               atol=1e-6)
    _assert_generated_close(
        {k: v.numpy() for k, v in base.items()
         if model.plan.generation_flag[k]}, ref["generated"])


def test_port_draws_keep_their_rates_and_repeat_by_step(all_rates):
    _, _, model, config, _, batch = all_rates

    def draws_of(step):
        draws = Draws(draws_generator(5, step, "cpu"), record=True)
        _generated(model, batch, draws)
        model.base_net.loss(
            per_sample_view(model.plan, model.hypernet.generate(
                model.params, model.hypernet.task_context(
                    model.params, to_tensors(batch, "cpu")["task"],
                    torch.as_tensor(batch["task"]["language_instruction"][
                        "token_embedding"]),
                    torch.as_tensor(batch["initial_state"][
                        "patch_embeddings"])))),
            to_tensors(batch, "cpu"), None, None, draws)
        return draws.drawn

    a, b, c = draws_of(3), draws_of(3), draws_of(4)
    assert set(a) == {s for key in DROPOUT for s in RATES[key][1]}
    for site, mask in a.items():
        n = mask.numel()
        kept = float(mask.float().mean())
        assert abs(kept - (1 - RATE)) <= 4 * (RATE * (1 - RATE) / n) ** .5, (
            site, kept, n)
        assert torch.equal(mask, b[site]), site
    assert any(not torch.equal(a[s], c[s]) for s in a)
