"""The training step (counterpart of hypervla_tpu/train/train_step.py) for
the flagship path: in-step frozen T5 embed of the instruction (with the
"replace" rephrase strategy) and frozen DINOv2 encode of the initial image,
the shared DINOv2 trunk run once over the whole batch (the JAX package's
`hoist_shared_trunk` layout, which tests/test_hoist_trunk.py pins equal to
its per-sample vmap), the hypernetwork and the per-sample base-net loss with
the sample axis written out, its batch mean, backward, the optimizer, and
the EMA of the params.

The per-task losses of the trainer's drawer tasks (`task_index`) and
device augmentation (dataset_kwargs device_augment: ops/preprocess.py::
fused_resize_augment over each camera's frames on the card, drawn from a
generator seeded by the state's seed and step) are the JAX step's. The
configured paths that the flagship fast preset does not take raise
NotImplementedError: delta-decay, the v4 weight decay, the attention aux
losses and embedding noise (ROADMAP.md A8, the rest of the train step),
and the trunk switches with no counterpart
(models/base_vit.py::check_trunk_switches). The layer-kernel trunk
(vit_kwargs dino_layers_impl="pallas_train") needs
config["hoist_shared_trunk"], as in the JAX package. vit_kwargs
dino_fused_add_ln runs every residual boundary of the trunk through
ops/add_layer_norm.py, forward and backward; the frozen encoder does not
take that switch (it takes fused_layer_norm, as the JAX trainer's does).
"""
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hypervla_tpu_torch.configs import refuse_dropout
from hypervla_tpu_torch.models.base_vit import check_trunk_switches
from hypervla_tpu_torch.models.hypernetwork import per_sample_view
from hypervla_tpu_torch.ops.preprocess import fused_resize_augment
from hypervla_tpu_torch.train.optimizer import global_norm
from hypervla_tpu_torch.train.train_state import TrainState


def to_tensors(tree, device):
    """A nested dict of numpy arrays (or tensors) -> the same nesting of
    tensors on `device`; arrays of strings stay as they are."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.asarray(tree)
    if arr.dtype.kind in "biuf":
        return torch.as_tensor(arr, device=device)
    return tree


def _check_layer_kernel_hoist(config: Dict[str, Any]) -> None:
    """The JAX package's contract (hypervla_tpu/train/train_step.py): the
    layer kernel sums its weight gradients over the batch, which exists only
    where the shared trunk runs once over the whole batch, outside the
    per-sample loss. This step always runs the trunk so; it still holds a
    config to the same conditions, so that one config means one thing in
    both packages."""
    vk = config["base_net_kwargs"]["vit_kwargs"]
    if vk.get("dino_layers_impl") != "pallas_train":
        return
    shared = tuple(config["hypernet_kwargs"].get("shared_modules") or ())
    hoist = bool(
        config.get("hoist_shared_trunk", False)
        and config["base_net_kwargs"].get("model_type") == "vit"
        and vk.get("encoder_type") == "DINOv2"
        and float(vk.get("image_embedding_noise", 0.0)) == 0.0
        and not vk.get("sow_dino_attention", False)
        and "image_encoder" in shared)
    if not hoist:
        raise ValueError(
            "dino_layers_impl='pallas_train' requires the hoisted trunk: "
            "set config['hoist_shared_trunk']=True (and keep "
            "sow_dino_attention=False, image_embedding_noise=0, "
            "image_encoder shared)")


def _unported(config: Dict[str, Any], pretrained_params) -> None:
    vk = config["base_net_kwargs"]["vit_kwargs"]
    check_trunk_switches(vk)
    hk = config["hypernet_kwargs"]
    refuse_dropout("hypernet_kwargs", hk)
    refuse_dropout("hypernet_kwargs context_encoder_kwargs",
                   hk.get("context_encoder_kwargs", {}))
    refuse_dropout("vit_kwargs", vk)
    aux = config["auxiliary_loss"]
    opt = config["optimizer"]
    rest = "A8, the rest of the train step"
    checks = {
        "delta-decay toward pretrained params": (rest, 
            pretrained_params is not None
            and vk.get("fine_tune_pretrained_image_encoder", False)
            and opt.get("base_weight_decay", 0.0) > 0),
        "weight_decay_strategy v4": (
            rest, opt.get("weight_decay_strategy", "v1") == "v4"),
        "auxiliary_loss attention_entropy": (
            rest, aux.get("attention_entropy", 0.0) > 0.0),
        "auxiliary_loss attention_map_alignment": (
            rest, aux.get("attention_map_alignment", 0.0) > 0.0),
        "vit_kwargs image_embedding_noise": (
            rest, float(vk.get("image_embedding_noise", 0.0)) > 0.0),
    }
    for name, (item, bad) in checks.items():
        if bad:
            raise NotImplementedError(
                f"train step: {name} is not ported yet (ROADMAP.md {item})")


def augment_specs(config: Dict[str, Any]) -> Dict[str, dict]:
    """{camera: augment kwargs} that the step applies on the card: empty
    unless dataset_kwargs device_augment is set (then the host pipeline
    only decodes and resizes, train/trainer.py::make_train_datasets)."""
    dk = config.get("dataset_kwargs", {})
    ak = dk.get("image_augment_kwargs") or {}
    if not (dk.get("device_augment", False) and ak):
        return {}
    return {"primary": ak} if "augment_order" in ak else dict(ak)


def augment_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a step's device augmentation: one stream for each
    (seed, step), so that a run repeats bit for bit and a resumed run draws
    what the uninterrupted one would have."""
    gen = torch.Generator(device=device)
    return gen.manual_seed(int(seed) * 1_000_003 + int(step))


def device_augment(batch, specs: Dict[str, dict], generator) -> None:
    """Runs fused_resize_augment over each camera's flattened (B * window)
    frames of batch["observation"], in place, drawing from `generator`."""
    obs = batch["observation"]
    for cam, kw in specs.items():
        key = f"image_{cam}"
        if key not in obs:
            continue
        imgs = obs[key]
        flat = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        flat = fused_resize_augment(flat, tuple(flat.shape[1:3]), dict(kw),
                                    train=True, generator=generator)
        obs[key] = flat.reshape(imgs.shape)


def make_train_step(model, config: Dict[str, Any], tx,
                    lr_callable: Callable, base_lr_callable: Callable,
                    param_norm_callable: Callable,
                    text_encode: Optional[Callable] = None,
                    dino_encode: Optional[Callable] = None,
                    pretrained_params=None):
    """Returns train_step(state, batch, task_index=None, encoder_params=None,
    with_metrics=True) -> (new_state, info). task_index {task: (B,) 0/1
    mask} adds info["task_loss_<task>"], the mean loss of the masked
    samples (0 where none is).

    text_encode(t5_params, input_ids, attention_mask) and
    dino_encode(dino_params, images) are the frozen encoders of
    train/trainer.py::build_frozen_encoders; their params arrive per call in
    encoder_params["t5"] and ["dino"]. Without them the batch must carry
    the instruction's token_embedding and the initial image's
    patch_embeddings. The new state's params are new tensors; the old
    state is left as it was."""
    del base_lr_callable  # only delta-decay reads it, which is not ported
    _check_layer_kernel_hoist(config)
    _unported(config, pretrained_params)
    hk = config["hypernet_kwargs"]
    use_initial_image = hk.get("use_initial_image", False)
    rephrase = config["auxiliary_loss"].get("rephrase_strategy")
    ema_decay = config.get("EMA_decay", 0.999)
    ema_start = config.get("EMA_start_step", 0)
    plan = model.plan
    encoder = model.base_net.encoder
    aug_specs = augment_specs(config)

    def train_step(state: TrainState, batch, task_index=None,
                   encoder_params=None, with_metrics: bool = True):
        encoder_params = encoder_params or {}
        batch = to_tensors(batch, model.device)
        if aug_specs:  # to_tensors made the batch's dicts anew
            device_augment(batch, aug_specs, augment_generator(
                state.seed, state.step, model.device))
        instr = dict(batch["task"]["language_instruction"])
        patches = (batch.get("initial_state") or {}).get("patch_embeddings")
        with torch.no_grad():
            if text_encode is not None:
                if rephrase == "replace" and "rephrased_task" in batch:
                    instr = dict(
                        batch["rephrased_task"]["language_instruction"])
                instr["token_embedding"] = text_encode(
                    encoder_params["t5"], instr["input_ids"],
                    instr["attention_mask"])
            if use_initial_image and dino_encode is not None:
                patches = dino_encode(
                    encoder_params["dino"],
                    batch["initial_state"]["image_primary"].squeeze(1))
        if "token_embedding" not in instr:
            raise ValueError(
                "batch has no task token_embedding and no text_encode was "
                "passed to make_train_step: give the batch its embeddings "
                "or the frozen T5 (trainer.build_frozen_encoders)")
        if use_initial_image and patches is None:
            raise ValueError(
                "batch has no initial_state patch_embeddings and no "
                "dino_encode was passed to make_train_step: give the batch "
                "its embeddings or the frozen DINOv2 "
                "(trainer.build_frozen_encoders)")

        params = state.params
        for p in params.values():
            p.grad = None
        # the shared trunk, batched over the whole batch (hoisted)
        with torch.set_grad_enabled(encoder.fine_tune):
            emb = encoder.train_image_embeddings(
                model.shared_params(params=params),
                batch["observation"]["image_primary"].squeeze(1))
        # the hypernetwork and the per-sample loss, sample axis written out
        ctx = model.hypernet.context_embedding(
            params, instr["token_embedding"].float(),
            instr["attention_mask"],
            batch["task"]["pad_mask_dict"]["language_instruction"],
            None if patches is None else patches.float())
        generated = model.hypernet.generate(params, ctx)
        losses, metrics = model.base_net.loss(
            per_sample_view(plan, generated), batch, emb)
        loss = losses.mean()
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}

        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, params)
            info = {"training_loss": loss.detach(),
                    "learning_rate": lr_callable(state.step)}
            if with_metrics:
                info.update(grad_norm=global_norm(grads),
                            update_norm=global_norm(updates),
                            param_norm=param_norm_callable(params))
            for name, mask in (task_index or {}).items():
                mask = torch.as_tensor(mask, device=losses.device).float()
                info[f"task_loss_{name}"] = (
                    (losses.detach() * mask).sum() / mask.sum().clamp(min=1))
            info.update({k: v.detach().mean() for k, v in metrics.items()})
            info["base_params_norm"] = _base_params_norm(plan, generated)
            new_params = {k: (p.detach() + updates[k]).requires_grad_(True)
                          for k, p in params.items()}
            ema = state.ema_params
            if ema is not None:
                started = state.step >= ema_start
                ema = {k: (ema_decay * e + (1.0 - ema_decay)
                           * new_params[k].detach()) if started
                       else new_params[k].detach().clone()
                       for k, e in ema.items()}
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=opt_state, ema_params=ema,
                          seed=state.seed), info

    return train_step


def _base_params_norm(plan, generated):
    """Mean over samples of each sample's base-net param norm (its
    generated blocks and the shared ones)."""
    shared = sum((v.float() ** 2).sum() for n, v in generated.items()
                 if not plan.generation_flag[n])
    per_sample = sum((v.float() ** 2).flatten(1).sum(1)
                     for n, v in generated.items()
                     if plan.generation_flag[n])
    return torch.sqrt(per_sample + shared).mean()
