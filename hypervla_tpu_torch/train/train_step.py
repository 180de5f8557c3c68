"""The training step (counterpart of hypervla_tpu/train/train_step.py):
in-step frozen T5 embed of the instruction (with the "replace" rephrase
strategy) and frozen DINOv2 encode of the initial image, the hypernetwork
and the per-sample base-net loss with the sample axis written out (the JAX
step vmaps it over the per-sample generated params), its batch mean,
backward, the optimizer, and the EMA of the params. A shared DINOv2 or CLIP
trunk runs once over the whole batch (the JAX package's
`hoist_shared_trunk` layout, which tests/test_hoist_trunk.py pins equal to
its per-sample vmap); a Siglip policy reads the batch's observation
patch_embeddings; a shared EfficientNet runs over the whole batch inside
the loss, its stochastic depth drawn per sample;
a generated image encoder (SmallStem, PatchEncoder) runs per sample inside
the loss, its convolutions grouped by sample (models/layers.py::conv2d),
as the JAX step does without the hoist.

The per-task losses of the trainer's drawer tasks (`task_index`) and
device augmentation (dataset_kwargs device_augment: ops/preprocess.py::
fused_resize_augment over each camera's frames on the card, drawn from a
generator seeded by the state's seed and step) are the JAX step's, and so
are the two extra weight-decay terms: delta-decay of the fine-tuned trunk
toward `pretrained_params` and the v4 weight decay (the clipped gradient
of 0.5 * sum(kernel ** 2) over the generated base-net params), and so
are the regularisers: dropout at every site of the hypernetwork and the
policy ViT and the trunk's embedding noise, drawn from a generator of the
state's (seed, step) (models/draws.py), and the two attention aux losses
on the policy ViT's last attention map (`aux_losses`): its entropy and,
annealed over the run, its alignment to the batch's
observation DINO_last_layer_attention_map. The trunk switches with no
counterpart raise NotImplementedError
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

from hypervla_tpu_torch.models.base_vit import check_trunk_switches
from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.models.hypernetwork import per_sample_view
from hypervla_tpu_torch.ops.preprocess import (
    fused_resize_augment,
    sample_augment_params,
)
from hypervla_tpu_torch.parallel.mesh import batch_rows
from hypervla_tpu_torch.parallel.sharded import layout_for
from hypervla_tpu_torch.train.optimizer import global_norm
from hypervla_tpu_torch.train.train_state import TrainState

_F = np.float32


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
        and vk.get("encoder_type") in ("DINOv2", "CLIP")
        and float(vk.get("image_embedding_noise", 0.0)) == 0.0
        and not vk.get("sow_dino_attention", False)
        and "image_encoder" in shared)
    if not hoist:
        raise ValueError(
            "dino_layers_impl='pallas_train' requires the hoisted trunk: "
            "set config['hoist_shared_trunk']=True (and keep "
            "sow_dino_attention=False, image_embedding_noise=0, "
            "image_encoder shared)")


#: the batch's reference map of the alignment aux loss
REFERENCE_MAP = "DINO_last_layer_attention_map"


def aux_losses(config: Dict[str, Any], losses, maps: dict, batch,
               step: int):
    """The attention aux losses of hypervla_tpu/train/train_step.py
    (:166-190) on the policy ViT's last attention map (B, heads, L, L):
    per sample, the attention_entropy coefficient times the mean over heads
    of the last row's entropy (log(p + 1e-8)), and the
    attention_map_alignment coefficient, annealed by 1 - step / num_steps,
    times the mean square between the head-mean of the last row without
    itself and the head-mean of the batch's reference map's
    [:, :, 0, 1:] (the class token's row without itself), each added to
    the per-sample losses (B,) in that order. Returns (losses,
    {metric: (B,)})."""
    aux = config["auxiliary_loss"]
    metrics = {}
    if not (aux.get("attention_entropy", 0.0) > 0.0
            or aux.get("attention_map_alignment", 0.0) > 0.0):
        return losses, metrics
    attention_map = maps["policy"][-1]
    if aux.get("attention_entropy", 0.0) > 0.0:
        prob = attention_map[:, :, -1]
        per_head = -(prob * torch.log(prob + 1e-8)).sum(-1)
        entropy = per_head.mean(-1)
        losses = losses + float(_F(aux["attention_entropy"])) * entropy
        metrics["attention_entropy_loss"] = entropy.detach()
    if aux.get("attention_map_alignment", 0.0) > 0.0:
        observation = batch["observation"]
        if REFERENCE_MAP not in observation:
            raise KeyError(REFERENCE_MAP)
        policy = attention_map[:, :, -1, :-1]
        reference = observation[REFERENCE_MAP][:, :, 0, 1:].float().detach()
        alignment = ((policy.mean(1) - reference.mean(1)) ** 2).mean(-1)
        annealing = _F(1.0) - _F(step) / _F(config.get("num_steps", 100000))
        losses = losses + float(
            annealing * _F(aux["attention_map_alignment"])) * alignment
        metrics["attention_alignment_loss"] = alignment.detach()
    return losses, metrics


def _check_aux(config: Dict[str, Any]) -> None:
    """The aux losses read the policy ViT's attention map, which the JAX
    ViT returns only with return_attention_map or differential attention
    (else 0.0, which the JAX step fails to index with a TypeError)."""
    aux = config["auxiliary_loss"]
    vk = config["base_net_kwargs"]["vit_kwargs"]
    wanted = (aux.get("attention_entropy", 0.0) > 0.0
              or aux.get("attention_map_alignment", 0.0) > 0.0)
    if wanted and not (vk.get("return_attention_map", False)
                       or vk.get("use_differential_transformer", False)):
        raise TypeError(
            "auxiliary_loss attention_entropy / attention_map_alignment "
            "read the policy ViT's attention map: set vit_kwargs "
            "return_attention_map=True")


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


def device_augment(batch, specs: Dict[str, dict], generator,
                   rows: Optional[tuple] = None) -> None:
    """Runs fused_resize_augment over each camera's flattened (B * window)
    frames of batch["observation"], in place, drawing from `generator`.
    rows, (first, last, total) of a rank's rows of the global batch
    (parallel/mesh.py::batch_rows): the draws are made for the whole batch
    and the rank's frames take theirs."""
    obs = batch["observation"]
    for cam, kw in specs.items():
        key = f"image_{cam}"
        if key not in obs:
            continue
        imgs = obs[key]
        flat = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        params = None
        if rows is not None:
            first, last, total = rows
            per_row = flat.shape[0] // (last - first)
            params = {op: {k: v[first * per_row:last * per_row]
                           for k, v in drawn.items()}
                      for op, drawn in sample_augment_params(
                          total * per_row, generator=generator,
                          **dict(kw)).items()}
        flat = fused_resize_augment(flat, tuple(flat.shape[1:3]), dict(kw),
                                    train=True, params=params,
                                    generator=generator)
        obs[key] = flat.reshape(imgs.shape)


def make_train_step(model, config: Dict[str, Any], tx,
                    lr_callable: Callable, base_lr_callable: Callable,
                    param_norm_callable: Callable,
                    text_encode: Optional[Callable] = None,
                    dino_encode: Optional[Callable] = None,
                    pretrained_params=None, mesh=None):
    """Returns train_step(state, batch, task_index=None, encoder_params=None,
    with_metrics=True, draws=None) -> (new_state, info). task_index {task:
    (B,) 0/1 mask} adds info["task_loss_<task>"], the mean loss of the
    masked samples (0 where none is). draws (models/draws.py::Draws) are
    the step's dropout masks and noise, by default drawn from
    draws_generator(state.seed, state.step).

    text_encode(t5_params, input_ids, attention_mask) and
    dino_encode(dino_params, images) are the frozen encoders of
    train/trainer.py::build_frozen_encoders; their params arrive per call in
    encoder_params["t5"] and ["dino"]. Without them the batch must carry
    the instruction's token_embedding and the initial image's
    patch_embeddings. The new state's params are new tensors; the old
    state is left as it was.

    pretrained_params: a (partial) tree of the pretrained image encoder's
    params in the JAX nesting; where vit_kwargs
    fine_tune_pretrained_image_encoder and optimizer base_weight_decay > 0
    hold, every step adds base_lr(step) * base_weight_decay * the
    pretrained value to the matching shared param's update (delta-decay),
    optimizer update or not. weight_decay_strategy "v4" reads
    auxiliary_loss base_weight_decay (a KeyError without it) and logs
    info["base_weight_decay_grad_norm"].

    mesh (parallel/mesh.py::create_mesh) of more than one rank: the state
    holds this rank's shards (parallel/sharded.py::ShardLayout.shard_state)
    and the batch this rank's rows (parallel/mesh.py::shard_batch). The
    step gathers the params, runs its rows, reduces the gradients before
    the optimizer, so that the clip sees the global gradient, and reports
    global-batch means and per-task losses (a global sum over a global
    count), the same on every rank; every draw is made at the global
    batch's shape and sliced to the rank's rows, so that the ranks together
    take the step one process takes on the whole batch. The step's
    `layout` attribute is its parallel/sharded.py::ShardLayout (None on one
    process)."""
    _check_layer_kernel_hoist(config)
    check_trunk_switches(config["base_net_kwargs"]["vit_kwargs"])
    _check_aux(config)
    hk = config["hypernet_kwargs"]
    vk = config["base_net_kwargs"]["vit_kwargs"]
    opt_cfg = config["optimizer"]
    aux = config["auxiliary_loss"]
    use_initial_image = hk.get("use_initial_image", False)
    rephrase = aux.get("rephrase_strategy")
    ema_decay = config.get("EMA_decay", 0.999)
    ema_start = config.get("EMA_start_step", 0)
    plan = model.plan
    encoder = model.base_net.encoder
    aug_specs = augment_specs(config)
    capture_maps = (aux.get("attention_entropy", 0.0) > 0.0
                    or aux.get("attention_map_alignment", 0.0) > 0.0)
    delta_decay = None
    layout = layout_for(mesh, model.params)
    if pretrained_params is not None:
        targets = _delta_decay_targets(plan, pretrained_params, model.device)
        if (vk.get("fine_tune_pretrained_image_encoder", False)
                and opt_cfg.get("base_weight_decay", 0.0) > 0):
            delta_decay = targets
            if layout is not None:
                delta_decay = [(name, layout.shard(name, value.view(
                    layout.shapes[name]))) for name, value in targets]
    v4 = opt_cfg.get("weight_decay_strategy", "v1") == "v4"
    if v4:
        if "base_weight_decay" not in aux:
            raise KeyError(
                "weight_decay_strategy v4 reads auxiliary_loss."
                "base_weight_decay, which the config does not set")
        wd_clip = opt_cfg["clip_gradient"]
        wd_coef = aux["base_weight_decay"]

    def train_step(state: TrainState, batch, task_index=None,
                   encoder_params=None, with_metrics: bool = True,
                   draws: Optional[Draws] = None):
        encoder_params = encoder_params or {}
        batch = to_tensors(batch, model.device)
        rows = batch_rows(mesh, batch["action"].shape[0])
        if draws is None:
            draws = Draws(draws_generator(state.seed, state.step,
                                          model.device), rows=rows)
        if aug_specs:  # to_tensors made the batch's dicts anew
            device_augment(batch, aug_specs, augment_generator(
                state.seed, state.step, model.device), rows)
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

        params = (state.params if layout is None
                  else layout.gather_params(state.params))
        for p in params.values():
            p.grad = None
        emb = None
        if encoder.batched_encoder:
            # the shared trunk, batched over the whole batch (hoisted)
            with torch.set_grad_enabled(encoder.fine_tune):
                emb = encoder.train_image_embeddings(
                    model.shared_params(params=params),
                    batch["observation"]["image_primary"].squeeze(1), draws)
        elif encoder.encoder_type == "Siglip":
            emb = batch["observation"]["patch_embeddings"]
        # the hypernetwork and the per-sample loss, sample axis written out
        ctx = model.hypernet.task_context(
            params, dict(batch["task"], language_instruction=instr),
            instr["token_embedding"], patches, draws)
        generated = model.hypernet.generate(
            params, ctx, draws,
            fanout=None if layout is None else layout.fanout)
        maps = {} if capture_maps else None
        losses, metrics = model.base_net.loss(
            per_sample_view(plan, generated), batch, emb,
            instr["token_embedding"].float(), draws, maps)
        losses, aux_metrics = aux_losses(config, losses, maps, batch,
                                         state.step)
        metrics.update(aux_metrics)
        n_global = losses.shape[0] if rows is None else rows[2]
        if layout is None:
            loss = losses.mean()
        else:  # the rank's share of the global batch mean
            loss = losses.sum() / n_global
        wd_grads = None
        if v4:
            # a second backward over the same generated params, into its
            # own gradients, before the loss's frees the graph
            wd_grads = _weight_decay_grads(plan, generated, params,
                                           None if layout is None
                                           else n_global)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        norm = global_norm
        if layout is not None:
            grads = layout.reduce_grads(grads)
            if v4:
                wd_grads = layout.reduce_grads(wd_grads)
            norm = layout.global_norm
            params = state.params

        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, params,
                                           norm=norm)
            info = {}
            if delta_decay is not None:
                # pull the fine-tuned trunk toward its pretrained values
                coef = float(_F(base_lr_callable(state.step))
                             * _F(opt_cfg["base_weight_decay"]))
                for name, value in delta_decay:
                    updates[name] = updates[name] + coef * value
            if v4:
                wd_norm = norm(wd_grads)
                scale = torch.clamp(wd_norm, max=wd_clip)
                coef = float(_F(lr_callable(state.step)) * _F(wd_coef))
                updates = {k: u - coef * (wd_grads[k] / wd_norm * scale)
                           for k, u in updates.items()}
                info["base_weight_decay_grad_norm"] = wd_norm
            means = {"training_loss": losses.detach(),
                     **{k: v.detach() for k, v in metrics.items()},
                     "base_params_norm": _base_params_norms(plan,
                                                            generated)}
            masks = {name: torch.as_tensor(mask, device=losses.device
                                           ).float()
                     for name, mask in (task_index or {}).items()}
            if layout is None:
                stats = {k: v.mean() for k, v in means.items()}
                tasks = {name: ((losses.detach() * mask).sum(), mask.sum())
                         for name, mask in masks.items()}
            else:
                stats, tasks = _global_stats(layout, means, masks,
                                             losses.detach(), n_global)
            info["training_loss"] = stats.pop("training_loss")
            info["learning_rate"] = lr_callable(state.step)
            if with_metrics:
                info.update(grad_norm=norm(grads),
                            update_norm=norm(updates),
                            param_norm=param_norm_callable(params,
                                                           norm=norm))
            for name, (total, count) in tasks.items():
                info[f"task_loss_{name}"] = total / count.clamp(min=1)
            base_norm = stats.pop("base_params_norm")
            info.update(stats)
            info["base_params_norm"] = base_norm
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

    train_step.layout = layout
    return train_step


def _delta_decay_targets(plan, pretrained_params, device):
    """[(hypernet param name, flat fp32 pretrained value)] of a (partial)
    pretrained image-encoder tree in the JAX nesting, e.g. {"embeddings":
    {"cls_token": array}}, each leaf mapped through the plan's flat-name
    table under its pretrained block path."""
    if plan.pretrained_block_path is None:
        raise ValueError(
            "pretrained_params given but the WeightPlan has no pretrained "
            "image-encoder block (encoder_type must be DINOv2 or CLIP for "
            "delta-decay)")
    names = plan.flat_name_table()
    for key in plan.pretrained_block_path:
        names = names[key]
    out = []

    def walk(tree, table):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, table[key])
            else:
                if not isinstance(value, torch.Tensor):
                    value = torch.tensor(np.asarray(value))
                out.append((table[key],
                            value.to(device, torch.float32).reshape(-1)))

    walk(pretrained_params, names)
    return out


def _weight_decay_grads(plan, generated, params, n_global=None):
    """The v4 weight decay's gradient: of the batch mean of each sample's
    0.5 * sum(kernel ** 2) over the base-net params whose path holds
    "kernel" (generated ones per sample, shared ones whole), with respect
    to every hypernetwork param (zeros where it does not reach). n_global:
    on a mesh, the global batch size, of whose mean this rank's rows give
    their share."""
    per_sample = sum((v.float() ** 2).flatten(1).sum(1)
                     for n, v in generated.items()
                     if "kernel" in n and plan.generation_flag[n])
    shared = sum((v.float() ** 2).sum() for n, v in generated.items()
                 if "kernel" in n and not plan.generation_flag[n])
    if n_global is None:
        wd_loss = 0.5 * (per_sample + shared).mean()
    else:
        wd_loss = 0.5 * (per_sample + shared).sum() / n_global
    names = list(params)
    grads = torch.autograd.grad(wd_loss, [params[n] for n in names],
                                retain_graph=True, allow_unused=True)
    return {n: g if g is not None else torch.zeros_like(params[n])
            for n, g in zip(names, grads)}


def _base_params_norms(plan, generated):
    """Each sample's base-net param norm (its generated blocks and the
    shared ones), (B,)."""
    shared = sum((v.float() ** 2).sum() for n, v in generated.items()
                 if not plan.generation_flag[n])
    per_sample = sum((v.float() ** 2).flatten(1).sum(1)
                     for n, v in generated.items()
                     if plan.generation_flag[n])
    return torch.sqrt(per_sample + shared)


def _global_stats(layout, means, masks, losses, n_global):
    """({name: global-batch mean} of per-sample values (B_rank,),
    {task: (global masked loss sum, global mask count)}), summed over the
    rows' ranks in one collective."""
    for name, value in means.items():
        if value.dim() != 1 or value.shape[0] != losses.shape[0]:
            raise ValueError(f"metric {name} of shape {tuple(value.shape)} "
                             "is not per sample: its global mean is unknown")
    values = [v.sum() for v in means.values()]
    for mask in masks.values():
        values += [(losses * mask).sum(), mask.sum()]
    sums = layout.row_sums(values)
    stats = {k: s / n_global for k, s in zip(means, sums)}
    rest = sums[len(means):]
    tasks = {name: (rest[2 * i], rest[2 * i + 1])
             for i, name in enumerate(masks)}
    return stats, tasks
