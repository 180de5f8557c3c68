"""The trainer (counterpart of hypervla_tpu/train/trainer.py).

`train()` runs the JAX trainer's loop on one card: the input pipeline
(data/dataset.py, an OXE named mix or a list of datasets) in a worker
process (`PipelineProcess`), host-side tokenization, a thread that keeps
two batches ahead on the card, the train
step (train/train_step.py) with the frozen T5 and DINOv2 encoders inside
it, per-task losses for the drawer tasks, wandb-style logging, the save
and validation callbacks (train/callbacks.py), resume from
`<save_dir>/state/latest.pt` and a warm start from a pretrained EMA file.

Without pretrained weights (`$HYPERVLA_PRETRAINED_DIR/<name>.pt`,
models/encoders/pretrained.py) T5 and DINOv2 are drawn from seeds of their
own, as the JAX trainer inits them when no weights load; the DINOv2
conditioning encoder's params are separate from the (fine-tuned) trunk's.

Not ported, and refused with the ROADMAP.md item that will carry them: a
sharded mesh (fsdp, tp > 1: A11), the profile window (`profile_dir`: the
JAX trainer reads XPlane traces, a TPU tool), and the visualization and
rollout callbacks (`viz_datasets`: A12.3).
"""
import logging
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from hypervla_tpu_torch.configs import (
    dinov2_config,
    disable_unused_attention_capture,
)
from hypervla_tpu_torch.data.text_processing import HFTokenizer
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    dinov2_specs,
    pack_frozen_layers,
)
from hypervla_tpu_torch.models.encoders.pretrained import (
    load_dinov2_weights,
    load_t5_weights,
)
from hypervla_tpu_torch.models.encoders.t5 import (
    t5_config,
    t5_encode,
    t5_specs,
)
from hypervla_tpu_torch.models.hypervla import EMA_FILE, HyperVLA
from hypervla_tpu_torch.models.layers import init_params
from hypervla_tpu_torch.train.callbacks import SaveCallback, ValidationCallback
from hypervla_tpu_torch.train.optimizer import (
    create_optimizer,
    hn_param_type_tree,
)
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.utils.device import resolve_device
from hypervla_tpu_torch.utils.timer import Timer

DRAWER_TASKS = (b"close top drawer", b"close middle drawer",
                b"close bottom drawer")
#: the token width of the example batch's placeholder embedding (T5-base)
T5_DIM = 768
#: batches the pipeline keeps ready, and batches kept ahead on the card
PREFETCH = 2


def frozen_layer_kernel(config: Dict[str, Any]) -> bool:
    """Whether the frozen DINOv2's layers take the no-residual layer
    forward (ops/dino_layer_train.py): asked for (frozen_encoder_layer_kernel
    or dino_layers_impl="pallas_train"), a bf16 encoder and a width that is
    a multiple of 128, as the JAX trainer decides."""
    vk = config["base_net_kwargs"]["vit_kwargs"]
    name = vk.get("pretrained_encoder_name", "dinov2-base")
    return bool(
        (config.get("frozen_encoder_layer_kernel", False)
         or vk.get("dino_layers_impl") == "pallas_train")
        and vk.get("encoder_dtype") == "bfloat16"
        and dinov2_config(name).hidden_size % 128 == 0)


def build_frozen_encoders(config: Dict[str, Any], device=None,
                          seed: int = 0):
    """Returns (text_apply, dino_apply, t5_params, dino_params):
    text_apply(t5_params, input_ids, attention_mask) -> fp32 token
    embeddings; dino_apply(dino_params, uint8 images (B, H, W, 3)) -> fp32
    last_hidden_state (B, 1 + patches, width). Each encoder's params load
    from `$HYPERVLA_PRETRAINED_DIR/<name>.pt` where that file exists, else
    T5's are drawn from `seed` and DINOv2's from `seed + 1`; on the layer
    forward's route (frozen_layer_kernel) dino_params hold each layer's
    operands packed once. The frozen DINOv2 follows the trunk's compute
    dtype and its LayerNorm choice (vit_kwargs fused_layer_norm), as the
    JAX trainer's does. dino_apply is None without initial-image
    conditioning."""
    device = resolve_device(device)
    tok = config["dataset_kwargs"].get("text_tokenizer", "t5-base")
    t5 = t5_config(tok)
    t5_params = load_t5_weights(tok, device=device)
    if t5_params is None:
        t5_params = init_params(t5_specs(t5), seed, device)

    def text_apply(params, input_ids, attention_mask):
        return t5_encode(t5, params, input_ids, attention_mask)

    if not config["hypernet_kwargs"].get("use_initial_image", False):
        return text_apply, None, t5_params, None
    vk = config["base_net_kwargs"]["vit_kwargs"]
    name = vk.get("pretrained_encoder_name", "dinov2-base")
    dino = dinov2_config(name)
    dino_params = load_dinov2_weights(name, device=device)
    if dino_params is None:
        specs = dinov2_specs(dino, "dino")
        dino_params = {k[len("dino/"):]: v for k, v in
                       init_params(specs, seed + 1, device).items()}
    dtype = (torch.bfloat16 if vk.get("encoder_dtype") == "bfloat16"
             else torch.float32)
    layer_kernel = frozen_layer_kernel(config)
    fused_ln = vk.get("fused_layer_norm", False)
    if layer_kernel:
        dino_params = pack_frozen_layers(dino, dino_params)

    def dino_apply(params, images):
        return dinov2_forward(dino, params, normalize_pixels(images), dtype,
                              layer_kernel=layer_kernel, fused_ln=fused_ln)

    return text_apply, dino_apply, t5_params, dino_params


def _tokenizer(config: Dict[str, Any]) -> HFTokenizer:
    dk = config["dataset_kwargs"]
    return HFTokenizer(
        tokenizer_name=dk.get("text_tokenizer", "t5-base"),
        tokenizer_kwargs={
            "max_length": dk.get("tokenizer_max_length", 32),
            "padding": "max_length",
            "truncation": True,
            "return_tensors": "np",
        },
    )


def _strings(values):
    return [s if isinstance(s, bytes) else bytes(s)
            for s in np.asarray(values).reshape(-1)]


def make_process_batch(config: Dict[str, Any]):
    """Host-side batch prep: tokenizes the instruction strings (and the
    rephrased ones) and keeps the raw strings for per-task logging."""
    tokenizer = _tokenizer(config)

    def process_batch(batch):
        task = batch["task"]
        if "language_instruction" in task and not isinstance(
                task["language_instruction"], dict):
            strings = _strings(task["language_instruction"])
            task["instruction_string"] = np.asarray(strings, dtype=object)
            task["language_instruction"] = dict(tokenizer.encode(strings))
        rephrased = batch.get("rephrased_task")
        if rephrased is not None and not isinstance(
                rephrased["language_instruction"], dict):
            rephrased["language_instruction"] = dict(tokenizer.encode(
                _strings(rephrased["language_instruction"])))
        return batch

    return process_batch


def _traj_kwargs(config: Dict[str, Any], **extra) -> dict:
    return dict(window_size=config.get("window_size", 1),
                action_horizon=config["base_net_kwargs"]["action_horizon"],
                max_action_dim=config["base_net_kwargs"]["action_dim"],
                **extra)


def train_dataset_args(config: Dict[str, Any], train: bool = True):
    """(dataset kwargs list, weights, keyword arguments) of the training
    pipeline's make_interleaved_dataset: an OXE named mix (dataset_kwargs
    oxe_mix), expanded here, or dataset_kwargs dataset_kwargs_list. Plain
    data throughout (the standardize functions as ModuleSpecs), so a worker
    process can build the pipeline from it. With device_augment the host
    only decodes and resizes; the augmentation runs in the train step on
    the card."""
    from hypervla_tpu_torch.data.oxe import (
        make_oxe_dataset_kwargs_and_weights,
    )

    dk = config["dataset_kwargs"]
    frame_kwargs = dict(
        resize_size=dk.get("resize_size", {"primary": (224, 224)}),
        image_augment_kwargs=(
            {} if dk.get("device_augment", False)
            else dk.get("image_augment_kwargs", {})),
    )
    if dk.get("oxe_mix"):
        kwargs_list, weights = make_oxe_dataset_kwargs_and_weights(
            dk["oxe_mix"],
            dk["data_dir"],
            load_camera_views=("primary",),
            skip_unlabeled=dk.get("skip_unlabeled", False),
            add_initial_image=config["hypernet_kwargs"].get(
                "use_initial_image", False),
        )
    else:
        kwargs_list = dk["dataset_kwargs_list"]
        weights = dk.get("sample_weights")
    return kwargs_list, weights, dict(
        train=train,
        shuffle_buffer_size=dk.get("shuffle_buffer_size", 1000),
        traj_transform_kwargs=_traj_kwargs(
            config, skip_unlabeled=dk.get("skip_unlabeled", False)),
        frame_transform_kwargs=frame_kwargs,
        batch_size=dk["batch_size"],
        balance_weights=dk.get("balance_weights", False),
        seed=config.get("seed", 0),
    )


def make_train_datasets(config: Dict[str, Any], train: bool = True):
    """The training data pipeline from the config, in this process
    (`train_dataset_args`)."""
    from hypervla_tpu_torch.data.dataset import make_interleaved_dataset

    kwargs_list, weights, kwargs = train_dataset_args(config, train)
    return make_interleaved_dataset(kwargs_list, weights, **kwargs)


def _pipeline_worker(kwargs_list, weights, kwargs, out, stop) -> None:
    """A PipelineProcess's worker: builds the pipeline and puts
    ("statistics", ...), then ("batch", batch) items on `out` until `stop`
    is set; ("error", traceback) if anything raises. The frame transforms
    run on the pipeline's own thread pool, each op on one CPU thread."""
    import traceback

    from hypervla_tpu_torch.data.dataset import make_interleaved_dataset

    torch.set_num_threads(1)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        dataset = make_interleaved_dataset(kwargs_list, weights, **kwargs)
        if put(("statistics", dataset.dataset_statistics)):
            for batch in dataset:
                if not put(("batch", batch)):
                    break
    except BaseException:  # reported to the trainer, which raises it
        put(("error", traceback.format_exc()))
    if stop.is_set():
        # the trainer reads no more: exit without flushing the queue
        out.cancel_join_thread()


class PipelineProcess:
    """The training pipeline (`train_dataset_args`) run in a worker process
    that keeps PREFETCH batches ahead. The JAX package runs its pipeline on
    threads beside a step that is one compiled call; the port's step is
    thousands of launches from Python, and the pipeline's threads taking
    turns at the interpreter lock with it made a full-width trainer step
    ~2 s against ~0.29 s with the batches made beforehand (PERF.md, on an
    H100 host of 8 cores).
    The batches are the same: the worker runs the same pipeline. Iterating
    yields the batches; `dataset_statistics` are the pipeline's; `close()`
    stops the worker."""

    def __init__(self, config: Dict[str, Any]):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue(maxsize=PREFETCH)
        self._stop = ctx.Event()
        self._proc = ctx.Process(
            target=_pipeline_worker,
            args=(*train_dataset_args(config), self._queue, self._stop),
            daemon=True, name="input_pipeline")
        self._proc.start()
        try:
            self.dataset_statistics = self._get()
        except BaseException:
            self.close()
            raise

    def _get(self):
        while True:
            try:
                kind, value = self._queue.get(timeout=1.0)
            except queue.Empty:
                if not self._proc.is_alive():
                    raise RuntimeError(
                        "the input pipeline's worker process exited (code "
                        f"{self._proc.exitcode})") from None
                continue
            if kind == "error":
                raise RuntimeError(f"input pipeline worker:\n{value}")
            return value

    def __iter__(self):
        while True:
            yield self._get()

    def close(self) -> None:
        self._stop.set()
        # drain what the worker put, so that it can exit
        deadline = time.monotonic() + 30
        while self._proc.is_alive() and time.monotonic() < deadline:
            try:
                self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=10)
        self._queue.close()


def _to_device(tree, device):
    """A nested dict of numeric numpy arrays -> tensors on `device`,
    through pinned memory to a card. A leaf that is not numeric (a string
    field the host should have dropped) raises."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"a host-only field of dtype {arr.dtype} reached "
                        "the copy to the device")
    t = torch.as_tensor(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, device: torch.device, size: int = 2):
    """Yields the items of `iterator` moved to `device` by a background
    thread that keeps `size` of them ahead (counterpart of
    hypervla_tpu/parallel/mesh.py::device_prefetch). Closing the generator
    stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()
    error = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(_to_device(item, device)):
                    return
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=worker, daemon=True,
                              name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


def _refuse_unported(config: Dict[str, Any], fsdp: int, tp: int,
                     profile_dir: Optional[str]) -> None:
    if fsdp > 1 or tp > 1:
        raise NotImplementedError(
            f"train: fsdp={fsdp}, tp={tp}: a sharded mesh is not ported "
            "yet (ROADMAP.md A11, multi-card training)")
    if profile_dir is not None:
        raise NotImplementedError(
            "train: profile_dir reads XPlane traces, a TPU tool that is not "
            "carried (ROADMAP.md A11, multi-card training and its "
            "profiling); trace a step with torch.profiler instead")
    names = set(config.get("viz_datasets") or ())
    kwargs_list = config["dataset_kwargs"].get("dataset_kwargs_list") or []
    if any(k["name"] in names for k in kwargs_list):
        raise NotImplementedError(
            "train: viz_datasets needs the visualization and rollout "
            "callbacks, which are not ported yet (ROADMAP.md A12.3, "
            "eval/visualization.py)")


def train(
    config: Dict[str, Any],
    save_dir: Optional[str] = None,
    num_steps: Optional[int] = None,
    dataset=None,
    wandb_run=None,
    fsdp: int = 1,
    tp: int = 1,
    profile_dir: Optional[str] = None,
    device=None,
) -> TrainState:
    """Runs the training loop on `device` (None: the CUDA card); returns
    the final TrainState. wandb_run is anything with
    `.log(dict, step=int)`: it receives the flattened info of every logged
    step (training_loss, task_loss_<task>, the norms on logged steps, the
    timer's mean seconds per phase) and the validation metrics."""
    _refuse_unported(config, fsdp, tp, profile_dir)
    device = resolve_device(device)
    num_steps = num_steps if num_steps is not None else config["num_steps"]
    pipeline = None
    if dataset is None:
        dataset = pipeline = PipelineProcess(config)
        batches = iter(pipeline)
    else:
        batches = iter(dataset.prefetch(PREFETCH))
    try:
        return _train(config, save_dir, num_steps, dataset, batches,
                      wandb_run, device)
    finally:
        if pipeline is not None:
            pipeline.close()


def _train(config, save_dir, num_steps, dataset, batches, wandb_run,
           device) -> TrainState:
    """train()'s loop over `batches`, the raw batches of `dataset`."""
    seed = config.get("seed", 0)
    process_batch = make_process_batch(config)
    data_iter = map(process_batch, batches)

    # the first batch primes model construction (the embeddings' shapes)
    example_batch = _prime_example_batch(next(data_iter), config)
    disable_unused_attention_capture(config)

    text_apply, dino_apply, t5_params, dino_params = build_frozen_encoders(
        config, device=device)

    def text_encode(ids, mask):
        return text_apply(t5_params, ids, mask)

    dino_encode = None
    if dino_apply is not None:
        def dino_encode(images):
            return dino_apply(dino_params, images)

    model = HyperVLA.from_config(
        config, example_batch, seed=seed,
        dataset_statistics=getattr(dataset, "dataset_statistics", None),
        device=device)

    if config.get("pretrained_checkpoint_path"):
        ema_path = (f"{config['pretrained_checkpoint_path']}/"
                    f"{config['pretrained_checkpoint_step']}/{EMA_FILE}")
        ema = torch.load(ema_path, map_location=device, weights_only=True)
        model = model.replace(params=ema["EMA_0.999"])
        logging.info(f"Warm-started from {ema_path}")

    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **config["optimizer"])
    state = TrainState.create(model.params, tx,
                              track_ema=config.get("save_param_EMA", False),
                              seed=seed)

    save_callback = SaveCallback(save_dir)
    val_callback = _build_validation_callback(
        config, model, text_encode, dino_encode, process_batch)
    start_step = 0
    if save_dir is not None:
        state, restored_step = save_callback.restore(state)
        if restored_step is not None:
            start_step = restored_step
            logging.info(f"Resumed from step {start_step}")

    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                              text_encode=text_apply, dino_encode=dino_apply)
    encoder_params = {"t5": t5_params, "dino": dino_params}

    def prepared():
        for raw in data_iter:
            task_index = _drawer_task_index(raw)
            yield {"batch": _prime_example_batch(raw, config, embed=False),
                   "task_index": task_index or {}}

    prefetched = device_prefetch(prepared(), device, size=PREFETCH)
    log_interval = config.get("log_interval", 100)
    timer = Timer()
    last_saved_step = None
    try:
        for i in range(start_step, num_steps):
            timer.tick("total")
            with timer("dataset"):
                item = next(prefetched)
            step_will_log = (i + 1) % log_interval == 0
            with timer("train"):
                state, info = step_fn(
                    state, item["batch"], item["task_index"] or None,
                    encoder_params, with_metrics=step_will_log)
            timer.tock("total")

            step = i + 1
            if (save_dir is not None
                    and step % config.get("save_interval", 10000) == 0):
                save_callback(model, state, step)
                last_saved_step = step
            if (val_callback is not None
                    and step % config.get("eval_interval", 5000) == 0):
                with timer("eval"):
                    val_metrics = val_callback(state.params, step)
                logging.info(f"step {step}: {val_metrics}")
                if wandb_run is not None:
                    wandb_run.log(val_metrics, step=step)
            if step % log_interval == 0:
                info = {k: float(v) for k, v in info.items()}
                info["timer"] = timer.get_average_times()
                if wandb_run is not None:
                    wandb_run.log(_flatten_log(info), step=step)
                logging.info(f"step {step}: "
                             f"loss={info['training_loss']:.4f}")
        if save_dir is not None and last_saved_step != num_steps:
            save_callback(model, state, num_steps)
    finally:
        prefetched.close()
        save_callback.close()
    return state


def _build_validation_callback(config, model, text_encode, dino_encode,
                               process_batch):
    """Validation iterators over the eval_datasets of dataset_kwargs_list
    (the held-out shards, no augmentation, batches of at most 16)."""
    eval_datasets = set(config.get("eval_datasets") or ())
    dk = config["dataset_kwargs"]
    selected = [k for k in dk.get("dataset_kwargs_list") or []
                if k["name"] in eval_datasets]
    if not selected:
        return None
    from hypervla_tpu_torch.data.dataset import (
        apply_frame_transforms,
        apply_trajectory_transforms,
        make_dataset_from_rlds,
    )

    val_iterators = {}
    for kwargs in selected:
        try:
            dataset, _ = make_dataset_from_rlds(**kwargs, train=False)
        except FileNotFoundError as e:
            logging.warning(f"validation dataset {kwargs['name']}: {e}")
            continue
        dataset = apply_trajectory_transforms(
            dataset.repeat(), **_traj_kwargs(config), train=False,
        ).flatten_frames()
        dataset = apply_frame_transforms(
            dataset,
            resize_size=dk.get("resize_size", {"primary": (224, 224)}),
            train=False,
        ).batch(min(dk.get("batch_size", 64), 16))
        val_iterators[kwargs["name"]] = map(
            lambda b: _prime_example_batch(process_batch(b), config,
                                           embed=False),
            iter(dataset))
    if not val_iterators:
        return None
    return ValidationCallback(
        model, text_encode, val_iterators,
        use_initial_image=config["hypernet_kwargs"].get(
            "use_initial_image", False),
        dino_encode=dino_encode)


def _prime_example_batch(batch, config, embed=True):
    """embed=True (model construction): fills placeholder token and patch
    embeddings, so that the example batch carries the model's full input
    shapes. embed=False (the training and validation feed): drops them, as
    the step recomputes both from input_ids and the initial image. Either
    way drops the host-only fields (instruction_string, dataset_name)."""
    instr = batch["task"]["language_instruction"]
    if not embed:
        instr.pop("token_embedding", None)
        if isinstance(batch.get("initial_state"), dict):
            batch["initial_state"].pop("patch_embeddings", None)
    else:
        if "token_embedding" not in instr:
            instr["token_embedding"] = np.zeros(
                (*np.asarray(instr["input_ids"]).shape, T5_DIM), np.float32)
        if (config["hypernet_kwargs"].get("use_initial_image", False)
                and "patch_embeddings" not in batch.get("initial_state", {})):
            dcfg = dinov2_config(config["base_net_kwargs"]["vit_kwargs"].get(
                "pretrained_encoder_name", "dinov2-base"))
            size = config["dataset_kwargs"].get(
                "resize_size", {"primary": (224, 224)})["primary"]
            patches = ((size[0] // dcfg.patch_size)
                       * (size[1] // dcfg.patch_size))
            batch["initial_state"]["patch_embeddings"] = np.zeros(
                (batch["action"].shape[0], patches + 1, dcfg.hidden_size),
                np.float32)
    batch["task"].pop("instruction_string", None)
    batch.pop("dataset_name", None)
    return batch


def _drawer_task_index(batch):
    """{task: (B,) fp32 mask} of the drawer tasks, popping the batch's
    instruction strings; None where the batch has none."""
    strings = batch["task"].pop("instruction_string", None)
    if strings is None:
        return None
    strings = np.asarray(strings)
    return {name.decode("utf-8"): (strings == name).astype(np.float32)
            for name in DRAWER_TASKS}


def _flatten_log(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_log(v, key))
        else:
            out[key] = v
    return out
