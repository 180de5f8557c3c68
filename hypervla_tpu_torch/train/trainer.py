"""The trainer (counterpart of hypervla_tpu/train/trainer.py).

`train()` runs the JAX trainer's loop on one card: the input pipeline
(data/dataset.py, an OXE named mix or a list of datasets) in a worker
process (`PipelineProcess`), host-side tokenization, a thread that keeps
two batches ahead on the card, the train
step (train/train_step.py) with the frozen T5 and DINOv2 encoders inside
it, per-task losses for the drawer tasks, wandb-style logging, the save
and validation callbacks (train/callbacks.py), resume from
`<save_dir>/state/latest.pt` and a warm start from a pretrained EMA file,
which with configs.py::finetune_config's frozen keys and the optimizer's
gradient accumulation is the JAX package's fine-tuning.

Without pretrained weights (`$HYPERVLA_PRETRAINED_DIR/<name>.pt`,
models/encoders/pretrained.py) T5 and DINOv2 are drawn from seeds of their
own, as the JAX trainer inits them when no weights load; the DINOv2
conditioning encoder's params are separate from the (fine-tuned) trunk's.

The datasets named in `viz_datasets` feed the visualization callback
(train/callbacks.py::VisualizationCallback), which logs
`visualizer/<name>/<metric>` every `viz_interval` steps (default
`eval_interval`), as the JAX trainer does.

Under torchrun (`torchrun --nproc_per_node N -m hypervla_tpu_torch.train.
main ... --fsdp F --tp T`) `train()` joins the process group and lays the
ranks out on the JAX trainer's ("data", "fsdp"[, "model"]) mesh
(parallel/mesh.py): the state sharded by the JAX rule
(parallel/sharded.py), each rank's own pipeline process yielding the
global batch from the same seed, of which the rank keeps its rows (the
JAX single-process semantics: the ranks' rows of step k are the one
process's batch of step k), the frozen encoders replicated, the logging,
wandb and the checkpoints on rank 0. The profile window (`profile_dir`,
`profile_steps`) traces its steps with torch.profiler into a chrome trace
and logs each kernel's device ms per step (utils/profile.py).
"""
import logging
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
from hypervla_tpu_torch.parallel.mesh import (
    create_mesh,
    device_prefetch,
    init_distributed,
    process_index,
)
from hypervla_tpu_torch.parallel.sharded import layout_for
from hypervla_tpu_torch.train.callbacks import (
    SaveCallback,
    ValidationCallback,
    VisualizationCallback,
)
from hypervla_tpu_torch.train.optimizer import (
    create_optimizer,
    hn_param_type_tree,
)
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.utils import profile
from hypervla_tpu_torch.utils.device import resolve_device
from hypervla_tpu_torch.utils.timer import Timer

DRAWER_TASKS = (b"close top drawer", b"close middle drawer",
                b"close bottom drawer")
#: the token width of the example batch's placeholder embedding (T5-base)
T5_DIM = 768
#: batches the pipeline keeps ready, and batches kept ahead on the card
PREFETCH = 2
#: seconds the trainer waits for the pipeline's next item before it fails
BATCH_TIMEOUT = 1800.0


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


def _pipeline_worker(kwargs_list, weights, kwargs, conn, slots, stop) -> None:
    """A PipelineProcess's worker: builds the pipeline and sends
    ("statistics", ...), then ("batch", batch) items down `conn`, each
    once a slot of `slots` is free, until `stop` is set; ("error",
    traceback) if anything raises. The frame transforms run on the
    pipeline's own thread pool, each op on one CPU thread."""
    import traceback

    from hypervla_tpu_torch.data.dataset import make_interleaved_dataset

    torch.set_num_threads(1)

    def send(item) -> bool:
        while not slots.acquire(timeout=0.1):
            if stop.is_set():
                return False
        if stop.is_set():
            return False
        conn.send(item)
        return True

    try:
        dataset = make_interleaved_dataset(kwargs_list, weights, **kwargs)
        if send(("statistics", dataset.dataset_statistics)):
            for batch in dataset:
                if not send(("batch", batch)):
                    break
    except BaseException:  # reported to the trainer, which raises it
        send(("error", traceback.format_exc()))
    finally:
        conn.close()


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
    stops the worker.

    The worker sends whole items down a one-way pipe, PREFETCH ahead of
    what this side has taken (a semaphore of PREFETCH slots). This side
    holds only the pipe's read end, so a worker that ends, however it
    ends, is an end of file here and never a read that waits for bytes no
    one will write; and a wait for an item ends after BATCH_TIMEOUT seconds
    with a RuntimeError."""

    def __init__(self, config: Dict[str, Any]):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, writer = ctx.Pipe(duplex=False)
        self._slots = ctx.Semaphore(PREFETCH)
        self._stop = ctx.Event()
        self._proc = ctx.Process(
            target=_pipeline_worker,
            args=(*train_dataset_args(config), writer, self._slots,
                  self._stop),
            daemon=True, name="input_pipeline")
        self._proc.start()
        writer.close()
        try:
            self.dataset_statistics = self._get()
        except BaseException:
            self.close()
            raise

    def _recv(self):
        try:
            item = self._conn.recv()
        except EOFError:
            self._proc.join(timeout=10)
            raise RuntimeError(
                "the input pipeline's worker process exited (code "
                f"{self._proc.exitcode})") from None
        self._slots.release()
        return item

    def _get(self):
        if not self._conn.poll(BATCH_TIMEOUT):
            raise RuntimeError(
                f"the input pipeline's worker sent nothing in {BATCH_TIMEOUT}"
                " s")
        kind, value = self._recv()
        if kind == "error":
            raise RuntimeError(f"input pipeline worker:\n{value}")
        return value

    def __iter__(self):
        while True:
            yield self._get()

    def close(self) -> None:
        self._stop.set()
        # take what the worker is sending, so that it can exit
        deadline = time.monotonic() + 30
        while self._proc.is_alive() and time.monotonic() < deadline:
            try:
                if self._conn.poll(0.1):
                    self._recv()
            except RuntimeError:  # the worker has ended
                break
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=10)
        self._conn.close()


def train(
    config: Dict[str, Any],
    save_dir: Optional[str] = None,
    num_steps: Optional[int] = None,
    dataset=None,
    wandb_run=None,
    fsdp: int = 1,
    tp: int = 1,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (10, 15),
    device=None,
) -> TrainState:
    """Runs the training loop on `device` (None: the CUDA card, under a
    process group the rank's own, cuda:LOCAL_RANK); returns the final
    TrainState, whole on every rank. Under torchrun's environment (or in
    a process group the caller made) the ranks train as one on a mesh of
    fsdp x tp (x the rest on "data"), as the JAX trainer does on its
    devices. profile_dir: steps [profile_steps[0], profile_steps[1]) are
    traced with torch.profiler into <profile_dir>/trace_rank<r>.json and
    each device kernel's ms per step is logged. wandb_run is anything with
    `.log(dict, step=int)`: it receives, on rank 0, the flattened info of
    every logged step (training_loss, task_loss_<task>, the norms on
    logged steps, the timer's mean seconds per phase) and the validation
    metrics."""
    created = init_distributed(
        cpu=device is not None and torch.device(device).type == "cpu")
    try:
        device = resolve_device(device)
        mesh = create_mesh(fsdp=fsdp, tp=tp)
        num_steps = (num_steps if num_steps is not None
                     else config["num_steps"])
        pipeline = None
        if dataset is None:
            dataset = pipeline = PipelineProcess(config)
            batches = iter(pipeline)
        else:
            batches = iter(dataset.prefetch(PREFETCH))
        try:
            return _train(config, save_dir, num_steps, dataset, batches,
                          wandb_run, device, mesh,
                          profile_dir, tuple(profile_steps))
        finally:
            if pipeline is not None:
                pipeline.close()
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(config, save_dir, num_steps, dataset, batches, wandb_run,
           device, mesh, profile_dir, profile_steps) -> TrainState:
    """train()'s loop over `batches`, the raw batches of `dataset`."""
    seed = config.get("seed", 0)
    process_batch = make_process_batch(config)
    data_iter = map(process_batch, batches)

    # the first batch primes model construction (the embeddings' shapes)
    example_batch = _prime_example_batch(next(data_iter), config)
    if mesh.size(*mesh.axis_names) > 1:
        _check_ranks_agree(example_batch, device)
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
    if config.get("finetune_mode"):
        logging.info(f"Fine-tuning, mode {config['finetune_mode']}: "
                     f"{len(tx.frozen)} of {len(model.params)} params frozen")
    state = TrainState.create(model.params, tx,
                              track_ema=config.get("save_param_EMA", False),
                              seed=seed)
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                              text_encode=text_apply, dino_encode=dino_apply,
                              mesh=mesh)
    layout = layout_for(mesh, model.params)
    if layout is not None:
        state = layout.shard_state(state, tx)
        logging.info(f"Mesh {mesh.shape}: rank {mesh.rank} holds "
                     f"{sum(p.numel() for p in state.params.values())} of "
                     f"{sum(p.numel() for p in model.params.values())} "
                     "param elements")
    main_rank = process_index() == 0

    save_callback = SaveCallback(save_dir, layout=layout, tx=tx)
    val_callback = _build_validation_callback(
        config, model, text_encode, dino_encode, process_batch)
    viz_callback = _build_visualization_callback(
        config, model, text_encode, dino_encode)
    start_step = 0
    if save_dir is not None:
        state, restored_step = save_callback.restore(state)
        if restored_step is not None:
            start_step = restored_step
            logging.info(f"Resumed from step {start_step}")
    encoder_params = {"t5": t5_params, "dino": dino_params}

    def whole_params():
        return (state.params if layout is None
                else layout.gather_tree(state.params))

    def prepared():
        for raw in data_iter:
            task_index = _drawer_task_index(raw)
            yield {"batch": _prime_example_batch(raw, config, embed=False),
                   "task_index": task_index or {}}

    prefetched = device_prefetch(prepared(), mesh, size=PREFETCH,
                                 device=device)
    log_interval = config.get("log_interval", 100)
    timer = Timer()
    last_saved_step = None
    trace = None
    try:
        for i in range(start_step, num_steps):
            if profile_dir is not None and i == profile_steps[0]:
                trace = profile.start_trace()
            if trace is not None and i == profile_steps[1]:
                _end_profile(trace, profile_dir, profile_steps, main_rank)
                trace = None
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
            # every rank gathers the params; rank 0 evaluates and logs
            if (val_callback is not None
                    and step % config.get("eval_interval", 5000) == 0):
                with timer("eval"):
                    params = whole_params()
                    if main_rank:
                        val_metrics = val_callback(params, step)
                if main_rank:
                    logging.info(f"step {step}: {val_metrics}")
                    if wandb_run is not None:
                        wandb_run.log(val_metrics, step=step)
            if (viz_callback is not None
                    and step % config.get(
                        "viz_interval",
                        config.get("eval_interval", 5000)) == 0):
                with timer("visualize"):
                    params = whole_params()
                    if main_rank:
                        viz_metrics = viz_callback(params, step)
                if main_rank:
                    logging.info(f"step {step}: {viz_metrics}")
                    if wandb_run is not None:
                        wandb_run.log(viz_metrics, step=step)
            if step % log_interval == 0 and main_rank:
                info = {k: float(v) for k, v in info.items()}
                info["timer"] = timer.get_average_times()
                if wandb_run is not None:
                    wandb_run.log(_flatten_log(info), step=step)
                logging.info(f"step {step}: "
                             f"loss={info['training_loss']:.4f}")
        if trace is not None:  # the run ended inside the window
            _end_profile(trace, profile_dir,
                         (profile_steps[0], num_steps), main_rank)
            trace = None
        if save_dir is not None and last_saved_step != num_steps:
            save_callback(model, state, num_steps)
    finally:
        if trace is not None:
            trace.stop()
        prefetched.close()
        save_callback.close()
    return state if layout is None else layout.gather_state(state, tx)


def _check_ranks_agree(batch, device) -> None:
    """Every rank's pipeline must yield the same global batch (of which it
    keeps its rows): a digest of the first batch's tokens and actions is
    compared over the ranks. A tokenizer whose ids depend on the process
    (data/text_processing.py::FallbackTokenizer hashes words with Python's
    salted hash) breaks that unless every rank runs under one
    PYTHONHASHSEED."""
    import torch.distributed as dist

    ids = np.asarray(batch["task"]["language_instruction"]["input_ids"],
                     np.int64).reshape(-1)
    digest = torch.tensor(
        [float(((ids % 65521) * (np.arange(ids.size) % 65521 + 1)).sum()),
         float(np.asarray(batch["action"], np.float64).sum())],
        dtype=torch.float64, device=device)
    low, high = digest.clone(), digest.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    if not torch.equal(low, high):
        raise RuntimeError(
            "the ranks' input pipelines yield different global batches: "
            "every rank must draw the same batch from the same seed (a "
            "tokenizer that hashes words needs one PYTHONHASHSEED on every "
            "rank)")


def _end_profile(trace, profile_dir, window, log_summary: bool) -> None:
    """Ends the profile window: the chrome trace written, and on rank 0
    each kernel's ms per step logged (a failed summary is a warning, as in
    the JAX trainer)."""
    profile.stop_trace(trace, profile_dir, process_index())
    if not log_summary:
        return
    try:
        for line in profile.summary_lines(trace, window[1] - window[0]):
            logging.info(line)
    except Exception as e:
        logging.warning(f"profile summary failed: {e!r}")


def _build_visualization_callback(config, model, text_encode, dino_encode):
    """The manipulation-metric visualizers over the datasets named in
    config["viz_datasets"] (single datasets of whole trajectories, no
    augmentation, instructions through the trainer's tokenizer), or None
    where none is named or found."""
    viz_datasets = set(config.get("viz_datasets") or ())
    dk = config["dataset_kwargs"]
    selected = [k for k in dk.get("dataset_kwargs_list") or []
                if k["name"] in viz_datasets]
    if not selected:
        return None
    from hypervla_tpu_torch.data.dataset import make_single_dataset
    from hypervla_tpu_torch.eval.visualization import Visualizer

    tokenizer = _tokenizer(config)
    visualizers = {}
    for kwargs in selected:
        try:
            dataset = make_single_dataset(
                kwargs,
                train=False,
                traj_transform_kwargs=_traj_kwargs(config),
                frame_transform_kwargs=dict(resize_size=dk.get(
                    "resize_size", {"primary": (224, 224)})),
            )
        except FileNotFoundError as e:
            logging.warning(f"viz dataset {kwargs['name']}: {e}")
            continue
        visualizers[kwargs["name"]] = Visualizer(
            dataset=dataset.repeat(), text_processor=tokenizer)
    if not visualizers:
        return None
    return VisualizationCallback(
        model, text_encode, visualizers,
        n_trajs=config.get("viz_num_trajs", 4),
        use_initial_image=config["hypernet_kwargs"].get(
            "use_initial_image", False),
        dino_encode=dino_encode)


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
