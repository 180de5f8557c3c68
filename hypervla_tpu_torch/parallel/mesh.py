"""The device mesh on torch.distributed (counterpart of
hypervla_tpu/parallel/mesh.py).

A mesh lays the process group's ranks out on the JAX package's axes:

  * "data"  -- the batch: each rank of the axis takes its own rows;
  * "fsdp"  -- params and optimizer state sharded; the batch is split over
    it too, so that a rank's gradient is its own rows' (torch's FSDP
    layout: the gradients are reduce-scattered over "fsdp" and summed over
    "data");
  * "model" -- tensor parallelism: a second axis of the large params is
    sharded, and the hypernetwork's fan-out matmul runs split over it
    (parallel/sharded.py); the ranks of the axis share their rows.

The mesh's shape follows the JAX rule (data = n // (fsdp * tp), "model" only
where tp > 1), and so does each leaf's layout (`fsdp_sharding`): a spec, a
tuple with an axis name or None per dimension, that compares with the JAX
PartitionSpec as a tuple. The ranks sit on the mesh in row-major order;
with dcn_data the "data" axis is dcn_data contiguous blocks of ranks (the
JAX CPU fallback's slices; on a GPU cluster, the nodes).

Without a process group (or a group of one rank) a mesh has one rank and
no collective runs: today's one-process path. `init_distributed` reads
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT):
nccl on the card, gloo on the CPU.
"""
import os
import queue
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: the axes a batch is split over (a rank's rows); "model" ranks share them
ROW_AXES = ("data", "fsdp")

Spec = Tuple[Optional[str], ...]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(cpu: bool = False) -> bool:
    """Joins the process group that torchrun's environment describes
    (init_method env://): nccl, or gloo with `cpu` or without a card.
    Returns whether it created the group: False where one exists already
    or the environment names no world of more than one process."""
    if dist.is_initialized():
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    backend = ("gloo" if cpu or not torch.cuda.is_available() else "nccl")
    dist.init_process_group(backend, init_method="env://")
    return True


class Mesh:
    """Ranks on named axes. `devices` holds the ranks (the JAX mesh's
    devices), `shape` {axis: size}; this rank's coordinates are `coords`
    (None on a rank outside the mesh). `group(*axes)` is the process group
    of the ranks that differ from this one only along `axes` (None where
    that is this rank alone)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = process_index()
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups: Dict[tuple, object] = {}
        if process_count() > 1 and self.devices.size > 1:
            self._make_groups()

    @property
    def active(self) -> bool:
        """Whether this rank is on the mesh."""
        return self.coords is not None

    def size(self, *axes: str) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, *axes: str) -> int:
        """This rank's row-major position among the ranks along `axes`."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + (self.coords or {}).get(a, 0)
        return i

    def group(self, *axes: str):
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.size(*axes) == 1:
            return None
        return self._groups[axes]

    def _make_groups(self) -> None:
        """A process group for each set of axes a step reduces over. Every
        rank of the world creates every group, in one order
        (torch.distributed.new_group's contract), and keeps its own."""
        wanted = [(a,) for a in self.axis_names] + [
            tuple(a for a in self.axis_names if a in ROW_AXES),
            self.axis_names]
        for axes in dict.fromkeys(wanted):
            if self.size(*axes) == 1:
                continue
            moved = np.moveaxis(
                self.devices, [self.axis_names.index(a) for a in axes],
                range(-len(axes), 0))
            for ranks in moved.reshape(-1, self.size(*axes)):
                ranks = [int(r) for r in ranks]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def create_mesh(devices: Optional[Sequence[int]] = None, fsdp: int = 1,
                tp: int = 1, dcn_data: Optional[int] = None) -> Mesh:
    """A ("data", "fsdp"[, "model"]) mesh over `devices`, the ranks (None:
    every rank of the process group, or this process alone). Every rank of
    the world calls it with the same arguments."""
    devices = list(devices if devices is not None
                   else range(process_count()))
    n = len(devices)
    assert n % (fsdp * tp) == 0, (
        f"{n} devices not divisible by fsdp={fsdp} * tp={tp}"
    )
    data = n // (fsdp * tp)
    shape = (data, fsdp) + ((tp,) if tp > 1 else ())
    axes = ("data", "fsdp") + (("model",) if tp > 1 else ())
    ranks = np.asarray(devices)
    if dcn_data and dcn_data > 1:
        # dcn_data contiguous blocks of ranks along "data", each laid out
        # as one slice's mesh (the JAX package's CPU fallback)
        per_slice = n // dcn_data
        blocks = [ranks[i * per_slice:(i + 1) * per_slice].reshape(
            (data // dcn_data,) + shape[1:]) for i in range(dcn_data)]
        ranks = np.concatenate(blocks, axis=0)
    return Mesh(ranks.reshape(shape), axes)


class NamedSharding:
    """A leaf's layout on a mesh: spec[d] is the axis dimension d is split
    over, or None."""

    def __init__(self, mesh: Mesh, spec: Spec = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """A batch's layout: its leading axis split over "data" and "fsdp"."""
    return NamedSharding(mesh, (tuple(a for a in mesh.axis_names
                                      if a in ROW_AXES),))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def leaf_spec(mesh: Mesh, shape: Sequence[int]) -> Spec:
    """The JAX package's rule: "fsdp" on the largest axis that is divisible
    by the fsdp size and at least twice it; "model" on the largest
    remaining axis that passes the same test for the tp size; trailing
    Nones dropped (a scalar or a small leaf is replicated)."""
    fsdp_size = mesh.shape["fsdp"]
    tp_size = mesh.shape.get("model", 1)
    shape = tuple(shape)
    spec = [None] * len(shape)
    order = list(np.argsort(shape)[::-1]) if shape else []
    for name, size in (("fsdp", fsdp_size), ("model", tp_size)):
        if size <= 1:
            continue
        for axis in order:
            if (spec[axis] is None and shape[axis] % size == 0
                    and shape[axis] >= 2 * size):
                spec[axis] = name
                break
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def fsdp_sharding(mesh: Mesh, tree):
    """The layout of every leaf of `tree` (nested dicts, lists, a
    dataclass such as TrainState), in the same nesting: a NamedSharding by
    `leaf_spec` for each tensor or array, replicated for anything else."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: fsdp_sharding(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fsdp_sharding(mesh, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: fsdp_sharding(mesh, getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if hasattr(tree, "shape") and len(tree.shape):
        return NamedSharding(mesh, leaf_spec(mesh, tree.shape))
    return replicated(mesh)


def batch_rows(mesh: Optional[Mesh], n_local: int) -> Optional[tuple]:
    """(first, last, total) of this rank's rows of a global batch whose
    rank share is n_local rows; None on a mesh of one row group."""
    if mesh is None or mesh.size(*ROW_AXES) == 1:
        return None
    first = mesh.index(*ROW_AXES) * n_local
    return first, first + n_local, n_local * mesh.size(*ROW_AXES)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (nested dicts of arrays or
    tensors, leading axis the batch): the rank's block along "data" and
    "fsdp", the same on every rank of "model"."""
    parts = mesh.size(*ROW_AXES)
    if parts == 1:
        return batch
    i = mesh.index(*ROW_AXES)

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if not hasattr(x, "shape") or not len(x.shape):
            return x
        n = x.shape[0]
        if n % parts:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{parts} ranks")
        return x[i * n // parts:(i + 1) * n // parts]

    return rows(batch)


def to_device(tree, device):
    """A nested dict of numeric arrays -> tensors on `device`, through
    pinned memory to a card. A leaf that is not numeric (a string field
    the host should have dropped) raises."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        arr = np.asarray(tree)
        if arr.dtype.kind not in "biuf":
            raise TypeError(f"a host-only field of dtype {arr.dtype} "
                            "reached the copy to the device")
        t = torch.as_tensor(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, mesh: Mesh, size: int = 2,
                    device: Optional[torch.device] = None):
    """Yields this rank's rows of each global batch of `iterator`
    (`shard_batch`), as tensors on `device` (the CPU where None), made
    `size` batches ahead on a background thread, in order; the iterator's
    error is raised after the batches before it. Closing the generator
    stops the thread."""
    device = torch.device(device or "cpu")

    def transform(batch):
        return to_device(shard_batch(batch, mesh), device)

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
                if not put(transform(item)):
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
