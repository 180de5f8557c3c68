"""The train state on a mesh (parallel/mesh.py): each rank holds its shard
of every param, optimizer-state and EMA leaf, laid out by the JAX rule
(mesh.py::leaf_spec), and the step's collectives over the port's flat
dict of leaf tensors:

  * before the step reads the params, each leaf is all-gathered whole
    (`gather_params`), but for the hypernetwork's fan-out kernels where a
    "model" axis splits them: those are gathered over "fsdp" only and
    multiplied split (`fanout`), one collective completing the output, so
    that no rank holds or multiplies such a kernel at its global shape;
  * after backward, each leaf's gradient is reduce-scattered over "fsdp"
    (summed over it where the leaf is not fsdp-sharded) and summed over
    "data" (`reduce_grads`); each rank's loss is its rows' sum over the
    global batch size, so the sum is the global batch mean's gradient;
  * norms sum each element once over the mesh (`global_norm`), so every
    rank clips by the same global norm and takes the same branch.

The optimizer and the EMA are elementwise and run on the shards. A packed
AdamW buffer (train/optimizer.py::PackedAdamW) is the concatenation of the
rank's shards of its group's leaves, in the group's order, so per-leaf and
packed stay equal bit for bit on a mesh as on one process.
"""
from typing import Dict, Optional

import torch
import torch.distributed as dist

from hypervla_tpu_torch.parallel.mesh import ROW_AXES, Mesh, leaf_spec

Params = Dict[str, torch.Tensor]


def is_fanout(name: str) -> bool:
    """Whether a hypernetwork param is a fan-out (output-head) kernel."""
    return name.startswith("output_head") and name.endswith("/kernel")


def _all_gather(t, group, size: int, dim: int):
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t, group, size: int, index: int, dim: int):
    """The sum over the group's ranks of t, this rank's chunk of it along
    `dim`."""
    moved = t.movedim(dim, 0).contiguous()
    if moved.is_cuda and dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter of CUDA tensors
        dist.all_reduce(moved, group=group)
        out = moved.chunk(size)[index].clone()
    else:
        out = moved.new_empty((moved.shape[0] // size,) + moved.shape[1:])
        dist.reduce_scatter(out, list(moved.chunk(size)), group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    """The identity forward; backward sums the gradient over "model" (each
    rank's fan-out shard contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverModel(torch.autograd.Function):
    """Forward sums the partial products over "model"; the gradient, the
    same on every rank of it, passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """Forward all-gathers the column blocks over "model"; backward keeps
    this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.size, ctx.index = size, index
        return _all_gather(x, group, size, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[-1] // ctx.size
        return (grad[..., ctx.index * n:(ctx.index + 1) * n].contiguous(),
                None, None, None)


class ShardLayout:
    """The layout of a flat param dict on a mesh of more than one rank:
    spec, this rank's shard, and the collectives of the train step."""

    def __init__(self, mesh: Mesh, shapes: Dict[str, tuple]):
        self.mesh = mesh
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.specs = {n: leaf_spec(mesh, s) for n, s in self.shapes.items()}
        #: fan-out kernels multiplied split over "model"
        self.tp = {n for n, s in self.specs.items()
                   if "model" in s and is_fanout(n)}
        #: (name, multiplied shape) of each split fan-out matmul
        self.fanout_records = []

    # ---- shards ----

    def _slices(self, name: str, shape):
        idx = []
        for d, axis in enumerate(self.specs[name]):
            if axis is None:
                idx.append(slice(None))
            else:
                n = shape[d] // self.mesh.shape[axis]
                i = self.mesh.coords[axis]
                idx.append(slice(i * n, (i + 1) * n))
        return tuple(idx)

    def local_shape(self, name: str) -> tuple:
        shape = list(self.shapes[name])
        for d, axis in enumerate(self.specs[name]):
            if axis is not None:
                shape[d] //= self.mesh.shape[axis]
        return tuple(shape)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole leaf."""
        return full.detach()[self._slices(name, full.shape)].clone()

    def gather(self, name: str, local: torch.Tensor,
               axes=("fsdp", "model")) -> torch.Tensor:
        """The leaf whole along `axes` from every rank's shard."""
        spec = self.specs[name]
        for axis in axes:
            if axis in spec and self.mesh.size(axis) > 1:
                local = _all_gather(local, self.mesh.group(axis),
                                    self.mesh.size(axis), spec.index(axis))
        return local

    def shard_tree(self, tree: Optional[Params]) -> Optional[Params]:
        if tree is None:
            return None
        return {n: self.shard(n, t) for n, t in tree.items()}

    def gather_tree(self, tree: Optional[Params]) -> Optional[Params]:
        if tree is None:
            return None
        return {n: self.gather(n, t) for n, t in tree.items()}

    def _flat(self, names, flat, fn, shape_of):
        sizes = [int(torch.Size(shape_of(n)).numel()) for n in names]
        return torch.cat([fn(n, part.view(shape_of(n))).reshape(-1)
                          for n, part in zip(names, flat.split(sizes))])

    def shard_flat(self, names, flat):
        """A packed buffer of whole leaves -> the buffer of their shards."""
        return self._flat(names, flat, self.shard, self.shapes.get)

    def gather_flat(self, names, flat):
        return self._flat(names, flat, self.gather, self.local_shape)

    # ---- the step ----

    def gather_params(self, local: Params) -> Params:
        """The leaves the step reads, whole (the fan-out kernels split over
        "model": whole over "fsdp" only), as new leaf tensors that carry
        gradients."""
        out = {}
        for name, t in local.items():
            axes = ("fsdp",) if name in self.tp else ("fsdp", "model")
            out[name] = self.gather(name, t.detach(), axes).requires_grad_(
                True)
        return out

    def fanout(self, x, name: str, kernel):
        """x @ kernel of a fan-out kernel as gather_params gives it: split
        over "model" where the layout says so (the rows of the kernel: the
        partial products summed over "model"; its columns: the column
        blocks gathered), else the plain product."""
        if name not in self.tp:
            return x @ kernel
        mesh = self.mesh
        group, size = mesh.group("model"), mesh.size("model")
        index = mesh.coords["model"]
        self.fanout_records.append((name, tuple(kernel.shape)))
        x = _CopyToModel.apply(x, group)
        if self.specs[name].index("model") == 1:
            return _GatherColumns.apply(x @ kernel, group, size, index)
        rows = kernel.shape[0]
        part = x[..., index * rows:(index + 1) * rows] @ kernel
        return _SumOverModel.apply(part, group)

    def reduce_grads(self, grads: Params) -> Params:
        """Each rank's gradients of its rows -> this rank's shard of their
        sum over the rows' ranks: the model shard taken where the step ran
        the leaf whole, reduce-scattered over "fsdp" where the leaf is
        sharded over it, then summed over "data" (and over "fsdp" for the
        rest), the all-reduces in one flat buffer per group."""
        mesh = self.mesh
        out, over_rows, over_data = {}, [], []
        for name, g in grads.items():
            spec = self.specs[name]
            if "model" in spec and name not in self.tp:
                d = spec.index("model")
                n = g.shape[d] // mesh.size("model")
                i = mesh.coords["model"]
                g = g.narrow(d, i * n, n)
            if "fsdp" in spec and mesh.size("fsdp") > 1:
                g = _reduce_scatter(g, mesh.group("fsdp"), mesh.size("fsdp"),
                                    mesh.coords["fsdp"], spec.index("fsdp"))
                over_data.append(name)
            else:
                over_rows.append(name)
            out[name] = g
        for names, axes in ((over_rows, ROW_AXES), (over_data, ("data",))):
            group = mesh.group(*axes)
            if not names or group is None:
                continue
            flat = torch.cat([out[n].reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            sizes = [out[n].numel() for n in names]
            for n, part in zip(names, flat.split(sizes)):
                out[n] = part.view(out[n].shape)
        return {n: out[n].contiguous() for n in grads}

    def owns(self, name: str) -> bool:
        """Whether this rank counts the leaf's shard in a sum over the mesh:
        the first rank of every axis the leaf is not split over."""
        spec = self.specs[name]
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names
                   if a not in spec)

    def global_norm(self, tree: Params) -> torch.Tensor:
        """The norm of the whole tree from its shards, the same on every
        rank."""
        parts = [(t.float() ** 2).sum() for n, t in tree.items()
                 if self.owns(n)]
        device = next(iter(tree.values())).device
        total = (torch.stack(parts).sum() if parts
                 else torch.zeros((), device=device))
        dist.all_reduce(total, group=self.mesh.group(*self.mesh.axis_names))
        return torch.sqrt(total)

    def row_sums(self, values):
        """Sums of per-rank values over the rows' ranks, in one collective:
        a list of scalars in, a list out."""
        group = self.mesh.group(*ROW_AXES)
        stacked = torch.stack([v.float() for v in values])
        if group is not None:
            dist.all_reduce(stacked, group=group)
        return list(stacked.unbind())

    # ---- the state ----

    def _map_opt_state(self, tx, opt_state, leaf, flat):
        from hypervla_tpu_torch.train.optimizer import PackedAdamW

        inner = tx.inner

        def inner_map(s):
            if isinstance(inner, PackedAdamW):
                return {key: dict(s[key], mu=flat(names, s[key]["mu"]),
                                  nu=flat(names, s[key]["nu"]))
                        for key, (_, names) in inner.members.items()}
            return dict(s, mu={n: leaf(n, t) for n, t in s["mu"].items()},
                        nu={n: leaf(n, t) for n, t in s["nu"].items()})

        if tx.k == 1:
            return inner_map(opt_state)
        return dict(opt_state, inner=inner_map(opt_state["inner"]),
                    acc_grads={n: leaf(n, t)
                               for n, t in opt_state["acc_grads"].items()})

    def shard_state(self, state, tx):
        """A TrainState of whole leaves -> this rank's shards of it."""
        from hypervla_tpu_torch.train.train_state import TrainState

        params = {n: t.requires_grad_(True)
                  for n, t in self.shard_tree(state.params).items()}
        return TrainState(
            step=state.step, params=params,
            opt_state=self._map_opt_state(tx, state.opt_state, self.shard,
                                          self.shard_flat),
            ema_params=self.shard_tree(state.ema_params), seed=state.seed)

    def gather_state(self, state, tx):
        """Every rank's shards -> the whole TrainState, on every rank."""
        from hypervla_tpu_torch.train.train_state import TrainState

        with torch.no_grad():
            params = {n: t.requires_grad_(True)
                      for n, t in self.gather_tree(state.params).items()}
            return TrainState(
                step=state.step, params=params,
                opt_state=self._map_opt_state(tx, state.opt_state,
                                              self.gather, self.gather_flat),
                ema_params=self.gather_tree(state.ema_params),
                seed=state.seed)


def layout_for(mesh: Optional[Mesh], params: Params
               ) -> Optional[ShardLayout]:
    """The layout of `params` on `mesh`, or None where the mesh is one
    rank (the one-process step)."""
    if mesh is None or mesh.size(*mesh.axis_names) == 1:
        return None
    return ShardLayout(mesh, {n: tuple(t.shape) for n, t in params.items()})
