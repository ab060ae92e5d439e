"""The ('data', 'model') layout of the training processes, and its
collectives.

Counterpart of ``neural_marionette_tpu/parallel/mesh.py``. The port runs
one process per card (``torch.distributed``), where JAX runs one process
per host holding several devices. The world's ranks are laid out as JAX
lays out its devices, ``reshape(data, model)``, so rank = d * model + m:

* ``data`` shards the batch. The ranks of one data row d hold the same
  rows of each global batch, and the step averages the gradients over the
  world after its last backward (``train/step.py``).
* ``model`` shards the frames of a window in the detector's per-frame conv
  stacks (``models/detector.py``). Their results are gathered over the
  model row by :func:`gather_frames`, and everything across frames stays
  replicated.

JAX's ``PartitionSpec`` helpers (``batch_spec``, ``data_only_spec``,
``replicated_spec``) have no counterpart: a rank holds whole tensors, and
which rows it holds is :func:`local_rows`.

The collectives are ``all_reduce`` and ``broadcast`` only, which both NCCL
and gloo take on CUDA tensors; an all-gather is an ``all_reduce`` of a
zero-filled buffer, which is exact. Half-precision tensors travel in
float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_layout(world: int, data: int = -1, model: int = 1) -> np.ndarray:
    """The (data, model) array of ranks of a world of ``world`` processes
    (``data=-1``: every rank the model axis leaves); raises where the JAX
    ``make_mesh`` asserts."""
    if model < 1 or world % model:
        raise ValueError(f"{world} processes not divisible by model={model}")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    return np.arange(world).reshape(data, model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) layout, with the process
    groups of its data column (the ranks of its model index, one per data
    row) and of its model row. The groups are None in a world of one
    process."""
    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ('data', 'model') mesh of the initialised world (one process
    when ``torch.distributed`` is not initialised). Every rank creates the
    group of every data column and of every model row, in the same order,
    as ``torch.distributed.new_group`` requires."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    ranks = mesh_layout(world, data, model)
    data, model = ranks.shape
    data_group = model_group = None
    if initialised:
        for m in range(model):
            g = dist.new_group(ranks[:, m].tolist())
            if m == rank % model:
                data_group = g
        for d in range(data):
            g = dist.new_group(ranks[d].tolist())
            if d == rank // model:
                model_group = g
    return Mesh(data, model, rank, data_group, model_group)


def check_batch_shape(mesh: Mesh, batch) -> None:
    """Guard: the (B, T) leading axes of ``batch`` (a tensor or array, or
    its shape) must divide the (data, model) mesh, with JAX's messages."""
    shape = tuple(batch) if isinstance(batch, (tuple, list, torch.Size)) \
        else tuple(batch.shape)
    B, T = shape[0], shape[1]
    if B % mesh.data != 0:
        raise ValueError(
            f"batch B={B} not divisible by mesh data={mesh.data}; pad the "
            f"batch or choose a mesh with data dividing B")
    if T % mesh.model != 0:
        raise ValueError(
            f"window T={T} not divisible by mesh model={mesh.model} (frame "
            f"sequence-parallel axis); use model=1 or pick T divisible by "
            f"model")


def local_rows(batch_size: int, data: int, data_rank: int,
               microbatches: int = 1) -> np.ndarray:
    """The rows of a global batch that data row ``data_rank`` holds: its
    ``1/data`` share of each of the ``microbatches`` contiguous
    microbatches that the one-process step splits the batch into, so that
    the world's microbatch i is the one-process step's microbatch i, rows
    and noise (``train/step.py``). With one microbatch, the contiguous
    rows ``[d B/data, (d+1) B/data)`` that the JAX loader gives process d."""
    if batch_size % (data * microbatches):
        raise ValueError(f"global batch {batch_size} is not a multiple of "
                         f"{data} data ranks x {microbatches} microbatches")
    micro = batch_size // microbatches
    per = micro // data
    return np.concatenate([np.arange(i * micro + data_rank * per,
                                     i * micro + (data_rank + 1) * per)
                           for i in range(microbatches)])


def shard_batch(mesh: Mesh, batch, microbatches: int = 1):
    """This rank's rows (:func:`local_rows`) of a global batch
    ``(B, T, ...)``, every frame: the ranks of a model row share their rows
    and split the frames inside the detector."""
    check_batch_shape(mesh, batch)
    rows = local_rows(batch.shape[0], mesh.data, mesh.data_rank,
                      microbatches)
    if isinstance(batch, torch.Tensor):
        return batch[torch.from_numpy(rows).to(batch.device)]
    return batch[rows]


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank, in place; returns the module."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                _broadcast_(t)
    return module


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _broadcast_(t: torch.Tensor, src: int = 0) -> None:
    buf = t.detach().to(_wide(t.dtype)).contiguous()
    dist.broadcast(buf, src)
    t.copy_(buf)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the world, in place: one ``all_reduce`` sum
    of one flat buffer per dtype, then a division by the world size (gloo
    has no ``ReduceOp.AVG``, so both backends take the same arithmetic)."""
    if mesh.world == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = torch.cat([t.reshape(-1).to(_wide(dtype)) for t in group])
        dist.all_reduce(flat)
        flat /= mesh.world
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_max(value: bool, mesh: Mesh, device) -> bool:
    """Whether ``value`` holds on any rank."""
    if mesh.world == 1:
        return value
    flag = torch.tensor([float(value)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def barrier(mesh: Mesh, device) -> None:
    """Wait until every rank has reached this point (an ``all_reduce``
    read back on the host, the same on both backends)."""
    all_reduce_max(False, mesh, device)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The tensors ``x`` of the ranks of ``group``, concatenated along
    ``dim`` in group-rank order (equal shapes on every rank); ``x`` itself
    when ``group`` is None. An ``all_reduce`` of a zero-filled buffer into
    which each rank writes its part: every element is its rank's value
    plus zeros, so the gather is exact (a -0.0 comes back as 0.0)."""
    if group is None:
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    shape[dim] *= n
    buf = x.new_zeros(shape, dtype=_wide(x.dtype))
    buf.narrow(dim, i * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _GatherFrames(torch.autograd.Function):
    """:func:`all_gather` whose backward is a reduce-scatter: the incoming
    gradients of the M ranks of the group summed, and this rank's slice
    of the sum. After the gather every rank computes the same loss, but
    what lies downstream of it may itself be sharded (the decoder), so the
    incoming gradient differs by rank; the sum gathers every rank's
    share. The factor this leaves is M, the ranks of the row: the
    gradient of the replicated loss reaches each gather on all M ranks,
    so a frame-sharded parameter's gradient on a rank is M times the
    gradient of that rank's frames, and a replicated parameter's is the
    gradient of the replicated path plus M times the rank's share of the
    sharded paths. Averaged over the M ranks of a row, both are the
    one-process gradient, which is what the step's world average takes
    (``tests/test_torch_parallel.py`` holds both kinds)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = g.to(_wide(g.dtype)).contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, i * ctx.n, ctx.n).to(g.dtype), None, None


def frame_slice(mesh: Optional[Mesh], T: int) -> slice:
    """This rank's frames of a window of ``T`` frames: all of them without
    a mesh or with ``model`` 1."""
    if mesh is None or mesh.model == 1:
        return slice(0, T)
    if T % mesh.model:
        raise ValueError(f"window T={T} not divisible by mesh "
                         f"model={mesh.model}")
    per = T // mesh.model
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def gather_frames(x: torch.Tensor, mesh: Optional[Mesh],
                  dim: int = 1) -> torch.Tensor:
    """The frames of the model row gathered along ``dim`` (differentiable,
    :class:`_GatherFrames`); ``x`` itself without a frame axis."""
    if mesh is None or mesh.model == 1:
        return x
    return _GatherFrames.apply(x, mesh.model_group, dim)
