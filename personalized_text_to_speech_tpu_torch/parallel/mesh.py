"""The mesh of processes, the rank, and the collectives of the train step.

Counterpart of ``personalized_text_to_speech_tpu/parallel/mesh.py``.  The
reference's only distribution mode is DDP over the local GPUs, one process
per GPU (``finetune_speaker_v2.py:69,144-145``); the JAX package lays the
same data parallelism out as a ``data`` mesh axis that GSPMD reduces over,
and tensor parallelism as a ``model`` axis (``parallel/tp.py``).  Here one
process runs per device, laid out as JAX lays its devices, a ``[data,
model]`` array of ranks (``rank = data_index · model + model_index``):
:func:`create_mesh` returns a :class:`Mesh` with the two sizes, this
rank's two indices and its two subgroups.  Each data index holds its rows
(:class:`~..data.dataset.BucketBatcher` with ``shard_index``/``shard_count``
the data index and size), and the train step sums its gradients, loss
normalisers and metrics over the **data** group with explicit
``torch.distributed`` collectives (:func:`allreduce_grads`,
:func:`allreduce_`), so every rank sees the global batch's gradient, as
the GSPMD step does.  The ranks of one model group hold the same rows and
the slices of the sharded parameters (:mod:`.tp`).  The group comes from
:func:`~..utils.runtime.init_distributed`.

JAX's ``shard_batch``, ``batch_sharding`` and ``replicated`` have no
counterpart: each process already holds its rows, and every replicated
parameter is a whole replica on its rank (:func:`broadcast_module` makes
them equal).  Sequence parallelism over the ``model`` axis (JAX
``parallel/sp.py``, ``tpu.sp``) is not ported yet (ROADMAP.md, Queue 1,
item 9).
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# gradients are summed in flat buckets of at most this many bytes (DDP's
# default bucket size)
BUCKET_BYTES = 25 * 2**20
# a module → (the positions of its parameters with a gradient, the flat
# buffers of allreduce_grads' buckets); a module's buffers die with it
_GRAD_BUFFERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

def rank() -> int:
    """This process's rank in the group; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return rank() == 0


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` as ``torchrun``
    sets it, else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``[data, model]`` array of ranks.

    A group is ``None`` where it is the default group (the whole world) or
    where its axis has size 1 and nothing is reduced over it; callers look
    at the size first."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional["dist.ProcessGroup"] = None
    model_group: Optional["dist.ProcessGroup"] = None

    @property
    def data_root(self) -> int:
        """The global rank of data index 0 in this rank's data group."""
        return self.model_index

    @property
    def model_root(self) -> int:
        """The global rank of model index 0 in this rank's model group."""
        return self.data_index * self.model


def mesh_shape(axes: Optional[Dict[str, int]], world: int) -> Tuple[int, int]:
    """``(data, model)`` of ``tpu.mesh`` (default ``{"data": -1}``) over
    ``world`` processes.  A size of -1 absorbs the processes the other axis
    leaves, as in JAX; raises ``ValueError`` unless data × model is the
    world size (one process per device)."""
    axes = dict(axes or {"data": -1})
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes must be 'data' and 'model', got {sorted(unknown)}")
    fixed = 1
    for size in axes.values():
        if size != -1:
            fixed *= int(size)
    sizes = {name: world // fixed if size == -1 else int(size)
             for name, size in axes.items()}
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    if data * model != world or data < 1 or model < 1:
        raise ValueError(
            f"mesh {sizes} needs data x model = {data * model} processes, "
            f"the world size is {world} (one process per device); use -1 "
            "for one axis")
    return data, model


def create_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The :class:`Mesh` of ``tpu.mesh`` over the group's processes
    (:func:`mesh_shape`).  With both axes above 1 every rank creates every
    subgroup, the model groups then the data groups, in one order (a rank
    that skipped one would hang the others); with one axis of size 1 the
    other is the default group and no group is created."""
    data, model = mesh_shape(axes, world_size())
    r = rank()
    data_group = model_group = None
    if data > 1 and model > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if d == r // model:
                model_group = group
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if m == r % model:
                data_group = group
    return Mesh(data, model, r // model, r % model, data_group, model_group)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and device, each at most
    :data:`BUCKET_BYTES` (a larger tensor is a bucket of its own)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on each bucket of ``tensors``: on a lone
    contiguous tensor itself, else on the bucket flattened into one buffer,
    which one multi-tensor copy then writes back (the flattening and the
    views are C++ calls, not a Python pass over the tensors)."""
    for bucket in _buckets(tensors):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            collective(bucket[0])
            continue
        flat = _flatten_dense_tensors(bucket)
        collective(flat)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


def allreduce_(tensors: Sequence[torch.Tensor],
               group: Optional["dist.ProcessGroup"] = None) -> None:
    """Sum ``tensors`` over ``group`` (default: the whole group) in place
    (the step's loss normalisers and metrics); nothing without a group."""
    if dist.is_initialized():
        _bucketed(list(tensors), lambda t: dist.all_reduce(t, group=group))


def _check_grad_pattern(grads: Sequence[Optional[torch.Tensor]],
                        device: torch.device,
                        group: Optional["dist.ProcessGroup"] = None
                        ) -> Tuple[List[int], List[int]]:
    """Raise on every rank unless all ranks hold the same count of
    gradients, the same ``None`` pattern and the same sizes: a rank with
    another pattern would otherwise wait in a collective the others never
    call.  The signature is computed on the host from the shapes alone;
    one all-reduce of eight integers on ``device`` (the maxima of the
    signature and of its negation) and one read of it.  The read waits for
    the card, but a CPU all-reduce over gloo instead took longer on four
    H100s (PERF.md, data parallelism).  Returns the positions of the
    gradients that are not ``None`` and the signature."""
    present = [i for i, g in enumerate(grads) if g is not None]
    numel = sum(grads[i].numel() for i in present)
    # positions and sizes weighted by position, so a swap shows too
    mix = sum((i + 1) * (grads[i].numel() % 1_000_003) for i in present)
    sig = [len(grads), len(present), numel, mix % (2**61 - 1)]
    both = torch.tensor(sig + [-v for v in sig], dtype=torch.int64,
                        device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(both[:4], -both[4:]):
        raise RuntimeError(
            f"rank {rank()}: the ranks' gradients differ in count, None "
            f"pattern or sizes (this rank: {sig}, the maxima: "
            f"{both[:4].tolist()}, the minima: {(-both[4:]).tolist()})")
    return present, sig


def _grad_buffers(module: nn.Module, key: tuple,
                  grads: Sequence[torch.Tensor]
                  ) -> List[Optional[Tuple[torch.Tensor, List[torch.Tensor]]]]:
    """The module's persistent flat buffers, one a bucket of ``grads``, each
    with its views shaped as the bucket's gradients; ``None`` for a bucket
    of one contiguous gradient, which the all-reduce takes in place.  Made
    again only when ``key`` (the gradients' positions, signature, dtype
    and device) changes."""
    cached = _GRAD_BUFFERS.get(module)
    if cached is None or cached[0] != key:
        plan = []
        for bucket in _buckets(grads):
            if len(bucket) == 1 and bucket[0].is_contiguous():
                plan.append(None)
                continue
            flat = torch.empty(sum(t.numel() for t in bucket),
                               dtype=bucket[0].dtype, device=bucket[0].device)
            plan.append((flat, list(_unflatten_dense_tensors(flat, bucket))))
        cached = _GRAD_BUFFERS[module] = (key, plan)
    return cached[1]


def allreduce_grads(module: nn.Module,
                    group: Optional["dist.ProcessGroup"] = None) -> None:
    """Sum every ``.grad`` of ``module`` that is not ``None`` over
    ``group`` (default: the whole group), in parameter order, in buckets of at most :data:`BUCKET_BYTES`:
    one multi-tensor copy into the bucket's persistent flat buffer, the
    all-reduce, and one copy back.  A ``None`` stays ``None`` (AdamW skips
    a missing gradient but decays on a zero one).  First one small
    all-reduce checks that every rank holds the same gradients' count and
    sizes; a mismatch raises on every rank.  Nothing without a group."""
    if not dist.is_initialized():
        return
    params = list(module.parameters())
    if not params:
        return
    grads = [p.grad for p in params]
    present, sig = _check_grad_pattern(grads, params[0].device, group)
    if not present:
        return
    grads = [grads[i] for i in present]
    key = (tuple(present), tuple(sig), grads[0].dtype, grads[0].device)
    start = 0
    for entry in _grad_buffers(module, key, grads):
        if entry is None:
            dist.all_reduce(grads[start], group=group)
            start += 1
            continue
        flat, views = entry
        part = grads[start:start + len(views)]
        start += len(views)
        torch._foreach_copy_(views, part)
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(part, views)


def broadcast_module(module: nn.Module, src: int = 0,
                     group: Optional["dist.ProcessGroup"] = None) -> None:
    """Give every rank of ``group`` (default: the whole group) the
    parameters and buffers of global rank ``src`` (the spectral-norm
    ``weight_u``/``weight_v`` among them); nothing without a group."""
    if not dist.is_initialized():
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    with torch.no_grad():
        _bucketed(tensors, lambda t: dist.broadcast(t, src, group=group))


def broadcast_over_data(module: nn.Module, mesh: Mesh) -> None:
    """Give every rank of this rank's data group the parameters and buffers
    of its data index 0 (under tensor parallelism a model group's ranks
    hold different slices, so the broadcast runs over the data group);
    nothing with one data index."""
    if mesh.data > 1:
        broadcast_module(module, mesh.data_root, mesh.data_group)
