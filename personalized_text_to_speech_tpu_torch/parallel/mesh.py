"""Data parallelism across processes: the mesh, the rank, and the
collectives of the train step.

Counterpart of ``personalized_text_to_speech_tpu/parallel/mesh.py``.  The
reference's only distribution mode is DDP over the local GPUs, one process
per GPU (``finetune_speaker_v2.py:69,144-145``); the JAX package lays the
same data parallelism out as a ``data`` mesh axis that GSPMD reduces over.
Here one process runs per device, each holds its rank's rows
(:class:`~..data.dataset.BucketBatcher` with ``shard_index``/``shard_count``),
and the train step sums its gradients, loss normalisers and metrics with
explicit ``torch.distributed`` collectives (:func:`allreduce_grads`,
:func:`allreduce_`), so every rank sees the global batch's gradient, as the
GSPMD step does.  The group comes from
:func:`~..utils.runtime.init_distributed`.

JAX's ``shard_batch``, ``batch_sharding`` and ``replicated`` have no
counterpart: each process already holds its rows, and every parameter is a
whole replica on its rank (:func:`broadcast_module` makes them equal).  The
``model`` axis, on which JAX runs tensor parallelism (``parallel/tp.py``) and
sequence parallelism (``parallel/sp.py``), is not ported yet
(ROADMAP.md, Queue 1, items 8 and 9): :func:`create_mesh` refuses a
``model`` axis above 1.
"""

from __future__ import annotations

import os
import weakref
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

_MODEL_AXIS_TODO = (
    "the mesh's `model` axis (tensor parallelism, JAX parallel/tp.py; "
    "sequence parallelism, JAX parallel/sp.py) is not ported yet: "
    "ROADMAP.md, Queue 1, items 8 and 9. Set tpu.mesh.model to 1")


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


def create_mesh(axes: Optional[Dict[str, int]] = None) -> int:
    """Check the mesh of ``tpu.mesh`` (default ``{"data": -1}``) against the
    group's processes and return the size of its ``data`` axis.  A size of
    -1 absorbs the processes the other axes leave, as in JAX; ``data`` must
    come to the world size, and a ``model`` axis above 1 raises
    ``NotImplementedError``.  The port's mesh is that one number: a process
    a device, each a replica."""
    axes = dict(axes or {"data": -1})
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes must be 'data' and 'model', got {sorted(unknown)}")
    n = world_size()
    fixed = 1
    for size in axes.values():
        if size != -1:
            fixed *= int(size)
    sizes = {name: n // fixed if size == -1 else int(size)
             for name, size in axes.items()}
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(f"mesh {sizes}: {_MODEL_AXIS_TODO}")
    data = sizes.get("data", 1)
    if data != n:
        raise ValueError(
            f"mesh {sizes} needs a data axis of the world size {n} (one "
            f"process per device); use -1 for the data axis")
    return data


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


def allreduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the group in place (the step's loss normalisers
    and metrics); nothing without a group."""
    if dist.is_initialized():
        _bucketed(list(tensors), dist.all_reduce)


def _check_grad_pattern(grads: Sequence[Optional[torch.Tensor]],
                        device: torch.device) -> Tuple[List[int], List[int]]:
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
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
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


def allreduce_grads(module: nn.Module) -> None:
    """Sum every ``.grad`` of ``module`` that is not ``None`` over the
    group, in parameter order, in buckets of at most :data:`BUCKET_BYTES`:
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
    present, sig = _check_grad_pattern(grads, params[0].device)
    if not present:
        return
    grads = [grads[i] for i in present]
    key = (tuple(present), tuple(sig), grads[0].dtype, grads[0].device)
    start = 0
    for entry in _grad_buffers(module, key, grads):
        if entry is None:
            dist.all_reduce(grads[start])
            start += 1
            continue
        flat, views = entry
        part = grads[start:start + len(views)]
        start += len(views)
        torch._foreach_copy_(views, part)
        dist.all_reduce(flat)
        torch._foreach_copy_(part, views)


def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Give every rank ``src``'s parameters and buffers (the spectral-norm
    ``weight_u``/``weight_v`` among them); nothing without a group."""
    if not dist.is_initialized():
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    with torch.no_grad():
        _bucketed(tensors, lambda t: dist.broadcast(t, src))
