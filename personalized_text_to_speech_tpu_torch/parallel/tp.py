"""Tensor parallelism over the mesh's ``model`` axis: the out-channels of
every conv and the feature dim of the speaker embedding, sharded
("column-parallel"), with their AdamW moments.

Counterpart of ``personalized_text_to_speech_tpu/parallel/tp.py``.  JAX
annotates each parameter with a ``PartitionSpec`` and GSPMD inserts the
collectives; here :func:`param_specs` makes the same decision per
parameter on torch layouts, :func:`shard_module` keeps each rank's slice
and gives each sharded layer a forward with explicit collectives inside
``torch.autograd.Function`` s, and the train step reduces what the
collectives leave partial (:func:`sync_replicated_grads`, the sharded
squares of ``train/state.py::global_norm``).  The bar is JAX's: the losses
and gradients of one process (``tests/test_sharding.py``).

The decision (JAX ``param_pspecs``, ``tp.py:68-106``), with "out" in torch's
layouts: dim 0 of a ``Conv1d``/``Conv2d`` ``weight``/``weight_v``; dim 1 of a
``ConvTranspose1d`` ``weight_v`` (``[C_in, C_out, K]``); dim 1 of an
``nn.Embedding`` weight.  ``bias`` and a conv's ``weight_g`` shard on dim 0
with it; a ``ConvTranspose1d``'s ``weight_g`` indexes its in-channels and
stays replicated.  A module whose out size the tp size does not divide
stays whole, and so does a grouped conv whose groups it does not divide.
Loose tensors (``LayerNorm``, ``emb_rel_k``/``emb_rel_v``, the flows'
``m``/``logs``) and the text encoder's symbol table, which JAX declares as a
loose ``self.param`` (``models/synthesizer.py:73``), stay replicated.  One
decision is the port's own: the spectral-norm convs' ``weight_orig`` shards
as a ``weight`` does, with ``weight_u`` (one entry per out-channel) beside
it; JAX's ``_KERNEL_NAMES`` has no ``w_orig``, so GSPMD replicates that
discriminator.

A sharded layer's forward: copy-to-model (the identity; in the backward an
all-reduce over the model group of the input's gradient, which each rank
holds only in part), the local conv on the weight slice, gather-from-model
(an all-gather along channels; in the backward this rank's slice of the
gradient).  So the activations between layers stay whole and replicated on
every rank of a model group, as GSPMD's all-gather choice leaves them.

* Grouped convs (the scale discriminator's groups 4–256, the SDP's
  depthwise DDSConv): rank r's out-channels belong to groups ``[r·g/tp,
  (r+1)·g/tp)``; it convolves those groups' in-channels with ``g/tp``
  groups.
* ``ConvTranspose1d`` weight norm: ``g`` is per in-channel, so its norm runs
  over the sharded out dim: the weight is built from an all-reduced sum of
  squares whose gradient is all-reduced too, and ``g`` enters through
  copy-to-model.  The legacy hook is removed from those layers.
* Spectral norm: with ``W`` sharded on out-channels ``u`` is sharded; Wᵀu,
  ‖W v‖² and σ = uᵀW v are all-reduced over the model group (σ with its
  gradient), so ``u``/``v`` are one process's up to rounding.

Collectives are the list ``all_gather``, ``all_reduce`` and ``broadcast``,
which gloo and NCCL both take; a failed collective raises.
"""

from __future__ import annotations

import types
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.weight_norm import WeightNorm

from personalized_text_to_speech_tpu_torch.models.layers import (
    SPECTRAL_EPS,
    _SpectralNorm,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import TextEncoder
from personalized_text_to_speech_tpu_torch.parallel.mesh import Mesh, _bucketed

# a layer's parameters that carry its out dim
_WEIGHTS = ("weight", "weight_v", "weight_orig")


@dataclass(frozen=True)
class _Shard:
    """A sharded layer's model group: its size and this rank's index."""

    group: Optional["dist.ProcessGroup"]
    size: int
    index: int


# --------------------------------------------------------------------------
# the collectives, as autograd functions
# --------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the model group of a partial sum; each rank's backward
    holds the gradient of its own use only, so it is summed too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's slices joined along ``dim``; the backward is this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        x = x.contiguous()
        ctx.slice = (dim, index * x.shape[dim], x.shape[dim])
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, start, n = ctx.slice
        return grad.narrow(dim, start, n), None, None, None, None


def copy_to_model(x: torch.Tensor, shard: _Shard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard.group)


def allreduce_sum(x: torch.Tensor, shard: _Shard) -> torch.Tensor:
    return _AllReduceSum.apply(x, shard.group)


def gather_from_model(x: torch.Tensor, shard: _Shard, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, shard.group, shard.size, shard.index,
                                  dim % x.dim())


# --------------------------------------------------------------------------
# the decision
# --------------------------------------------------------------------------

def _sharded_layers(module: nn.Module, tp_size: int) -> Dict[str, int]:
    """The layers whose out dim shards: qualified name → the weight's out
    dim (the caller reads it before :func:`shard_module` narrows them)."""
    if tp_size <= 1:
        return {}
    tables = {id(m.emb) for m in module.modules() if isinstance(m, TextEncoder)}
    layers = {}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.ConvTranspose1d):
            if mod.groups == 1 and mod.out_channels % tp_size == 0:
                layers[name] = 1
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            if mod.out_channels % tp_size == 0 and (
                    mod.groups == 1 or mod.groups % tp_size == 0):
                layers[name] = 0
        elif isinstance(mod, nn.Embedding) and id(mod) not in tables:
            if mod.embedding_dim % tp_size == 0:
                layers[name] = 1
    return layers


def _layer_specs(mod: nn.Module, dim: Optional[int]) -> Dict[str, Optional[int]]:
    """The sharded dim of each of one layer's own parameters and buffers."""
    specs = {}
    for name, p in mod._parameters.items():
        if p is None:
            continue
        if dim is None:
            specs[name] = None
        elif name in _WEIGHTS:
            specs[name] = dim
        elif name == "weight_g":
            specs[name] = None if isinstance(mod, nn.ConvTranspose1d) else 0
        else:
            specs[name] = 0 if name == "bias" else None
    for name, b in mod._buffers.items():
        if b is not None:
            specs[name] = 0 if dim is not None and name == "weight_u" else None
    return specs


def state_specs(module: nn.Module, tp_size: int) -> Dict[str, Optional[int]]:
    """Every state-dict key of ``module`` (unsharded) → its sharded dim, or
    ``None`` where it stays replicated: :func:`param_specs` and the
    spectral-norm buffers."""
    layers = _sharded_layers(module, tp_size)
    specs = {}
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        for key, dim in _layer_specs(mod, layers.get(name)).items():
            specs[prefix + key] = dim
    return specs


def param_specs(module: nn.Module, tp_size: int) -> Dict[str, Optional[int]]:
    """Each parameter name of ``module`` (unsharded) → the dim it shards
    on over ``tp_size`` ranks, or ``None`` (module docstring)."""
    specs = state_specs(module, tp_size)
    return {n: specs[n] for n, _ in module.named_parameters()}


def count_sharded(module: nn.Module, tp_size: int) -> Tuple[int, int]:
    """(sharded parameter count, total parameter count) of ``module``
    (unsharded) under :func:`param_specs`."""
    specs = param_specs(module, tp_size)
    total = sharded = 0
    for name, p in module.named_parameters():
        total += p.numel()
        if specs[name] is not None:
            sharded += p.numel()
    return sharded, total


# --------------------------------------------------------------------------
# sharded layers
# --------------------------------------------------------------------------

def _spectral_weight(self) -> torch.Tensor:
    """``SpectralNormConv*.spectral_weight`` on a slice of out-channels."""
    shard = self._tp
    w = self.weight_orig
    with torch.autocast(device_type=w.device.type, enabled=False):
        mat = w.float().reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.power_iteration:
            with torch.no_grad():
                wtu = torch.mv(mat.t(), u)
                dist.all_reduce(wtu, group=shard.group)
                v = F.normalize(wtu, dim=0, eps=SPECTRAL_EPS)
                wv = torch.mv(mat, v)
                sq = wv.square().sum()
                dist.all_reduce(sq, group=shard.group)
                u = wv / sq.sqrt().clamp_min(SPECTRAL_EPS)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = allreduce_sum(torch.dot(u, torch.mv(mat, v)), shard)
        return (w.float() / sigma).to(w.dtype)


def _tp_conv_forward(self, x: torch.Tensor) -> torch.Tensor:
    shard = self._tp
    x = copy_to_model(x, shard)
    if self._tp_inputs is not None:
        x = x[:, self._tp_inputs]
    weight = (_spectral_weight(self) if isinstance(self, _SpectralNorm)
              else self.weight)
    return gather_from_model(self._conv_forward(x, weight, self.bias), shard, 1)


def _conv_transpose_forward(self, x: torch.Tensor) -> torch.Tensor:
    shard = self._tp
    x = copy_to_model(x, shard)
    v = self.weight_v.float()
    norm = allreduce_sum(v.square().sum(dim=(1, 2), keepdim=True), shard).sqrt()
    g = copy_to_model(self.weight_g, shard).float()
    weight = (v * (g / norm)).to(self.weight_v.dtype)
    y = F.conv_transpose1d(x, weight, self.bias, self.stride, self.padding,
                           self.output_padding, self.groups, self.dilation)
    return gather_from_model(y, shard, 1)


def _embedding_forward(self, ids: torch.Tensor) -> torch.Tensor:
    y = F.embedding(ids, self.weight, self.padding_idx, self.max_norm,
                    self.norm_type, self.scale_grad_by_freq, self.sparse)
    return gather_from_model(y, self._tp, -1)


def _narrow(t: torch.Tensor, dim: int, shard: _Shard) -> torch.Tensor:
    n = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * n, n).clone()


def _weight_norm_hooks(mod: nn.Module) -> List[Tuple[int, WeightNorm]]:
    return [(k, h) for k, h in mod._forward_pre_hooks.items()
            if isinstance(h, WeightNorm)]


def shard_module(module: nn.Module, mesh: Mesh) -> None:
    """Keep this rank's slice (model index of ``mesh``) of every sharded
    parameter and buffer of ``module`` and give each sharded layer its
    tensor-parallel forward (module docstring); every rank of the model
    group must hold the same whole module first.  Nothing with a model axis
    of 1.  Build the optimizer afterwards."""
    if mesh.model == 1:
        return
    if is_sharded(module):
        raise ValueError("the module is sharded already")
    shard = _Shard(mesh.model_group, mesh.model, mesh.model_index)
    specs = state_specs(module, mesh.model)
    layers = _sharded_layers(module, mesh.model)
    for name, mod in module.named_modules():
        if name not in layers:
            continue
        own = _layer_specs(mod, layers[name])
        with torch.no_grad():
            for key, dim in own.items():
                if dim is None:
                    continue
                if key in mod._parameters:
                    mod._parameters[key].data = _narrow(mod._parameters[key].data,
                                                        dim, shard)
                else:
                    mod._buffers[key] = _narrow(mod._buffers[key], dim, shard)
        mod._tp = shard
        if isinstance(mod, nn.Embedding):
            mod.embedding_dim //= shard.size
            mod.forward = types.MethodType(_embedding_forward, mod)
            continue
        mod.out_channels //= shard.size
        if isinstance(mod, nn.ConvTranspose1d):
            for key, _ in _weight_norm_hooks(mod):
                del mod._forward_pre_hooks[key]
            mod.__dict__.pop("weight", None)  # the hook's last whole weight
            mod.forward = types.MethodType(_conv_transpose_forward, mod)
            continue
        mod._tp_inputs = None
        if mod.groups > 1:
            per_rank = mod.in_channels // shard.size
            mod._tp_inputs = slice(shard.index * per_rank,
                                   (shard.index + 1) * per_rank)
            mod.in_channels = per_rank
            mod.groups //= shard.size
        with torch.no_grad():  # the hook's weight, from the slices
            for _, hook in _weight_norm_hooks(mod):
                hook(mod, None)
        mod.forward = types.MethodType(_tp_conv_forward, mod)
    module._tp_specs = specs
    module._tp = shard


def is_sharded(module: nn.Module) -> bool:
    return bool(getattr(module, "_tp_specs", None))


def sharded_names(module: nn.Module) -> frozenset:
    """The state-dict keys of ``module`` that hold a slice."""
    return frozenset(k for k, d in getattr(module, "_tp_specs", {}).items()
                     if d is not None)


def sync_replicated_grads(module: nn.Module, mesh: Mesh) -> None:
    """Give every rank of the model group the group's mean gradient of
    each replicated parameter: two processes may round its backward
    differently (cuDNN's algorithms, the CPU's kernels with the memory's
    alignment), and a replicated parameter must stay bit-identical across
    the group after every update.  An all-reduce and a division, which
    took less time than a broadcast from model index 0 over NCCL on four
    cards (PERF.md, PR 10); nothing with a model axis of 1."""
    if mesh.model == 1:
        return
    sharded = sharded_names(module)
    grads = [p.grad for n, p in module.named_parameters()
             if n not in sharded and p.grad is not None]

    def mean(t):
        dist.all_reduce(t, group=mesh.model_group)
        t.div_(mesh.model)

    _bucketed(grads, mean)


# --------------------------------------------------------------------------
# the full state
# --------------------------------------------------------------------------

def _gather(tensors: List[Tuple[torch.Tensor, int]],
            shard: _Shard) -> List[torch.Tensor]:
    """Each ``(slice, dim)`` joined with the model group's slices along
    ``dim``; one all-gather per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    # one order on every rank
    for dtype in sorted({t.dtype for t, _ in tensors}, key=str):
        idx = [i for i, (t, _) in enumerate(tensors) if t.dtype == dtype]
        moved = [tensors[i][0].movedim(tensors[i][1], 0) for i in idx]
        flat = torch.cat([m.reshape(-1) for m in moved])
        parts = [torch.empty_like(flat) for _ in range(shard.size)]
        dist.all_gather(parts, flat, group=shard.group)
        offset = 0
        for i, m in zip(idx, moved):
            n = m.numel()
            whole = torch.cat([p[offset:offset + n].view(m.shape) for p in parts])
            out[i] = whole.movedim(0, tensors[i][1]).contiguous()
            offset += n
    return out


def _gather_dict(state: dict, specs: Dict[str, Optional[int]],
                 shard: _Shard) -> dict:
    keys = [k for k in state if specs.get(k) is not None]
    whole = _gather([(state[k].detach(), specs[k]) for k in keys], shard)
    return {**state, **dict(zip(keys, whole))}


def _slice_dict(state: dict, specs: Dict[str, Optional[int]],
                shard: _Shard) -> dict:
    return {k: _narrow(v, specs[k], shard) if specs.get(k) is not None else v
            for k, v in state.items()}


def full_state_dict(module: nn.Module) -> dict:
    """The unsharded state dict of ``module``, with the reference's keys:
    its own where it is not sharded; a collective of the model group where
    it is (every rank of the group calls it)."""
    state = module.state_dict()
    if not is_sharded(module):
        return state
    return _gather_dict(state, module._tp_specs, module._tp)


def load_full_state_dict(module: nn.Module, state: dict) -> None:
    """Load an unsharded state dict into ``module``, this rank's slice of
    each sharded entry (no collective), strictly."""
    if is_sharded(module):
        state = _slice_dict(state, module._tp_specs, module._tp)
    module.load_state_dict(state, strict=True)


def _moment_specs(module: nn.Module) -> List[Optional[int]]:
    """The sharded dim of each parameter, in the order of
    ``module.parameters()``, from which the optimizer was built."""
    return [module._tp_specs[n] for n, _ in module.named_parameters()]


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer,
                              module: nn.Module) -> dict:
    """``optimizer.state_dict()`` with AdamW's ``exp_avg``/``exp_avg_sq``
    of each sharded parameter gathered whole, as :func:`full_state_dict`
    (a collective of the model group where ``module`` is sharded)."""
    state = optimizer.state_dict()
    if not is_sharded(module):
        return state
    dims = _moment_specs(module)
    per_param = {}
    for idx, entry in state["state"].items():
        specs = {k: dims[idx] if torch.is_tensor(v) and v.dim() > 0 else None
                 for k, v in entry.items()}
        per_param[idx] = (entry, specs)
    flat = {(idx, k): v for idx, (entry, _) in per_param.items()
            for k, v in entry.items()}
    flat_specs = {(idx, k): d for idx, (_, specs) in per_param.items()
                  for k, d in specs.items()}
    whole = _gather_dict(flat, flat_specs, module._tp)
    return {**state, "state": {idx: {k: whole[(idx, k)] for k in entry}
                               for idx, (entry, _) in per_param.items()}}


def load_full_optimizer_state_dict(optimizer: torch.optim.Optimizer,
                                   module: nn.Module, state: dict) -> None:
    """Load an unsharded optimizer state dict, this rank's slice of each
    sharded parameter's moments (no collective)."""
    if is_sharded(module):
        dims = _moment_specs(module)
        state = {**state, "state": {
            idx: {k: _narrow(v, dims[idx], module._tp)
                  if dims[idx] is not None and torch.is_tensor(v)
                  and v.dim() > 0 else v for k, v in entry.items()}
            for idx, entry in state["state"].items()}}
    optimizer.load_state_dict(state)
