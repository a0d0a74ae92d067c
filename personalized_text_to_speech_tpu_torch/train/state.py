"""Train states and optimizers of the two GAN networks.

Counterpart of ``personalized_text_to_speech_tpu/train/state.py``
(``make_optimizer`` at ``:33``, ``global_norm`` at ``:71``), with the
reference's optimizer (reference ``finetune_speaker_v2.py:133-148``,
``configs/finetune_speaker.json:7-12``): AdamW with lr 2e-4, betas
(0.8, 0.99), eps 1e-9 and weight decay 0.01, and a per-epoch exponential
decay γ = 0.999875 taken as a staircase, ``lr·γ^⌊step/steps_per_epoch⌋``,
through a per-step ``LambdaLR``.  As in optax, update ``k`` (from 0) runs at
``lr·γ^⌊k/steps_per_epoch⌋``.  Gradient norms are logged, never clipped
(the reference's ``clip_grad_value_(…, None)``).

Under tensor parallelism (:mod:`..parallel.tp`) the module holds slices and
AdamW updates them; :meth:`TrainState.state_dict` is nonetheless the full
state (a collective of the model group) and :meth:`TrainState.load_state_dict`
takes the full state and keeps this rank's slices, so a checkpoint is one
file whatever the tp size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from personalized_text_to_speech_tpu_torch.parallel import tp


def make_optimizer(
    params: Iterable[nn.Parameter],
    learning_rate: float,
    betas: Sequence[float] = (0.8, 0.99),
    eps: float = 1e-9,
    lr_decay: float = 0.999875,
    steps_per_epoch: int = 1,
    weight_decay: float = 0.01,
):
    """→ (AdamW, its staircase ``LambdaLR``), every setting explicit."""
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps, weight_decay=weight_decay)
    spe = max(int(steps_per_epoch), 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_decay ** (step // spe)
    )
    return opt, sched


@dataclass
class TrainState:
    """A network with its optimizer, schedule and count of updates (the
    counterpart of flax's ``TrainState``; here the module is updated in
    place)."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``, then the schedule."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def state_dict(self) -> dict:
        """The full state: every rank of a model group calls it."""
        return {
            "params": tp.full_state_dict(self.module),
            "optimizer": tp.full_optimizer_state_dict(self.optimizer,
                                                      self.module),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        """From the full state; no collective."""
        tp.load_full_state_dict(self.module, state["params"])
        tp.load_full_optimizer_state_dict(self.optimizer, self.module,
                                          state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def create_train_state(module: nn.Module, hps, steps_per_epoch: int) -> TrainState:
    opt, sched = make_optimizer(
        module.parameters(),
        learning_rate=hps.train.learning_rate,
        betas=tuple(hps.train.betas),
        eps=hps.train.eps,
        lr_decay=hps.train.lr_decay,
        steps_per_epoch=steps_per_epoch,
    )
    return TrainState(module, opt, sched)


def global_norm(tensors: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                group: Optional["dist.ProcessGroup"] = None) -> torch.Tensor:
    """Global L2 norm over a list of gradients, in float32 (the metric the
    reference logs as grad_norm_g/grad_norm_d, ``commons.py:149-164``).
    Under tensor parallelism ``sharded`` marks the slices: their squares
    are summed over the model ``group``, and each replicated tensor, which
    every rank holds whole, counts once."""
    if sharded is None or not any(sharded):
        return torch.nn.utils.get_total_norm([t.float() for t in tensors], 2.0)

    def sq(part):
        if not part:
            return torch.zeros((), device=tensors[0].device)
        return torch.nn.utils.get_total_norm([t.float() for t in part],
                                             2.0).square()

    shards = sq([t for t, s in zip(tensors, sharded) if s])
    dist.all_reduce(shards, group=group)
    return (shards + sq([t for t, s in zip(tensors, sharded) if not s])).sqrt()
