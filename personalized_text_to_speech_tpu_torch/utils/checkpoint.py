"""Full train-state checkpoints with rolling retention.

Counterpart of ``personalized_text_to_speech_tpu/utils/checkpoint.py`` (Orbax
there, ``torch.save`` here).  Each checkpoint holds both networks' params,
both AdamW states, both schedules, both update counts and the Trainer's step
label, so a resume continues where the run stopped: the reference saved
weights only and lost its optimizer state on resume (reference
``utils.py:183-193``).  The newest ``preserved`` checkpoints are kept, as
the reference keeps four rolling ``G_*.pth``.  Reference-layout ``.pth``
import and export live in :mod:`.torch_compat`.

Files: ``<dir>/step_<00000000>.pt``, written to a temporary name and renamed,
so a run killed mid-write leaves the previous checkpoint whole.

Under tensor parallelism (:mod:`..parallel.tp`) a checkpoint holds the full
parameters and AdamW moments (:meth:`~..train.state.TrainState.state_dict`
gathers them over the model group, so every rank calls
:func:`save_train_state` and one writes), and a restore keeps each rank's
slices: the file is the same whatever the tp size, and a run resumes at
another.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from personalized_text_to_speech_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
                  if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def save_train_state(directory: str, step: int, g_state: TrainState,
                     d_state: TrainState, preserved: int = 4,
                     write: bool = True) -> Optional[str]:
    """Write the checkpoint of ``step`` (the full state) when ``write``;
    delete all but the newest ``preserved``.  Returns its path, or
    ``None`` on a rank that only took part in the gathering."""
    payload = {"step": step, "g": g_state.state_dict(),
               "d": d_state.state_dict()}
    if not write:
        return None
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max(int(preserved), 1)]:
        os.remove(_path(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_train_state(directory: str, g_state: TrainState,
                        d_state: TrainState) -> Optional[int]:
    """Load the newest checkpoint into the two states in place (this rank's
    slices of a sharded state); returns its step label, or None where there
    is none."""
    step = latest_step(directory)
    if step is None:
        return None
    # read to the host: the module and optimizer loads move each tensor
    # where its parameter lives, and AdamW's step counts stay on the host,
    # where AdamW keeps them
    payload = torch.load(_path(directory, step), map_location="cpu",
                         weights_only=True)
    g_state.load_state_dict(payload["g"])
    d_state.load_state_dict(payload["d"])
    return int(payload["step"])
