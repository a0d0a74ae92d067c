"""Runtime set-up: refuse a card that is not there, pay the first device
round trip before anything is timed, and join the process group of a
data-parallel run.

Counterpart of ``personalized_text_to_speech_tpu/utils/runtime.py``, whose
``enable_compilation_cache`` has no counterpart here: PyTorch runs eagerly
and compiles nothing ahead of a call.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective waits for a peer before it raises: a lost or failed
# rank ends the others with an error instead of a hang
DEFAULT_TIMEOUT_S = 600.0


def require_card(device) -> None:
    """Raise ``SystemExit`` with a clear message when ``device`` is a CUDA
    device and there is no card (in place of ``require_tpu_reachable``):
    a measurement meant for the card never falls back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"device {device!r} asked for, but torch finds no CUDA device; "
            "run on a machine with a card, or pass --device cpu for a CPU "
            "run (whose rates are not device figures)"
        )


def warmup_transfers(device) -> float:
    """One device round trip (CUDA context and first copy set up); returns
    the seconds it took, so it never lands inside a timed call."""
    t0 = time.perf_counter()
    x = torch.zeros((8, 128), device=device)
    (x + 1.0).cpu()
    return time.perf_counter() - t0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group of a data-parallel run (the reference's
    ``dist.init_process_group('nccl', init_method='env://')``,
    ``finetune_speaker_v2.py:69``; JAX's ``jax.distributed.initialize``).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group meets at ``tcp://<coordinator_address>``;
    without them it reads the ``env://`` variables that ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  The
    backend is ``nccl`` when torch sees a card and ``gloo`` otherwise;
    ``backend="gloo"`` also takes CUDA tensors, which two ranks on one card
    need (NCCL refuses them).  Under NCCL the process takes the card
    ``LOCAL_RANK`` (else its rank) modulo the count of cards.  Every
    collective of the group raises after ``timeout_s`` seconds without its
    peers."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator address needs "
                             "num_processes and process_id")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
