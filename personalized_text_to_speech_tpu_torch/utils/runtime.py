"""Runtime set-up of the tools: refuse a card that is not there, and pay the
first device round trip before anything is timed.

Counterpart of ``personalized_text_to_speech_tpu/utils/runtime.py``, whose
other two functions have no counterpart here: ``enable_compilation_cache``,
because PyTorch runs eagerly and compiles nothing ahead of a call, and
``init_distributed``, because data parallelism (DDP) is not ported yet
(ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import time

import torch


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
