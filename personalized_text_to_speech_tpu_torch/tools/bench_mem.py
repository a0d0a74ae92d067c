"""Memory audit of the GAN train step: what ``train.accum_steps`` (exact
gradient accumulation) and ``train.remat`` (checkpointing of the generator
forward) buy, the port's counterpart of ``tools/bench_mem.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench_mem
    python -m personalized_text_to_speech_tpu_torch.tools.bench_mem \\
        --combos 1:none 4:none 1:full 4:full

The JAX tool reads XLA's compile-time buffer assignment.  This one runs
each ``accum_steps:remat`` combination on the card (the full width of
``configs/finetune_speaker.json``, or ``--tiny``; a synthetic batch of
``--batch`` × ``--frames`` frames × ``--text`` tokens drawn from a seed):
two warm-up steps, then ``torch.cuda.reset_peak_memory_stats`` and one
step, timed.  One JSON line per combination:

* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over that step, less
  ``base_bytes``, what the process held before the combination's networks
  were built (other work in the same process is not counted);
* ``resident_bytes``: what lives across steps, counted from the tensors:
  both networks' parameters and buffers, their gradients, the AdamW state
  and the batch;
* ``activation_bytes = peak_bytes − resident_bytes``: the part
  accumulation and remat shrink;
* ``step_ms``: the timed step, synchronised.

Each line also carries ``device`` (``utils/profiling.py::device_info``),
``dtype`` and ``tf32``.  On the CPU the byte fields are ``null``: they are
device figures.  ``--dtype bfloat16`` runs the forwards under bf16 autocast
(the config's ``bf16_run``); the default is float32, as the JAX tool.
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Iterable, List, Optional, Sequence

import torch

from personalized_text_to_speech_tpu_torch.tools import common
from personalized_text_to_speech_tpu_torch.utils import profiling

BYTES = ("peak_bytes", "resident_bytes", "activation_bytes", "base_bytes")
WARMUP = 2


def _nbytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def resident_bytes(g_state, d_state, batch) -> int:
    """Parameters and buffers, gradients and AdamW state of both networks,
    and the batch."""
    total = _nbytes(batch)
    for st in (g_state, d_state):
        total += _nbytes(st.module.state_dict().values())
        total += _nbytes(p.grad for p in st.module.parameters())
        for s in st.optimizer.state.values():
            total += _nbytes(v for v in s.values() if isinstance(v, torch.Tensor))
    return total


def measure(combo: str, args, hps, info) -> dict:
    """One ``accum_steps:remat`` combination → its line."""
    from personalized_text_to_speech_tpu_torch.tools.bench_train import (
        build_step,
    )

    k_s, remat = combo.split(":")
    k = int(k_s)
    card = profiling.on_card(args.device)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() if card else 0
    step_once, state = build_step(args.batch, args.frames, args.text,
                                  args.dtype, seed=0, device=args.device,
                                  hps=hps, accum_steps=k, remat=remat)
    for _ in range(WARMUP):
        state, metrics = step_once(state)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step_once(state)
    if card:
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base if card else None
    g_state, d_state, batch, _ = state
    resident = resident_bytes(g_state, d_state, batch)
    row = {
        "metric": "train-step device memory",
        "batch": args.batch, "frames": args.frames, "text": args.text,
        "widths": "tiny" if args.tiny else "production",
        "accum_steps": k, "remat": remat,
        "peak_bytes": peak,
        "resident_bytes": resident,
        "activation_bytes": None if peak is None else peak - resident,
        "base_bytes": base,
        "step_ms": step_ms,
        "loss_g": float(metrics["loss/g/total"]),
    }
    del step_once, state, metrics, g_state, d_state, batch
    return common.emit(row, info, args.dtype, BYTES)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench_mem",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=400,
                    help="spectrogram frame bucket (wav = frames*hop)")
    ap.add_argument("--text", type=int, default=96, help="text bucket")
    ap.add_argument("--combos", nargs="*",
                    default=["1:none", "1:dots", "1:full", "2:none", "4:none",
                             "4:dots"],
                    help="accum_steps:remat pairs")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    common.add_device_flags(ap)
    args = ap.parse_args(argv)
    info = common.setup(args.device)
    hps = common.model_config(args.tiny)
    return [measure(c, args, hps, info) for c in args.combos]


if __name__ == "__main__":
    main()
