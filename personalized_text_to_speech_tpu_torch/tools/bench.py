"""Benchmark: end-to-end text → waveform synthesis throughput (1/RTF) on one
card, the port's counterpart of the root ``bench.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench

Prints one JSON line per finished trial (``provisional`` until the last):
``{"metric", "value", "unit", "vs_baseline", ...}``, ``value`` being audio
seconds per wall second and ``vs_baseline`` that over the target of 50×
real time per card.

Methodology, as ``bench.py``: the full width of
``configs/finetune_speaker.json``, random weights, bf16 by default
(``PTTS_BENCH_DTYPE=float32``); a batch of ``PTTS_BENCH_BATCH`` (64) English
sentences with fixed seeds, so the frame bucket is the same every call; two
warm-up calls; then ``PTTS_BENCH_TRIALS`` (3) trials of ``PTTS_BENCH_REPS``
(5) pipelined calls (call i+1 submitted before call i is collected, PCM16
quantized on the card); 1/RTF from the true, unpadded audio lengths, the
median of the trials.  The p50 latency of one utterance comes last, unless
``PTTS_BENCH_BUDGET_S`` (480 s from the start) has run out.  ``--device
cpu`` runs the same steps on the CPU, with every rate ``None``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from personalized_text_to_speech_tpu_torch.tools import common

SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Speech synthesis converts written language into audible speech.",
    "Yesterday it rained all morning, but the afternoon was bright and clear.",
    "Please remember to close the windows before you leave the building.",
    "Modern hardware accelerates matrix multiplication astonishingly well.",
    "A journey of a thousand miles begins with a single step forward.",
    "She sells seashells by the seashore on sunny summer mornings.",
    "The committee will announce its final decision early next week.",
]
TARGET = 50.0  # ≥50× real time per card
RATES = ("value", "vs_baseline", "best", "trial_rtfs")


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench")
    common.add_device_flags(parser)
    args = parser.parse_args(argv)
    t_process = time.perf_counter()
    info = common.setup(args.device)

    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    dtype = os.environ.get("PTTS_BENCH_DTYPE", "bfloat16")
    batch = int(os.environ.get("PTTS_BENCH_BATCH", "64"))
    reps = int(os.environ.get("PTTS_BENCH_REPS", "5"))
    trials = int(os.environ.get("PTTS_BENCH_TRIALS", "3"))
    budget_s = float(os.environ.get("PTTS_BENCH_BUDGET_S", "480"))

    hps = common.model_config(args.tiny)
    eng = TTSEngine(hps, device=args.device, dtype=dtype)
    texts = (SENTENCES * ((batch + len(SENTENCES) - 1) // len(SENTENCES)))[:batch]
    id_seqs = [eng.text_to_ids(t, "English") for t in texts]
    sids = [i % min(10, hps.data.n_speakers) for i in range(batch)]
    # fixed seeds keep the durations, and so the frame bucket, the same in
    # every call: the warm-up meets every shape the timed calls run
    eng.synthesize_ids(id_seqs, sids, rng=0, pcm16=True)
    eng.synthesize_ids(id_seqs, sids, rng=0, pcm16=True)

    def timed_trial() -> float:
        t0 = time.perf_counter()
        total_audio = 0.0
        pending = eng.submit_ids(id_seqs, sids, rng=0, pcm16=True)
        for i in range(reps):
            nxt = (eng.submit_ids(id_seqs, sids, rng=0, pcm16=True)
                   if i + 1 < reps else None)
            wavs = eng.collect(pending, eng.hop_length, dtype=np.int16)
            total_audio += sum(len(w) for w in wavs) / eng.sampling_rate
            pending = nxt
        return total_audio / (time.perf_counter() - t0)

    rows = []

    def emit(trial_rtfs, p50_ms=None, provisional=False):
        inv_rtf = float(np.median(trial_rtfs))
        row = {
            "metric": "synthesized audio sec/sec/card (1/RTF) text→wav",
            "value": inv_rtf,
            "unit": "x_realtime",
            "vs_baseline": inv_rtf / TARGET,
            "batch": batch,
            "best": float(max(trial_rtfs)),
            "trial_rtfs": list(trial_rtfs),
            "p50_latency_ms": p50_ms,
        }
        if provisional:
            row["provisional"] = True
        rows.append(common.emit(row, info, dtype, RATES))

    def over_budget():
        return budget_s > 0 and time.perf_counter() - t_process > budget_s

    trial_rtfs = []
    for t in range(trials):
        trial_rtfs.append(timed_trial())
        if t + 1 < trials:
            emit(trial_rtfs, provisional=True)
            if over_budget():
                break

    p50_ms = None
    if not over_budget():
        lat = []
        single = [id_seqs[0]]
        eng.synthesize_ids(single, [0], rng=1, pcm16=True)  # its bucket
        eng.synthesize_ids(single, [0], rng=1, pcm16=True)
        for _ in range(max(reps * 3, 15)):
            t0 = time.perf_counter()
            eng.synthesize_ids(single, [0], rng=1, pcm16=True)
            lat.append(time.perf_counter() - t0)
            if over_budget():
                break
        p50_ms = float(np.percentile(lat, 50) * 1000)
    emit(trial_rtfs, p50_ms=p50_ms)
    return rows


if __name__ == "__main__":
    main()
