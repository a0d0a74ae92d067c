"""Streaming latency benchmark: time to the first audio of the in-sentence
chunked decode (``TTSEngine.stream_tts``) against the whole render
(``tts``), the port's counterpart of ``tools/bench_stream.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench_stream

Both paths render ``LONG_SENTENCE`` with the same seed, two warm-ups each,
then ``--reps`` timed runs each.  Prints one JSON line: the p50 time to the
first chunk (``value``), the p50 of the whole render, of the whole stream
and of the gap between chunks, and the real-time margin (a chunk's audio
seconds over the p50 gap; above 1 the playback has no gaps).  ``--device
cpu`` runs the same steps on the CPU with the margin ``None``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np

from personalized_text_to_speech_tpu_torch.tools import common

LONG_SENTENCE = (
    "The lighthouse keeper climbed the winding staircase every evening at "
    "dusk to light the great lamp, watching the fishing boats return across "
    "the darkening bay while gulls wheeled and cried above the harbor walls."
)
RATES = ("realtime_margin",)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench_stream")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--chunk_frames", type=int, default=96)
    ap.add_argument("--halo_frames", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    common.add_device_flags(ap)
    args = ap.parse_args(argv)
    info = common.setup(args.device)

    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    eng = TTSEngine(common.model_config(args.tiny), device=args.device,
                    dtype=args.dtype)

    def run_stream():
        """→ (time to the first piece, to the last, gaps, audio seconds)"""
        t0 = time.perf_counter()
        times, audio = [], 0.0
        for sr, piece in eng.stream_tts(
            LONG_SENTENCE, 0, "English", chunk_frames=args.chunk_frames,
            halo_frames=args.halo_frames, rng=0,
        ):
            times.append(time.perf_counter() - t0)
            audio += len(piece) / sr
        return times[0], times[-1], np.diff(times), audio

    run_stream()
    run_stream()
    eng.tts(LONG_SENTENCE, 0, "English", rng=0)
    eng.tts(LONG_SENTENCE, 0, "English", rng=0)

    ttfas, totals, gaps, audio_s = [], [], [], 0.0
    for _ in range(args.reps):
        f, t, g, audio_s = run_stream()
        ttfas.append(f)
        totals.append(t)
        gaps.extend(g)
    mono = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        eng.tts(LONG_SENTENCE, 0, "English", rng=0)
        mono.append(time.perf_counter() - t0)

    chunk_audio_s = args.chunk_frames * eng.hop_length / eng.sampling_rate
    p50_gap = float(np.percentile(gaps, 50)) if len(gaps) else 0.0
    row = {
        "metric": "time_to_first_audio_ms (stream_tts)",
        "value": float(np.percentile(ttfas, 50)) * 1000,
        "unit": "ms",
        "monolithic_p50_ms": float(np.percentile(mono, 50)) * 1000,
        "stream_total_p50_ms": float(np.percentile(totals, 50)) * 1000,
        "chunk_p50_ms": p50_gap * 1000,
        "chunk_audio_ms": chunk_audio_s * 1000,
        "realtime_margin": chunk_audio_s / p50_gap if p50_gap else None,
        "sentence_audio_s": audio_s,
        "chunk_frames": args.chunk_frames,
        "halo_frames": args.halo_frames,
    }
    return [common.emit(row, info, args.dtype, RATES)]


if __name__ == "__main__":
    main()
