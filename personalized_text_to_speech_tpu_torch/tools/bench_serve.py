"""Concurrent-load serving benchmark: throughput and per-request latency of
the micro-batched engine under N simultaneous clients, the port's
counterpart of ``tools/bench_serve.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench_serve --clients 1,16

Drives ``MicroBatcher`` directly (no HTTP; that path has its tests) with a
closed loop: each of N client threads issues back-to-back ``tts`` calls for
``--duration`` seconds.  Reports audio seconds per wall second (the serving
1/RTF under load), p50/p95/p99 latency, and the batching the micro-batcher
achieved.  The clients are Python threads and hold the interpreter lock
while they dispatch eager PyTorch, as the port's server threads do; the
tool measures that as it is.

Past saturation (``--clients`` well above ``--max_queue``) the bounded
admission queue sheds requests; a shed client backs off ``--backoff_ms``
and retries, and the shed count and rate are reported.  ``--compare`` runs
the same sentences through ``engine.tts`` and through the batcher with one
client, in turns, and reports both p50s.  The warm-up of every
power-of-two batch the batcher can emit is timed and reported as set-up
(``warmup_s``).  ``--device cpu --tiny`` runs the same loop on the CPU with
every rate ``None``.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from personalized_text_to_speech_tpu_torch.tools import common

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "A watched pot never boils, but it certainly steams.",
    "She sells seashells by the seashore every morning.",
    "Better late than never, but never late is better.",
    "The early bird catches the worm before sunrise.",
    "Practice makes perfect when patience guides the hand.",
    "Every cloud has a silver lining somewhere above.",
    "Actions speak louder than words in every language.",
]
RATES = ("requests_per_s", "audio_s_per_wall_s")


def parse_client_specs(spec_list: str, default_queue: int):
    """``'1,8,16,64/16'`` → ``[(1, q), (8, q), (16, q), (64, 16)]``.

    Each comma-separated point is ``N`` (clients, default queue) or
    ``N/queue``.  All points run in one process, on one engine."""
    points = []
    for spec in spec_list.split(","):
        spec = spec.strip()
        if not spec:
            continue
        if "/" in spec:
            n_str, q_str = spec.split("/")
            points.append((int(n_str), int(q_str)))
        else:
            points.append((int(spec), default_queue))
    if not points:
        raise ValueError(f"no load points in --clients={spec_list!r}")
    return points


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench_serve")
    ap.add_argument("--clients", type=str, default="8",
                    help="comma list of load points; each point is 'N' or "
                         "'N/queue' (e.g. '1,8,16,64/16'), all in one process")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_queue", type=int, default=64)
    ap.add_argument("--backoff_ms", type=float, default=50.0,
                    help="client sleep after a shed before retrying")
    ap.add_argument("--window_ms", type=float, default=5.0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--compare", action="store_true",
                    help="one client: the same sentences through engine.tts "
                         "and through batcher.tts in turns, both p50s")
    common.add_device_flags(ap)
    args = ap.parse_args(argv)
    info = common.setup(args.device)

    from personalized_text_to_speech_tpu_torch.infer.batching import (
        MicroBatcher,
        OverloadedError,
    )
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    hps = common.model_config(args.tiny)
    eng = TTSEngine(hps, device=args.device, dtype=args.dtype)
    engine_kind = "tiny-behavioral" if args.tiny else "full"
    n_sid = min(8, int(hps.data.n_speakers))
    batcher = MicroBatcher(eng, max_batch=args.max_batch,
                           window_ms=args.window_ms, max_queue=args.max_queue)
    # every sentence's bucket at every power-of-two batch the batcher can
    # emit: the padding to powers of two bounds the shapes to warm
    t0 = time.perf_counter()
    batcher.warmup(SENTENCES, language="English")
    warmup_s = time.perf_counter() - t0

    if args.compare:
        half = max(1, int(args.duration) // 2)
        direct_lat, batched_lat = [], []
        deadline = time.monotonic() + 2 * half
        j = 0
        try:
            while time.monotonic() < deadline:
                text = SENTENCES[j % len(SENTENCES)]
                t0 = time.perf_counter()
                eng.tts(text, speaker=j % n_sid, language="English")
                direct_lat.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                batcher.tts(text, speaker=j % n_sid, language="English")
                batched_lat.append(time.perf_counter() - t0)
                j += 1
        finally:
            batcher.close()
        d50 = float(np.percentile(direct_lat, 50)) * 1000
        b50 = float(np.percentile(batched_lat, 50)) * 1000
        return [common.emit({
            "metric": "micro-batcher lone-client overhead (same window)",
            "pairs": len(direct_lat),
            "direct_p50_ms": d50,
            "batched_p50_ms": b50,
            "overhead_ms": b50 - d50,
            "direct_p95_ms": float(np.percentile(direct_lat, 95)) * 1000,
            "batched_p95_ms": float(np.percentile(batched_lat, 95)) * 1000,
            "window_ms": args.window_ms,
            "warmup_s": warmup_s,
            "engine": engine_kind,
        }, info, args.dtype, RATES)]

    batcher.close()

    def run_point(n_clients: int, max_queue: int) -> dict:
        point = MicroBatcher(eng, max_batch=args.max_batch,
                             window_ms=args.window_ms, max_queue=max_queue)
        go = threading.Event()
        lat, audio_s = [], []
        sheds = [0]
        lock = threading.Lock()
        stop_at = [0.0]

        def client(i):
            go.wait()
            j = i
            while time.monotonic() < stop_at[0]:
                text = SENTENCES[j % len(SENTENCES)]
                j += 1
                t0 = time.perf_counter()
                try:
                    sr, wav = point.tts(text, speaker=i % n_sid,
                                        language="English")
                except OverloadedError:
                    with lock:
                        sheds[0] += 1
                    time.sleep(args.backoff_ms / 1000.0)
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
                    audio_s.append(len(wav) / sr)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        t_start = time.perf_counter()
        stop_at[0] = time.monotonic() + args.duration
        go.set()
        try:
            for t in threads:
                t.join()
        finally:
            point.close()
        wall = time.perf_counter() - t_start
        lat_np = np.asarray(lat)
        stats = point.stats_snapshot()
        return common.emit({
            "metric": "serving throughput under concurrent load (micro-batched)",
            "clients": n_clients,
            "requests": len(lat),
            "wall_s": wall,
            "requests_per_s": len(lat) / wall,
            "audio_s_per_wall_s": float(np.sum(audio_s)) / wall,
            "latency_p50_ms": float(np.percentile(lat_np, 50)) * 1000,
            "latency_p95_ms": float(np.percentile(lat_np, 95)) * 1000,
            "latency_p99_ms": float(np.percentile(lat_np, 99)) * 1000,
            "shed": sheds[0],
            "shed_rate": sheds[0] / max(sheds[0] + len(lat), 1),
            "max_queue": max_queue,
            "dispatches": stats["dispatches"],
            "mean_batch": stats["requests"] / max(stats["dispatches"], 1),
            "max_batch_seen": stats["max_batch_seen"],
            "window_ms": args.window_ms,
            "warmup_s": warmup_s,
            "engine": engine_kind,
        }, info, args.dtype, RATES)

    return [run_point(n, q)
            for n, q in parse_client_specs(args.clients, args.max_queue)]


if __name__ == "__main__":
    main()
