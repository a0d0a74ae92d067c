"""Concurrent-request micro-batching for serving.

The port's own copy of ``personalized_text_to_speech_tpu/infer/batching.py``
(pure Python and numpy; nothing is shared with the JAX package).  The
engine's bucketed batch path is where a card's serving throughput lives,
but a server that makes one device call per request runs at batch 1.  The
reference's Gradio app (``VC_inference.py``) has no answer to this: every
request is a whole single-utterance round trip.

``MicroBatcher`` closes the gap: handler threads enqueue single utterances;
one worker thread drains the queue, waits at most ``window_ms`` for
stragglers (the window opens at the FIRST queued request, so an idle server
adds no latency), groups compatible requests (same noise/length scalars:
they are per call, not per row), and issues ONE ``synthesize_ids`` call per
group.  Under concurrent load the card sees batches, not singles; a lone
request pays only the window.

The worker thread is the only caller on the card.  Share ``device_lock``
with every other user of the engine (streaming, VC, long-form) to serialize
against them: the engine's per-call seed counter is not re-entrant.

Backpressure: admission is bounded by ``max_queue`` pending requests.  When
arrivals outpace the card, new requests are shed at once with
``OverloadedError`` instead of queueing without bound; the HTTP layer maps
this to 503 so clients can back off, and in-flight latency stays bounded by
``max_queue / throughput``.  The reference's Gradio app
(``VC_inference.py:77-99``) queues without bound.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MicroBatcher", "OverloadedError"]

_STOP = object()


class OverloadedError(RuntimeError):
    """Admission queue is full — shed the request (HTTP 503)."""


@dataclass
class _Request:
    ids: Sequence[int]
    sid: int
    params: Tuple  # (noise_scale, noise_scale_w, length_scale)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


class MicroBatcher:
    def __init__(
        self,
        engine,
        max_batch: int = 16,
        window_ms: float = 5.0,
        device_lock: Optional[threading.Lock] = None,
        max_queue: int = 64,
    ):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self.device_lock = device_lock or threading.Lock()
        self.stats: Dict[str, Any] = {
            "requests": 0, "dispatches": 0, "max_batch_seen": 0, "shed": 0,
        }
        self._stats_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=int(max_queue))
        self._worker = threading.Thread(
            target=self._run, name="microbatcher", daemon=True
        )
        self._worker.start()

    # -- client side ---------------------------------------------------
    def tts(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        timeout: Optional[float] = 120.0,
    ) -> Tuple[int, np.ndarray]:
        """Drop-in for ``engine.tts`` that batches with concurrent callers.
        Text→ids runs in the calling thread (pure CPU, parallel-safe)."""
        ids = self.engine.text_to_ids(text, language)
        req = _Request(
            ids=ids,
            sid=self.engine.speaker_id(speaker),
            params=(float(noise_scale), float(noise_scale_w),
                    1.0 / float(speed)),
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            raise OverloadedError(
                "admission queue full — server overloaded, retry later"
            ) from None
        if not req.done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if req.error is not None:
            raise req.error
        return self.engine.sampling_rate, req.result

    def warmup(
        self,
        texts: Sequence[str] = ("Warming up the serving batcher now.",),
        language: Optional[str] = None,
        speaker=0,
    ) -> None:
        """Run every power-of-two batch shape the batcher can emit for the
        given texts' buckets once, so first requests meet no new shape."""
        sid = self.engine.speaker_id(speaker)
        for text in texts:
            ids = self.engine.text_to_ids(text, language)
            size = 1
            while size <= self.max_batch:
                with self.device_lock:
                    self.engine.synthesize_ids([ids] * size, [sid] * size)
                size *= 2

    def stats_snapshot(self) -> Dict[str, Any]:
        """Stats plus the instantaneous admission-queue depth."""
        with self._stats_lock:
            snap = dict(self.stats)
        snap["queue_depth"] = self._q.qsize()
        snap["max_queue"] = self._q.maxsize
        return snap

    def close(self) -> None:
        self._q.put(_STOP)
        self._worker.join(timeout=10)

    # -- worker side ---------------------------------------------------
    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            batch: List[_Request] = [first]
            deadline = time.monotonic() + self.window_s
            stop_after = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is _STOP:
                    stop_after = True
                    break
                batch.append(item)

            groups: Dict[Tuple, List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.params, []).append(r)
            for params, reqs in groups.items():
                noise_scale, noise_scale_w, length_scale = params
                # pad the batch dim to the next power of two (duplicating
                # the last row): each new batch size sets up new cuDNN and
                # cuBLAS plans, so padding bounds the shapes per bucket pair
                # to log2(max_batch), all warmable up front
                ids = [r.ids for r in reqs]
                sids = [r.sid for r in reqs]
                n = len(reqs)
                target = 1 << (n - 1).bit_length()
                ids += [ids[-1]] * (target - n)
                sids += [sids[-1]] * (target - n)
                try:
                    with self.device_lock:
                        wavs = self.engine.synthesize_ids(
                            ids, sids,
                            noise_scale=noise_scale,
                            noise_scale_w=noise_scale_w,
                            length_scale=length_scale,
                        )[:n]
                    for r, w in zip(reqs, wavs):
                        r.result = w
                except Exception as e:  # deliver to the callers; the worker lives on
                    for r in reqs:
                        r.error = e
                finally:
                    for r in reqs:
                        r.done.set()
                with self._stats_lock:
                    self.stats["requests"] += len(reqs)
                    self.stats["dispatches"] += 1
                    self.stats["max_batch_seen"] = max(
                        self.stats["max_batch_seen"], len(reqs)
                    )
            if stop_after:
                return
