"""The port's ``MicroBatcher`` against a fake engine (no device, no JAX):
the cases of ``tests/test_batching.py`` (pass-through, grouping, padding to
a power of two, result ordering, load shedding, error delivery), run on
the port's own copy, plus a stress test of its shared counters."""

import sys
import threading
import time

import numpy as np
import pytest

from personalized_text_to_speech_tpu_torch.infer.batching import (
    MicroBatcher,
    OverloadedError,
)


class FakeEngine:
    sampling_rate = 16000

    def __init__(self, delay=0.0):
        self.calls = []  # (padded batch size, params)
        self.delay = delay

    def text_to_ids(self, text, language=None):
        return [ord(c) % 60 for c in text]

    def speaker_id(self, speaker):
        return int(speaker)

    def synthesize_ids(self, id_seqs, sids, noise_scale=0.667,
                       noise_scale_w=0.8, length_scale=1.0):
        self.calls.append((len(id_seqs), (noise_scale, noise_scale_w, length_scale)))
        if self.delay:
            time.sleep(self.delay)
        # the wav's length is the ids' and its value the speaker's, so each
        # caller can tell its own result
        return [np.full(len(ids), float(sid), np.float32)
                for ids, sid in zip(id_seqs, sids)]


def _run_threads(target, n, timeout=30):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def test_single_request_passthrough():
    eng = FakeEngine()
    mb = MicroBatcher(eng, max_batch=8, window_ms=1.0)
    sr, wav = mb.tts("abc", speaker=3)
    assert sr == 16000
    assert wav.shape == (3,) and wav[0] == 3.0
    assert eng.calls[0][0] == 1  # no padding for batch 1
    mb.close()


@pytest.mark.parametrize("n,padded", [(3, 4), (5, 8), (2, 2)])
def test_concurrent_requests_batch_and_pad_pow2(n, padded):
    eng = FakeEngine(delay=0.05)
    mb = MicroBatcher(eng, max_batch=8, window_ms=100.0)
    results = {}

    def call(i):
        results[i] = mb.tts("x" * (i + 1), speaker=i)

    _run_threads(call, n)
    for i in range(n):  # every caller got ITS wav
        _, wav = results[i]
        assert wav.shape == (i + 1,) and wav[0] == float(i)
    assert max(c[0] for c in eng.calls) == padded
    assert mb.stats["max_batch_seen"] == n
    assert mb.stats["dispatches"] < mb.stats["requests"] == n
    mb.close()


def test_different_params_split_groups():
    eng = FakeEngine(delay=0.05)
    mb = MicroBatcher(eng, max_batch=8, window_ms=100.0)
    scales = {0: 0.5, 1: 0.9}
    _run_threads(lambda i: mb.tts("hello", speaker=0, noise_scale=scales[i]), 2)
    assert len(eng.calls) == 2  # other scalars never share a call
    assert {c[1][0] for c in eng.calls} == {0.5, 0.9}
    mb.close()


def test_overload_sheds_with_bounded_queue():
    # a slow device and an admission queue of 2: a burst of 10 must shed
    eng = FakeEngine(delay=0.2)
    mb = MicroBatcher(eng, max_batch=1, window_ms=0.0, max_queue=2)
    ok, shed = [], []
    lock = threading.Lock()

    def call(i):
        try:
            _, wav = mb.tts("abcd", speaker=i)
            with lock:
                ok.append((i, wav))
        except OverloadedError:
            with lock:
                shed.append(i)

    _run_threads(call, 10)
    assert len(ok) + len(shed) == 10
    assert shed and ok
    for i, wav in ok:
        assert wav[0] == float(i)  # shedding never corrupts admitted results
    assert mb.stats["shed"] == len(shed)
    snap = mb.stats_snapshot()
    assert snap["max_queue"] == 2 and "queue_depth" in snap
    mb.close()


def test_no_shed_under_bound():
    mb = MicroBatcher(FakeEngine(), max_batch=8, window_ms=1.0, max_queue=64)
    for _ in range(5):
        mb.tts("abc", speaker=0)
    assert mb.stats["shed"] == 0 and mb.stats["requests"] == 5
    mb.close()


def test_error_delivered_not_fatal():
    eng = FakeEngine()

    def boom(*a, **k):
        raise RuntimeError("synth failed")

    eng.synthesize_ids = boom
    mb = MicroBatcher(eng, max_batch=4, window_ms=1.0)
    with pytest.raises(RuntimeError, match="synth failed"):
        mb.tts("abc", speaker=0)
    # the worker survives and serves the next request
    eng.synthesize_ids = lambda ids, sids, **k: [np.zeros(3, np.float32)] * len(ids)
    _, wav = mb.tts("abc", speaker=0)
    assert wav.shape == (3,)
    mb.close()


def test_warmup_runs_every_power_of_two():
    eng = FakeEngine()
    mb = MicroBatcher(eng, max_batch=8, window_ms=1.0)
    mb.warmup(texts=("abc",))
    assert [c[0] for c in eng.calls] == [1, 2, 4, 8]
    mb.close()


def test_stress_counters_and_results_under_contention():
    """More client threads than cores, a short switch interval: no request
    is lost, miscounted or answered with another caller's wav."""
    eng = FakeEngine()
    mb = MicroBatcher(eng, max_batch=16, window_ms=2.0, max_queue=1024)
    n_threads, per_thread = 48, 5
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def call(i):
            for j in range(per_thread):
                _, wav = mb.tts("y" * (1 + (i + j) % 7), speaker=i)
                if wav.shape != (1 + (i + j) % 7,) or wav[0] != float(i):
                    bad.append((i, j))

        _run_threads(call, n_threads, timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert mb.stats["requests"] == n_threads * per_thread
    assert mb.stats["shed"] == 0
    assert mb.stats["dispatches"] == len(eng.calls)
    mb.close()
