"""The port's HTTP API and CLIs on the CPU engine, in process, at the tiny
geometry of ``tiny_model_config()`` (random weights).

The server is built with ``TTSServer`` (port 0) and served from a thread:
``/healthz``, ``/speakers``, ``/stats``, ``/tts`` (wav, concurrent requests
sharing calls through the micro-batcher, long-form), ``/tts_stream``
(a chunked WAV of the engine's frame chunks), ``/vc`` (``X-VC`` header), the
413 body cap, the 503 shed and errors as JSON.  The tts CLI runs as
``python -m ... --device cpu``; both CLIs default to the card and raise
without one.
"""

import argparse
import io
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from personalized_text_to_speech_tpu_torch.config import (
    save_hparams,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import load_wav
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.tools import serve as serve_tool
from personalized_text_to_speech_tpu_torch.tools import tts as tts_tool

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _args(**kw):
    base = dict(host="127.0.0.1", port=0, max_body_mb=1, max_batch=8,
                batch_window_ms=50.0, max_queue=64)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def engine():
    eng = TTSEngine(tiny_model_config(), device="cpu", seed=5)
    eng.warmup()
    return eng


def _start(engine, args):
    srv = serve_tool.TTSServer(engine, args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(engine):
    srv, thread = _start(engine, _args())
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    _stop(srv, thread)


def _post(url, payload=None, data=None, headers=None, timeout=120):
    body = json.dumps(payload).encode() if data is None else data
    req = urllib.request.Request(url, data=body, headers=headers or {
        "Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _read_wav(body):
    sr, pcm = wavfile.read(io.BytesIO(body))
    return sr, pcm


def test_healthz_speakers_stats(server):
    _, url = server
    assert urllib.request.urlopen(f"{url}/healthz").read() == b"ok"
    assert json.loads(urllib.request.urlopen(f"{url}/speakers").read()) == {
        "alice": 0, "bob": 1}
    stats = json.loads(urllib.request.urlopen(f"{url}/stats").read())
    assert {"requests", "dispatches", "shed", "queue_depth", "max_queue"} <= set(stats)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nothing")
    assert e.value.code == 404


@pytest.mark.parametrize("long_form", [False, True], ids=["single", "long-form"])
def test_tts_returns_wav(server, engine, long_form):
    _, url = server
    text = "Hello there. Bye now." if long_form else "Hello there."
    resp = _post(f"{url}/tts", {"text": text, "speaker": "bob",
                                "language": "English", "long_form": long_form})
    assert resp.headers["Content-Type"] == "audio/wav"
    sr, pcm = _read_wav(resp.read())
    assert sr == engine.sampling_rate and pcm.dtype == np.int16
    assert len(pcm) > 0 and np.abs(pcm).max() > 0


def test_concurrent_tts_share_calls(server):
    srv, url = server
    before = srv.batcher.stats_snapshot()
    n, bodies, errors = 6, [None] * 6, []

    def call(i):
        try:
            bodies[i] = _post(f"{url}/tts", {
                "text": f"Concurrent request number {i}.", "speaker": 0,
                "language": "English"}).read()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for body in bodies:
        with wave.open(io.BytesIO(body)) as w:
            assert w.getnframes() > 0
    after = srv.batcher.stats_snapshot()
    assert after["requests"] - before["requests"] == n
    assert after["dispatches"] - before["dispatches"] < n
    assert after["max_batch_seen"] >= 2


def test_tts_stream_is_chunked_wav_of_the_stream(server, engine):
    _, url = server
    text = "Streaming synthesis test sentence."
    resp = _post(f"{url}/tts_stream", {"text": text, "speaker": 0,
                                       "language": "English",
                                       "chunk_frames": 16})
    assert resp.headers["Content-Type"] == "audio/wav"
    assert resp.headers["Transfer-Encoding"] == "chunked"
    body = resp.read()  # urllib joins the chunks
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert struct.unpack("<I", body[4:8])[0] == 0xFFFFFFFF
    assert struct.unpack("<I", body[24:28])[0] == engine.sampling_rate
    pcm = np.frombuffer(body[44:], dtype="<i2")
    assert len(pcm) > 16 * engine.hop_length  # more than one chunk
    assert len(pcm) % engine.hop_length == 0 and np.abs(pcm).max() > 0


@pytest.mark.parametrize("sr_in", [8000, 16000], ids=["same-rate", "resampled"])
def test_vc_converts_a_wav_body(server, engine, sr_in):
    _, url = server
    n = int(0.6 * sr_in) + 11
    t = np.arange(n) / sr_in
    wav = (0.3 * np.sin(2 * np.pi * 200 * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr_in, wav)
    resp = _post(f"{url}/vc", data=buf.getvalue(), headers={
        "X-VC": json.dumps({"source": "alice", "target": "bob"})})
    sr, pcm = _read_wav(resp.read())
    n_model = int(round(n * engine.sampling_rate / sr_in))
    assert sr == engine.sampling_rate
    assert len(pcm) == (n_model // engine.hop_length) * engine.hop_length


def test_body_cap_413(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/tts", data=b"x" * (2 * 1024 * 1024), headers={})
    assert e.value.code == 413
    assert "cap" in json.loads(e.value.read())["error"]


def test_error_surfaces_as_json(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/tts", {"speaker": 0})  # no "text"
    assert e.value.code == 400
    assert "KeyError" in json.loads(e.value.read())["error"]


def test_full_queue_sheds_503(engine):
    """One call in flight (held at the device lock) and one queued fill a
    queue of 1: of four requests, at least two are shed at once."""
    srv, thread = _start(engine, _args(max_batch=1, batch_window_ms=0.0,
                                       max_queue=1))
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    codes, retry, lock = [], [], threading.Lock()

    def call(i):
        try:
            code = _post(f"{url}/tts", {"text": "Shed me.", "speaker": 0,
                                        "language": "English"}).status
        except urllib.error.HTTPError as e:
            code = e.code
            retry.append(e.headers["Retry-After"])
        with lock:
            codes.append(code)

    try:
        with srv.batcher.device_lock:
            threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for _ in range(600):  # the shed answers come back while held
                with lock:
                    if codes.count(503) >= 2:
                        break
                time.sleep(0.05)
        for t in threads:
            t.join(timeout=120)
    finally:
        _stop(srv, thread)
    assert sorted(codes) in ([200, 200, 503, 503], [200, 503, 503, 503])
    assert retry == ["1"] * codes.count(503)
    assert srv.batcher.stats["shed"] == codes.count(503)


def test_tts_cli_on_the_cpu(tmp_path):
    cfg = tmp_path / "tiny.json"
    save_hparams(tiny_model_config(), str(cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "personalized_text_to_speech_tpu_torch.tools.tts",
         "-c", str(cfg), "--random-init", "-t", "Hello there.", "-l", "English",
         "-s", "alice", "-o", str(tmp_path / "out"), "-on", "hello",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    wav, sr = load_wav(str(tmp_path / "out" / "hello.wav"))
    assert sr == 8000 and wav.shape[-1] > 0 and wav.shape[-1] % 64 == 0
    assert "wrote" in proc.stdout


@pytest.mark.parametrize("mode", ["long-form", "cleaned-text", "bf16"])
def test_tts_cli_modes(tmp_path, mode):
    cfg = tmp_path / "tiny.json"
    save_hparams(tiny_model_config(), str(cfg))
    extra = {"long-form": ["--long-form", "-t", "One. Two!"],
             "cleaned-text": ["--cleaned-text", "-t", "həlˈoʊ"],
             "bf16": ["--dtype", "bfloat16", "-t", "Hello."]}[mode]
    assert tts_tool.main(["-c", str(cfg), "--random-init", "-o", str(tmp_path),
                          "--device", "cpu", *extra]) == 0
    wav, sr = load_wav(str(tmp_path / "output.wav"))
    assert sr == 8000 and wav.shape[-1] > 0


def test_clis_default_to_the_card(tmp_path, monkeypatch):
    cfg = tmp_path / "tiny.json"
    save_hparams(tiny_model_config(), str(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tts_tool.main(["-c", str(cfg), "--random-init", "-t", "hi",
                       "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_tool.main(["--config_dir", str(cfg), "--random-init", "--http"])
    with pytest.raises(SystemExit):  # no -m and no --random-init
        tts_tool.main(["-c", str(cfg), "-t", "hi", "--device", "cpu"])


def test_serve_flags_match_the_jax_tool():
    args = serve_tool.build_parser().parse_args([])
    assert (args.dtype, args.device, args.host, args.port) == (
        "bfloat16", "cuda", "127.0.0.1", 7860)
    assert (args.max_batch, args.max_queue, args.batch_window_ms,
            args.max_body_mb) == (16, 64, 5.0, 32)
