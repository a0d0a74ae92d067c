"""Web TTS serving of the port, with the flags of ``tools/serve.py``
(reference ``VC_inference.py``).

With ``gradio`` installed, launches the reference's Blocks UI (textbox,
speaker dropdown from the config's speaker map, language dropdown, speed
slider 0.1–5, reference ``VC_inference.py:77-99``).  Without it, or with
``--http``, serves a dependency-free HTTP API on the standard library:

    POST /tts         {"text", "speaker", "language", "speed", "long_form"}
                      → audio/wav (micro-batched with concurrent requests)
    POST /tts_stream  {"text", "speaker", "language", "speed", "chunk_frames"}
                      → audio/wav in chunked transfer, PCM16 pieces as each
                        sentence's frame chunks are decoded
    POST /vc          wav body, header ``X-VC: {"source": .., "target": ..}``
                      → audio/wav in the target's voice
    GET  /speakers    → JSON speaker map
    GET  /stats       → micro-batcher counters and queue depth
    GET  /healthz     → ok

Bodies over ``--max-body-mb`` get 413; a full admission queue gets 503.
Runs on the card (bf16 by default, as ``tools/serve.py``); ``--device cpu``
asks for the CPU.

    python -m personalized_text_to_speech_tpu_torch.tools.serve \\
        --model_dir G_latest.pth --config_dir finetune_speaker.json --http
"""

from __future__ import annotations

import argparse
import io
import json
import struct
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from personalized_text_to_speech_tpu_torch.infer.batching import (
    MicroBatcher,
    OverloadedError,
)


def build_engine(args):
    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    return TTSEngine(
        load_hparams(args.config_dir),
        checkpoint_path=None if args.random_init else args.model_dir,
        device=args.device,
        dtype=args.dtype,
    )


def wav_bytes(sr: int, wav: np.ndarray) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wav, -1, 1) * 32767.0).astype(np.int16))
    return buf.getvalue()


def stream_wav_header(sr: int) -> bytes:
    """16-bit mono WAV header with the unknown-length RIFF/data sizes."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def serve_gradio(eng, args) -> None:
    import gradio as gr

    speakers = list(eng.speakers.keys()) or ["0"]
    langs = ["English", "Chinese", "Japanese", "Mix"]

    def tts_fn(text, speaker, language, speed):
        sr, wav = eng.tts(
            text, speaker=speaker if eng.speakers else 0,
            language=None if language == "Mix" else language, speed=speed,
            noise_scale=0.667, noise_scale_w=0.8,
        )
        return "Success", (sr, wav)

    app = gr.Blocks()
    with app:
        gr.Markdown("# Personalized Text-to-Speech")
        with gr.Tab("Text-to-Speech"):
            with gr.Row():
                with gr.Column():
                    textbox = gr.TextArea(
                        label="Text", placeholder="Type your sentence here",
                        value="Hello, this is a test of my custom voice.")
                    char_dropdown = gr.Dropdown(
                        choices=speakers, value=speakers[0], label="character")
                    language_dropdown = gr.Dropdown(
                        choices=langs, value=langs[0], label="language")
                    duration_slider = gr.Slider(
                        minimum=0.1, maximum=5, value=1, step=0.1, label="Speed")
                with gr.Column():
                    text_output = gr.Textbox(label="Message")
                    audio_output = gr.Audio(label="Output Audio")
                    btn = gr.Button("Generate!", variant="primary")
                    btn.click(tts_fn,
                              inputs=[textbox, char_dropdown, language_dropdown,
                                      duration_slider],
                              outputs=[text_output, audio_output])
    app.launch(share=args.share, server_port=args.port)


class TTSServer(ThreadingHTTPServer):
    """Requests are handled concurrently (a slow client blocks no other),
    device work is serialized: ``/tts`` goes through the micro-batcher, and
    the streaming, VC and long-form paths take its ``device_lock``."""

    def __init__(self, eng, args):
        self.eng = eng
        self.max_body = args.max_body_mb * 1024 * 1024
        self.batcher = MicroBatcher(
            eng, max_batch=args.max_batch, window_ms=args.batch_window_ms,
            max_queue=args.max_queue,
        )
        try:
            super().__init__((args.host, args.port), _Handler)
        except OSError:
            self.batcher.close()
            raise

    def server_close(self) -> None:
        super().server_close()
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    server: TTSServer

    def log_message(self, fmt, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json",
              headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        eng, batcher = self.server.eng, self.server.batcher
        if self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        elif self.path == "/speakers":
            self._send(200, json.dumps(eng.speakers).encode())
        elif self.path == "/stats":
            self._send(200, json.dumps(batcher.stats_snapshot()).encode())
        else:
            self._send(404, b"{}")

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > self.server.max_body:
                # drain in constant memory so the client sees the 413
                # instead of a broken pipe, then reject
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                cap = self.server.max_body // (1024 * 1024)
                self._send(413, json.dumps(
                    {"error": f"body exceeds {cap} MiB cap"}).encode())
                return
            body = self.rfile.read(length)
            if self.path == "/tts":
                self._tts(json.loads(body or b"{}"))
            elif self.path == "/tts_stream":
                self._tts_stream(json.loads(body or b"{}"))
            elif self.path == "/vc":
                self._vc(body)
            else:
                self._send(404, b"{}")
        except OverloadedError:
            # admission queue full: shed so latency stays bounded
            self._send(503, json.dumps({"error": "server overloaded"}).encode(),
                       headers=[("Retry-After", "1")])
        except Exception as e:  # a bad request: the client gets the error
            self._send(400, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode())

    def _tts(self, req) -> None:
        eng, batcher = self.server.eng, self.server.batcher
        kw = dict(speaker=req.get("speaker", 0), language=req.get("language"),
                  speed=float(req.get("speed", 1.0)))
        text = req["text"]
        if req.get("long_form", False):
            with batcher.device_lock:
                sr, wav = eng.long_form(text, **kw)
        else:
            sr, wav = batcher.tts(text, **kw)  # shares a call with others
        self._send(200, wav_bytes(sr, wav), "audio/wav")

    def _tts_stream(self, req) -> None:
        eng, lock = self.server.eng, self.server.batcher.device_lock
        text = req["text"]
        kw = dict(speaker=req.get("speaker", 0), language=req.get("language"),
                  speed=float(req.get("speed", 1.0)),
                  chunk_frames=int(req.get("chunk_frames", 96)))
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(b: bytes) -> None:
            self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

        emit(stream_wav_header(eng.sampling_rate))
        with lock:
            for _, piece in eng.stream_long_form(text, **kw):
                pcm = (np.clip(piece, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                if pcm:
                    emit(pcm)
        self.wfile.write(b"0\r\n\r\n")

    def _vc(self, body: bytes) -> None:
        from scipy.io import wavfile

        from personalized_text_to_speech_tpu_torch.data.audio import (
            resample,
            to_mono,
        )

        eng, lock = self.server.eng, self.server.batcher.device_lock
        meta = json.loads(self.headers.get("X-VC", "{}"))
        sr_in, data = wavfile.read(io.BytesIO(body))
        wav_in = to_mono(data.T.astype(np.float32) / 32768.0
                         if data.dtype == np.int16 else data.T.astype(np.float32))
        wav_in = resample(wav_in, sr_in, eng.sampling_rate)
        with lock:
            sr, wav = eng.voice_conversion(wav_in, meta.get("source", 0),
                                           meta.get("target", 0))
        self._send(200, wav_bytes(sr, wav), "audio/wav")


def serve_http(eng, args) -> None:
    server = TTSServer(eng, args)
    host, port = server.server_address[:2]
    print(f"HTTP TTS API on {host}:{port}  (POST /tts, /tts_stream, /vc; "
          f"GET /speakers, /stats, /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.serve")
    parser.add_argument("--model_dir", default="./G_latest.pth")
    parser.add_argument("--config_dir", default="./finetune_speaker.json")
    parser.add_argument("--share", default=False, action="store_true")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--host", default="127.0.0.1",
                        help="HTTP bind address (default loopback; set "
                             "0.0.0.0 explicitly to expose externally)")
    parser.add_argument("--max-body-mb", type=int, default=32,
                        help="reject request bodies larger than this (MiB)")
    parser.add_argument("--max-batch", type=int, default=16,
                        help="micro-batcher: max concurrent /tts requests "
                             "per device call")
    parser.add_argument("--max-queue", type=int, default=64,
                        help="micro-batcher admission-queue bound; beyond "
                             "it /tts sheds load with HTTP 503")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="micro-batcher: how long the first queued "
                             "request waits for stragglers (0 disables "
                             "batching in all but back-to-back load)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--http", action="store_true",
                        help="force the stdlib HTTP API even if gradio exists")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    eng = build_engine(args)
    if not args.http:
        try:
            serve_gradio(eng, args)
            return 0
        except ImportError:
            print("gradio not installed: serving the HTTP API")
    serve_http(eng, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
