"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
goes wrong:

1. device: the card's name and power limit, the torch/CUDA versions; no
   CUDA device is a failure.  TF32 is switched off for convolutions and
   matmuls, so fp32 means fp32 on both sides of every comparison.
2. kernels: every hand-written kernel of the port is built from the sources
   in this checkout (``nvcc``, once per source) and held against its plain
   PyTorch version on the card, on random, edge and full-size inputs.
3. main path, with every launch counter set to 0 first: the serving engine
   at the full width of ``configs/finetune_speaker.json`` (random weights
   from a seed) answers text requests in three languages and a batch of 8;
   then ``SynthesizerTrn.forward``, the aligning forward pass, runs on a
   batch of 16 (192 tokens, 400 frames × 513 bins).  Every kernel must have
   been launched; MAS's path must equal the plain version's on the same
   scores.
4. kernel timing at the shapes the main path gave each kernel, beside the
   least time the card could take for the same work.
5. the card against the CPU: one short request's stages on both devices
   with the same weights and injected noise, each output held to a bound
   relative to its own size.
6. where the time goes: each serving request and the forward again with a
   fixed noise seed, the median host latency of several runs, and one
   ``torch.profiler`` run of each for the device's busy time, its idle
   share and the kernels launched.

The last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "finetune_speaker.json"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SERVE_TEXTS = [
    ("Hello, this is the port speaking on the card.", "English"),
    ("你好，今天我们在显卡上合成语音。", "Chinese"),
    ("こんにちは、これは音声合成のテストです。", "Japanese"),
]
BATCH_TEXTS = [
    "[EN]One short line.[EN]",
    "[EN]A somewhat longer sentence to give the batch a spread of lengths.[EN]",
    "[ZH]我们今天去公园散步。[ZH]",
    "[JA]東京は日本の首都です。[JA]",
    "[KO]안녕하세요 반갑습니다.[KO]",
    "[EN]Numbers like 42 and 1999 are read out in words.[EN]",
    "[ZH]我爱你[ZH][EN]and I mean it.[EN]",
    "[EN]Last of eight.[EN]",
]
FWD_B, FWD_TEXT, FWD_FRAMES = 16, 192, 400
# fp32 card against fp32 CPU, TF32 off: sums in another order through a
# 6-layer encoder, 4 flows and a 4-stage HiFi-GAN.  Each output's max abs
# error is held to this share of its own max abs value, so the bound scales
# with the random-weight model's amplitude; a wrong result is off by O(1)
CPU_REL_TOL = 1e-4
# timed runs per request in phase 6, after two warm-ups
PROFILE_REPEAT = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"---- {name}")


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median over ``iters`` launches of ``fn``, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mas_cases():
    """Random geometries of the CPU tests, the edge cases, and full size."""
    def random_case(seed, b, t_y, t_x):
        rng = np.random.default_rng(seed)
        neg = rng.normal(size=(b, t_y, t_x)).astype(np.float32)
        sl = rng.integers(t_x, t_y + 1, size=b).astype(np.int32)
        tl = np.minimum(rng.integers(2, t_x + 1, size=b), sl).astype(np.int32)
        sl[0], tl[0] = t_y, t_x
        return neg, tl, sl

    rng = np.random.default_rng(11)
    cases = {f"random-{s}": random_case(s, 3, 37, 11) for s in range(5)}
    cases["t_x_1"] = (rng.normal(size=(2, 9, 1)).astype(np.float32),
                      np.array([1, 1], np.int32), np.array([9, 4], np.int32))
    cases["t_y_eq_t_x"] = (rng.normal(size=(2, 8, 8)).astype(np.float32),
                           np.array([8, 5], np.int32), np.array([8, 5], np.int32))
    cases["padded"] = (rng.normal(size=(3, 30, 12)).astype(np.float32),
                       np.array([7, 3, 11], np.int32),
                       np.array([20, 3, 29], np.int32))
    cases["ties"] = (rng.integers(-2, 2, size=(2, 25, 9)).astype(np.float32),
                     np.array([9, 6], np.int32), np.array([25, 17], np.int32))
    cases["wide-t_x-1500"] = random_case(5, 2, 1600, 1500)
    cases["full-16x400x192"] = random_case(0, FWD_B, FWD_FRAMES, FWD_TEXT)
    return cases


def check_mas_kernel(mas) -> float:
    """Kernel against plain version on every case; returns the max error."""
    worst = 0.0
    for name, (neg, tl, sl) in mas_cases().items():
        args = (torch.from_numpy(neg).cuda(), torch.from_numpy(tl).cuda(),
                torch.from_numpy(sl).cuda())
        got = mas.maximum_path_cuda(*args)
        torch.cuda.synchronize()
        want = mas.maximum_path_plain(*args)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        log(f"mas {name} {tuple(neg.shape)}: max_abs_err {err}")
        if not torch.equal(got, want):
            raise AssertionError(f"MAS kernel differs from plain on {name}")
    for bad, why in (
        (lambda a: (a[0].double(), a[1], a[2]), "float64 scores"),
        (lambda a: (a[0].transpose(1, 2).contiguous().transpose(1, 2),
                    a[1], a[2]), "non-contiguous scores"),
        (lambda a: (a[0], a[1].long(), a[2]), "int64 lengths"),
        (lambda a: (a[0], a[1].cpu(), a[2]), "lengths on the CPU"),
    ):
        neg, tl, sl = mas_cases()["random-0"]
        args = (torch.from_numpy(neg).cuda(), torch.from_numpy(tl).cuda(),
                torch.from_numpy(sl).cuda())
        try:
            mas.maximum_path_cuda(*bad(args))
        except ValueError:
            continue
        raise AssertionError(f"MAS kernel wrapper took {why}")
    return worst


def serve(engine, hop: int, sr: int):
    """≥3 text requests and a batch of 8 through the engine's user API."""
    for text, lang in SERVE_TEXTS:
        t0 = time.perf_counter()
        out_sr, wav = engine.tts(text, speaker=4, language=lang)
        dt = time.perf_counter() - t0
        if out_sr != sr or not np.isfinite(wav).all():
            raise AssertionError(f"bad audio for {lang}")
        if len(wav) < hop or len(wav) % hop:
            raise AssertionError(f"{lang}: {len(wav)} samples, hop {hop}")
        secs = len(wav) / sr
        log(f"serve tts {lang}: {len(wav) // hop} frames, {secs:.3f} s audio, "
            f"latency {dt * 1e3:.2f} ms, 1/RTF {secs / dt:.2f}")
    ids = [engine.text_to_ids(t) for t in BATCH_TEXTS]
    sids = list(range(10, 10 + len(ids)))
    t0 = time.perf_counter()
    wavs = engine.synthesize_ids(ids, sids)
    dt = time.perf_counter() - t0
    wav_dev, y_len = engine.submit_ids(ids, sids)
    exact = engine.collect((wav_dev, y_len), hop)
    for w, e, n in zip(wavs, exact, y_len.tolist()):
        if not (np.isfinite(w).all() and len(w) >= hop and len(w) % hop == 0
                and len(e) == n * hop and n >= 1):
            raise AssertionError("bad audio in the batch of 8")
    secs = sum(len(w) for w in wavs) / sr
    log(f"serve batch of {len(ids)}: {secs:.3f} s audio, latency "
        f"{dt * 1e3:.2f} ms, 1/RTF {secs / dt:.2f}")


def forward_inputs(model, n_speakers: int, device):
    rng = np.random.default_rng(1234)
    spec_bins = model.spec_channels
    x_len = rng.integers(FWD_TEXT // 2, FWD_TEXT + 1, size=FWD_B)
    y_len = np.maximum(rng.integers(FWD_FRAMES // 2, FWD_FRAMES + 1,
                                    size=FWD_B), x_len)
    x_len[0], y_len[0] = FWD_TEXT, FWD_FRAMES
    x = rng.integers(1, 60, size=(FWD_B, FWD_TEXT))
    spec = np.abs(rng.normal(size=(FWD_B, FWD_FRAMES, spec_bins)))
    sid = rng.integers(0, n_speakers, size=FWD_B)
    to = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    return (to(x, torch.long), to(x_len, torch.int32),
            to(spec.astype(np.float32), torch.float32),
            to(y_len, torch.int32), to(sid, torch.long))


def card_against_cpu(engine, cpu_engine) -> None:
    """One short request's two stages on both engines, same weights and
    noise.  The decode stage gets the CPU's durations on both sides: a
    ceil next to an integer must not change the frame count."""
    ids = engine.text_to_ids("Short check.", "English")
    rng = np.random.default_rng(7)
    dp_noise = torch.from_numpy(
        rng.normal(size=(1, len(ids), 2)).astype(np.float32))

    def on(eng, *arrays):
        return [torch.as_tensor(a).to(eng.device) for a in arrays]

    errs, sizes = {}, {}
    with torch.no_grad():
        enc = {
            eng: eng.model.infer_encode(
                *on(eng, [ids], [len(ids)], [4]),
                dp_noise=dp_noise.to(eng.device))
            for eng in (engine, cpu_engine)
        }
        for i, k in enumerate(("m_p", "logs_p"), start=1):
            errs[k] = (enc[engine][i].cpu() - enc[cpu_engine][i]).abs().max().item()
            sizes[k] = enc[cpu_engine][i].abs().max().item()
        w_ceil, m_p, logs_p, x_mask = enc[cpu_engine]
        n_frames = max(int(w_ceil.sum().item()), 1)
        prior = torch.from_numpy(rng.normal(
            size=(1, n_frames, m_p.shape[-1])).astype(np.float32))
        wavs = [
            eng.model.infer_decode(
                *on(eng, w_ceil, m_p, logs_p, x_mask, [4]),
                max_len=n_frames, prior_noise=prior.to(eng.device),
            )[0].cpu()
            for eng in (engine, cpu_engine)
        ]
        errs["wav"] = (wavs[0] - wavs[1]).abs().max().item()
        sizes["wav"] = wavs[1].abs().max().item()
    for k, err in errs.items():
        log(f"card vs CPU, {n_frames} frames, {k}: max abs err {err}, max abs "
            f"value {sizes[k]}, tolerance {CPU_REL_TOL} x value = "
            f"{CPU_REL_TOL * sizes[k]}")
    if not all(err <= CPU_REL_TOL * sizes[k] for k, err in errs.items()):
        raise AssertionError("card and CPU disagree")


def run_forward(model, inputs, seed: int):
    gen = torch.Generator(device=inputs[0].device)
    gen.manual_seed(seed)
    with torch.no_grad():
        out = model(*inputs, generator=gen)
    if inputs[0].is_cuda:
        torch.cuda.synchronize()
    return out


def check_forward(model, out, inputs, hop: int) -> torch.Tensor:
    """The forward's outputs are finite and of the expected shapes, and its
    MAS path equals the plain MAS on the same scores, recomputed from the
    text encoder and ``z_p`` in the forward's layouts.  Returns the scores."""
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        mas_scores,
    )
    from personalized_text_to_speech_tpu_torch.ops.mas import maximum_path_plain

    x, x_len, _, y_len, _ = inputs
    with torch.no_grad():
        _, m_p, logs_p, _ = model.enc_p(x, x_len)
        z_p = out["z_p"].transpose(1, 2).contiguous()
        neg_cent = mas_scores(z_p, m_p, logs_p)
    if not torch.equal(out["attn"], maximum_path_plain(neg_cent, x_len, y_len)):
        raise AssertionError("forward's MAS path differs from the plain MAS")
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"forward output {k} is not finite")
    b = x.shape[0]
    if out["wav_hat"].shape != (b, model.segment_size * hop):
        raise AssertionError(f"wav_hat shape {tuple(out['wav_hat'].shape)}")
    if out["attn"].shape != (b, inputs[2].shape[1], x.shape[1]):
        raise AssertionError(f"attn shape {tuple(out['attn'].shape)}")
    if int(out["attn"].sum().item()) != int(y_len.sum().item()):
        raise AssertionError("MAS path does not cover every valid frame")
    log("forward: attn equals the plain MAS on the same scores; outputs "
        "finite")
    return neg_cent


def mas_needed_cells(text_lengths, spec_lengths, t_y: int, t_x: int):
    """Bool mask [B, T_y, T_x] of the score cells MAS's path depends on
    (for text_len <= spec_len): rows below spec_len, columns below text_len,
    and y - (spec_len - text_len) <= x <= y.  A cell right of the diagonal
    is overruled by the backtrack's ``c == y`` rule; a cell left of the band
    feeds no value that the backtrack from (spec_len-1, text_len-1), one
    column per row at most, ever compares."""
    tl = text_lengths.long().clamp(0, t_x)[:, None, None]
    sl = spec_lengths.long().clamp(0, t_y)[:, None, None]
    y = torch.arange(t_y, device=tl.device)[None, :, None]
    x = torch.arange(t_x, device=tl.device)[None, None, :]
    return (y < sl) & (x < tl) & (x <= y) & (x >= y - (sl - tl))


def _union_ms(intervals_us) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals_us):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def where_time_goes(engine, model, fwd_in, sr: int) -> None:
    """Each serving request of phase 3 (noise seed fixed, so every run has
    the same frame count) and the forward: two warm-ups, the median host
    latency of ``PROFILE_REPEAT`` runs, then one ``torch.profiler`` run for
    the device's busy time (the union of its kernel and copy intervals),
    the idle share of that run's wall time and of the median, the kernels
    launched, and the three kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # the profiler's first start sets up CUPTI for seconds: pay it here
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def tts(text, lang):
        return lambda: len(engine.tts(text, speaker=4, language=lang,
                                      rng=7)[1]) / sr

    def batch():
        ids = [engine.text_to_ids(t) for t in BATCH_TEXTS]
        wavs = engine.synthesize_ids(ids, list(range(10, 10 + len(ids))), rng=7)
        return sum(len(w) for w in wavs) / sr

    def forward():
        run_forward(model, fwd_in, seed=2)
        return None

    requests = {f"tts {lang}": tts(text, lang) for text, lang in SERVE_TEXTS}
    requests["batch of 8"] = batch
    requests[f"forward B={FWD_B}"] = forward
    for name, run in requests.items():
        for _ in range(2):
            run()
        times = []
        for _ in range(PROFILE_REPEAT):
            t0 = time.perf_counter()
            audio_s = run()
            times.append((time.perf_counter() - t0) * 1e3)
        median = statistics.median(times)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
        by_name = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        log("profile " + json.dumps({
            "request": name,
            "audio_s": audio_s,
            "latency_ms": {"median": median, "min": min(times),
                           "max": max(times)},
            "inv_rtf_median": audio_s / median * 1e3 if audio_s else None,
            "device_busy_ms": busy_ms,
            "profiled_wall_ms": wall_ms,
            "idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "idle_share_at_median": 1.0 - busy_ms / median,
            "device_events": len(dev),
            "top_ms": [[n[:60], ms] for n, ms in top],
        }))


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs the card")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convolutions and cuBLAS matmuls")

    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
    from personalized_text_to_speech_tpu_torch.ops import mas

    kernels = {"mas": mas.maximum_path_cuda}

    phase("2 kernels: build and hold against the plain versions")
    t0 = time.perf_counter()
    mas.build_library(verbose=True)
    log(f"build: csrc/mas.cu in {time.perf_counter() - t0:.2f} s")
    mas_err = check_mas_kernel(mas)

    phase("3 main path at full width")
    hps = load_hparams(str(CONFIG))
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    t0 = time.perf_counter()
    engine = TTSEngine(hps, device="cuda", seed=1234)
    model = engine.model
    log(f"engine: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"params, set up in {time.perf_counter() - t0:.2f} s")
    fwd_in = forward_inputs(model, hps.data.n_speakers, engine.device)
    # warm-up pass over the same requests and shapes: first use of a shape
    # sets up cuDNN/cuBLAS plans, and the Chinese frontend loads its
    # segmentation dictionary
    log("warm-up pass:")
    serve(engine, hop, sr)
    run_forward(model, fwd_in, seed=0)

    for fn in kernels.values():
        fn.launches = 0
    log("measured pass:")
    serve(engine, hop, sr)
    t0 = time.perf_counter()
    out = run_forward(model, fwd_in, seed=1)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"forward B={FWD_B} text={FWD_TEXT} frames={FWD_FRAMES}: "
        f"{fwd_ms:.2f} ms; launches {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    neg_cent = check_forward(model, out, fwd_in, hop)
    _, x_len, _, y_len, _ = fwd_in

    phase("4 kernel timing at the main path's shapes")
    mas_ms = cuda_time_ms(lambda: mas.maximum_path_cuda(neg_cent, x_len, y_len))
    mas_plain_ms = cuda_time_ms(
        lambda: mas.maximum_path_plain(neg_cent, x_len, y_len), iters=5)
    b, t_y, t_x = neg_cent.shape
    # bytes: the score cells this run's path depends on, the two length
    # vectors, and the path written whole; operations: add + max + compare
    # per needed cell
    cells = int(mas_needed_cells(x_len, y_len, t_y, t_x).sum().item())
    mas_bytes = 4 * cells + 8 * b + 4 * b * t_y * t_x
    mas_ops = 3 * cells
    bound_ms = max(mas_bytes / HBM_BYTES_PER_S, mas_ops / FP32_OPS_PER_S) * 1e3
    mas_bound_by = ("bytes" if mas_bytes / HBM_BYTES_PER_S
                    >= mas_ops / FP32_OPS_PER_S else "operations")
    log(f"mas [{b}, {t_y}, {t_x}]: kernel {mas_ms:.4f} ms, plain "
        f"{mas_plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {mas_bound_by} "
        f"({cells} of {b * t_y * t_x} score cells needed, {mas_bytes} B); "
        f"the real limit is the {t_y}-deep chain of dependent rows in each "
        f"block")

    phase("5 card against CPU")
    cpu_engine = TTSEngine(
        hps, state_dict={k: v.cpu() for k, v in model.state_dict().items()},
        device="cpu",
    )
    card_against_cpu(engine, cpu_engine)

    phase("6 where the time goes")
    where_time_goes(engine, model, fwd_in, sr)

    phase("summary")
    log(json.dumps({"kernels": [{
        "name": "mas",
        "route": "cuda",
        "source": "personalized_text_to_speech_tpu_torch/csrc/mas.cu",
        "replaces": "personalized_text_to_speech_tpu/ops/mas_pallas.py:93",
        "launches": launches["mas"],
        "max_abs_err": mas_err,
        "ms": mas_ms,
        "plain_ms": mas_plain_ms,
        "bound_ms": bound_ms,
        "bound_by": mas_bound_by,
        "library_ms": None,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
