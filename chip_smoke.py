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
4. kernel timing at the shapes the main path gave each kernel: one call's
   time as its caller sees it (CUDA events around the wrapper, its host
   work in: ``ms`` of the kernels line) and the card's time alone (the call
   queued behind a spin, so the host's work is off the clock:
   ``device_ms``), beside the least time the card could take for the same
   work and, for MAS, an estimate of the floor its chain of dependent rows
   sets.
5. the card against the CPU: one short request's stages on both devices
   with the same weights and injected noise, each output held to a bound
   relative to its own size.
6. where the time goes: each serving request and the forward again with a
   fixed noise seed, the median host latency of several runs, and one
   ``torch.profiler`` run of each for the device's busy time, its idle
   share and the kernels launched.
7. the training path, in fp32 (TF32 off), every launch counter set to 0
   first: a synthetic set of 32 clips (3.5–4.6 s at 22.05 kHz, texts for
   the 192-token bucket, speakers among the 999) is written with the
   port's ``save_wav``, and ``Trainer`` runs ``configs/finetune_speaker.json``
   at full width on it (B=16, 400 frames, segment 8192, random weights):
   ``fit`` for one epoch (2 steps), then 2 warm-up and 8 timed
   ``train_step`` calls and one profiled.  Losses must be finite, every
   parameter tensor must change, MAS must run once per step on the card,
   and each step's path must equal the plain MAS on that step's scores.
   Printed: median step time, audio seconds trained per wall second, peak
   device memory, the profiled step's busy time, idle share, events and
   top kernels.
8. the training outputs: ``save`` → a fresh ``Trainer`` resumes with the
   same weights and AdamW moments; ``G_latest.pth`` loads strictly into
   ``TTSEngine``, which answers a request.
9. phase 7 again as the config says (``bf16_run``: autocast bf16).
10. one training step at full width, B=2, 64 frames, on the card and on
    the CPU with the same weights and draws: loss terms and gradients
    held to bounds relative to their own size.

The last lines are a line of MAS launches per path, a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "finetune_speaker.json"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# latencies, in SM cycles, of one dependent fp32 add + max and of one
# dependent shared-memory load on Hopper (estimates, for MAS's chain floor)
ADD_MAX_CYCLES = 8
SHARED_LOAD_CYCLES = 30

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


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20,
                 hold_cycles: int = 0) -> float:
    """Median over ``iters`` calls of ``fn``, each timed by CUDA events.

    With ``hold_cycles`` the stream first spins that many cycles on the
    card, so the host has queued the call before its start event runs: the
    time is then the card's alone, without the host's overhead of the call.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
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
    # edges of the kernel's design: 32-column decision words, 7 to 9 word
    # groups (T_x 224, 256, 257); at T_x=24 a ring of 64 score rows in
    # halves of 32 and backtrack chunks of 64 rows; lengths 1 and 0; more
    # blocks than SMs; text_len past spec_len, where the forward computes
    # whole rows
    for t_x in (31, 32, 33, 64, 65, 224, 256, 257):
        cases[f"t_x-{t_x}"] = random_case(6, 3, max(100, t_x + 20), t_x)
    for t_y in (33, 65):
        cases[f"t_y-{t_y}"] = random_case(7, 3, t_y, 24)
    cases["length-1"] = (rng.normal(size=(4, 20, 10)).astype(np.float32),
                         np.array([1, 1, 5, 0], np.int32),
                         np.array([1, 7, 1, 0], np.int32))
    cases["batch-200"] = random_case(8, 200, 60, 20)
    cases["text-past-spec"] = (rng.normal(size=(3, 30, 40)).astype(np.float32),
                               np.array([25, 40, 12], np.int32),
                               np.array([10, 30, 12], np.int32))
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


# device time by kind of kernel, from the kernel's name: convolution
# forward, its input gradient (also a transposed convolution's forward), its
# weight gradient, matrix products, copies, then elementwise and reductions
KERNEL_KINDS = (
    ("conv dgrad", ("dgrad",)),
    ("conv wgrad", ("wgrad",)),
    ("conv fprop", ("fprop", "conv", "implicit_gemm", "winograd", "fft")),
    ("gemm", ("gemm", "gemv", "cutlass", "sm90_xmma")),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("reduce", ("reduce", "norm", "sum")),
    ("elementwise", ("elementwise", "vectorized", "foreach")),
)
# ranges the profiler also lays on the card's timeline: they span kernels
# and are not kernels themselves
RANGE_PREFIXES = ("Optimizer.", "ProfilerStep", "train/")


def profile_once(run, top_n: int = 3, ranges: str = "") -> dict:
    """One ``torch.profiler`` run of ``run``: the device's busy time (the
    union of its kernel and copy intervals), the profiled wall time, the
    device events, the ``top_n`` kernels with the most device time, and the
    device time by kind of kernel (``KERNEL_KINDS``).

    With ``ranges`` (a prefix of ``record_function`` names, as the train
    step's ``train/``), also each range's host time and the device time of
    the kernels inside its span on the card; a kernel outside every span
    (the autograd engine launches the backward from its own thread) counts
    for the range that ended last before it, as ``<name> (after)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = [e for e in on_card
           if not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(RANGE_PREFIXES)]
    busy_ms = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    by_kind = {}
    for name, ms in by_name.items():
        kind = next((k for k, keys in KERNEL_KINDS if any(w in name for w in keys)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    out = {"device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
           "idle_share_profiled": 1.0 - busy_ms / wall_ms,
           "device_events": len(dev), "top_ms": [[n[:60], ms] for n, ms in top],
           "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))}
    if ranges:
        host, device = {}, {}
        for e in events:
            if (e.name.startswith(ranges)
                    and e.device_type == torch.autograd.DeviceType.CPU):
                host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in on_card if e.name.startswith(ranges))
        for k in dev:
            start = k.time_range.start
            inside = [n for s0, s1, n in spans if s0 <= start < s1]
            before = [n for s0, s1, n in spans if s1 <= start]
            name = (inside[-1] if inside else
                    f"{before[-1]} (after)" if before else "(before the step)")
            device[name] = device.get(name, 0.0) + k.time_range.elapsed_us() / 1e3
        out["host_ms_by_range"] = host
        out["device_ms_by_range"] = device
    return out


def warm_up_profiler() -> None:
    """The profiler's first start sets up CUPTI for seconds: pay it here."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def where_time_goes(engine, model, fwd_in, sr: int) -> None:
    """Each serving request of phase 3 (noise seed fixed, so every run has
    the same frame count) and the forward: two warm-ups, the median host
    latency of ``PROFILE_REPEAT`` runs, then one ``torch.profiler`` run for
    the device's busy time, the idle share of that run's wall time and of
    the median, the kernels launched, and the three kernels with the most
    device time."""
    warm_up_profiler()

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
        prof = profile_once(run)
        log("profile " + json.dumps({
            "request": name,
            "audio_s": audio_s,
            "latency_ms": {"median": median, "min": min(times),
                           "max": max(times)},
            "inv_rtf_median": audio_s / median * 1e3 if audio_s else None,
            "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["profiled_wall_ms"],
            "idle_share_profiled": prof["idle_share_profiled"],
            "idle_share_at_median": 1.0 - prof["device_busy_ms"] / median,
            "device_events": prof["device_events"],
            "top_ms": prof["top_ms"],
        }))


# --------------------------------------------------------------------------
# training: the GAN fine-tuning path through the Trainer
# --------------------------------------------------------------------------

# the training phases' device
TRAIN_DEVICE = "cuda"
TRAIN_CLIPS = 32
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
# card against CPU at full width: B=2, 64 frames (16,384 samples), 24 tokens
CPU_TRAIN_FRAMES, CPU_TRAIN_TEXT = 64, 24
# fp32 card against fp32 CPU, TF32 off: each loss term to 1e-4 of its own
# size; each network's whole gradient to 1e-3 of its L2 norm; each gradient
# tensor to 2e-2 of its own largest magnitude, or of 1e-5 of its network's
# largest for the gradients that are zero in exact arithmetic (the attention
# key's bias) and rounding noise on both sides.  The per-tensor bound is
# wide because the discriminators are piecewise linear: a leaky-ReLU
# pre-activation within rounding distance of zero takes the other slope on
# the other device, and every gradient upstream of it moves by that
# position's share (7.4e-3 of a tensor's largest value at tiny widths,
# tests/test_torch_train_cuda.py); with no sign change the two agree to ~1e-6
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_NORM_TOL = 1e-3
TRAIN_GRAD_TOL = 2e-2


def sync() -> None:
    torch.cuda.synchronize()


def make_train_set(directory: Path, hps) -> None:
    """``TRAIN_CLIPS`` clips of 3.5–4.6 s (301–396 frames: the 400-frame
    bucket), sine mixtures from a numpy seed; IPA texts of 70–90 of the
    config's symbols (141–181 ids with blanks: the 192 text bucket);
    speaker ids among the config's; written with the port's ``save_wav``.
    Points ``hps`` at the filelist."""
    from personalized_text_to_speech_tpu_torch.data.audio import save_wav

    sr = hps.data.sampling_rate
    rng = np.random.default_rng(2024)
    symbols = [s for s in hps.symbols[1:] if s.strip()]
    lines = []
    for i in range(TRAIN_CLIPS):
        n = int(sr * rng.uniform(3.5, 4.6))
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 300)
        wav = sum(a * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
                  for h, a in ((1, 0.3), (2, 0.15), (3, 0.08)))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        wav = wav + 0.01 * rng.normal(size=n)
        path = directory / f"clip_{i:02d}.wav"
        save_wav(str(path), wav, sr)
        text = "".join(rng.choice(symbols, size=int(rng.integers(70, 91))))
        sid = int(rng.integers(0, hps.data.n_speakers))
        lines.append(f"{path}|{sid}|{text}")
    filelist = directory / "train.txt"
    filelist.write_text("\n".join(lines) + "\n", encoding="utf-8")
    hps.data.training_files = str(filelist)
    hps.data.validation_files = str(filelist)


def train_hps(filelist: str, bf16: bool):
    """``configs/finetune_speaker.json`` with the synthetic filelist, one
    checkpoint kept, and ``bf16_run`` set."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams

    hps = load_hparams(str(CONFIG))
    hps.data.training_files = hps.data.validation_files = filelist
    hps.train.bf16_run = bf16
    hps["preserved"] = 1
    return hps


class MasSpy:
    """Records what MAS got and gave inside the generator forward (the
    dispatcher is wrapped where the synthesizer calls it), so each step's
    path can be held against the plain MAS on the same scores."""

    def __init__(self):
        from personalized_text_to_speech_tpu_torch.models import synthesizer

        self._mod = synthesizer
        self._real = synthesizer.maximum_path
        self.calls = []

    def __enter__(self):
        def spy(neg_cent, x_len, y_len):
            path = self._real(neg_cent, x_len, y_len)
            self.calls.append((neg_cent.detach(), x_len, y_len, path))
            return path

        self._mod.maximum_path = spy
        return self

    def __exit__(self, *exc):
        self._mod.maximum_path = self._real
        return False


def check_mas_calls(calls) -> None:
    from personalized_text_to_speech_tpu_torch.ops.mas import maximum_path_plain

    for i, (neg, x_len, y_len, path) in enumerate(calls):
        if path.device.type != TRAIN_DEVICE:
            raise AssertionError("the training step's MAS ran off the card")
        if not torch.equal(path, maximum_path_plain(neg.float(), x_len, y_len)):
            raise AssertionError(f"step {i}: MAS path differs from the plain MAS")
        if int(path.sum().item()) != int(y_len.sum().item()):
            raise AssertionError(f"step {i}: MAS path misses valid frames")


def params_of(trainer):
    return {f"{n}.{k}": v.detach().clone()
            for n, st in (("g", trainer.g_state), ("d", trainer.d_state))
            for k, v in st.module.state_dict().items()}


def run_training(mode: str, hps, model_dir: Path, kernels) -> dict:
    """The training path in one mode: ``Trainer.fit`` for one epoch (2
    steps, checkpoint at step 0 and at the end, reference export), then
    ``TRAIN_WARMUP`` + ``TRAIN_TIMED`` more ``Trainer.train_step`` calls,
    each ended by a synchronise and timed on the host clock, then one
    profiled step.  Every launch counter is 0 just before and read just
    after.  Returns the trainer and the numbers."""
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(hps, str(model_dir), device=TRAIN_DEVICE)
    n_g = sum(p.numel() for p in trainer.g_state.module.parameters())
    n_d = sum(p.numel() for p in trainer.d_state.module.parameters())
    log(f"train {mode}: Trainer up in {time.perf_counter() - t0:.2f} s; G "
        f"{n_g / 1e6:.2f} M params, D {n_d / 1e6:.2f} M; "
        f"{len(trainer.train_set)} clips, {len(trainer.batcher)} batches of "
        f"{hps.train.batch_size} per epoch, buckets {trainer.batcher.boundaries}")
    before = params_of(trainer)

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with MasSpy() as spy:
        trainer.fit(max_epochs=1)
    fit_s = time.perf_counter() - t0
    after = params_of(trainer)
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    del before, after
    if unchanged:
        raise AssertionError(f"{mode}: parameters not updated: {unchanged[:8]}")
    check_mas_calls(spy.calls)
    del spy
    log(f"train {mode}: fit(1 epoch) took {trainer.global_step} steps in "
        f"{fit_s:.2f} s (2 checkpoints and the export included); every G and "
        f"D parameter tensor changed; MAS path of each step equals the plain "
        f"MAS on the step's own scores")

    batches = list(trainer.batcher)
    for b in batches:
        if b["wav"].shape[1] != FWD_FRAMES * hps.data.hop_length or \
                b["text"].shape[1] != FWD_TEXT:
            raise AssertionError(f"batch shapes {b['wav'].shape} {b['text'].shape}")
    metrics = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        metrics.append(trainer.train_step(batches[i % len(batches)]))
    sync()
    times, audio = [], []
    sr, hop = hps.data.sampling_rate, hps.data.hop_length
    for i in range(TRAIN_TIMED):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        metrics.append(trainer.train_step(b))
        sync()
        times.append(time.perf_counter() - t0)
        audio.append(float(b["wav_lengths"].sum()) / sr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_up_profiler()
    prof = profile_once(lambda: metrics.append(trainer.train_step(batches[0])),
                        top_n=8, ranges="train/")
    launches = {name: fn.launches for name, fn in kernels.items()}
    steps = trainer.global_step
    for m in metrics:
        bad = [k for k, v in m.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"{mode}: non-finite {bad}")
    if launches["mas"] != steps:
        raise AssertionError(f"{mode}: {launches['mas']} MAS launches in "
                             f"{steps} steps")
    median = statistics.median(times)
    result = {
        "mode": mode, "steps": steps, "launches": launches,
        "batch": hps.train.batch_size, "frames": FWD_FRAMES, "text": FWD_TEXT,
        "segment": hps.train.segment_size,
        "step_ms": {"median": median * 1e3, "min": min(times) * 1e3,
                    "max": max(times) * 1e3},
        "audio_s_per_step": statistics.mean(audio),
        "audio_s_per_wall_s": statistics.mean(audio) / median,
        "peak_memory_gb": peak_gb,
        "idle_share_at_median": 1.0 - prof["device_busy_ms"] / (median * 1e3),
        **prof,
        "last_losses": {k: metrics[-1][k].item() for k in
                        ("loss/g/total", "loss/d/total", "loss/g/mel",
                         "loss/g/kl", "loss/g/dur", "grad_norm_g")},
    }
    log("train " + json.dumps(result))
    return {"trainer": trainer, "result": result}


def check_train_outputs(trainer, hps) -> None:
    """save → a fresh Trainer resumes with the same step, weights, AdamW
    moments and schedule; the exported ``G_latest.pth`` loads strictly into
    ``TTSEngine``, which answers a request on the card."""
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    trainer.save()
    fresh = Trainer(hps, trainer.model_dir, device=TRAIN_DEVICE)
    if not fresh.resume() or fresh.global_step != trainer.global_step:
        raise AssertionError("resume did not restore the step")
    n_moments = 0
    for mine, theirs in ((fresh.g_state, trainer.g_state),
                         (fresh.d_state, trainer.d_state)):
        if mine.step != theirs.step:
            raise AssertionError("resume did not restore the update count")
        ref = theirs.module.state_dict()
        for k, v in mine.module.state_dict().items():
            if not torch.equal(v, ref[k]):
                raise AssertionError(f"resume: param {k} differs")
        a, b = mine.optimizer.state_dict(), theirs.optimizer.state_dict()
        for i, st in b["state"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(a["state"][i][name], st[name]):
                    raise AssertionError(f"resume: AdamW {name} of {i} differs")
                n_moments += 1
        if mine.scheduler.get_last_lr() != theirs.scheduler.get_last_lr():
            raise AssertionError("resume: learning rate differs")
    del fresh
    log(f"train outputs: resume at step {trainer.global_step} restored "
        f"weights and {n_moments} AdamW state tensors exactly")
    trainer.export_reference_checkpoint()
    engine = TTSEngine(hps, checkpoint_path=os.path.join(trainer.model_dir,
                                                         "G_latest.pth"),
                       device=TRAIN_DEVICE)
    ref = trainer.g_state.module.state_dict()
    for k, v in engine.model.state_dict().items():
        if not torch.equal(v, ref[k]):
            raise AssertionError(f"G_latest.pth: {k} differs from the trainer's")
    out_sr, wav = engine.tts("The fine-tuned voice speaks.", speaker=4,
                             language="English", rng=5)
    if out_sr != hps.data.sampling_rate or not np.isfinite(wav).all() or \
            len(wav) < hps.data.hop_length:
        raise AssertionError("the exported generator gave bad audio")
    log(f"train outputs: G_latest.pth loads strictly into TTSEngine; one "
        f"request gave {len(wav) / out_sr:.3f} s of finite audio")


def train_card_against_cpu(hps) -> None:
    """One fused step at full width, B=2, 64 frames, on the card and on the
    CPU: same weights, batch and injected draws, modules in ``eval()``."""
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.train.state import (
        create_train_state,
    )
    from personalized_text_to_speech_tpu_torch.train.step import (
        Batch,
        Samples,
        make_train_step,
    )

    def build():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(77)
            return SynthesizerTrn.from_hparams(hps), MultiPeriodDiscriminator()

    hop = hps.data.hop_length
    seg = hps.train.segment_size // hop
    rng = np.random.default_rng(77)
    n = CPU_TRAIN_FRAMES * hop
    t = np.arange(n) / hps.data.sampling_rate
    wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 250, size=(2, 1)) * t)
           + 0.02 * rng.normal(size=(2, n))).astype(np.float32)
    arrays = dict(
        text=rng.integers(1, len(hps.symbols), size=(2, CPU_TRAIN_TEXT)).astype(np.int32),
        text_lengths=np.array([CPU_TRAIN_TEXT, 17], np.int32), wav=wav,
        wav_lengths=np.array([n, 50 * hop], np.int32),
        sid=np.array([4, 900], np.int32))
    draws = (np.array([7, 50 - seg], np.int32),
             rng.normal(size=(2, CPU_TRAIN_FRAMES, hps.model.inter_channels)
                        ).astype(np.float32),
             rng.normal(size=(2, CPU_TRAIN_TEXT, 2)).astype(np.float32))
    step = make_train_step(hps, debug_grads=True)
    out = {}
    for dev in ("cpu", TRAIN_DEVICE):
        gm, dm = build()
        g_state = create_train_state(gm.to(dev).eval(), hps, steps_per_epoch=1)
        d_state = create_train_state(dm.to(dev).eval(), hps, steps_per_epoch=1)
        t0 = time.perf_counter()
        out[dev] = step(g_state, d_state, Batch.from_numpy(arrays, dev),
                        samples=Samples(*(torch.from_numpy(a).to(dev)
                                          for a in draws)))
        sync()
        log(f"train card vs CPU: the {dev} step took "
            f"{time.perf_counter() - t0:.2f} s")
    cpu, card = out["cpu"], out[TRAIN_DEVICE]
    if not torch.equal(card["_out"]["attn"].cpu(), cpu["_out"]["attn"]):
        raise AssertionError("train card vs CPU: MAS paths differ")
    worst_loss = 0.0
    for k, w in cpu.items():
        if k.startswith("_"):
            continue
        err = abs(card[k].item() - w.item())
        rel = err / max(abs(w.item()), 1e-3)
        worst_loss = max(worst_loss, rel)
        if rel > TRAIN_LOSS_TOL:
            raise AssertionError(f"train card vs CPU: {k} {card[k].item()} "
                                 f"against {w.item()}")
    worst, norm_rel = {}, {}
    for net in ("_grads_g", "_grads_d"):
        diff = {k: card[net][k].cpu() - w for k, w in cpu[net].items()}
        norm_rel[net] = (sum(v.double().square().sum().item() for v in diff.values())
                         / sum(w.double().square().sum().item()
                               for w in cpu[net].values())) ** 0.5
        scales = {k: v.abs().max().item() for k, v in cpu[net].items()}
        floor = 1e-5 * max(scales.values())
        worst[net] = sorted((v.abs().max().item() / max(scales[k], floor), k)
                            for k, v in diff.items())[-3:]
    log(f"train card vs CPU: MAS paths equal; "
        f"{sum(not k.startswith('_') for k in cpu)} loss terms, worst "
        f"{worst_loss:.3g} of their size (bound {TRAIN_LOSS_TOL}); gradients "
        f"of {len(cpu['_grads_g'])} G and {len(cpu['_grads_d'])} D tensors: "
        f"whole-network error against the norm {norm_rel} (bound "
        f"{TRAIN_GRAD_NORM_TOL}), the three worst tensors of each against "
        f"their scale {worst} (bound {TRAIN_GRAD_TOL})")
    if any(r > TRAIN_GRAD_NORM_TOL for r in norm_rel.values()) or \
            any(w[-1][0] > TRAIN_GRAD_TOL for w in worst.values()):
        raise AssertionError("train card vs CPU: gradients out of bounds")


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
    mas.build_library(verbose=True)  # prints ptxas's report
    log(f"build: csrc/mas.cu in {time.perf_counter() - t0:.2f} s")
    for t_x in (FWD_TEXT, 1500):
        log(f"mas dynamic shared memory per block at T_x={t_x}: "
            f"{mas.shared_bytes(t_x)} B")
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
    # one call's time as the caller sees it, the wrapper's host work in, and
    # the kernel's device time, with the call queued behind ~1 ms of spin
    mas_ms = cuda_time_ms(
        lambda: mas.maximum_path_cuda(neg_cent, x_len, y_len))
    mas_device_ms = cuda_time_ms(
        lambda: mas.maximum_path_cuda(neg_cent, x_len, y_len),
        hold_cycles=2_000_000)
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
    log(f"mas [{b}, {t_y}, {t_x}]: {mas_ms:.4f} ms per call with the "
        f"wrapper's host work, kernel {mas_device_ms:.4f} ms on the card, "
        f"plain {mas_plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {mas_bound_by} "
        f"({cells} of {b * t_y * t_x} score cells needed, {mas_bytes} B)")
    # the chain no design can shorten: the longest utterance's rows, each an
    # add + max on the row before, then as many dependent shared-memory
    # reads in the backtrack
    rows = int(y_len.max().item())
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    chain_ms = rows * (ADD_MAX_CYCLES + SHARED_LOAD_CYCLES) / (sm_mhz * 1e3)
    log(f"mas chain floor (estimate): {rows} rows x ({ADD_MAX_CYCLES} cycles "
        f"add+max + {SHARED_LOAD_CYCLES} cycles shared load) at "
        f"{sm_mhz:.0f} MHz = {chain_ms:.6f} ms; kernel on the card at "
        f"{mas_device_ms / chain_ms:.1f}x that floor")

    phase("5 card against CPU")
    cpu_engine = TTSEngine(
        hps, state_dict={k: v.cpu() for k, v in model.state_dict().items()},
        device="cpu",
    )
    card_against_cpu(engine, cpu_engine)

    phase("6 where the time goes")
    where_time_goes(engine, model, fwd_in, sr)

    serve_launches = launches
    del engine, model, cpu_engine, fwd_in, out, neg_cent
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        from personalized_text_to_speech_tpu_torch.config import load_hparams

        data_hps = load_hparams(str(CONFIG))
        (tmp / "data").mkdir()
        make_train_set(tmp / "data", data_hps)
        filelist = data_hps.data.training_files

        phase("7 training path in fp32 (TF32 off), full width, B=16")
        hps32 = train_hps(filelist, bf16=False)
        fp32 = run_training("fp32", hps32, tmp / "run_fp32", kernels)
        phase("8 training outputs: save and resume, export and serve")
        check_train_outputs(fp32["trainer"], hps32)
        train_results = {"fp32": fp32["result"]}
        del fp32
        torch.cuda.empty_cache()

        phase("9 training path as the config says (bf16_run), full width, B=16")
        bf16 = run_training("bf16", train_hps(filelist, bf16=True),
                            tmp / "run_bf16", kernels)
        train_results["bf16"] = bf16["result"]
        del bf16
        torch.cuda.empty_cache()

    phase("10 training step, card against CPU, full width, B=2")
    train_card_against_cpu(hps32)

    phase("summary")
    by_path = {"serve+forward": serve_launches["mas"],
               **{f"train {m}": r["launches"]["mas"]
                  for m, r in train_results.items()}}
    log("launches per path " + json.dumps({
        "mas": by_path,
        "train steps": {m: r["steps"] for m, r in train_results.items()},
    }))
    log(json.dumps({"kernels": [{
        "name": "mas",
        "route": "cuda",
        "source": "personalized_text_to_speech_tpu_torch/csrc/mas.cu",
        "replaces": "personalized_text_to_speech_tpu/ops/mas_pallas.py:93",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": mas_err,
        "ms": mas_ms,
        "device_ms": mas_device_ms,
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
