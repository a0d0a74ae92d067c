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
11. the rest of serving at full width (random weights from the serving
    seed, fp32 with TF32 off unless bf16), every launch counter set to 0
    first: voice conversion of a 3.0 s wav (speaker 3 → 7; length
    ``(n // hop) · hop``; card against CPU with injected noise, phase 5's
    bound; median latency of 5); ``stream_tts`` (chunk 96, halo 64) of the
    EN and ZH requests against ``tts`` with the same seed (1e-4 of the
    wav's largest value; time to the first chunk and to the last);
    ``stream_long_form`` of 3 sentences and ``long_form`` of 5 (pieces +
    pauses); ``tts_low_latency`` against ``tts`` and its saturation
    fallback; bf16: the waveform gap against fp32 with fp32's durations
    fed, the requests and the batch of 8; ``bench.py``'s batch of 64 with
    PCM16 collection in fp32 and bf16 (1/RTF, one profiled call); 16
    concurrent requests through the micro-batcher; one round trip each of
    ``/tts``, ``/tts_stream`` and ``/vc`` on 127.0.0.1.  None of these
    paths runs MAS.
12. the measurement tools at full width, each tool's ``main`` in this
    process with short settings (TF32 off, every launch counter set to 0
    before each run): ``bench`` (2 repetitions) and ``bench_cost`` (batch
    64) in fp32 and bf16; ``bench_serve`` at 1 and 16 clients for 3 s a
    point in both dtypes; ``bench_stream`` (3 repetitions); ``bench_train``
    at B=16, 400 frames, 128 tokens, 3 timed steps, in both dtypes;
    ``profile_ops --stage train`` (fp32, B=16), ``--stage decode`` (bf16,
    batch 64) and ``--stage encode`` (fp32, batch 64).  Every row is printed; a row that lacks its fields, a number
    that is not finite, a rate missing, a share of a peak above 1.05, step
    FLOPs of fp32 and bf16 more than 1 % apart, or a train step of
    ``bench_train`` or ``profile_ops`` without its one MAS launch on the
    card fails the run, and so does any MAS call of those runs whose path
    differs from the plain MAS on the same scores.  The layers behind
    cuDNN's convolution-backward kernels are printed by shape.
13. fine-tune and score at full width, in a temporary working directory,
    every launch counter set to 0 first, TF32 off: ``tools.make_dataset``
    writes the 2-speaker English formant corpus (80 clips) and
    ``tools.preprocess`` its filelists and config from
    ``configs/finetune_speaker.json`` (full width, ``bf16_run``); the port's
    ``Trainer`` fine-tunes on it on the card (B=16, ``fit`` for 12 epochs,
    ``evaluate()`` at step 0 and every 24 steps, each call timed on the
    card); every MAS call of the fit must give the plain MAS's path on the
    same scores, every ``evaluate()`` finite audio ``y_len · hop`` long and
    a ``[n_mels, y_len]`` mel, and its files must be under ``eval/``.  Then
    ``evaluate()`` on the card against ``evaluate()`` on the CPU (fp32, the
    same weights, injected noise and the CPU's durations; phase 5's bound);
    ``G_latest.pth`` scored by ``tools.eval_set`` (4 validation lines),
    ``tools.eval_vc`` (speaker 0 → 1, 2 pairs) and ``tools.eval_pair`` (one
    pair), every aggregate metric finite; ``tools.rearrange_speaker``
    compacts it, and a ``TTSEngine`` loads the result strictly and answers
    a request.
14. the rest of the train step at full width, TF32 off, every launch
    counter set to 0 before each run, every MAS call held to the plain MAS
    on its own scores: (a) ``Trainer`` with ``use_spectral_norm`` on a new
    copy of phase 7's 32-clip set (B=16, 400 frames), ``fit`` for 2 steps
    and 3 timed steps in fp32 and in ``bf16_run`` (losses finite, every
    ``u``/``v`` moved, ``D_latest.pth`` with ``weight_orig``/``weight_u``/
    ``weight_v`` for every conv, save → resume restores ``u``/``v`` bit for
    bit), then a ``fit`` of 2 steps with ``accum_steps`` 4 and remat
    ``full``; one D update at B=2 on the card against the CPU, ``u``/``v``
    within 1e-5 of their norm in fp32 and under bf16 autocast; (b) one step
    with ``accum_steps`` 1, 2 and 4 at B=16 from the same weights and draws,
    dropout off: every loss within 1e-4 of k=1's, each network's gradient
    within 1e-3 of its norm, 2k MAS launches; (c) remat ``dots`` and
    ``full`` against ``none`` to the same bounds, the MAS count printed;
    (d) ``tools.bench_mem`` for ``1:none 2:none 4:none 1:dots 1:full
    4:full`` in fp32 and ``1:none 4:none`` in bf16, each row printed, every
    field finite, fp32 ``4:none`` and ``1:full`` peaking below ``1:none``.
15. data-parallel fine-tuning at full width, TF32 off, every launch counter
    set to 0 first, every MAS call held to the plain MAS on its own scores
    on the process that made it: (a) a world-size-1 NCCL group
    (``init_distributed`` at 127.0.0.1) and the ``Trainer`` in it on a new
    copy of phase 7's 32-clip set (B=16, 400 frames): ``fit`` for 2 steps
    and 3 timed steps (median against phase 7's), one MAS launch a step;
    ``allreduce_grads`` of G and of D timed on the card; one step from
    fixed weights and draws in the group equal to the same step with no
    group bit for bit (cuDNN deterministic, the step with no group run
    twice first to show it repeats itself); (b) two ranks on the one card over gloo
    (``parallel.dryrun``'s ranks, subprocesses with a time limit, the MAS
    library built once before them), B=8 each, holding the same 16 rows and
    draws as one process at B=16, dropout off, ``use_spectral_norm`` on:
    every loss within 1e-4 of the single process's, each network's gradient
    within 1e-3 of its norm, the same gradients, parameters (a checksum of
    each tensor) and ``u``/``v`` on both ranks after the update, one MAS
    launch a rank; (c) ``python -m
    personalized_text_to_speech_tpu_torch.parallel.dryrun --nproc 2
    --device cuda --full-width`` (16 rows of up to 400 frames and 192
    tokens, 8 a rank) with a time limit.
16. tensor-parallel fine-tuning at full width, TF32 off, every launch
    counter set to 0 first, every MAS call held to the plain MAS on its own
    scores on the process that made it; two ranks on the one card over
    gloo, data 1 x model 2 (G and D sharded over the model axis,
    ``parallel/tp.py``): (a) one step at B=2 (2 rows of phase 7's set),
    spectral-norm D off and on, against one process on the card with
    ``dryrun.compare_tp``'s bounds (JAX's: losses 2e-4, gradient slices
    rtol 2e-4 / atol 2e-6 x scale, a tensor past it excused within 2e-2 of
    its largest value while its network's gradient is within 1e-4 of its
    norm, for leaky-ReLU slope flips; parameters after the update within 3
    learning rates, u/v), replicated tensors bit-identical on both ranks,
    at least 90 % of G sharded, each rank's resident memory after the step
    below the unsharded process's and its state (parameters, gradients,
    moments) below 0.6 of it; (b) a TP ``Trainer`` on a new copy of phase
    7's set: ``fit`` for 2 steps and 3 steps more, save, a new Trainer
    resumes bit for bit on both ranks, ``evaluate()``; then an unsharded
    ``Trainer`` here resumes the checkpoint with equal parameters and
    moments, its ``evaluate()`` within 1e-5 of rank 0's audio and one
    step of its 8-bit images, and
    ``G_latest.pth`` loads strictly into an unsharded model; in (a) and (c)
    3 more steps timed on each side, their MAS calls held to the plain MAS
    after the clock; (c) ``python
    -m personalized_text_to_speech_tpu_torch.parallel.dryrun --nproc 2
    --model 2 --device cuda --full-width`` (16 rows on both ranks) with a
    time limit.

The last lines are a line of MAS launches per path, a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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


# --------------------------------------------------------------------------
# the rest of serving: VC, streaming, long-form, the one-call path, bf16,
# PCM16 at batch 64, the micro-batcher and the HTTP API
# --------------------------------------------------------------------------

# bench.py's batch: its 8 English sentences cycled to 64, speakers 0-9,
# PCM16 collection, each call submitted before the last is collected
BENCH_SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Speech synthesis converts written language into audible speech.",
    "Yesterday it rained all morning, but the afternoon was bright and clear.",
    "Please remember to close the windows before you leave the building.",
    "Modern hardware accelerates matrix multiplication astonishingly well.",
    "A journey of a thousand miles begins with a single step forward.",
    "She sells seashells by the seashore on sunny summer mornings.",
    "The committee will announce its final decision early next week.",
]
BENCH_BATCH, BENCH_REPS = 64, 3
STREAM_CHUNK, STREAM_HALO = 96, 64
VC_SECONDS, VC_SRC, VC_TGT = 3.0, 3, 7
LONG_TEXT = ("The port now serves long documents. Each sentence is its own "
             "utterance. They share one bucketed batch on the card. Pauses "
             "join them. The last one ends here.")
MICRO_CLIENTS = 16


def in_turns(fns: dict, repeat: int = 5):
    """Each of ``fns`` once to warm up, then ``repeat`` rounds in which they
    run in turns (in order, then in reverse, and so on), each call ending
    on the host with its numpy result → ``({name: median host ms},
    {name: last result})``.  Versions compared in one round share the
    host's state, which drifts within a run."""
    out = {name: fn() for name, fn in fns.items()}
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(repeat):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            out[name] = fns[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}, out


def check_close(name: str, got: np.ndarray, want: np.ndarray,
                rel: float = CPU_REL_TOL) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} against {want.shape}")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log(f"{name}: max abs err {err}, max abs value {scale}, tolerance {rel} x "
        f"value = {rel * scale}")
    if not err <= rel * scale:
        raise AssertionError(f"{name} out of tolerance")
    return err


def vc_wav(sr: int) -> np.ndarray:
    """``VC_SECONDS`` of a voiced sine mixture from a numpy seed."""
    rng = np.random.default_rng(33)
    t = np.arange(int(VC_SECONDS * sr)) / sr
    f0 = 140.0 * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(a * np.sin(h * phase) for h, a in ((1, 0.3), (2, 0.15), (3, 0.07)))
    return (wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


def serve_vc(engine, cpu_engine) -> dict:
    hop, sr = engine.hop_length, engine.sampling_rate
    wav = vc_wav(sr)
    ms, res = in_turns(
        {"vc": lambda: engine.voice_conversion(wav, VC_SRC, VC_TGT, rng=9)})
    ms, (out_sr, out) = ms["vc"], res["vc"]
    n = (len(wav) // hop) * hop
    if out_sr != sr or len(out) != n or not np.isfinite(out).all():
        raise AssertionError(f"VC gave {len(out)} samples, want {n}")
    log(f"vc {VC_SECONDS} s, speaker {VC_SRC} -> {VC_TGT}: {len(out)} samples "
        f"= (n // hop) * hop; latency median of 5 {ms:.2f} ms, 1/RTF "
        f"{len(out) / sr / ms * 1e3:.2f}")
    # card against CPU, same weights and injected posterior noise
    spec, _ = engine.vc_spectrogram(wav)
    noise = torch.from_numpy(np.random.default_rng(34).normal(
        size=(1, spec.shape[1], engine.model.inter_channels)).astype(np.float32))
    outs, specs = {}, {}
    with torch.no_grad():
        for name, eng in (("card", engine), ("cpu", cpu_engine)):
            spec, spec_len = eng.vc_spectrogram(wav)
            dev = eng.device
            o, _, _ = eng.model.voice_conversion(
                spec, torch.tensor([spec_len], device=dev),
                torch.tensor([VC_SRC], device=dev),
                torch.tensor([VC_TGT], device=dev), noise=noise.to(dev))
            specs[name] = spec.cpu().numpy()
            outs[name] = o[0, : spec_len * hop].cpu().numpy()
    err_spec = check_close("vc card vs CPU, spectrogram", specs["card"], specs["cpu"])
    err = check_close("vc card vs CPU, wav", outs["card"], outs["cpu"])
    return {"latency_ms": ms, "samples": len(out), "err_wav": err,
            "err_spec": err_spec}


def serve_stream(engine) -> dict:
    """``stream_tts`` (chunk 96, halo 64) against ``tts`` with the same seed,
    for the EN and ZH requests; time to the first chunk and to the last."""
    sr = engine.sampling_rate
    result = {}
    for text, lang in SERVE_TEXTS[:2]:
        def stream():
            t0 = time.perf_counter()
            gen = engine.stream_tts(text, speaker=4, language=lang, rng=17,
                                    chunk_frames=STREAM_CHUNK,
                                    halo_frames=STREAM_HALO)
            pieces = [next(gen)[1]]
            first = (time.perf_counter() - t0) * 1e3
            return first, pieces + [w for _, w in gen]

        firsts = []

        def timed_stream():
            first, pieces = stream()
            firsts.append(first)
            return pieces

        ms, res = in_turns({
            "tts": lambda: engine.tts(text, speaker=4, language=lang, rng=17),
            "stream": timed_stream,
        })
        first, total, tts_ms = statistics.median(firsts[1:]), ms["stream"], ms["tts"]
        full, pieces = res["tts"][1], res["stream"]
        stream_wav = np.concatenate(pieces)
        err = check_close(f"stream {lang} ({len(pieces)} chunks) vs tts",
                          stream_wav, full)
        log(f"stream {lang}: {len(full) / sr:.3f} s audio in {len(pieces)} "
            f"chunks of {STREAM_CHUNK} frames (halo {STREAM_HALO}); first chunk "
            f"after {first:.2f} ms, whole stream {total:.2f} ms, tts "
            f"{tts_ms:.2f} ms (medians of 5, in turns)")
        result[lang] = {"first_chunk_ms": first, "stream_ms": total,
                        "tts_ms": tts_ms, "chunks": len(pieces), "err": err,
                        "audio_s": len(full) / sr}
    return result


def serve_long_form(engine) -> dict:
    sr = engine.sampling_rate
    five = engine.split_sentences(LONG_TEXT)
    if len(five) != 5:
        raise AssertionError(f"split into {len(five)} sentences")
    three = " ".join(five[:3])
    t0 = time.perf_counter()
    first_ms, got = None, []
    for _, w in engine.stream_long_form(three, speaker=4, language="English",
                                        rng=23):
        first_ms = first_ms or (time.perf_counter() - t0) * 1e3
        got.append(w)
    stream_ms = (time.perf_counter() - t0) * 1e3
    want = [engine.tts(s, speaker=4, language="English", rng=23)[1]
            for s in five[:3]]
    if [len(w) for w in got] != [len(w) for w in want]:
        raise AssertionError("stream_long_form: sentence lengths or order")
    for g, w in zip(got, want):
        check_close("stream_long_form sentence vs tts", g, w)
    t0 = time.perf_counter()
    _, joined = engine.long_form(LONG_TEXT, speaker=4, language="English",
                                 pause_ms=120.0, rng=29)
    long_ms = (time.perf_counter() - t0) * 1e3
    pieces = engine.synthesize_ids(
        [engine.text_to_ids(s, "English") for s in five], [4] * 5, rng=29)
    pause = int(sr * 0.120)
    want_len = sum(len(p) for p in pieces) + 4 * pause
    if len(joined) != want_len or not np.isfinite(joined).all():
        raise AssertionError(f"long_form: {len(joined)} samples, want {want_len}")
    log(f"long-form: stream_long_form of 3 sentences, first after "
        f"{first_ms:.2f} ms, all {stream_ms:.2f} ms; long_form of 5 "
        f"sentences ({len(joined) / sr:.3f} s = pieces + 4 pauses of "
        f"{pause} samples) in {long_ms:.2f} ms")
    return {"stream3_first_ms": first_ms, "stream3_ms": stream_ms,
            "long5_ms": long_ms, "long5_audio_s": len(joined) / sr}


def serve_low_latency(engine) -> dict:
    sr = engine.sampling_rate
    text, lang = SERVE_TEXTS[0]
    ms, res = in_turns({
        "fused": lambda: engine.tts_low_latency(text, speaker=4, language=lang,
                                                rng=31),
        "tts": lambda: engine.tts(text, speaker=4, language=lang, rng=31),
    }, repeat=7)
    fused_ms, tts_ms = ms["fused"], ms["tts"]
    fused, two = res["fused"][1], res["tts"][1]
    if not (np.isfinite(fused).all() and len(fused) % engine.hop_length == 0
            and len(fused) > 0):
        raise AssertionError("tts_low_latency: bad audio")
    _, fallback = engine.tts_low_latency(text, speaker=4, language=lang, rng=31,
                                         frames_per_token=0.05)
    check_close("low-latency saturation fallback vs tts", fallback, two)
    log(f"low-latency {lang}: one call {fused_ms:.2f} ms ({len(fused) / sr:.3f} "
        f"s), two-stage tts {tts_ms:.2f} ms ({len(two) / sr:.3f} s), medians "
        f"of 7 in turns; the saturated canvas (0.05 frames/token) fell back "
        f"to tts")
    return {"fused_ms": fused_ms, "tts_ms": tts_ms}


def bf16_gap(engine, engine16) -> dict:
    """One request's decode in fp32 and in bf16, both fed the fp32 encode's
    durations and the same noise: the waveform gap bf16 costs."""
    ids = engine.text_to_ids(*SERVE_TEXTS[0])
    rng = np.random.default_rng(37)
    dev = engine.device
    dp = torch.from_numpy(rng.normal(size=(1, len(ids), 2)).astype(np.float32))
    x = torch.tensor([ids], device=dev)
    xl = torch.tensor([len(ids)], device=dev)
    sid = torch.tensor([4], device=dev)
    with torch.no_grad():
        w_ceil = engine.model.infer_encode(x, xl, sid, dp_noise=dp.to(dev))[0]
        n = max(int(w_ceil.sum().item()), 1)
        prior = torch.from_numpy(rng.normal(
            size=(1, n, engine.model.inter_channels)).astype(np.float32)).to(dev)
        wavs = []
        for eng in (engine, engine16):
            with eng._autocast():
                enc = eng.model.infer_encode(x, xl, sid, dp_noise=dp.to(dev))
                wavs.append(eng.model.infer_decode(
                    w_ceil, *enc[1:], sid, max_len=n, prior_noise=prior
                )[0].float().cpu().numpy())
    gap = float(np.abs(wavs[1] - wavs[0]).max())
    scale = float(np.abs(wavs[0]).max())
    log(f"bf16 against fp32, fp32's w_ceil fed ({n} frames): max abs gap {gap}, "
        f"max abs value {scale}, gap/value {gap / scale}")
    if not np.isfinite(wavs[1]).all() or gap > 0.1 * scale:
        raise AssertionError("bf16 decode far from fp32")
    return {"gap": gap, "scale": scale}


def serve_requests(engines: dict) -> dict:
    """The three requests and the batch of 8 (fixed seed) on each engine
    (fp32 and bf16, in turns): median latency and 1/RTF; then one profiled
    EN request per engine for its device busy time and events."""
    sr = next(iter(engines.values())).sampling_rate
    out = {label: {} for label in engines}
    ids = [next(iter(engines.values())).text_to_ids(t) for t in BATCH_TEXTS]
    for text, lang in SERVE_TEXTS:
        ms, res = in_turns({
            label: (lambda e=eng: e.tts(text, speaker=4, language=lang, rng=7))
            for label, eng in engines.items()})
        for label in engines:
            wav = res[label][1]
            if not np.isfinite(wav).all() or len(wav) % engines[label].hop_length:
                raise AssertionError(f"{label} {lang}: bad audio")
            out[label][lang] = {"latency_ms": ms[label],
                                "inv_rtf": len(wav) / sr / ms[label] * 1e3}
    ms, res = in_turns({
        label: (lambda e=eng: e.synthesize_ids(ids, list(range(10, 18)), rng=7))
        for label, eng in engines.items()})
    text, lang = SERVE_TEXTS[0]
    for label, eng in engines.items():
        audio = sum(len(w) for w in res[label]) / sr
        out[label]["batch of 8"] = {"latency_ms": ms[label],
                                    "inv_rtf": audio / ms[label] * 1e3}
        prof = profile_once(lambda: eng.tts(text, speaker=4, language=lang,
                                            rng=7))
        out[label]["English profiled"] = {
            "device_busy_ms": prof["device_busy_ms"],
            "device_events": prof["device_events"],
            "idle_share_at_median": 1 - prof["device_busy_ms"]
            / out[label]["English"]["latency_ms"],
            "top_ms": prof["top_ms"]}
        log(f"serve {label} " + json.dumps(out[label]))
    return out


def batch64(engines: dict) -> dict:
    """bench.py's shape on each engine (fp32 and bf16, trials in turns): 64
    sentences, PCM16 on the card, call i+1 submitted before i is collected,
    ``BENCH_REPS`` calls a trial; 1/RTF on the true lengths, the median of
    the trials; then peak memory and one profiled call per engine."""
    first = next(iter(engines.values()))
    sr, hop = first.sampling_rate, first.hop_length
    texts = (BENCH_SENTENCES * (BENCH_BATCH // len(BENCH_SENTENCES)))[:BENCH_BATCH]
    ids = [first.text_to_ids(t, "English") for t in texts]
    sids = [i % 10 for i in range(BENCH_BATCH)]

    def trial(engine):
        audio = 0.0
        pending = engine.submit_ids(ids, sids, rng=0, pcm16=True)
        for i in range(BENCH_REPS):
            nxt = (engine.submit_ids(ids, sids, rng=0, pcm16=True)
                   if i + 1 < BENCH_REPS else None)
            got = engine.collect(pending, hop, dtype=np.int16)
            if any(w.dtype != np.int16 or len(w) < hop for w in got):
                raise AssertionError("batch 64: bad PCM16")
            audio += sum(len(w) for w in got) / sr
            pending = nxt
        return audio

    ms, audio = in_turns({label: (lambda e=eng: trial(e))
                          for label, eng in engines.items()}, repeat=2)
    out = {}
    for label, eng in engines.items():
        torch.cuda.reset_peak_memory_stats()
        prof = profile_once(lambda: eng.synthesize_ids(ids, sids, rng=0,
                                                       pcm16=True))
        per_call = ms[label] / BENCH_REPS
        out[label] = {
            "inv_rtf": audio[label] / ms[label] * 1e3,
            "ms_per_call": per_call,
            "audio_s_per_call": audio[label] / BENCH_REPS,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": 1 - prof["device_busy_ms"] / per_call,
            "device_events": prof["device_events"], "top_ms": prof["top_ms"]}
        log(f"batch 64 {label} (PCM16): " + json.dumps(out[label]))
    return out


def serve_micro_batcher(engine) -> dict:
    from personalized_text_to_speech_tpu_torch.infer.batching import MicroBatcher

    texts = [t for t, _ in SERVE_TEXTS] + BENCH_SENTENCES
    mb = MicroBatcher(engine, max_batch=16, window_ms=5.0, max_queue=64)
    try:
        mb.warmup(texts=(BENCH_SENTENCES[0],), language="English")
        results, errors = [None] * MICRO_CLIENTS, []

        def call(i):
            try:
                results[i] = mb.tts(texts[i % len(texts)], speaker=i % 10)
            except Exception as e:  # reported below
                errors.append(e)

        before = mb.stats_snapshot()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(MICRO_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = (time.perf_counter() - t0) * 1e3
        after = mb.stats_snapshot()
    finally:
        mb.close()
    if errors or any(r is None or not np.isfinite(r[1]).all() or len(r[1]) == 0
                     for r in results):
        raise AssertionError(f"micro-batcher: {errors[:3]}")
    calls = after["dispatches"] - before["dispatches"]
    audio = sum(len(r[1]) for r in results) / engine.sampling_rate
    log(f"micro-batcher: {MICRO_CLIENTS} concurrent requests all answered in "
        f"{calls} device calls (largest batch {after['max_batch_seen']}), "
        f"{wall:.2f} ms, {audio:.3f} s of audio, 1/RTF {audio / wall * 1e3:.2f}")
    return {"requests": MICRO_CLIENTS, "calls": calls, "wall_ms": wall}


def serve_http_round_trips(engine) -> dict:
    """/tts, /tts_stream and /vc on 127.0.0.1: a round trip each to set up
    the shapes, then one timed."""
    from scipy.io import wavfile

    from personalized_text_to_speech_tpu_torch.tools.serve import TTSServer

    args = argparse.Namespace(host="127.0.0.1", port=0, max_body_mb=32,
                              max_batch=16, batch_window_ms=5.0, max_queue=64)
    srv = TTSServer(engine, args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sr, hop = engine.sampling_rate, engine.hop_length

    def post(path, body, headers):
        """The round trip twice (the first sets up the shapes' plans on the
        card); the second's time and answer."""
        for _ in range(2):
            t0 = time.perf_counter()
            req = urllib.request.Request(url + path, data=body, headers=headers)
            with urllib.request.urlopen(req, timeout=120) as resp:
                data, ctype = resp.read(), resp.headers["Content-Type"]
        return (time.perf_counter() - t0) * 1e3, data, ctype

    js = {"Content-Type": "application/json"}
    out = {}
    try:
        if urllib.request.urlopen(url + "/healthz", timeout=30).read() != b"ok":
            raise AssertionError("/healthz")
        text = json.dumps({"text": SERVE_TEXTS[0][0], "speaker": 4,
                           "language": "English"}).encode()
        ms, data, ctype = post("/tts", text, js)
        got_sr, pcm = wavfile.read(io.BytesIO(data))
        if ctype != "audio/wav" or got_sr != sr or len(pcm) % hop or not len(pcm):
            raise AssertionError("/tts")
        out["/tts"] = {"ms": ms, "samples": len(pcm)}
        body = json.dumps({"text": SERVE_TEXTS[1][0], "speaker": 4,
                           "language": "Chinese", "chunk_frames": STREAM_CHUNK}
                          ).encode()
        ms, data, ctype = post("/tts_stream", body, js)
        pcm = np.frombuffer(data[44:], dtype="<i2")
        if data[:4] != b"RIFF" or len(pcm) % hop or not len(pcm):
            raise AssertionError("/tts_stream")
        out["/tts_stream"] = {"ms": ms, "samples": len(pcm)}
        buf = io.BytesIO()
        wav = vc_wav(sr)
        wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
        ms, data, ctype = post("/vc", buf.getvalue(), {
            "X-VC": json.dumps({"source": VC_SRC, "target": VC_TGT})})
        got_sr, pcm = wavfile.read(io.BytesIO(data))
        if got_sr != sr or len(pcm) != (len(wav) // hop) * hop:
            raise AssertionError("/vc")
        out["/vc"] = {"ms": ms, "samples": len(pcm)}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    log("http round trips " + json.dumps(out))
    return out


def rest_of_serving(kernels) -> dict:
    """Phase 11 at the full width of ``configs/finetune_speaker.json``,
    random weights from the serving seed, fp32 with TF32 off unless bf16;
    every launch counter 0 just before and read just after."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    hps = load_hparams(str(CONFIG))
    engine = TTSEngine(hps, device="cuda", seed=1234)
    state = engine.model.state_dict()
    cpu_engine = TTSEngine(hps, state_dict={k: v.cpu() for k, v in state.items()},
                           device="cpu")
    engine16 = TTSEngine(hps, state_dict=state, device="cuda", dtype="bfloat16")
    warm_up_profiler()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = {"vc": serve_vc(engine, cpu_engine)}
    del cpu_engine
    out["stream"] = serve_stream(engine)
    out["long_form"] = serve_long_form(engine)
    out["low_latency"] = serve_low_latency(engine)
    out["bf16_gap"] = bf16_gap(engine, engine16)
    both = {"fp32": engine, "bf16": engine16}
    out["requests"] = serve_requests(both)
    out["batch64"] = batch64(both)
    out["micro_batcher"] = serve_micro_batcher(engine16)
    out["http"] = serve_http_round_trips(engine16)
    out["launches"] = {name: fn.launches for name, fn in kernels.items()}
    out["phase_s"] = time.perf_counter() - t0
    log(f"rest of serving: {out['phase_s']:.2f} s; kernel launches on these "
        f"paths {out['launches']} (MAS is not on them)")
    return out


# --------------------------------------------------------------------------
# the measurement tools at full width
# --------------------------------------------------------------------------

# the fields each tool's rows carry: the JAX tool's names (device, dtype and
# tf32 are on every row)
TOOL_FIELDS = {
    "bench": ("metric", "value", "unit", "vs_baseline", "batch", "best",
              "trial_rtfs", "p50_latency_ms"),
    "bench_cost": ("metric", "batch", "text_bucket", "frame_bucket", "encode",
                   "decode", "compute_only_x_realtime"),
    "bench_serve": ("metric", "clients", "requests", "wall_s", "requests_per_s",
                    "audio_s_per_wall_s", "latency_p50_ms", "latency_p95_ms",
                    "latency_p99_ms", "shed", "shed_rate", "max_queue",
                    "dispatches", "mean_batch", "max_batch_seen", "window_ms",
                    "engine"),
    "bench_stream": ("metric", "value", "unit", "monolithic_p50_ms",
                     "stream_total_p50_ms", "chunk_p50_ms", "chunk_audio_ms",
                     "realtime_margin", "sentence_audio_s", "chunk_frames",
                     "halo_frames"),
    "bench_train": ("metric", "value", "unit", "vs_baseline",
                    "audio_sec_per_step", "audio_sec_per_wall_sec", "batch",
                    "frames", "tflops_per_step", "mfu", "loss_g"),
    "profile_ops": ("metric", "stage", "reps", "device_ms_per_rep",
                    "by_class_ms_per_rep", "flops_per_rep", "top_ops",
                    "top_kernels", "conv_backward_kernels"),
}
STAMP_FIELDS = ("device", "dtype", "tf32")
# shares of a peak, and the divisor that makes each a fraction
SHARES = {"mfu": 1.0, "peak_share": 1.0, "mfu_pct": 100.0, "hbm_util_pct": 100.0}
SHARE_LIMIT = 1.05
FLOPS_AGREE = 0.01
# the train-step tools at the training phases' shapes
TOOL_TRAIN = dict(PTTS_BENCH_BATCH="16", PTTS_BENCH_FRAMES=str(FWD_FRAMES),
                  PTTS_BENCH_REPS="3")


def _values(tree, key=None, lists=True):
    """Every (key, value) pair of a row, through nested dicts, and through
    lists too unless ``lists`` is false."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _values(v, k, lists)
    elif isinstance(tree, list) and lists:
        for v in tree:
            yield from _values(v, key, lists)
    else:
        yield key, tree


def check_tool_rows(name: str, tool, rows) -> None:
    """Every row has its fields; every number is finite; every rate of the
    row (outside its lists of op rows, where an op without FLOPs has none)
    is there on the card; no share of a peak reads above ``SHARE_LIMIT``."""
    if not rows:
        raise AssertionError(f"{name}: no rows")
    for row in rows:
        missing = [f for f in TOOL_FIELDS[name] + STAMP_FIELDS if f not in row]
        if missing:
            raise AssertionError(f"{name}: row lacks {missing}")
        if row["device"]["platform"] != "gpu":
            raise AssertionError(f"{name}: row not from the card")
        fields = {k: v for k, v in row.items() if k != "device"}
        for key, v in _values(fields):
            if isinstance(v, float) and not np.isfinite(v):
                raise AssertionError(f"{name}: {key} = {v}")
            if key in SHARES and v is not None and v / SHARES[key] > SHARE_LIMIT:
                raise AssertionError(f"{name}: share {key} = {v}")
        for key, v in _values(fields, lists=False):
            if key in tool.RATES and v is None:
                raise AssertionError(f"{name}: rate {key} missing on the card")


@contextlib.contextmanager
def environ(**env):
    """The tools' environment settings for one call, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measurement_tools(kernels) -> dict:
    """Phase 12: each tool's ``main`` in this process at full width with
    short settings, TF32 off; each run's launch counts set to 0 just before
    and read just after.  MAS must run once in every train step of
    ``bench_train`` and of ``profile_ops --stage train``, on the card, and
    each of those calls (``MasSpy``) must give the plain MAS's path on the
    same scores."""
    from personalized_text_to_speech_tpu_torch.tools import (
        bench,
        bench_cost,
        bench_serve,
        bench_stream,
        bench_train,
        profile_ops,
    )

    t_phase = time.perf_counter()
    runs = {}

    def run(label, tool, argv, trains=False, **env):
        name = tool.__name__.rsplit(".", 1)[-1]
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with environ(**env), MasSpy() as spy:
            rows = tool.main(argv)
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        check_tool_rows(name, tool, rows)
        if len(spy.calls) != launches["mas"]:
            raise AssertionError(f"{label}: {len(spy.calls)} MAS calls, "
                                 f"{launches['mas']} launches")
        check_mas_calls(spy.calls)
        if trains and not spy.calls:
            raise AssertionError(f"{label}: no MAS call")
        if trains:
            log(f"{label}: the MAS path of each of the {len(spy.calls)} calls "
                f"(scores {list(spy.calls[0][0].shape)}) equals the plain MAS "
                f"on the call's own scores")
        del spy
        log(f"{label}: {len(rows)} row(s) in {secs:.2f} s; launches {launches}")
        runs[label] = {"rows": rows, "seconds": secs, "launches": launches}
        torch.cuda.empty_cache()
        return rows

    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            run(f"bench {dtype}", bench, [], PTTS_BENCH_REPS="2",
                PTTS_BENCH_DTYPE=dtype)
        for dtype in ("float32", "bfloat16"):
            run(f"bench_cost {dtype}", bench_cost,
                ["--batch", str(BENCH_BATCH), "--reps", "3", "--dtype", dtype])
        for dtype in ("float32", "bfloat16"):
            run(f"bench_serve {dtype}", bench_serve,
                ["--clients", "1,16", "--duration", "3", "--dtype", dtype])
        run("bench_stream", bench_stream, ["--reps", "3"])
        steps = {}
        for dtype in ("float32", "bfloat16"):
            rows = run(f"bench_train {dtype}", bench_train, [], trains=True,
                       PTTS_BENCH_DTYPE=dtype, **TOOL_TRAIN)
            steps[dtype] = rows[0]
        ops_json = os.path.join(tmp, "ops_train.json")
        run("profile_ops train float32", profile_ops,
            ["--stage", "train", "--batch", TOOL_TRAIN["PTTS_BENCH_BATCH"],
             "--frames", str(FWD_FRAMES), "--dtype", "float32", "--top", "12",
             "--json", ops_json, "--trace_dir", os.path.join(tmp, "train")],
            trains=True)
        with open(ops_json, encoding="utf-8") as f:
            all_ops = json.load(f)
        run("profile_ops decode bfloat16", profile_ops,
            ["--stage", "decode", "--batch", str(BENCH_BATCH),
             "--dtype", "bfloat16", "--top", "12",
             "--trace_dir", os.path.join(tmp, "decode")])
        run("profile_ops encode float32", profile_ops,
            ["--stage", "encode", "--batch", str(BENCH_BATCH),
             "--dtype", "float32", "--top", "8",
             "--trace_dir", os.path.join(tmp, "encode")])

    # every op row of the train profile, not only the printed top ones
    check_tool_rows("profile_ops", profile_ops, [
        {**runs["profile_ops train float32"]["rows"][0], "top_ops": all_ops["ops"]}])
    f32, b16 = steps["float32"]["flops_per_step"], steps["bfloat16"]["flops_per_step"]
    if abs(f32 - b16) > FLOPS_AGREE * f32:
        raise AssertionError(f"step FLOPs differ: fp32 {f32}, bf16 {b16}")
    for label, want in (("bench_train float32", steps["float32"]["steps_run"]),
                        ("bench_train bfloat16", steps["bfloat16"]["steps_run"]),
                        ("profile_ops train float32", 2 + profile_ops.REPS)):
        got = runs[label]["launches"]["mas"]
        if got != want:
            raise AssertionError(f"{label}: {got} MAS launches in {want} steps")
    prof = runs["profile_ops train float32"]["rows"][0]
    mas_rows = [r for r in all_ops["ops"] if r["category"] == "MAS"]
    log("profile_ops train, MAS rows: " + json.dumps(mas_rows))
    if not prof["by_class_ms_per_rep"]["MAS"] > 0:
        raise AssertionError("profile_ops train: no MAS kernel time on the card; "
                             "kernels named like it: " + json.dumps(
                                 [k["kernel"] for k in all_ops["kernels"]
                                  if "mas" in k["kernel"].lower()]))
    backward = prof["conv_backward_kernels"]
    if not backward or not all(k["ops"] and k["ops"][0]["input_shapes"]
                               for k in backward):
        raise AssertionError("profile_ops train: no convolution shapes behind "
                             "cuDNN's dgrad/wgrad kernels")
    for k in backward:
        log(f"{k['kernel'][:70]}: {k['calls']} calls, "
            f"{k['device_time_us'] / profile_ops.REPS / 1e3:.3f} ms per step; "
            + "; ".join(f"{o['input_shapes'][:3]} {o['layers'][:3]} "
                        f"{o['device_time_us'] / profile_ops.REPS / 1e3:.3f} ms"
                        for o in k["ops"][:4]))
    serving = sum(r["launches"]["mas"] for label, r in runs.items()
                  if not label.startswith(("bench_train", "profile_ops train")))
    phase_s = time.perf_counter() - t_phase
    log(f"measurement tools: {phase_s:.2f} s; step FLOPs fp32 {f32:.6g} and "
        f"bf16 {b16:.6g}; MAS launches on the serving tools {serving}")
    return {"runs": runs, "phase_s": phase_s, "serving_mas": serving}


# --------------------------------------------------------------------------
# fine-tune and score: formant corpus → preprocess → Trainer with evaluate()
# → the scoring tools
# --------------------------------------------------------------------------

FT_EPOCHS = 12  # 6 batches of 16 an epoch: 72 steps
FT_EVAL_INTERVAL = 24  # evaluate() at steps 0, 24 and 48
FT_EVAL_LINES, FT_VC_PAIRS = 4, 2


class Captured:
    """Records the arrays ``Trainer.evaluate`` hands to the plot functions
    (the mel ``[n_mels, frames]`` and the alignment), drawing them as
    usual."""

    def __init__(self):
        from personalized_text_to_speech_tpu_torch.utils import logging_utils

        self._mod = logging_utils
        self._real = (logging_utils.plot_spectrogram_to_numpy,
                      logging_utils.plot_alignment_to_numpy)
        self.mels, self.alignments = [], []

    def __enter__(self):
        spec, align = self._real

        def plot_spec(a):
            self.mels.append(np.array(a))
            return spec(a)

        def plot_align(a, info=None):
            self.alignments.append(np.array(a))
            return align(a, info)

        self._mod.plot_spectrogram_to_numpy = plot_spec
        self._mod.plot_alignment_to_numpy = plot_align
        return self

    def __exit__(self, *exc):
        (self._mod.plot_spectrogram_to_numpy,
         self._mod.plot_alignment_to_numpy) = self._real
        return False


@contextlib.contextmanager
def durations(model, w_ceil=None):
    """Records ``model.infer_encode``'s own ceiled durations in the list it
    yields; with ``w_ceil``, the encode returns those in place of its own
    (a ceil next to an integer must not change the frame count between
    devices)."""
    real = model.infer_encode
    own = []

    def fed(*args, **kwargs):
        mine, *rest = real(*args, **kwargs)
        own.append(mine.detach().cpu())
        return (mine if w_ceil is None else w_ceil.to(mine.device, mine.dtype),
                *rest)

    model.infer_encode = fed
    try:
        yield own
    finally:
        del model.infer_encode


def check_evaluate_outputs(step, out, mels, alignments, hop, n_mels) -> int:
    """One ``evaluate()``'s outputs: finite audio ``y_len · hop`` long, its
    mel ``[n_mels, y_len]`` and alignment over ``y_len`` frames, finite;
    the ground truth's at step 0.  Returns ``y_len``."""
    images, audios = out
    gen = audios["gen/audio"]
    y_len = len(gen) // hop
    if y_len < 1 or len(gen) != y_len * hop or not np.isfinite(gen).all():
        raise AssertionError(f"evaluate at step {step}: gen/audio of "
                             f"{len(gen)} samples, hop {hop}")
    if mels[0].shape != (n_mels, y_len) or not np.isfinite(mels[0]).all():
        raise AssertionError(f"evaluate at step {step}: gen/mel "
                             f"{mels[0].shape}, want {(n_mels, y_len)}")
    if alignments[0].shape[1] != y_len:
        raise AssertionError(f"evaluate at step {step}: alignment "
                             f"{alignments[0].shape} over {y_len} frames")
    want = {"gen/mel", "gen/attn"} | ({"gt/mel"} if step == 0 else set())
    if set(images) != want or set(audios) != {"gen/audio"} | (
            {"gt/audio"} if step == 0 else set()):
        raise AssertionError(f"evaluate at step {step}: {sorted(images)} "
                             f"{sorted(audios)}")
    if step == 0 and not (len(mels) == 2 and np.isfinite(mels[1]).all()):
        raise AssertionError("evaluate at step 0: no finite gt/mel")
    return y_len


def check_eval_files(writer, steps) -> list:
    """The eval writer's files: TensorBoard events where tensorboardX is
    installed, else a ``.wav`` per audio and a ``.npy`` per image."""
    files = sorted(os.listdir(writer.log_dir))
    if writer._tb is not None:
        if not any(f.startswith("events.out.tfevents") for f in files):
            raise AssertionError(f"no TensorBoard events under eval/: {files}")
    else:
        want = ["gt_audio_0.wav", "gt_mel_0.npy"] + [
            f"gen_{k}_{s}.{ext}" for s in steps
            for k, ext in (("audio", "wav"), ("mel", "npy"), ("attn", "npy"))]
        missing = [f for f in want if f not in files]
        if missing:
            raise AssertionError(f"eval/ lacks {missing}; has {files}")
    return files


def finite_metrics(name: str, tree) -> None:
    bad = [k for k, v in _values(tree, lists=False)
           if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{name}: metrics not finite: {bad}")


def evaluate_card_against_cpu(trainer, hps) -> dict:
    """``evaluate()`` of the fine-tuned Trainer on the card against a CPU
    Trainer's with the same G weights, both in fp32 (TF32 off) at step 0:
    the same injected noise, and the CPU's durations fed to the card's
    decode.  The audio and both mels are held to ``CPU_REL_TOL`` of their
    own largest value, the alignment exactly."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams_from_dict
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    cpu_hps = load_hparams_from_dict(hps.to_dict())
    cpu_hps.train.bf16_run = False
    cpu = Trainer(cpu_hps, os.path.join(trainer.model_dir, "cpu"), device="cpu")
    cpu.g_state.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.g_state.module.state_dict().items()})
    rng = np.random.default_rng(13)
    noise = dict(
        dp_noise=rng.normal(size=(1, hps.tpu.text_buckets[-1], 2)).astype(np.float32),
        prior_noise=rng.normal(size=(1, hps.tpu.frame_buckets[-1],
                                     hps.model.inter_channels)).astype(np.float32))
    bf16, step = trainer.hps.train.bf16_run, trainer.global_step
    trainer.hps.train.bf16_run, trainer.global_step = False, 0
    try:
        t0 = time.perf_counter()
        with Captured() as cap_cpu, durations(cpu.g_state.module) as cpu_w:
            cpu_out = cpu.evaluate(**noise)
        cpu_s = time.perf_counter() - t0
        with Captured() as cap, durations(trainer.g_state.module,
                                          cpu_w[0]) as card_w:
            card_out = trainer.evaluate(**noise)
    finally:
        trainer.hps.train.bf16_run, trainer.global_step = bf16, step
    moved = int((card_w[0] - cpu_w[0]).abs().gt(0).sum())
    if (card_w[0] - cpu_w[0]).abs().max() > 1:
        raise AssertionError("evaluate card vs CPU: durations differ by more "
                             "than one frame")
    pairs = {"gen/audio": (card_out[1]["gen/audio"], cpu_out[1]["gen/audio"]),
             "gen/mel": (cap.mels[0], cap_cpu.mels[0]),
             "gt/mel": (cap.mels[1], cap_cpu.mels[1])}
    errs = {}
    for k, (got, want) in pairs.items():
        if got.shape != want.shape:
            raise AssertionError(f"evaluate card vs CPU: {k} {got.shape} "
                                 f"against {want.shape}")
        errs[k] = (float(np.abs(got - want).max()), float(np.abs(want).max()))
    if not np.array_equal(cap.alignments[0], cap_cpu.alignments[0]):
        raise AssertionError("evaluate card vs CPU: alignments differ")
    for k, (err, size) in errs.items():
        log(f"evaluate card vs CPU (fp32), {k}: max abs err {err}, max abs "
            f"value {size}, tolerance {CPU_REL_TOL} x value = "
            f"{CPU_REL_TOL * size}")
    if not all(err <= CPU_REL_TOL * size for err, size in errs.values()):
        raise AssertionError("evaluate: card and CPU disagree")
    log(f"evaluate card vs CPU: alignment equal; the card's own durations "
        f"differ from the CPU's at {moved} of {cpu_w[0].numel()} tokens; "
        f"the CPU call took {cpu_s:.2f} s")
    return {"errors": errs, "cpu_s": cpu_s, "durations_moved": moved}


def finetune_and_score(kernels) -> dict:
    """Phase 13: the fine-tune loop of ``docs/WORKFLOW.md`` on the card, in a
    temporary working directory: corpus, preprocess, ``Trainer.fit`` with
    ``evaluate()``, ``evaluate()`` card against CPU, the scoring tools on
    ``G_latest.pth``, and the compacted checkpoint served."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
    from personalized_text_to_speech_tpu_torch.tools import (
        eval_pair,
        eval_set,
        eval_vc,
        make_dataset,
        preprocess,
        rearrange_speaker,
    )
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    result = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        make_dataset.main(["--out_dir", "corpus", "--anno_out",
                           "short_character_anno.txt", "--speakers",
                           "klatt_m,klatt_f", "--languages", "E", "--seed", "0"])
        preprocess.main(["--base_config", str(CONFIG), "--out_config",
                         "finetune.json"])
        result["corpus_s"] = time.perf_counter() - t0
        hps = load_hparams("finetune.json")
        hps.train.eval_interval = FT_EVAL_INTERVAL
        hps["preserved"] = 1
        hop, n_mels = hps.data.hop_length, hps.data.n_mel_channels
        log(f"fine-tune: corpus and preprocess in {result['corpus_s']:.2f} s; "
            f"speakers {dict(hps.speakers.items())}, hidden "
            f"{hps.model.hidden_channels}, upsampling "
            f"{hps.model.upsample_rates}, bf16_run {hps.train.bf16_run}")

        trainer = Trainer(hps, os.path.abspath("run"), device=TRAIN_DEVICE)
        log(f"fine-tune: {len(trainer.train_set)} clips, {len(trainer.batcher)} "
            f"batches of {hps.train.batch_size} an epoch, buckets "
            f"{trainer.batcher.boundaries}; {len(trainer.eval_set)} validation "
            f"clips")
        evals = []
        real_evaluate = trainer.evaluate

        def timed_evaluate(**kwargs):
            sync()
            t0 = time.perf_counter()
            with Captured() as cap:
                out = real_evaluate(**kwargs)
            sync()
            evals.append((trainer.global_step, time.perf_counter() - t0, out,
                          cap))
            return out

        trainer.evaluate = timed_evaluate
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with MasSpy() as spy:
            trainer.fit(max_epochs=FT_EPOCHS)
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        del trainer.evaluate
        steps = trainer.global_step
        if not launches["mas"] == len(spy.calls) == steps:
            raise AssertionError(f"fine-tune: {launches['mas']} MAS launches, "
                                 f"{len(spy.calls)} calls in {steps} steps")
        check_mas_calls(spy.calls)
        shapes = sorted({tuple(c[0].shape) for c in spy.calls})
        del spy
        eval_steps = [e[0] for e in evals]
        if eval_steps != list(range(0, steps, FT_EVAL_INTERVAL)) or \
                len(eval_steps) < 3:
            raise AssertionError(f"fine-tune: evaluate() at steps {eval_steps}")
        y_lens = [check_evaluate_outputs(st, out, cap.mels, cap.alignments,
                                         hop, n_mels)
                  for st, _, out, cap in evals]
        files = check_eval_files(trainer.writer_eval, eval_steps)
        eval_ms = [e[1] * 1e3 for e in evals]
        log(f"fine-tune: fit({FT_EPOCHS} epochs) took {steps} steps in "
            f"{fit_s:.2f} s ({len(evals)} evaluate() calls, checkpoints and the "
            f"export included); MAS: {launches['mas']} launches, scores "
            f"{shapes}, each path equal to the plain MAS on its own scores")
        log(f"fine-tune: evaluate() at steps {eval_steps}: {y_lens} frames, ms "
            f"on the card per call {[round(m, 2) for m in eval_ms]} (median of "
            f"the calls after the first {statistics.median(eval_ms[1:]):.2f} "
            f"ms); {len(files)} files under eval/")
        result.update(steps=steps, fit_s=fit_s, launches=launches,
                      eval_steps=eval_steps, eval_ms=eval_ms, y_lens=y_lens)
        del evals

        result["card_vs_cpu"] = evaluate_card_against_cpu(trainer, hps)

        model = os.path.join(trainer.model_dir, "G_latest.pth")
        config = os.path.join(trainer.model_dir, "config.json")
        val = hps.data.validation_files
        emb = trainer.g_state.module.emb_g.weight.detach().cpu()
        del trainer
        torch.cuda.empty_cache()

        def tool(label, main, argv):
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with MasSpy() as spy:
                out = main(argv)
            secs = time.perf_counter() - t0
            n = {k: fn.launches for k, fn in kernels.items()}
            if n["mas"] or spy.calls:
                raise AssertionError(f"{label}: MAS ran ({n})")
            finite_metrics(label, out)
            log(f"{label}: {secs:.2f} s; launches {n}; " + json.dumps(out))
            result[label] = {"out": out, "seconds": secs}
            return out

        tool("eval_set", eval_set.main,
             ["--model", model, "--config", config, "--annotations", val,
              "--limit", str(FT_EVAL_LINES), "--batch", str(FT_EVAL_LINES),
              "--out_dir", "syn", "--device", TRAIN_DEVICE])
        tool("eval_vc", eval_vc.main,
             ["--model", model, "--config", config, "--annotations", val,
              "--src", "0", "--tgt", "1", "--limit", str(FT_VC_PAIRS),
              "--device", TRAIN_DEVICE])
        ref = eval_set.read_annotations(val)[0][0]
        tool("eval_pair", eval_pair.main,
             ["--ref_wav", ref, "--syn_wav",
              os.path.join("syn", os.path.basename(ref)),
              "--sr", str(hps.data.sampling_rate), "--device", TRAIN_DEVICE])
        es = result["eval_set"]
        log(f"eval_set: {FT_EVAL_LINES} utterances, per utterance "
            f"{es['out']['seconds']['synthesis'] / FT_EVAL_LINES:.4f} s of "
            f"synthesis on the card and "
            f"{es['out']['seconds']['metrics'] / FT_EVAL_LINES:.4f} s of "
            f"metrics on the host")

        rearrange_speaker.main(["--model_dir", model, "--config_dir", config,
                                "--out_model", "G_compact.pth", "--out_config",
                                "compact.json", "--out_moegoe", ""])
        compact = load_hparams("compact.json")
        engine = TTSEngine(compact, checkpoint_path="G_compact.pth",
                           device=TRAIN_DEVICE)  # a strict load
        order = [old for _, old in sorted(hps.speakers.items(),
                                          key=lambda kv: kv[1])]
        if not torch.equal(engine.model.emb_g.weight.cpu(), emb[order]):
            raise AssertionError("rearrange_speaker: speaker rows differ")
        out_sr, wav = engine.tts("The compact voice speaks.", speaker="klatt_f",
                                 language="English", rng=3)
        if out_sr != hps.data.sampling_rate or not np.isfinite(wav).all() or \
                len(wav) < hop:
            raise AssertionError("the compacted generator gave bad audio")
        log(f"rearrange_speaker: {emb.shape[0]} → "
            f"{compact.data.n_speakers} speakers {dict(compact.speakers.items())};"
            f" G_compact.pth loads strictly into TTSEngine, one request gave "
            f"{len(wav) / out_sr:.3f} s of finite audio")
        del engine
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"fine-tune and score: {result['phase_s']:.2f} s")
    return result


# --------------------------------------------------------------------------
# the rest of the train step: the spectral-norm discriminator, exact
# gradient accumulation, remat, and the memory audit
# --------------------------------------------------------------------------

# timed Trainer steps of each spectral-norm mode, after its fit
SN_TIMED = 3
# one D update, card against CPU: each u/v to this share of its norm (one
# fp32 matrix-vector product per estimate; bf16 keeps 8 bits of mantissa)
SN_UV_TOL = 1e-5
# accumulation and remat against the fused step, all on the card in fp32 with
# TF32 off, dropout off: each loss within 1e-4 of its size; each network's
# gradient within 1e-3 of its L2 norm (the same sums in another order, at
# batch 16/k, where cuDNN may pick other algorithms)
ACCUM_LOSS_TOL = 1e-4
ACCUM_GRAD_TOL = 1e-3
ACCUM_RUNS = ((1, "none"), (2, "none"), (4, "none"), (1, "dots"), (1, "full"))
MEM_RUNS = (("float32", ("1:none", "2:none", "4:none", "1:dots", "1:full",
                         "4:full")),
            ("bfloat16", ("1:none", "4:none")))
MEM_FIELDS = ("peak_bytes", "resident_bytes", "activation_bytes", "base_bytes",
              "step_ms")


def spectral_buffers(module) -> dict:
    return {n: b.detach().clone() for n, b in module.named_buffers()
            if n.endswith(("weight_u", "weight_v"))}


def mas_launches_ok(launches: int, steps: int, k: int, remat: str) -> bool:
    """One MAS launch per generator forward: one a fused step, two per
    microbatch under accumulation; remat's recompute may add some."""
    forwards = steps * (1 if k == 1 else 2 * k)
    return launches == forwards if remat == "none" else launches >= forwards


def spectral_training(mode: str, hps, model_dir: Path, kernels, timed: int,
                      check_resume: bool) -> dict:
    """Phase 14 (a): ``Trainer`` with the spectral-norm discriminator (and
    the accumulation and remat ``hps`` asks for): ``fit`` for one epoch
    (2 steps) and ``timed`` more steps, every launch counter 0 just before;
    losses finite, every ``u``/``v`` moved, every MAS call equal to the
    plain MAS, ``D_latest.pth`` with ``weight_orig``/``weight_u``/
    ``weight_v`` for every conv; ``save`` → resume restores them bit for
    bit when ``check_resume``."""
    from personalized_text_to_speech_tpu_torch.models.layers import (
        SpectralNormConv1d,
        SpectralNormConv2d,
    )
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer
    from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc

    trainer = Trainer(hps, str(model_dir), device=TRAIN_DEVICE)
    d = trainer.d_state.module
    uv_before = spectral_buffers(d)
    convs = [n for n, m in d.named_modules()
             if isinstance(m, (SpectralNormConv1d, SpectralNormConv2d))]
    if not convs or len(uv_before) != 2 * len(convs):
        raise AssertionError(f"{mode}: the discriminator has no spectral norm")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with MasSpy() as spy:
        trainer.fit(max_epochs=1)
        fit_s = time.perf_counter() - t0
        batches = list(trainer.batcher)
        metrics, times = [], []
        for i in range(timed):
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(batches[i % len(batches)]))
            sync()
            times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in kernels.items()}
    steps = trainer.global_step
    if len(spy.calls) != launches["mas"] or not mas_launches_ok(
            launches["mas"], steps, int(hps.train.get("accum_steps", 1)),
            str(hps.train.get("remat", "none"))):
        raise AssertionError(f"{mode}: {launches['mas']} MAS launches, "
                             f"{len(spy.calls)} calls in {steps} steps")
    check_mas_calls(spy.calls)
    shapes = sorted({tuple(c[0].shape) for c in spy.calls})
    del spy
    for m in metrics:
        bad = [k for k, v in m.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"{mode}: non-finite {bad}")
    uv_after = spectral_buffers(d)
    # a conv_post's u has one element, always 1 after normalising
    still = [n for n in uv_before if uv_before[n].numel() > 1
             and torch.equal(uv_before[n], uv_after[n])]
    if still:
        raise AssertionError(f"{mode}: u/v did not move: {still[:6]}")
    state, _ = tc.load_torch_checkpoint(str(model_dir / "D_latest.pth"))
    missing = [f"{c}.{key}" for c in convs
               for key in ("weight_orig", "weight_u", "weight_v")
               if f"{c}.{key}" not in state]
    if missing or any(k.endswith(("weight_g", ".weight")) for k in state):
        raise AssertionError(f"{mode}: D_latest.pth keys wrong: {missing[:6]}")
    result = {"mode": mode, "steps": steps, "launches": launches,
              "mas_shapes": shapes, "fit_s": fit_s,
              "accum_steps": int(hps.train.get("accum_steps", 1)),
              "remat": str(hps.train.get("remat", "none")),
              "spectral_convs": len(convs)}
    if times:
        result["step_ms"] = {"median": statistics.median(times) * 1e3,
                             "min": min(times) * 1e3, "max": max(times) * 1e3}
        result["last_losses"] = {k: metrics[-1][k].item() for k in
                                 ("loss/g/total", "loss/d/total", "grad_norm_d")}
    if check_resume:
        trainer.save()
        fresh = Trainer(hps, str(model_dir), device=TRAIN_DEVICE)
        if not fresh.resume() or fresh.global_step != steps:
            raise AssertionError(f"{mode}: resume did not restore the step")
        got = spectral_buffers(fresh.d_state.module)
        if set(got) != set(uv_after) or not all(
                torch.equal(got[n], uv_after[n]) for n in got):
            raise AssertionError(f"{mode}: resume did not restore u/v")
        del fresh
        result["resume"] = f"{len(got)} u/v buffers restored bit for bit"
    log(f"spectral {mode}: " + json.dumps(result))
    del trainer
    torch.cuda.empty_cache()
    return result


def spectral_card_against_cpu(hps) -> dict:
    """Phase 14 (a): one D update (forward with the power iteration on,
    loss, backward, AdamW) of the spectral-norm ensemble at B=2 × segment on
    the CPU in fp32 and on the card in fp32 and under bf16 autocast, from
    the same weights and audio: each ``u``/``v`` against the CPU's."""
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.layers import (
        power_iteration,
    )
    from personalized_text_to_speech_tpu_torch.train import losses
    from personalized_text_to_speech_tpu_torch.train.state import (
        create_train_state,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(88)
        weights = MultiPeriodDiscriminator(use_spectral_norm=True).state_dict()
    rng = np.random.default_rng(88)
    audio = [torch.from_numpy((0.3 * rng.normal(size=(2, hps.train.segment_size))
                               ).astype(np.float32)) for _ in range(2)]
    uv = {}
    for label, dev, bf16 in (("cpu", "cpu", False),
                             ("card fp32", TRAIN_DEVICE, False),
                             ("card bf16", TRAIN_DEVICE, True)):
        d = MultiPeriodDiscriminator(use_spectral_norm=True)
        d.load_state_dict(weights)
        d.to(dev)
        st = create_train_state(d, hps, steps_per_epoch=1)
        y, y_hat = (a.to(dev) for a in audio)
        with torch.autocast(device_type=dev, dtype=torch.bfloat16,
                            enabled=bf16), power_iteration(d):
            y_d_r, y_d_g, _, _ = d(y, y_hat)
        loss, _, _ = losses.discriminator_loss(y_d_r, y_d_g)
        st.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        st.apply_gradients()
        uv[label] = {n: b.cpu() for n, b in spectral_buffers(d).items()}
        if any(b.dtype != torch.float32 for b in uv[label].values()):
            raise AssertionError(f"{label}: u/v left float32")
    moved = sum(not torch.equal(uv["cpu"][n], weights[n]) for n in uv["cpu"]
                if weights[n].numel() > 1)
    worst = {}
    for label in ("card fp32", "card bf16"):
        worst[label] = max(
            ((uv[label][n] - w).abs().max() / w.norm()).item()
            for n, w in uv["cpu"].items())
    log(f"spectral card vs CPU: one D update moved {moved} of {len(uv['cpu'])} "
        f"u/v; worst error against the vector's norm {worst} (bound {SN_UV_TOL})")
    if any(v > SN_UV_TOL for v in worst.values()):
        raise AssertionError("spectral card vs CPU: u/v out of bounds")
    return worst


def accum_and_remat(filelist: str, kernels) -> dict:
    """Phase 14 (b) and (c): one step at B=16 (a batch of the synthetic set,
    400 frames, 192 tokens) from the same weights and draws, G and D in
    ``eval()`` (dropout off), with ``accum_steps`` 1, 2, 4 and with remat
    ``dots`` and ``full``: each held to the fused step; every MAS call
    counted and held to the plain MAS on its own scores."""
    from personalized_text_to_speech_tpu_torch.data.dataset import (
        BucketBatcher,
        DatasetConfig,
        TextAudioSpeakerDataset,
    )
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
        draw_samples,
        make_train_step,
    )

    hps = train_hps(filelist, bf16=False)
    hop = hps.data.hop_length
    ds = TextAudioSpeakerDataset(filelist, DatasetConfig.from_hparams(hps),
                                 hps.symbols, seed=hps.train.seed)
    batch = Batch.from_numpy(next(iter(BucketBatcher(ds, 16, seed=0))),
                             TRAIN_DEVICE)
    gen = torch.Generator(device=TRAIN_DEVICE)
    gen.manual_seed(99)
    samples = draw_samples(batch, hop, hps.train.segment_size // hop,
                           hps.model.inter_channels, True, gen)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(55)
        g, d = SynthesizerTrn.from_hparams(hps), MultiPeriodDiscriminator()
    g_weights = {k: v.clone() for k, v in g.state_dict().items()}
    d_weights = {k: v.clone() for k, v in d.state_dict().items()}
    g.to(TRAIN_DEVICE).eval()
    d.to(TRAIN_DEVICE).eval()
    runs = {}
    for k, remat in ACCUM_RUNS:
        g.load_state_dict(g_weights)
        d.load_state_dict(d_weights)
        g_state = create_train_state(g, hps, steps_per_epoch=1)
        d_state = create_train_state(d, hps, steps_per_epoch=1)
        step = make_train_step(hps, debug_grads=True, accum_steps=k, remat=remat)
        for fn in kernels.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        with MasSpy() as spy:
            m = step(g_state, d_state, batch, samples=samples)
            sync()
        secs = time.perf_counter() - t0
        launches = kernels["mas"].launches
        if launches != len(spy.calls) or not mas_launches_ok(launches, 1, k,
                                                             remat):
            raise AssertionError(f"k={k} {remat}: {launches} MAS launches, "
                                 f"{len(spy.calls)} calls")
        check_mas_calls(spy.calls)
        shapes = sorted({tuple(c[0].shape) for c in spy.calls})
        del spy
        runs[(k, remat)] = {
            "losses": {n: v.item() for n, v in m.items() if not n.startswith("_")},
            "grads": {net: {n: v.clone() for n, v in m[net].items()
                            if v is not None}
                      for net in ("_grads_g", "_grads_d")},
            "mas_launches": launches, "mas_shapes": shapes,
            "first_step_ms": secs * 1e3,
        }
        del m, step, g_state, d_state
        torch.cuda.empty_cache()
    ref = runs[(1, "none")]
    report = {}
    for key, run in runs.items():
        loss_err = max(abs(v - ref["losses"][n]) / max(abs(ref["losses"][n]), 1e-3)
                       for n, v in run["losses"].items())
        grad_err = {}
        for net, want in ref["grads"].items():
            got = run["grads"][net]
            if set(got) != set(want):
                raise AssertionError(f"{key}: {net} has other tensors")
            diff = sum((got[n] - w).double().square().sum().item()
                       for n, w in want.items())
            norm = sum(w.double().square().sum().item() for w in want.values())
            grad_err[net] = (diff / norm) ** 0.5
        report[f"{key[0]}:{key[1]}"] = {
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "mas_launches": run["mas_launches"], "mas_shapes": run["mas_shapes"],
            "first_step_ms": run["first_step_ms"]}
        if loss_err > ACCUM_LOSS_TOL or \
                any(e > ACCUM_GRAD_TOL for e in grad_err.values()):
            raise AssertionError(f"{key}: against the fused step {report}")
    log("accumulation and remat against the fused step (losses bound "
        f"{ACCUM_LOSS_TOL}, gradients {ACCUM_GRAD_TOL} of the norm): "
        + json.dumps(report))
    del runs, g, d
    torch.cuda.empty_cache()
    return report


def bench_mem_rows(kernels) -> dict:
    """Phase 14 (d): ``tools.bench_mem``'s ``main`` in this process, B=16 ×
    400 frames, 96 tokens; every field there and finite, and in fp32
    ``4:none`` and ``1:full`` peaking below ``1:none``."""
    from personalized_text_to_speech_tpu_torch.tools import bench_mem

    rows, launches = {}, {}
    for dtype, combos in MEM_RUNS:
        for fn in kernels.values():
            fn.launches = 0
        for row in bench_mem.main(["--dtype", dtype, "--combos", *combos]):
            if row["device"]["platform"] != "gpu":
                raise AssertionError("bench_mem: row not from the card")
            bad = [f for f in MEM_FIELDS if not isinstance(row.get(f), (int, float))
                   or not np.isfinite(row[f])]
            if bad:
                raise AssertionError(f"bench_mem: {bad} missing or not finite")
            rows[f"{dtype} {row['accum_steps']}:{row['remat']}"] = row
        launches[dtype] = kernels["mas"].launches
    fp32 = {k.split()[1]: r["peak_bytes"] for k, r in rows.items()
            if k.startswith("float32")}
    if not fp32["4:none"] < fp32["1:none"] or not fp32["1:full"] < fp32["1:none"]:
        raise AssertionError(f"bench_mem: fp32 peaks {fp32}")
    log(f"bench_mem: MAS launches {launches}; fp32 peaks {fp32}")
    return {"rows": rows, "launches": launches}


def rest_of_train_step(kernels, weight_norm_ms: dict) -> dict:
    """Phase 14: (a) the spectral-norm discriminator through ``Trainer`` in
    fp32 and bf16, and once more with ``accum_steps`` 4 and remat ``full``;
    one D update card against CPU; (b, c) accumulation and remat against
    the fused step; (d) ``tools.bench_mem``."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams

    t_phase = time.perf_counter()
    result = {"spectral": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data_hps = load_hparams(str(CONFIG))
        (tmp / "data").mkdir()
        make_train_set(tmp / "data", data_hps)
        filelist = data_hps.data.training_files
        for mode, bf16, extra in (("fp32", False, {}), ("bf16", True, {}),
                                  ("fp32 k=4 full", False,
                                   {"accum_steps": 4, "remat": "full"})):
            hps = train_hps(filelist, bf16=bf16)
            hps.model.use_spectral_norm = True
            for key, value in extra.items():
                hps.train[key] = value
            run = spectral_training(mode, hps, tmp / mode.replace(" ", "_"),
                                    kernels, timed=0 if extra else SN_TIMED,
                                    check_resume=mode == "fp32")
            if mode in weight_norm_ms:
                run["against_weight_norm"] = (run["step_ms"]["median"]
                                              / weight_norm_ms[mode])
                log(f"spectral {mode}: step median "
                    f"{run['step_ms']['median']:.2f} ms against the weight-norm "
                    f"step's {weight_norm_ms[mode]:.2f} ms (phases 7/9): "
                    f"{run['against_weight_norm']:.3f}x")
            result["spectral"][mode] = run
        result["uv_card_vs_cpu"] = spectral_card_against_cpu(
            train_hps(filelist, bf16=False))
        result["accum"] = accum_and_remat(filelist, kernels)
    result["bench_mem"] = bench_mem_rows(kernels)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"rest of the train step: {result['phase_s']:.2f} s")
    return result


# --------------------------------------------------------------------------
# data-parallel fine-tuning: a world-size-1 NCCL group through the Trainer,
# two gloo ranks on the one card, and the dry run
# --------------------------------------------------------------------------

# timed Trainer steps of the world-size-1 run, after its fit
DP_TIMED = 3
# seconds the two gloo ranks, and the dry run with its ranks, may take
DP_RANKS_LIMIT_S = 240
DP_DRYRUN_LIMIT_S = 300


def dp_job(filelist: str, spectral: bool) -> dict:
    """A dry-run job at full width: weights from a seed, 16 rows of the
    synthetic set (400 frames, 192 tokens) and the step's draws, made on
    the host."""
    from personalized_text_to_speech_tpu_torch.data.dataset import (
        BucketBatcher,
        DatasetConfig,
        TextAudioSpeakerDataset,
    )
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.parallel import dryrun
    from personalized_text_to_speech_tpu_torch.train.step import (
        Batch,
        draw_samples,
    )

    hps = train_hps(filelist, bf16=False)
    hps.model.use_spectral_norm = spectral
    hop = hps.data.hop_length
    ds = TextAudioSpeakerDataset(filelist, DatasetConfig.from_hparams(hps),
                                 hps.symbols, seed=hps.train.seed)
    arrays = next(iter(BucketBatcher(ds, 16, seed=0)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(66)
        g = SynthesizerTrn.from_hparams(hps)
        d = MultiPeriodDiscriminator(use_spectral_norm=spectral)
    samples = draw_samples(Batch.from_numpy(arrays, "cpu"), hop,
                           hps.train.segment_size // hop,
                           hps.model.inter_channels, True,
                           torch.Generator().manual_seed(67))
    return dryrun.make_job(hps, g.state_dict(), d.state_dict(), arrays,
                           samples, d_kwargs={"use_spectral_norm": spectral})


def run_limited(cmd, limit_s: float) -> str:
    """``cmd`` in a session of its own; after ``limit_s`` seconds the whole
    session (its ranks too) is killed and the run fails."""
    import signal

    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=limit_s)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        log(out[-4000:])
        raise AssertionError(f"{cmd[2:]} ran past {limit_s} s and was killed")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        log(out[-4000:])
        raise AssertionError(f"{cmd[2:]} exited with {proc.returncode}")
    return out


def dp_world_one(filelist: str, kernels, fp32_step_ms: float,
                 smi: str) -> dict:
    """Phase 15 (a): the Trainer in a world-size-1 NCCL group;
    ``allreduce_grads`` timed; one step in the group bit for bit the step
    with no group."""
    import torch.distributed as dist

    from personalized_text_to_speech_tpu_torch import parallel
    from personalized_text_to_speech_tpu_torch.parallel import dryrun
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer
    from personalized_text_to_speech_tpu_torch.utils import runtime

    job = dp_job(filelist, spectral=False)

    def one_step():
        saved = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            return dryrun.run_step(job, TRAIN_DEVICE)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved

    # the step with no group, twice (it must repeat itself)
    runs = [one_step(), one_step()]
    runtime.init_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        result = {"backend": "nccl",
                  "world": dist.get_world_size()}
        with tempfile.TemporaryDirectory() as tmp:
            hps = train_hps(filelist, bf16=False)
            trainer = Trainer(hps, str(Path(tmp) / "run"), device=TRAIN_DEVICE)
            if trainer.world != 1 or \
                    trainer.device != torch.device("cuda", 0):
                raise AssertionError("the Trainer did not take the group")
            launches0 = kernels["mas"].launches
            with MasSpy() as spy:
                t0 = time.perf_counter()
                trainer.fit(max_epochs=1)
                fit_s = time.perf_counter() - t0
                batches = list(trainer.batcher)
                metrics, times = [], []
                for i in range(DP_TIMED):
                    t0 = time.perf_counter()
                    metrics.append(trainer.train_step(batches[i % len(batches)]))
                    sync()
                    times.append(time.perf_counter() - t0)
            launches = kernels["mas"].launches - launches0
            steps = trainer.global_step
            if launches != steps or len(spy.calls) != steps:
                raise AssertionError(f"world 1: {launches} MAS launches, "
                                     f"{len(spy.calls)} calls in {steps} steps")
            check_mas_calls(spy.calls)
            del spy
            for m in metrics:
                bad = [k for k, v in m.items() if not torch.isfinite(v)]
                if bad:
                    raise AssertionError(f"world 1: non-finite {bad}")
            g_mod, d_mod = trainer.g_state.module, trainer.d_state.module
            ar_ms = {"g": cuda_time_ms(lambda: parallel.allreduce_grads(g_mod),
                                       warmup=2, iters=10),
                     "d": cuda_time_ms(lambda: parallel.allreduce_grads(d_mod),
                                       warmup=2, iters=10)}
            grad_mb = {net: sum(p.grad.numel() * p.grad.element_size()
                                for p in mod.parameters() if p.grad is not None)
                       / 2**20 for net, mod in (("g", g_mod), ("d", d_mod))}
            median = statistics.median(times) * 1e3
            result.update(
                steps=steps, trainer_launches=launches, fit_s=fit_s,
                step_ms={"median": median, "min": min(times) * 1e3,
                         "max": max(times) * 1e3},
                against_phase7=median / fp32_step_ms,
                allreduce_grads_ms=ar_ms, grad_mb=grad_mb)
            log(f"dp world 1 (nccl) on {smi}: fit {steps - DP_TIMED} steps in "
                f"{fit_s:.2f} s, step median {median:.2f} ms against phase 7's "
                f"{fp32_step_ms:.2f} ms ({median / fp32_step_ms:.3f}x); "
                f"allreduce_grads G {ar_ms['g']:.4f} ms ({grad_mb['g']:.1f} MiB), "
                f"D {ar_ms['d']:.4f} ms ({grad_mb['d']:.1f} MiB) on the card")
            del trainer, metrics, g_mod, d_mod
            torch.cuda.empty_cache()

        # the same step in the group
        runs.append(one_step())
    finally:
        dist.destroy_process_group()
    plain = runs[0]
    for label, got in (("no group again", runs[1]), ("in the group", runs[2])):
        same = (got["metrics"] == plain["metrics"]
                and got["checksums"] == plain["checksums"]
                and all((v is None and got[net][n] is None)
                        or torch.equal(got[net][n], v)
                        for net in ("grads_g", "grads_d")
                        for n, v in plain[net].items()))
        if not same:
            raise AssertionError(f"world 1: the step {label} differs from "
                                 "the step with no group")
    if any(r["mas_launches"] != 1 or r["mas_plain_equal"] is not True
           for r in runs):
        raise AssertionError("world 1: a step's MAS did not launch once "
                             "or differs from the plain MAS")
    result["bit_exact_step_launches"] = sum(r["mas_launches"] for r in runs)
    log("dp world 1 (nccl): one step at B=16 in the group equals the step "
        "with no group bit for bit (losses, gradients, updated parameters); "
        "the step with no group repeats itself bit for bit")
    return result


def data_parallel(kernels, fp32_step_ms: float, smi: str) -> dict:
    """Phase 15: (a) world-size-1 NCCL, (b) two gloo ranks on the card,
    (c) the dry run."""
    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    for fn in kernels.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data_hps = load_hparams(str(CONFIG))
        (tmp / "data").mkdir()
        make_train_set(tmp / "data", data_hps)
        filelist = data_hps.data.training_files
        result = {"world_one": dp_world_one(filelist, kernels, fp32_step_ms,
                                            smi)}

        launches0 = kernels["mas"].launches
        job = dp_job(filelist, spectral=True)
        two = dryrun.check_parallel(job, 2, TRAIN_DEVICE,
                                         DP_RANKS_LIMIT_S, say=log)
        two["reference_launches"] = kernels["mas"].launches - launches0
        if two["mas_launches"] != [1, 1]:
            raise AssertionError(f"gloo ranks: MAS launches {two['mas_launches']}")
        del job
        result["two_ranks"] = {k: v for k, v in two.items() if k != "ref_metrics"}
        log("dp two gloo ranks on the card (B=8 each, spectral norm): "
            + json.dumps(result["two_ranks"]))

    out = run_limited([sys.executable, "-m",
                       "personalized_text_to_speech_tpu_torch.parallel.dryrun",
                       "--nproc", "2", "--device", "cuda", "--full-width"],
                      DP_DRYRUN_LIMIT_S)
    log(out.rstrip())
    result["dryrun"] = json.loads(out.strip().splitlines()[-1])
    result["launches"] = {
        "dp world-1 nccl Trainer": result["world_one"]["trainer_launches"],
        "dp world-1 nccl step vs no group": result["world_one"][
            "bit_exact_step_launches"],
        "dp gloo single-process reference": two["reference_launches"],
        "dp gloo 2 ranks": sum(two["mas_launches"]),
        "dp dryrun 2 ranks": sum(result["dryrun"]["mas_launches"]),
    }
    if kernels["mas"].launches == 0 or 0 in result["launches"].values():
        raise AssertionError(f"data-parallel paths: {result['launches']}")
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"data-parallel fine-tuning: {result['phase_s']:.2f} s; MAS launches "
        + json.dumps(result["launches"]))
    return result


# --------------------------------------------------------------------------
# tensor-parallel fine-tuning: two gloo ranks on the one card, model axis 2
# --------------------------------------------------------------------------

# rows of phase 16 (a)'s step and the steps timed after it, and the
# seconds its ranks, the TP Trainer's ranks and the TP dry run may take
TP_ROWS = 2
TP_TIMED_STEPS = 3
TP_RANKS_LIMIT_S = 240
TP_TRAINER_LIMIT_S = 300
TP_DRYRUN_LIMIT_S = 360
# TP Trainer steps after its fit
TP_EXTRA_STEPS = 3
# evaluate() of the TP Trainer's rank 0 (an unsharded copy) against the
# unsharded Trainer's on the same card: each audio within this share of its
# largest value, each 8-bit image within one step
TP_EVAL_TOL = 1e-5


def tp_step(filelist: str, kernels, smi: str) -> dict:
    """Phase 16 (a): two gloo ranks on the card, data 1 x model 2, full
    width, B=2, spectral-norm D off and on, against one process with
    ``dryrun.compare_tp``'s bounds; each rank's resident state and peak
    against the unsharded process's."""
    from personalized_text_to_speech_tpu_torch.parallel import dryrun

    result = {}
    for spectral in (False, True):
        job = dp_job(filelist, spectral=spectral)
        job["batch"] = {k: v[:TP_ROWS] for k, v in job["batch"].items()}
        job["samples"] = [None if t is None else t[:TP_ROWS]
                          for t in job["samples"]]
        job["timed_steps"] = TP_TIMED_STEPS
        launches0 = kernels["mas"].launches
        report = dryrun.check_parallel(job, 2, TRAIN_DEVICE, TP_RANKS_LIMIT_S,
                                       say=log, model=2)
        report["reference_launches"] = kernels["mas"].launches - launches0
        del job
        steps = 1 + TP_TIMED_STEPS
        if report["mas_launches"] != [steps, steps] or \
                report["reference_launches"] != steps:
            raise AssertionError(f"tp step: MAS launches {report['mas_launches']}"
                                 f", reference {report['reference_launches']}")
        if report["sharded_g"] < dryrun.MIN_SHARDED:
            raise AssertionError(f"tp step: {report['sharded_g']:.3f} of G "
                                 "sharded")
        ref_mem = report["ref_memory"]
        for mem in report["memory"]:
            if mem["after_step_mib"] >= ref_mem["after_step_mib"] or \
                    mem["state_mib"] >= 0.6 * ref_mem["state_mib"]:
                raise AssertionError(f"tp step: rank memory {mem} against "
                                     f"the unsharded {ref_mem}")
        label = "spectral" if spectral else "weight_norm"
        result[label] = {k: v for k, v in report.items() if k != "ref_metrics"}
        log(f"tp step (data 1 x model 2, B={TP_ROWS}, {label} D) on {smi}: "
            + json.dumps(result[label]))
    return result


def tp_trainer(filelist: str, kernels, tmp: Path, smi: str) -> dict:
    """Phase 16 (b): a TP ``Trainer`` on two gloo ranks (``fit`` for 2
    steps, 3 steps more, save, resume bit for bit, ``evaluate()``), then in
    this process an unsharded ``Trainer`` resumes the checkpoint with equal
    parameters and moments, its ``evaluate()`` matches rank 0's, and
    ``G_latest.pth`` loads strictly into an unsharded model."""
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.parallel import dryrun
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer
    from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc

    hps = train_hps(filelist, bf16=False)
    hps.tpu.mesh = {"data": 1, "model": 2}
    gen = torch.Generator().manual_seed(16)
    dp_noise = torch.randn(1, max(hps.tpu.text_buckets), 2, generator=gen)
    prior_noise = torch.randn(1, max(hps.tpu.frame_buckets),
                              hps.model.inter_channels, generator=gen)
    model_dir = tmp / "tp_run"
    t0 = time.perf_counter()
    ranks = dryrun.spawn_ranks(
        {"hps": hps.to_dict(), "model_dir": str(model_dir), "epochs": 1,
         "extra_steps": TP_EXTRA_STEPS, "dp_noise": dp_noise,
         "prior_noise": prior_noise},
        2, TRAIN_DEVICE, TP_TRAINER_LIMIT_S, task="trainer")
    ranks_s = time.perf_counter() - t0
    steps = ranks[0]["steps"]
    for r in ranks:
        if r["steps"] != steps or r["mas_launches"] != steps or \
                r["mas_calls"] != steps or r["mas_plain_equal"] is not True:
            raise AssertionError(
                f"tp Trainer rank {r['rank']}: {r['steps']} steps, "
                f"{r['mas_launches']} MAS launches, {r['mas_calls']} calls, "
                f"plain MAS equal {r['mas_plain_equal']}")
        if not r["resume_held"]:
            raise AssertionError(f"tp Trainer rank {r['rank']}: resume did "
                                 "not hold the state bit for bit")
    if steps != ranks[0]["fit_steps"] + TP_EXTRA_STEPS or steps <= TP_EXTRA_STEPS:
        raise AssertionError(f"tp Trainer: {steps} steps, "
                             f"{ranks[0]['fit_steps']} in the fit")

    hps1 = train_hps(filelist, bf16=False)
    back = Trainer(hps1, str(model_dir), device=TRAIN_DEVICE)
    if back.mesh.model != 1 or not back.resume() or back.global_step != steps:
        raise AssertionError("tp Trainer: model 1 did not resume the run")
    whole = dryrun.whole_state(back)
    for r in ranks:
        bad = dryrun.slices_differ(whole, r, r["end"])
        if bad:
            raise AssertionError(f"tp Trainer rank {r['rank']}: the model-1 "
                                 f"resume differs in {bad[:6]}")
    images, audios = back.evaluate(dp_noise=dp_noise, prior_noise=prior_noise)
    got_images, got_audios = ranks[0]["evaluate"]
    eval_err = {}
    for k, v in audios.items():
        err = float(np.abs(got_audios[k].numpy() - v).max())
        eval_err[k] = err
        if err > TP_EVAL_TOL * float(np.abs(v).max()):
            raise AssertionError(f"tp evaluate(): {k} off by {err}")
    for k, v in images.items():  # 8-bit images: at most one step
        err = float(np.abs(got_images[k].numpy().astype(np.int64)
                           - np.asarray(v).astype(np.int64)).max())
        eval_err[k] = err
        if err > 1:
            raise AssertionError(f"tp evaluate(): {k} off by {err} steps")
    state, _ = tc.load_torch_checkpoint(str(model_dir / "G_latest.pth"))
    g = SynthesizerTrn.from_hparams(hps1)
    g.load_state_dict(state, strict=True)
    same = all(torch.equal(state[k], v.cpu())
               for k, v in back.g_state.module.state_dict().items())
    if not same:
        raise AssertionError("tp Trainer: G_latest.pth is not the resumed G")
    del back, whole, g, state
    torch.cuda.empty_cache()
    result = {"steps": steps, "ranks_s": ranks_s,
              "launches": sum(r["mas_launches"] for r in ranks),
              "evaluate_max_abs_err": eval_err}
    log(f"tp Trainer (2 gloo ranks, model 2) on {smi}: {steps} steps, save, "
        f"resume bit for bit on both ranks, model-1 resume equal, "
        f"G_latest.pth strict, evaluate() against the unsharded "
        f"{json.dumps(eval_err)}; {ranks_s:.1f} s")
    return result


def tensor_parallel(kernels, smi: str) -> dict:
    """Phase 16: (a) the TP step against one process, (b) the TP Trainer,
    (c) the TP dry run at full width."""
    t_phase = time.perf_counter()
    for fn in kernels.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        from personalized_text_to_speech_tpu_torch.config import load_hparams

        data_hps = load_hparams(str(CONFIG))
        (tmp / "data").mkdir()
        make_train_set(tmp / "data", data_hps)
        filelist = data_hps.data.training_files
        result = {"step": tp_step(filelist, kernels, smi),
                  "trainer": tp_trainer(filelist, kernels, tmp, smi)}
    out = run_limited([sys.executable, "-m",
                       "personalized_text_to_speech_tpu_torch.parallel.dryrun",
                       "--nproc", "2", "--model", "2", "--device", "cuda",
                       "--full-width"], TP_DRYRUN_LIMIT_S)
    log(out.rstrip())
    result["dryrun"] = json.loads(out.strip().splitlines()[-1])
    result["launches"] = {
        **{f"tp step {k} reference": r["reference_launches"]
           for k, r in result["step"].items()},
        **{f"tp step {k} 2 ranks": sum(r["mas_launches"])
           for k, r in result["step"].items()},
        "tp Trainer 2 ranks": result["trainer"]["launches"],
        "tp dryrun 2 ranks": sum(result["dryrun"]["mas_launches"]),
    }
    if 0 in result["launches"].values():
        raise AssertionError(f"tensor-parallel paths: {result['launches']}")
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"tensor-parallel fine-tuning: {result['phase_s']:.2f} s; MAS "
        "launches " + json.dumps(result["launches"]))
    return result


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

    phase("11 rest of serving at full width: VC, streaming, long-form, "
          "one-call path, bf16, PCM16 batch 64, micro-batcher, HTTP")
    rest = rest_of_serving(kernels)

    phase("12 measurement tools at full width")
    tools = measurement_tools(kernels)

    phase("13 fine-tune and score at full width: formant corpus, preprocess, "
          "Trainer with evaluate(), eval_set, eval_vc, eval_pair, "
          "rearrange_speaker")
    scored = finetune_and_score(kernels)

    phase("14 rest of the train step at full width: spectral-norm D, "
          "accumulation, remat, bench_mem")
    rest_step = rest_of_train_step(
        kernels, {m: r["step_ms"]["median"] for m, r in train_results.items()})

    phase("15 data-parallel fine-tuning at full width: world-size-1 NCCL "
          "Trainer, two gloo ranks on the card, the dry run")
    dp = data_parallel(kernels, train_results["fp32"]["step_ms"]["median"],
                       smi)

    phase("16 tensor-parallel fine-tuning at full width: two gloo ranks on "
          "the card, data 1 x model 2: the step, the Trainer, the dry run")
    tp_run = tensor_parallel(kernels, smi)

    phase("summary")
    by_path = {"serve+forward": serve_launches["mas"],
               **{f"train {m}": r["launches"]["mas"]
                  for m, r in train_results.items()},
               "rest of serving": rest["launches"]["mas"],
               **{label: tools["runs"][label]["launches"]["mas"]
                  for label in ("bench_train float32", "bench_train bfloat16",
                                "profile_ops train float32")},
               "measurement tools, serving": tools["serving_mas"],
               "fine-tune and score": scored["launches"]["mas"],
               **{f"spectral {m}": r["launches"]["mas"]
                  for m, r in rest_step["spectral"].items()},
               **{f"step k={k}": r["mas_launches"]
                  for k, r in rest_step["accum"].items()},
               **{f"bench_mem {dt}": n
                  for dt, n in rest_step["bench_mem"]["launches"].items()},
               **dp["launches"], **tp_run["launches"]}
    log("launches per path " + json.dumps({
        "mas": by_path,
        "train steps": {**{m: r["steps"] for m, r in train_results.items()},
                        "fine-tune": scored["steps"],
                        **{f"spectral {m}": r["steps"]
                           for m, r in rest_step["spectral"].items()},
                        "dp world-1 nccl": dp["world_one"]["steps"],
                        "tp Trainer (per rank)": tp_run["trainer"]["steps"]},
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
