"""Training-throughput benchmark: the fused GAN step's time on synthetic
batches, the port's counterpart of ``tools/bench_train.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench_train

Measures the whole fine-tuning step (spectrogram on the card → generator
forward with MAS → D update → G update) at the reference's shapes (batch
16, a 400-frame bucket ≈ 4.6 s clips), one JSON line per batch size.
``flops_per_step`` is ``FlopCounterMode``'s count over one whole step, the
forward and backward of both networks (matmuls and convolutions; MAS, the
elementwise work and AdamW are not counted), and ``mfu`` that over the step
time and the card's peak for the step's dtype and TF32 state
(``utils/profiling.py``), so a lower bound on the share of the peak.

Environment: ``PTTS_BENCH_BATCH`` (16), ``PTTS_BENCH_FRAMES`` (400),
``PTTS_BENCH_TOKENS`` (128), ``PTTS_BENCH_REPS`` (10 timed steps, after the
counted step and 2 warm-ups), ``PTTS_BENCH_DTYPE`` (bfloat16: the forwards
under bf16 autocast, the config's ``bf16_run``).

Flags:
  --scaling    sweep batch sizes 8/16/32/64, a line each
  --pipeline   also time the port's ``BucketBatcher`` producing batches from
               a corpus directory (``--data_dir``, holding
               ``final_annotation_train.txt``) against the step it feeds
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from personalized_text_to_speech_tpu_torch.tools import common
from personalized_text_to_speech_tpu_torch.utils import profiling

RATES = ("audio_sec_per_wall_sec", "mfu")
WARMUP = 2


def build_step(batch, frames, tokens=128, dtype="bfloat16", seed=0,
               device="cuda", hps=None):
    """The fused GAN train step on a synthetic batch drawn with numpy from
    ``seed``, on ``device``, for ``hps`` (default: the full width).

    Returns ``(step_once, state)``: ``state`` is ``(g_state, d_state,
    batch, generator)`` and ``step_once(state)`` runs one update (the
    states change in place) and returns ``(state, metrics)``.  Shared with
    the per-op profile (``tools/profile_ops.py``)."""
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
        make_train_step,
    )

    hps = copy.deepcopy(hps if hps is not None else common.model_config(False))
    hps.train.bf16_run = dtype == "bfloat16"
    hop = hps.data.hop_length
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = SynthesizerTrn.from_hparams(hps)
        d = MultiPeriodDiscriminator()
    g.to(device).train()
    d.to(device).train()
    g_state = create_train_state(g, hps, 100)
    d_state = create_train_state(d, hps, 100)

    np_rng = np.random.default_rng(seed)
    b = Batch.from_numpy({
        "text": np_rng.integers(1, 60, size=(batch, tokens)),
        "text_lengths": np.full((batch,), tokens),
        "wav": np_rng.normal(size=(batch, frames * hop)) * 0.1,
        "wav_lengths": np.full((batch,), frames * hop),
        "sid": np_rng.integers(0, min(10, hps.data.n_speakers), size=batch),
    }, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 1)
    step = make_train_step(hps)

    def step_once(state):
        g_state, d_state, b, gen = state
        metrics = step(g_state, d_state, b, generator=gen)
        return state, metrics

    return step_once, (g_state, d_state, b, generator)


def step_flops(step_once, state) -> float:
    """``FlopCounterMode``'s count over one whole step (which runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step_once(state)
    return float(counter.get_total_flops())


def _sync(device) -> None:
    if profiling.on_card(device):
        torch.cuda.synchronize()


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench_train")
    ap.add_argument("--scaling", action="store_true",
                    help="sweep batch 8/16/32/64")
    ap.add_argument("--pipeline", action="store_true",
                    help="time the host batcher on a corpus's wavs")
    ap.add_argument("--data_dir", default=None,
                    help="corpus dir for --pipeline (holds "
                         "final_annotation_train.txt)")
    common.add_device_flags(ap)
    args = ap.parse_args(argv)
    info = common.setup(args.device)

    batch = int(os.environ.get("PTTS_BENCH_BATCH", "16"))
    frames = int(os.environ.get("PTTS_BENCH_FRAMES", "400"))
    tokens = int(os.environ.get("PTTS_BENCH_TOKENS", "128"))
    reps = int(os.environ.get("PTTS_BENCH_REPS", "10"))
    dtype = os.environ.get("PTTS_BENCH_DTYPE", "bfloat16")
    batches = [8, 16, 32, 64] if args.scaling else [batch]
    hps = common.model_config(args.tiny)
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    peak = profiling.peak_flops(dtype, any(info["tf32"].values()))

    rows = []
    for bsz in batches:
        step_once, state = build_step(bsz, frames, tokens, dtype, seed=0,
                                      device=args.device, hps=hps)
        flops = step_flops(step_once, state)
        for _ in range(WARMUP):
            state, metrics = step_once(state)
        _sync(args.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, metrics = step_once(state)
        _sync(args.device)
        dt = (time.perf_counter() - t0) / reps
        audio_sec = bsz * frames * hop / sr
        rows.append(common.emit({
            "metric": "train step time (fused GAN update)",
            "value": dt * 1000,
            "unit": "ms/step",
            "vs_baseline": None,
            "audio_sec_per_step": audio_sec,
            "audio_sec_per_wall_sec": audio_sec / dt,
            "batch": bsz,
            "frames": frames,
            "tokens": tokens,
            "steps_run": 1 + WARMUP + reps,
            "flops_per_step": flops,
            "tflops_per_step": flops / 1e12,
            "mfu": flops / dt / peak,
            "peak_tflops": peak / 1e12,
            "loss_g": float(metrics["loss/g/total"]),
        }, info, dtype, RATES))
        del step_once, state, metrics

    if args.pipeline:
        rows.append(common.emit(_pipeline(args.data_dir, hps, batch,
                                          rows[0]["value"]), info, dtype))
    return rows


def _pipeline(data_dir, hps, batch, device_step_ms) -> dict:
    """The port's ``BucketBatcher`` (wav decode, tokenized text, padded
    buckets, a background thread) producing two epochs, per batch, against
    the step time it has to keep up with."""
    anno = os.path.join(data_dir or "", "final_annotation_train.txt")
    if not data_dir or not os.path.exists(anno):
        return {"metric": "host batcher production rate", "value": None,
                "unit": "ms/batch", "vs_baseline": None,
                "error": f"no corpus at {anno}; pass --data_dir"}
    from personalized_text_to_speech_tpu_torch.data.dataset import (
        BucketBatcher,
        DatasetConfig,
        TextAudioSpeakerDataset,
    )

    cwd = os.getcwd()
    os.chdir(data_dir)  # annotations use wav paths relative to the corpus
    try:
        ds = TextAudioSpeakerDataset(anno, DatasetConfig.from_hparams(hps),
                                     hps.symbols, seed=0)
        batcher = BucketBatcher(ds, batch_size=batch, seed=0)
        n = 0
        t0 = time.perf_counter()
        for epoch in range(2):
            batcher.set_epoch(epoch)
            for _ in batcher.iter_prefetch():
                n += 1
        host_ms = (time.perf_counter() - t0) / max(n, 1) * 1000
    finally:
        os.chdir(cwd)
    return {
        "metric": "host batcher production rate (real wav decode)",
        "value": host_ms,
        "unit": "ms/batch",
        "vs_baseline": None,
        "batches_measured": n,
        "device_step_ms": device_step_ms,
        "producer_occupancy": host_ms / device_step_ms,
        "keeps_up": host_ms < device_step_ms,
    }


if __name__ == "__main__":
    main()
