"""Serving roofline: each serving stage timed alone on the card and set
against the work it does, the port's counterpart of ``tools/bench_cost.py``.

    python -m personalized_text_to_speech_tpu_torch.tools.bench_cost

The encode (text → durations, attention and the duration predictor's
splines) and the decode (flow reverse + HiFi-GAN, convolutions) run on a
dummy batch (``TTSEngine.stage_calls``), each timed by CUDA events over
``--reps`` calls queued after two warm-ups, and divided into
``TTSEngine.cost_analysis``: achieved TFLOP/s and its share of the peak
(``mfu_pct``), bytes moved at least and their share of HBM's rate
(``hbm_util_pct``).  The FLOPs count matmuls and convolutions only, and the
bytes each input once and each output once, so both shares are lower bounds.
Peaks default to the H100's data sheet for the run's dtype and TF32 state
(``utils/profiling.py``); ``--peak_tflops``/``--peak_gbps`` override them.
On the CPU (``--device cpu``) the stages are timed on the host clock and
every rate and share is ``None``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from personalized_text_to_speech_tpu_torch.tools import common
from personalized_text_to_speech_tpu_torch.utils import profiling

RATES = ("tflops_per_s", "mfu_pct", "gbps", "hbm_util_pct",
         "compute_only_x_realtime")


def time_stage(fn, reps: int, device) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls after two warm-ups:
    CUDA events on the card, the host clock on the CPU.  ``fn`` waits for
    nothing, so the calls queue one behind the other and the events read
    the card's time, plus any gap where the host issues more slowly than
    the card runs."""
    fn()
    fn()
    if not profiling.on_card(device):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.bench_cost")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="default: the H100's peak for --dtype and TF32")
    ap.add_argument("--peak_gbps", type=float, default=None,
                    help="default: the H100's HBM rate, 3350 GB/s")
    common.add_device_flags(ap)
    args = ap.parse_args(argv)
    info = common.setup(args.device)

    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    hps = common.model_config(args.tiny)
    eng = TTSEngine(hps, device=args.device, dtype=args.dtype)
    peak_flops = (args.peak_tflops * 1e12 if args.peak_tflops else
                  profiling.peak_flops(args.dtype, any(info["tf32"].values())))
    peak_bps = (args.peak_gbps * 1e9 if args.peak_gbps else
                profiling.PEAK_HBM_BYTES_PER_S)

    b = args.batch
    cost = eng.cost_analysis(b)
    encode, decode, t_bucket, f_bucket = eng.stage_calls(
        b, f_bucket=int(cost["buckets"]["frames"]))
    t_enc = time_stage(encode, args.reps, args.device)
    t_dec = time_stage(decode, args.reps, args.device)

    def roofline(stats, secs):
        fl, by = stats["flops"], stats["bytes_min"]
        return {
            "ms": secs * 1000,
            "gflops": fl / 1e9,
            "tflops_per_s": fl / secs / 1e12,
            "mfu_pct": fl / secs / peak_flops * 100,
            "gbytes": by / 1e9,
            "gbps": by / secs / 1e9,
            "hbm_util_pct": by / secs / peak_bps * 100,
            "temp_gbytes": (None if stats["temp_size_bytes"] is None
                            else stats["temp_size_bytes"] / 1e9),
        }

    audio_s = b * f_bucket * eng.hop_length / eng.sampling_rate
    row = {
        "metric": "serving roofline (per-stage device time vs counted work)",
        "batch": b,
        "text_bucket": t_bucket,
        "frame_bucket": f_bucket,
        "encode": roofline(cost["encode"], t_enc),
        "decode": roofline(cost["decode"], t_dec),
        "compute_only_x_realtime": audio_s / (t_enc + t_dec),
        "peak_tflops": peak_flops / 1e12,
        "peak_gbps": peak_bps / 1e9,
    }
    return [common.emit(row, info, args.dtype, RATES)]


if __name__ == "__main__":
    main()
