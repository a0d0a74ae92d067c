"""The port's measurement tools on the CPU (``--device cpu --tiny``, the
smallest settings): ``bench``, ``bench_cost``, ``bench_serve``,
``bench_stream``, ``bench_train`` and ``profile_ops``.

Each tool's lines parse as JSON, carry the JAX tool's field names plus
``device``, ``dtype`` and ``tf32``, and hold ``None`` in every rate and every
share of a peak: a CPU run gives no device figure.  Without a card, each
tool's default device raises.  The cases of ``tests/test_batching.py`` for
``parse_client_specs`` and of ``tests/test_profile_ops.py`` for
``summarize`` run on the port's copies; ``profile_ops``'s FLOPs, read from a
trace's input shapes, equal ``FlopCounterMode``'s count of the same stage.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.tools import (
    bench,
    bench_cost,
    bench_serve,
    bench_stream,
    bench_train,
    profile_ops,
)
from personalized_text_to_speech_tpu_torch.tools.bench_serve import (
    parse_client_specs,
)
from personalized_text_to_speech_tpu_torch.tools.profile_ops import summarize

CPU = ["--device", "cpu", "--tiny"]
STAMP = ("device", "dtype", "tf32")


def run_tool(capsys, tool, argv):
    """``tool.main(argv)``: its rows, each printed as one JSON line."""
    rows = tool.main(argv)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == json.loads(json.dumps(rows))
    for row in rows:
        assert set(STAMP) <= set(row)
        assert row["device"]["platform"] == "cpu"
        assert row["device"]["power_limit"] is None
    return rows


def check(row, fields, rates):
    assert set(fields) <= set(row), set(fields) - set(row)
    for path in rates:
        value = row
        for key in path.split("."):
            value = value[key]
        assert value is None, path


# --------------------------------------------------------------------------
# the cases of tests/test_batching.py and tests/test_profile_ops.py
# --------------------------------------------------------------------------

class TestParseClientSpecs:
    def test_single_point_default_queue(self):
        assert parse_client_specs("8", 64) == [(8, 64)]

    def test_sweep_with_per_point_queue(self):
        assert parse_client_specs("1,8,16,64/16", 64) == [
            (1, 64), (8, 64), (16, 64), (64, 16),
        ]

    def test_whitespace_and_empty_segments_tolerated(self):
        assert parse_client_specs(" 4 , , 32/8 ", 64) == [(4, 64), (32, 8)]

    def test_empty_spec_rejected(self):
        with pytest.raises(ValueError):
            parse_client_specs(" , ", 64)


def _row(op, cls, us, flops=0, rate=None, share=None, n=3):
    return {"operation": op, "input_shapes": [[1]], "category": cls,
            "device_time_us": us, "flops": flops, "tflops_per_s": rate,
            "peak_share": share, "occurrences": n}


def test_summarize_classes_add_up_to_the_total(capsys):
    rows = [
        _row("aten::conv1d", "convolution", 3000.0, 6e9, 2.0, 0.03),
        _row("aten::convolution_backward", "convolution", 1000.0),
        _row("aten::copy_", "copy/transpose", 2000.0),
        _row("mas_kernel", "MAS", 500.0),
        _row("aten::linear", "GEMM", 250.0),
        _row("aten::add", "elementwise", 250.0),
    ]
    got = summarize(rows, reps=2, top=2)
    out = capsys.readouterr().out
    # 7000 us over 2 repetitions
    assert got["device_ms_per_rep"] == pytest.approx(3.5)
    assert "3.500 ms per repetition" in out
    assert sum(got["by_class_ms_per_rep"].values()) == pytest.approx(3.5)
    assert got["by_class_ms_per_rep"]["convolution"] == pytest.approx(2.0)
    assert got["by_class_ms_per_rep"]["MAS"] == pytest.approx(0.25)
    # the top 2, largest first; the third is left out
    assert [r["operation"] for r in got["top"]] == ["aten::conv1d", "aten::copy_"]
    table = out.split("-" * 20)[-1]
    assert table.index("aten::conv1d") < table.index("aten::copy_")
    assert "convolution_backward" not in table


def test_summarize_without_device_time(capsys):
    """A CPU trace has no device time: every row's is ``None``."""
    got = summarize([_row("aten::conv1d", "convolution", None)], reps=3, top=5)
    assert got["device_ms_per_rep"] == 0.0


def test_op_flops_follow_flop_counter_formulas():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(2, 8, 40, requires_grad=True)
    for conv in (torch.nn.Conv1d(8, 16, 5, stride=2, padding=3, dilation=2),
                 torch.nn.Conv1d(8, 16, 3, groups=4),
                 torch.nn.ConvTranspose1d(8, 4, 16, stride=8, padding=4)):
        with FlopCounterMode(display=False) as counter:
            conv(x).sum().backward()
        want = counter.get_flop_counts()["Global"]
        w = list(conv.weight.shape)
        stride, pad, dil = conv.stride, conv.padding, conv.dilation
        transposed = isinstance(conv, torch.nn.ConvTranspose1d)
        # the trace's Concrete Inputs: convolution(input, weight, bias,
        # stride, padding, dilation, transposed, output_padding, groups) and
        # convolution_backward(grad_output, input, weight, bias_sizes,
        # stride, padding, dilation, transposed, output_padding, groups,
        # output_mask)
        args = [str(list(stride)), str(list(pad)), str(list(dil)),
                str(transposed), "[0]", str(conv.groups)]
        fwd = profile_ops.op_flops("aten::convolution", [list(x.shape), w],
                                   ["", "", ""] + args)
        assert fwd == want[torch.ops.aten.convolution]
        out = list(conv(x).shape)
        bwd = profile_ops.op_flops("aten::convolution_backward",
                                   [out, list(x.shape), w],
                                   ["", "", "", "[16]"] + args
                                   + ["[True, True, True]"])
        assert bwd == want[torch.ops.aten.convolution_backward]
    assert profile_ops.op_flops("aten::addmm", [[4], [3, 5], [5, 4]], []) == 120
    assert profile_ops.op_flops("aten::bmm", [[2, 3, 5], [2, 5, 4]], []) == 240
    assert profile_ops.op_flops("aten::add", [[3], [3]], []) == 0


# --------------------------------------------------------------------------
# each tool's main on the CPU
# --------------------------------------------------------------------------

def test_bench(capsys, monkeypatch):
    for k, v in dict(PTTS_BENCH_BATCH="2", PTTS_BENCH_REPS="1",
                     PTTS_BENCH_TRIALS="2", PTTS_BENCH_DTYPE="float32").items():
        monkeypatch.setenv(k, v)
    rows = run_tool(capsys, bench, CPU)
    assert [r.get("provisional") for r in rows] == [True, None]
    check(rows[-1], ("metric", "value", "unit", "vs_baseline", "batch", "dtype",
                     "best", "trial_rtfs", "device", "p50_latency_ms"),
          ("value", "vs_baseline", "best", "trial_rtfs"))
    assert rows[-1]["dtype"] == "float32" and rows[-1]["batch"] == 2
    assert rows[-1]["p50_latency_ms"] > 0


def test_bench_cost(capsys):
    rows = run_tool(capsys, bench_cost,
                    CPU + ["--batch", "2", "--reps", "1", "--dtype", "float32"])
    stage = ("ms", "gflops", "tflops_per_s", "mfu_pct", "gbytes", "gbps",
             "hbm_util_pct")
    rates = ("tflops_per_s", "mfu_pct", "gbps", "hbm_util_pct")
    check(rows[0], ("metric", "batch", "text_bucket", "frame_bucket", "encode",
                    "decode", "compute_only_x_realtime", "dtype", "device"),
          ["compute_only_x_realtime"] + [f"{s}.{r}" for s in ("encode", "decode")
                                         for r in rates])
    want = TTSEngine(tiny_model_config(), device="cpu").cost_analysis(2)
    for s in ("encode", "decode"):
        check(rows[0][s], stage, ())
        assert rows[0][s]["gflops"] == want[s]["flops"] / 1e9
        assert rows[0][s]["gbytes"] == want[s]["bytes_min"] / 1e9
        assert rows[0][s]["ms"] > 0


SERVE_FIELDS = ("metric", "clients", "requests", "wall_s", "requests_per_s",
                "audio_s_per_wall_s", "latency_p50_ms", "latency_p95_ms",
                "latency_p99_ms", "shed", "shed_rate", "max_queue",
                "dispatches", "mean_batch", "max_batch_seen", "window_ms",
                "dtype", "engine")


def test_bench_serve(capsys):
    rows = run_tool(capsys, bench_serve,
                    CPU + ["--clients", "1,3/2", "--duration", "0.5",
                           "--max_batch", "2", "--dtype", "float32"])
    assert [(r["clients"], r["max_queue"]) for r in rows] == [(1, 64), (3, 2)]
    for r in rows:
        check(r, SERVE_FIELDS, ("requests_per_s", "audio_s_per_wall_s"))
        assert r["requests"] > 0 and r["dispatches"] > 0
        assert r["max_batch_seen"] <= 2 and r["warmup_s"] > 0
        assert r["engine"] == "tiny-behavioral"


def test_bench_serve_compare(capsys):
    rows = run_tool(capsys, bench_serve,
                    CPU + ["--compare", "--duration", "1", "--max_batch", "1"])
    check(rows[0], ("metric", "pairs", "direct_p50_ms", "batched_p50_ms",
                    "overhead_ms", "direct_p95_ms", "batched_p95_ms",
                    "window_ms", "dtype", "engine"), ())
    assert rows[0]["pairs"] >= 1 and rows[0]["dtype"] == "bfloat16"


def test_bench_stream(capsys):
    rows = run_tool(capsys, bench_stream,
                    CPU + ["--reps", "1", "--chunk_frames", "16",
                           "--halo_frames", "8"])
    check(rows[0], ("metric", "value", "unit", "monolithic_p50_ms",
                    "stream_total_p50_ms", "chunk_p50_ms", "chunk_audio_ms",
                    "realtime_margin", "sentence_audio_s", "chunk_frames",
                    "halo_frames", "device"), ("realtime_margin",))
    assert rows[0]["value"] <= rows[0]["stream_total_p50_ms"]
    assert rows[0]["sentence_audio_s"] > 0


def _corpus(tmp_path):
    """Four short wavs and the annotation file ``--pipeline`` reads."""
    sr, lines = 8000, []
    for i in range(4):
        t = np.arange(int(0.6 * sr)) / sr
        save_wav(str(tmp_path / f"w{i}.wav"), 0.3 * np.sin(2 * np.pi * 200 * t), sr)
        lines.append(f"w{i}.wav|{i % 2}|ab ko→ no↓ da to mi.")
    (tmp_path / "final_annotation_train.txt").write_text("\n".join(lines),
                                                          encoding="utf-8")


def test_bench_train(capsys, monkeypatch, tmp_path):
    for k, v in dict(PTTS_BENCH_BATCH="2", PTTS_BENCH_FRAMES="64",
                     PTTS_BENCH_TOKENS="16", PTTS_BENCH_REPS="1").items():
        monkeypatch.setenv(k, v)
    _corpus(tmp_path)
    rows = run_tool(capsys, bench_train,
                    CPU + ["--pipeline", "--data_dir", str(tmp_path)])
    check(rows[0], ("metric", "value", "unit", "vs_baseline",
                    "audio_sec_per_step", "audio_sec_per_wall_sec", "batch",
                    "frames", "dtype", "tflops_per_step", "mfu", "loss_g",
                    "device"), ("audio_sec_per_wall_sec", "mfu"))
    assert rows[0]["steps_run"] == 4 and np.isfinite(rows[0]["loss_g"])
    assert rows[0]["flops_per_step"] > 0
    check(rows[1], ("metric", "value", "unit", "batches_measured",
                    "device_step_ms", "producer_occupancy", "keeps_up"), ())
    assert rows[1]["batches_measured"] > 0


def test_bench_train_counts_both_passes():
    """The step's count covers the forward and backward of both networks,
    and does not depend on the dtype (the same shapes)."""
    hps = tiny_model_config()
    counts = {}
    for dtype in ("float32", "bfloat16"):
        step_once, state = bench_train.build_step(1, 32, 8, dtype,
                                                  device="cpu", hps=hps)
        counts[dtype] = bench_train.step_flops(step_once, state)
    assert counts["float32"] == counts["bfloat16"] > 0


def test_profile_ops_decode_and_reread(capsys, tmp_path):
    rows = run_tool(capsys, profile_ops,
                    CPU + ["--stage", "decode", "--batch", "2", "--top", "3",
                           "--json", str(tmp_path / "ops.json"),
                           "--trace_dir", str(tmp_path / "trace")])
    row = rows[0]
    assert row["trace"] == str(tmp_path / "trace")
    check(row, ("metric", "stage", "reps", "top_ops", "top_kernels"),
          ("device_ms_per_rep", "by_class_ms_per_rep"))
    assert row["stage"] == "decode" and row["reps"] == 3
    for op in row["top_ops"]:
        assert {"operation", "category", "occurrences"} <= set(op)
        assert op["device_time_us"] is None
        assert op["tflops_per_s"] is None and op["peak_share"] is None
    assert row["top_kernels"] == []  # no device activity on the CPU
    # the FLOPs read from the trace's shapes equal FlopCounterMode's count
    want = TTSEngine(tiny_model_config(), device="cpu",
                     dtype="bfloat16").cost_analysis(2)
    assert row["flops_per_rep"] == want["decode"]["flops"]
    conv = [r for r in json.load(open(tmp_path / "ops.json"))["ops"]
            if r["operation"] == "aten::conv_transpose1d"]
    assert conv and all(r["layers"] for r in conv)  # named by weight shape
    again = run_tool(capsys, profile_ops, ["--logdir", row["trace"]])
    assert again[0]["flops_per_rep"] == row["flops_per_rep"]
    assert again[0]["top_ops"][:3] == row["top_ops"]


@pytest.mark.parametrize("name", ["bench", "bench_cost", "bench_serve",
                                  "bench_stream", "bench_train", "profile_ops"])
def test_default_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(
        f"personalized_text_to_speech_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
