"""Per-op profile: which ATen ops and CUDA kernels take the card's time, and
how close each op comes to the card's peak; the port's counterpart of
``tools/profile_ops.py``.

    M=personalized_text_to_speech_tpu_torch.tools.profile_ops
    python -m $M                   # train step, batch 64
    python -m $M --stage decode    # serving decode stage
    python -m $M --stage encode    # serving encode stage
    python -m $M --json ops.json   # every row to a file
    python -m $M --trace_dir <dir> # keep the trace there
    python -m $M --logdir <dir>    # re-read a trace it wrote

The stage runs twice to warm up, then ``torch.profiler`` records 3
repetitions with ``record_shapes=True`` (``utils/profiling.py::trace``) and
writes a Chrome trace.  The rows are read back from that trace, so a capture
and ``--logdir`` give the same tables:

* one row per ATen op and input shapes, the op being the outermost ATen
  call around the launch (``aten::conv1d``, ``aten::convolution_backward``,
  ``aten::linear``...), with its calls, host time, the device time of every
  kernel and copy it launched, its FLOPs and the achieved TFLOP/s and share
  of the peak for its dtype.  A kernel launched outside any ATen op (MAS,
  through ``ctypes``) is a row of its own, named by the kernel.  FLOPs come
  from the trace's input shapes by ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions forward and backward); the profiler's own ``with_flops``
  counts neither 1-d convolutions nor their backward and leaves no count in
  the Chrome trace;
* one row per CUDA kernel name, with the op rows that launched it: the
  convolution shapes behind cuDNN's ``dgrad``/``wgrad`` kernels, and the
  layers of the model that have those weight shapes (written beside the
  trace as ``profile_ops.json``).

The summary gives the device time per repetition by class (convolution,
GEMM, elementwise, copy/transpose, MAS) and the top ops.  On the CPU
(``--device cpu``) the trace has no device activity: every device time,
rate and share is ``None``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from itertools import zip_longest
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import flop_counter

from personalized_text_to_speech_tpu_torch.tools import common
from personalized_text_to_speech_tpu_torch.utils import profiling

META_FILE = "profile_ops.json"
REPS = 3
RATES = ("tflops_per_s", "peak_share", "device_ms_per_rep", "by_class_ms_per_rep")
CLASSES = ("convolution", "GEMM", "elementwise", "copy/transpose", "MAS")
_GEMM = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
         "aten::matmul", "aten::linear", "aten::einsum")
_COPY = ("aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
         "aten::contiguous", "aten::cat", "aten::stack", "aten::constant_pad_nd",
         "aten::pad", "aten::reflection_pad1d", "aten::index_select",
         "aten::gather", "aten::transpose", "aten::permute", "aten::item",
         "aten::_local_scalar_dense")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DTYPES = {"float": "float32", "c10::BFloat16": "bfloat16",
           "c10::Half": "float16"}


# --------------------------------------------------------------------------
# FLOPs from an op's input shapes, by FlopCounterMode's own formulas
# --------------------------------------------------------------------------

_FORMULAS = {
    "aten::mm": flop_counter.mm_flop,
    "aten::addmm": flop_counter.addmm_flop,
    "aten::bmm": flop_counter.bmm_flop,
    "aten::baddbmm": flop_counter.baddbmm_flop,
    "aten::convolution": flop_counter.conv_flop,
    "aten::_convolution": flop_counter.conv_flop,
    "aten::convolution_backward": flop_counter.conv_backward_flop,
}


def _literal(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def op_flops(name: str, dims, concrete) -> int:
    """FLOPs of one call of a matmul or convolution op from the trace's
    ``Input Dims`` and ``Concrete Inputs``, by ``torch.utils.flop_counter``'s
    formula for the op; 0 for any other op."""
    formula = _FORMULAS.get(name)
    if formula is None:
        return 0
    if "conv" not in name:  # the matrices (after addmm's and baddbmm's bias)
        return formula(*dims[:3 if name in ("aten::addmm", "aten::baddbmm") else 2])
    args = [_literal(c) if c else d
            for c, d in zip_longest(concrete, dims, fillvalue="")]
    if name == "aten::convolution_backward":
        # the input's and the weight's gradients take their shapes
        return formula(*args, out_val=(args[1], args[2], None))
    x, w, _, stride, pad, dil = args[:6]  # a transposed one counts from x
    out = [x[0], w[0]] + [(n + 2 * p - d * (k - 1) - 1) // s + 1
                          for n, k, s, p, d in zip(x[2:], w[2:], stride, pad, dil)]
    return formula(*args, out_val=out)


# --------------------------------------------------------------------------
# the trace → op rows and kernel rows
# --------------------------------------------------------------------------

def op_class(op: str) -> str:
    if "mas_kernel" in op:  # csrc/mas.cu's kernel, by its (mangled) name
        return "MAS"
    if "conv" in op:
        return "convolution"
    if op in _GEMM:
        return "GEMM"
    if op in _COPY or op.startswith(("Memcpy", "Memset")):
        return "copy/transpose"
    return "elementwise"


def _weight_dims(op: str, dims):
    if "conv" not in op or len(dims) < 2:
        return None
    return dims[2] if op == "aten::convolution_backward" else dims[1]


def load_trace(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def trace_rows(events: List[dict], tf32: bool,
               layers: Optional[Dict[str, List[str]]] = None
               ) -> Tuple[List[dict], List[dict]]:
    """Op rows and kernel rows of a Chrome trace (see the module's
    docstring); ``layers`` maps a weight shape to the model's modules that
    have it."""
    layers = layers or {}
    by_tid = defaultdict(list)
    launch_at = {}  # correlation id → (tid, ts)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cpu_op":
            by_tid[e["tid"]].append(e)
        elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat in _DEVICE_CATS:
            device.append(e)
    on_card = bool(device)

    rows: Dict[Tuple, dict] = {}

    def row_of(name, dims):
        key = (name, json.dumps(dims))
        if key not in rows:
            w = _weight_dims(name, dims)
            rows[key] = {"operation": name, "input_shapes": dims,
                         "category": op_class(name), "dtype": None,
                         "layers": layers.get(json.dumps(w), []) if w else [],
                         "occurrences": 0, "host_time_us": 0.0,
                         "device_time_us": 0.0 if on_card else None,
                         "flops": 0}
        return rows[key]

    # each thread's ops nest by time: sweep them in start order with a stack
    # of open ops; an op's row is its outermost ATen ancestor's (or its own)
    spans = {}  # tid → (starts, ends, row keys) of its outermost ATen ops
    for tid, ops in by_tid.items():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack, starts, ends, keys = [], [], [], []
        for e in ops:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
                stack.pop()
            args = e.get("args", {})
            dims = args.get("Input Dims", [])
            outer = next((s for s in stack if s[1] is not None), None)
            counted = any(s[2] for s in stack)
            if outer is None and e["name"].startswith("aten::"):
                r = row_of(e["name"], dims)
                r["occurrences"] += 1
                r["host_time_us"] += e["dur"]
                starts.append(e["ts"])
                ends.append(e["ts"] + e["dur"])
                keys.append((r["operation"], json.dumps(dims)))
                outer = (e, r)
            flop_op = e["name"] in _FORMULAS and not counted
            if flop_op and outer is not None:
                # the dtype the product ran in: autocast casts inside the
                # outermost op, so it is the flop op's own
                outer[1]["flops"] += op_flops(e["name"], dims,
                                              args.get("Concrete Inputs", []))
                outer[1]["dtype"] = next((_DTYPES[t] for t in args.get(
                    "Input type", ()) if t in _DTYPES), None)
            stack.append((e, outer[1] if outer else None, flop_op or counted))
        spans[tid] = (starts, ends, keys)

    kernels: Dict[str, dict] = {}
    for k in device:
        name = k["name"]
        row = None
        where = launch_at.get(k.get("args", {}).get("correlation"))
        if where is not None and where[0] in spans:
            starts, ends, keys = spans[where[0]]
            i = bisect_right(starts, where[1]) - 1
            if i >= 0 and ends[i] >= where[1]:
                row = rows[keys[i]]
        if row is None:  # launched outside every ATen op (MAS via ctypes)
            row = row_of(name, [])
            row["occurrences"] += 1
        row["device_time_us"] += k["dur"]
        kr = kernels.setdefault(name, {"kernel": name, "calls": 0,
                                       "device_time_us": 0.0,
                                       "category": row["category"], "ops": {}})
        kr["calls"] += 1
        kr["device_time_us"] += k["dur"]
        op_key = (row["operation"], json.dumps(row["input_shapes"]))
        kr["ops"][op_key] = kr["ops"].get(op_key, 0.0) + k["dur"]

    op_rows = list(rows.values())
    for r in op_rows:
        t = r["device_time_us"]
        rate = r["flops"] / t / 1e6 if t and r["flops"] else None
        r["tflops_per_s"] = rate
        r["peak_share"] = (rate * 1e12 / profiling.peak_flops(r["dtype"], tf32)
                           if rate is not None and r["dtype"] else None)
    op_rows.sort(key=lambda r: -(r["device_time_us"] or r["host_time_us"]))
    kernel_rows = sorted(kernels.values(), key=lambda r: -r["device_time_us"])
    for kr in kernel_rows:
        ops = sorted(kr["ops"].items(), key=lambda kv: -kv[1])
        kr["ops"] = [{"operation": op, "input_shapes": json.loads(dims),
                      "layers": rows[(op, dims)]["layers"], "device_time_us": us}
                     for (op, dims), us in ops]
    return op_rows, kernel_rows


def summarize(rows: List[dict], reps: int, top: int) -> dict:
    """Print the device time per repetition by class and the ``top`` ops;
    return the same as a dict (times in ms per repetition)."""
    times = [r["device_time_us"] or 0.0 for r in rows]
    total = sum(times)
    by_class = {c: 0.0 for c in CLASSES}
    for r, t in zip(rows, times):
        by_class[r["category"]] += t
    print(f"device time {total / reps / 1e3:.3f} ms per repetition across "
          f"{len(rows)} op rows ({reps} repetitions traced)")
    print("\ndevice time by class:")
    for c, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:15s} {t / reps / 1e3:9.3f} ms "
              f"({100 * t / total if total else 0.0:5.1f}%)")
    ranked = sorted(zip(rows, times), key=lambda rt: -rt[1])[:top]
    hdr = (f"\n{'operation':32s} {'input shapes':40s} {'ms/rep':>8s} "
           f"{'%':>5s} {'TFLOP/s':>8s} {'peak%':>6s} {'n':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for r, t in ranked:
        rate, share = r["tflops_per_s"], r["peak_share"]
        print(f"{r['operation'][:32]:32s} {json.dumps(r['input_shapes'])[:40]:40s} "
              f"{t / reps / 1e3:8.3f} {100 * t / total if total else 0.0:5.1f} "
              f"{'-' if rate is None else f'{rate:.2f}':>8s} "
              f"{'-' if share is None else f'{100 * share:.1f}':>6s} "
              f"{r['occurrences'] // reps:5d}")
    return {"device_ms_per_rep": total / reps / 1e3,
            "by_class_ms_per_rep": {c: t / reps / 1e3 for c, t in by_class.items()},
            "top": [r for r, _ in ranked]}


# --------------------------------------------------------------------------
# capture
# --------------------------------------------------------------------------

def _layers(*modules) -> Dict[str, List[str]]:
    """Weight shape → the names of the convolutions that have it."""
    out = defaultdict(list)
    for prefix, module in zip(("G", "D"), modules):
        for name, m in module.named_modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                              torch.nn.ConvTranspose1d)):
                w = getattr(m, "weight_v", None)
                w = m.weight if w is None else w
                out[json.dumps(list(w.shape))].append(f"{prefix}.{name}")
    return dict(out)


def _capture(args, hps, logdir: str) -> Dict[str, List[str]]:
    """Warm the stage up, trace ``REPS`` repetitions into ``logdir``, and
    return the model's layers by weight shape."""
    if args.stage == "train":
        from personalized_text_to_speech_tpu_torch.tools.bench_train import (
            build_step,
        )

        step_once, state = build_step(args.batch, args.frames,
                                      dtype=args.dtype, device=args.device,
                                      hps=hps)
        layers = _layers(state[0].module, state[1].module)

        def run():
            step_once(state)
    else:
        from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

        eng = TTSEngine(hps, device=args.device, dtype=args.dtype)
        encode, decode, _, _ = eng.stage_calls(args.batch)
        run = encode if args.stage == "encode" else decode
        layers = _layers(eng.model)
    for _ in range(2):
        run()
    with profiling.trace(logdir, record_shapes=True):
        for _ in range(REPS):
            run()
    return layers


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.profile_ops")
    ap.add_argument("--stage", choices=["train", "decode", "encode"],
                    default="train")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=400,
                    help="train-step segment frames")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", default=None, help="write all rows here")
    ap.add_argument("--logdir", default=None,
                    help="read a trace this tool wrote before instead of "
                         "capturing one")
    ap.add_argument("--reps", type=int, default=None,
                    help="repetitions in the trace read with --logdir")
    ap.add_argument("--trace_dir", default=None,
                    help="write the captured trace here (default: a fresh "
                         "temporary directory, whose path is printed)")
    common.add_device_flags(ap)
    args = ap.parse_args(argv)

    if args.logdir is None:
        info = common.setup(args.device)
        logdir = args.trace_dir or tempfile.mkdtemp(prefix="ptts_prof_")
        layers = _capture(args, common.model_config(args.tiny), logdir)
        meta = {"stage": args.stage, "reps": REPS, "dtype": args.dtype,
                "device": info, "layers": layers}
        with open(os.path.join(logdir, META_FILE), "w", encoding="utf-8") as f:
            json.dump(meta, f)
        print(f"trace captured → {logdir}")
    else:
        logdir = args.logdir
        with open(os.path.join(logdir, META_FILE), encoding="utf-8") as f:
            meta = json.load(f)
        info = meta["device"]
    reps = args.reps or meta["reps"]
    tf32 = any(info["tf32"].values())
    rows, kernel_rows = trace_rows(
        load_trace(os.path.join(logdir, profiling.TRACE_FILE)), tf32,
        meta["layers"])
    summary = summarize(rows, reps, args.top)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"stage": meta["stage"], "reps": reps, "ops": rows,
                       "kernels": kernel_rows}, f, indent=1)
        print(f"\nfull rows → {args.json}")
    print()
    return [common.emit({
        "metric": "per-op device time (torch.profiler)",
        "stage": meta["stage"],
        "reps": reps,
        "trace": logdir,
        "device_ms_per_rep": summary["device_ms_per_rep"],
        "by_class_ms_per_rep": summary["by_class_ms_per_rep"],
        "flops_per_rep": sum(r["flops"] for r in rows) / reps,
        "top_ops": summary["top"],
        "top_kernels": kernel_rows[:args.top],
        "conv_backward_kernels": [k for k in kernel_rows
                                  if "dgrad" in k["kernel"] or "wgrad" in k["kernel"]],
    }, info, meta["dtype"], RATES)]


if __name__ == "__main__":
    main()
