"""Tracing and profiling hooks.

Counterpart of ``personalized_text_to_speech_tpu/utils/profiling.py``: a
``torch.profiler`` trace around any code region, a per-step timer with EMA
reporting, the work of one call counted from what it runs (FLOPs and bytes,
in place of XLA's cost analysis), the git-hash guard of a run directory, and
what the tools write beside every number: the device, its power limit, the
TF32 state and the card's peak rates.

No device figure comes from a CPU run: a tool that runs on the CPU reports
every rate and every share of a peak as ``None`` (:func:`on_card`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import platform
import subprocess
import time
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

# the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, **profile_kwargs) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write a Chrome trace into
    ``log_dir`` (:data:`TRACE_FILE`, replaced if there is one):

        with profiling.trace("runs/trace") as prof:
            step(...)
        prof.key_averages()

    Records the host, and the card where there is one (the region is
    synchronised before the profiler stops, so its kernels are in).
    ``profile_kwargs`` go to ``torch.profiler.profile`` (``record_shapes``
    and the like)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, **profile_kwargs) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Wall-clock step timing with warmup skip and EMA smoothing."""

    def __init__(self, warmup: int = 2, ema: float = 0.9):
        self.warmup = warmup
        self.ema = ema
        self.count = 0
        self.value: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[float]:
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.value = dt if self.value is None else (
                self.ema * self.value + (1 - self.ema) * dt
            )
        return dt

    @property
    def steps_per_sec(self) -> Optional[float]:
        return None if not self.value else 1.0 / self.value


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """A key for the memory a tensor views, and the bytes it views there."""
    nbytes = min(t.numel() * t.element_size(), t.untyped_storage().nbytes())
    if nbytes == 0:
        return None, 0
    return (t.device, t.untyped_storage().data_ptr()), nbytes


class _Reads(TorchDispatchMode):
    """Every tensor an op reads that no op of the region made: the region's
    arguments, its parameters included, by the memory they live in."""

    def __init__(self):
        super().__init__()
        self.made = set()
        self.read: Dict[Any, int] = {}
        self.on_card = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            self.on_card = self.on_card or t.is_cuda
            key, nbytes = _storage(t)
            if key is not None and key not in self.made:
                self.read[key] = max(self.read.get(key, 0), nbytes)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            key, _ = _storage(t)
            if key is not None and key not in self.read:
                self.made.add(key)
        return out


def cost_stats(fn, *args, **kwargs) -> Dict[str, Optional[float]]:
    """The work of one call ``fn(*args, **kwargs)``, counted from what it
    runs (the port's stand-in for XLA's ``compiled_stats``):

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, which
      covers matmuls and convolutions (forward and backward) only.
      Elementwise work, reductions and the MAS kernel are not counted, so
      this is a lower bound on the work and lies below XLA's ``flops``
      where elementwise work weighs (the attention softmax, the splines).
    * ``argument_size_bytes``: the bytes of the parameters and inputs the
      call reads, from their shapes and dtypes.
    * ``bytes_min``: each input byte read once plus each output byte
      written once, the least traffic a roofline counts.  It is not XLA's
      ``bytes accessed``, which counts every intermediate's traffic too.
    * ``temp_size_bytes``: on the card, the peak of
      ``torch.cuda.max_memory_allocated()`` during the call beyond what was
      allocated before it (the arguments and all else alive); ``None`` on
      the CPU.

    The call runs once, for real, on the device its tensors are on; ``fn``
    may be a closure over them."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    reads = _Reads()
    with FlopCounterMode(display=False) as counter, reads:
        out = fn(*args, **kwargs)
    temp = None
    if reads.on_card:
        torch.cuda.synchronize()
        temp = float(torch.cuda.max_memory_allocated() - before)
    arg_bytes = float(sum(reads.read.values()))
    out_bytes = float(sum(_storage(t)[1] for t in _tensors(out)))
    return {
        "flops": float(counter.get_total_flops()),
        "argument_size_bytes": arg_bytes,
        "bytes_min": arg_bytes + out_bytes,
        "temp_size_bytes": temp,
    }


def check_git_hash(model_dir: str) -> Optional[str]:
    """Record/compare the repo commit hash in the run dir (reference
    ``utils.py:370-387`` provenance guard)."""
    source_dir = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    if not os.path.exists(os.path.join(source_dir, ".git")):
        return None
    try:
        cur = subprocess.run(
            ["git", "-C", source_dir, "rev-parse", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur:
            logging.getLogger(__name__).warning(
                "git hash mismatch: %s (saved) != %s (current)",
                saved[:8], cur[:8],
            )
    else:
        with open(path, "w") as f:
            f.write(cur)
    return cur


# --------------------------------------------------------------------------
# what every measurement carries: the device, its power limit, TF32, peaks
# --------------------------------------------------------------------------

def on_card(device) -> bool:
    """Whether numbers taken on ``device`` are device figures."""
    return torch.device(device).type == "cuda"


def tf32_state() -> Dict[str, bool]:
    """Whether cuDNN's convolutions and cuBLAS's matmuls may use TF32."""
    return {"cudnn": bool(torch.backends.cudnn.allow_tf32),
            "matmul": bool(torch.backends.cuda.matmul.allow_tf32)}


def _name_and_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_info(device) -> Dict[str, Any]:
    """The device numbers were taken on: the platform (``gpu`` or ``cpu``),
    the card's name and the count of cards, ``nvidia-smi``'s name and power
    limit line, and the TF32 state."""
    if on_card(device):
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(torch.device(device)),
                "count": torch.cuda.device_count(),
                "power_limit": _name_and_power_limit(),
                "tf32": tf32_state()}
    return {"platform": "cpu", "kind": platform.machine(), "count": 1,
            "power_limit": None, "tf32": tf32_state()}


def peak_flops(dtype, tf32: bool) -> float:
    """The card's peak rate for work in ``dtype`` (``"bfloat16"``,
    ``"float16"`` or ``"float32"``, or the torch dtype); float32 with
    ``tf32`` may run on the tensor cores, so its peak is TF32's."""
    name = str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return PEAK_BF16_FLOPS
    if name == "float32":
        return PEAK_TF32_FLOPS if tf32 else PEAK_FP32_FLOPS
    raise ValueError(f"no peak rate for dtype {dtype!r}")
