"""Monotonic Alignment Search (MAS): the dispatcher, the Hopper kernel's
wrapper, and the plain PyTorch version.

Counterpart of ``personalized_text_to_speech_tpu/ops/mas.py::maximum_path``.
On the TPU the JAX package runs the Pallas kernel
``ops/mas_pallas.py::maximum_path_pallas``; here a CUDA tensor goes to the
hand-written kernel in ``csrc/mas.cu`` (:func:`maximum_path_cuda`) and a CPU
tensor to :func:`maximum_path_plain`.  There is no fallback between the two:
a CUDA tensor the kernel cannot take raises.

Index conventions follow the JAX package: ``neg_cent`` is
``[B, T_y(spec), T_x(text)]`` and the hard path is ``[B, T_y, T_x]`` with
``path[b, y, x] = 1`` iff spec frame ``y`` is aligned to text token ``x``.

The kernel's bound on an H100: it writes the path whole, ``4·B·T_y·T_x``
bytes, and reads the band of ``neg_cent`` the path depends on, which
``chip_smoke.py`` counts for its own inputs (~2 µs at 3.35 TB/s for B=16,
T_y=400, T_x=192).  The real limiter is the T_y-deep chain of dependent rows
in each block, then the T_y-step backtrack.  The kernel runs one block of
128 threads per utterance: warp 0 walks the rows with the two value rows in
shared memory and one ``__syncwarp()`` per row, a ring of score rows in
flight with ``cp.async``, and one 32-bit word of packed decisions per
(row, 32 columns) in an int32 ``[B, T_y, ceil(T_x/32)]`` scratch; warps 1–3
zero the path meanwhile; lane 0 then follows the decisions back from shared
memory.  Its shared memory grows with T_x only (:func:`shared_bytes`); a
T_x past the block's 227 KB (5,728 columns) raises.  The design note
at the top of ``csrc/mas.cu`` has the details.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

_NEG = -1e9

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "mas.cu"
BUILD_DIR = _CSRC / "build"
# -Xptxas -v: ptxas's register, spill and shared-memory report, kept beside
# the library (:func:`build_library`)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# shared memory one block may use on Hopper (227 KB)
_MAX_SHARED_BYTES = 232_448

_lib = None
_lib_lock = threading.Lock()


# --------------------------------------------------------------------------
# plain version: the kernel's arithmetic as a batched loop over frames
# --------------------------------------------------------------------------

def maximum_path_plain(
    neg_cent: torch.Tensor,
    text_lengths: torch.Tensor,
    spec_lengths: torch.Tensor,
) -> torch.Tensor:
    """Batched MAS as a PyTorch loop over ``y`` (like the JAX package's
    ``_maximum_path_scan``): the Pallas kernel's fp32 operations in the same
    order, so the path is bit-identical to it and to the numpy oracle."""
    b, t_y, t_x = neg_cent.shape
    neg = neg_cent.float()
    dev = neg.device
    x_idx = torch.arange(t_x, device=dev)
    sentinel = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)

    value = torch.empty((b, t_y, t_x), dtype=torch.float32, device=dev)
    row = neg[:, 0, :] + torch.where(x_idx == 0, zero, sentinel)
    value[:, 0] = row
    for y in range(1, t_y):
        stay = torch.where(x_idx < y, row, sentinel)
        advance = F.pad(row[:, :-1], (1, 0), value=_NEG)
        row = neg[:, y, :] + torch.maximum(stay, advance)
        value[:, y] = row

    text_lengths = text_lengths.to(device=dev, dtype=torch.long)
    spec_lengths = spec_lengths.to(device=dev, dtype=torch.long)
    batch = torch.arange(b, device=dev)
    idx = (text_lengths - 1).clamp(min=0)
    path = torch.zeros((b, t_y, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        active = y < spec_lengths
        path[batch, y, idx] = active.float()
        if y > 0:
            below = value[:, y - 1]
            v_stay = below.gather(1, idx[:, None])[:, 0]
            v_adv = below.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
            dec = (idx != 0) & ((idx == y) | (v_stay < v_adv)) & active
            idx = idx - dec.long()
    return path * (x_idx[None, None, :] < text_lengths[:, None, None])


# --------------------------------------------------------------------------
# the Hopper kernel: build, load, launch
# --------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: cannot build csrc/mas.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """``csrc/build/libmas-<hash>.so``, keyed by the source and the flags, so
    a build of other sources is never loaded."""
    digest = hashlib.sha1(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libmas-{digest}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/mas.cu`` with ``nvcc`` unless this build is already
    there.  The compiler's output, ptxas's report among it, is kept beside
    the library as ``.log``; ``verbose`` prints it."""
    lib = library_path()
    report = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    if verbose:
        print(report.read_text(), end="")
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.mas_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.mas_launch.restype = ctypes.c_int
            lib.mas_shared_bytes.argtypes = [ctypes.c_int]
            lib.mas_shared_bytes.restype = ctypes.c_size_t
            lib.mas_error_string.argtypes = [ctypes.c_int]
            lib.mas_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def shared_bytes(t_x: int) -> int:
    """Shared memory one block of the kernel takes at this T_x, as
    ``csrc/mas.cu`` sizes it (``mas_shared_bytes``)."""
    return _library().mas_shared_bytes(t_x)


def maximum_path_cuda(
    neg_cent: torch.Tensor,
    text_lengths: torch.Tensor,
    spec_lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch the MAS kernel of ``csrc/mas.cu`` (replaces
    ``personalized_text_to_speech_tpu/ops/mas_pallas.py::maximum_path_pallas``).

    Takes CUDA tensors only: ``neg_cent`` f32 ``[B, T_y, T_x]`` contiguous,
    lengths int32 ``[B]`` on the same card.  Raises on anything else.
    """
    if not neg_cent.is_cuda:
        raise ValueError("maximum_path_cuda needs a CUDA tensor")
    if neg_cent.dtype != torch.float32 or neg_cent.dim() != 3:
        raise ValueError(
            f"neg_cent must be float32 [B, T_y, T_x], got {neg_cent.dtype} "
            f"{tuple(neg_cent.shape)}"
        )
    b, t_y, t_x = neg_cent.shape
    if b == 0 or t_y == 0 or t_x == 0:
        raise ValueError(f"empty neg_cent {tuple(neg_cent.shape)}")
    if not neg_cent.is_contiguous():
        raise ValueError("neg_cent must be contiguous")
    for name, t in (("text_lengths", text_lengths), ("spec_lengths", spec_lengths)):
        if (t.device != neg_cent.device or t.dtype != torch.int32
                or tuple(t.shape) != (b,) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous int32 [{b}] on {neg_cent.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    smem = shared_bytes(t_x)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(
            f"T_x={t_x} needs {smem} bytes of shared memory; a Hopper block "
            f"has {_MAX_SHARED_BYTES}"
        )
    lib = _library()
    path = torch.empty_like(neg_cent)
    # decision bits, one int32 word per (row, 32 columns)
    dec = torch.empty((b, t_y, (t_x + 31) // 32), dtype=torch.int32,
                      device=neg_cent.device)
    with torch.cuda.device(neg_cent.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mas_launch(
            neg_cent.data_ptr(), text_lengths.data_ptr(),
            spec_lengths.data_ptr(), path.data_ptr(), dec.data_ptr(),
            b, t_y, t_x, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"MAS kernel launch failed: {lib.mas_error_string(err).decode()}"
        )
    maximum_path_cuda.launches += 1
    return path


maximum_path_cuda.launches = 0


def maximum_path(
    neg_cent: torch.Tensor,
    text_lengths: torch.Tensor,
    spec_lengths: torch.Tensor,
) -> torch.Tensor:
    """Batched MAS: [B, T_y, T_x] scores → hard 0/1 path (no gradient).

    A CUDA tensor runs the Hopper kernel, a CPU tensor the plain version.
    """
    neg_cent = neg_cent.detach().float().contiguous()
    text_lengths = text_lengths.to(device=neg_cent.device, dtype=torch.int32)
    spec_lengths = spec_lengths.to(device=neg_cent.device, dtype=torch.int32)
    if neg_cent.is_cuda:
        return maximum_path_cuda(
            neg_cent, text_lengths.contiguous(), spec_lengths.contiguous()
        )
    if neg_cent.device.type != "cpu":
        raise ValueError(f"no MAS for device {neg_cent.device}")
    return maximum_path_plain(neg_cent, text_lengths, spec_lengths)
