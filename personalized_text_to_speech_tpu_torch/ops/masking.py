"""Masking, duration-path expansion, and segment slicing utilities.

Counterpart of ``personalized_text_to_speech_tpu/ops/masking.py`` (reference
``commons.py:48-146``).  Segment slicing works along the last axis, because
the port's modules keep time last (``[B, C, T]``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths → [B, max_length] float mask (reference ``commons.py:124-128``)."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return (pos[None, :] < lengths[:, None]).float()


def generate_path(
    duration: torch.Tensor, t_y: int, attn_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Durations [B, T_x] → hard monotonic path [B, t_y, T_x] with
    ``path[b, y, x] = 1`` iff ``cum[x-1] <= y < cum[x]`` (the band condition of
    the JAX version, reference ``commons.py:131-146``)."""
    cum = torch.cumsum(duration, dim=-1)
    y_pos = torch.arange(t_y, device=cum.device, dtype=cum.dtype)[None, :, None]
    upper = cum[:, None, :]
    lower = upper - duration[:, None, :]
    path = ((y_pos >= lower) & (y_pos < upper)).float()
    if attn_mask is not None:
        path = path * attn_mask
    return path


def slice_segments(
    x: torch.Tensor, ids_str: torch.Tensor, segment_size: int
) -> torch.Tensor:
    """Per-sample windows ``x[b, ..., ids[b]:ids[b]+segment_size]`` along the
    last axis (reference ``commons.py:48-57``).  Like ``dynamic_slice_in_dim``
    in the JAX version, a start past ``T - segment_size`` is clamped back so
    the window stays inside the tensor."""
    t = x.shape[-1]
    start = ids_str.long().clamp(0, max(t - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    idx = idx.view(idx.shape[0], *([1] * (x.dim() - 2)), segment_size)
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], segment_size))


def rand_slice_segments(
    x: torch.Tensor,
    lengths: torch.Tensor,
    segment_size: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random training windows (reference ``commons.py:60-67``): per-sample
    uniform start in ``[0, length - segment_size]``."""
    ids_max = torch.clamp(lengths - segment_size + 1, min=1)
    u = torch.rand(x.shape[0], device=x.device, generator=generator)
    ids_str = (u * ids_max.float()).int()
    return slice_segments(x, ids_str, segment_size), ids_str
