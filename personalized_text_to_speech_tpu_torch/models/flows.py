"""Normalizing-flow layers: elementwise flows, affine coupling, spline coupling.

Counterpart of ``personalized_text_to_speech_tpu/models/flows.py``
(reference ``modules.py:259-391``); layout ``[B, C, T]``, masks ``[B, 1, T]``.
Every flow is bidirectional: ``reverse=False`` returns ``(y, logdet)``,
``reverse=True`` returns ``x``.  Flow containers interleave parameterless
:class:`Flip` modules as the reference does, so coupling ``i`` sits at
``flows.{2i}`` in the state dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from personalized_text_to_speech_tpu_torch.models.layers import DDSConv, WN, conv1d
from personalized_text_to_speech_tpu_torch.ops.spline import (
    piecewise_rational_quadratic_transform,
)


class Log(nn.Module):
    """y = log(x) elementwise flow (reference ``modules.py:259-267``)."""

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    """Channel-order reversal (reference ``modules.py:270-277``)."""

    def forward(self, x, *args, reverse: bool = False, **kwargs):
        x = torch.flip(x, dims=[1])
        if not reverse:
            return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return x


class ElementwiseAffine(nn.Module):
    """Per-channel affine flow (reference ``modules.py:280-295``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ResidualCouplingLayer(nn.Module):
    """Affine (mean-only in VITS) coupling with a WN inner net
    (reference ``modules.py:298-343``)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, p_dropout: float = 0.0,
                 gin_channels: int = 0, mean_only: bool = False):
        super().__init__()
        self.half = channels // 2
        self.mean_only = mean_only
        self.pre = conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, p_dropout=p_dropout)
        self.post = conv1d(hidden_channels, self.half * (2 - mean_only), 1,
                           init_std=0.0)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = self.post(h) * x_mask
        if not self.mean_only:
            m, logs = stats[:, :self.half], stats[:, self.half:]
        else:
            m, logs = stats, torch.zeros_like(stats)
        if not reverse:
            x1 = (m + x1 * torch.exp(logs)) * x_mask
            return torch.cat([x0, x1], dim=1), torch.sum(logs, dim=(1, 2))
        x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n × (coupling + flip) prior/posterior bridge
    (reference ``models.py:179-209``)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels, mean_only=True,
            ))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            for flow in self.flows:
                x, _ = flow(x, x_mask, g=g, reverse=False)
            return x
        for flow in reversed(self.flows):
            x = flow(x, x_mask, g=g, reverse=True)
        return x


class ConvFlow(nn.Module):
    """Spline coupling: DDSConv conditioner → rational-quadratic spline on the
    second half-channels (reference ``modules.py:346-391``)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers, p_dropout=0.0)
        self.proj = conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1,
                           init_std=0.0)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0)
        h = self.convs(h, x_mask, g=g)
        h = self.proj(h) * x_mask
        b, _, t = x0.shape
        # channel-major grouping of the reference reshape (modules.py:370)
        h = h.reshape(b, self.half, -1, t).permute(0, 1, 3, 2)
        denom = math.sqrt(self.filter_channels)
        k = self.num_bins
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1.float(),
            (h[..., :k] / denom).float(),
            (h[..., k:2 * k] / denom).float(),
            h[..., 2 * k:].float(),
            inverse=reverse,
            tails="linear",
            tail_bound=self.tail_bound,
        )
        x = torch.cat([x0, x1.to(x0.dtype)], dim=1) * x_mask
        if not reverse:
            return x, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return x
