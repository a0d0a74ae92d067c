"""Duration models: stochastic (flow-based) and deterministic predictors.

Counterpart of ``personalized_text_to_speech_tpu/models/duration.py``
(reference ``models.py:17-132``).  The stochastic predictor is a
conditional normalizing flow over 2-channel ``(log-duration, auxiliary)``
latents:

* ``reverse=False`` (aligning forward): the NLL + log-q duration loss per
  example, through the variational posterior flows,
* ``reverse=True`` (serving): noise × ``noise_scale`` pulled back through the
  reversed main flows; like the reference, the first spline coupling is
  skipped but its Flip is kept (reference ``models.py:88-89``).

Layout ``[B, C, T]``; noise is ``[B, 2, T]`` and is drawn from ``generator``
unless given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from personalized_text_to_speech_tpu_torch.models.flows import (
    ConvFlow,
    ElementwiseAffine,
    Flip,
    Log,
)
from personalized_text_to_speech_tpu_torch.models.layers import DDSConv, LayerNorm, conv1d

_LOG_2PI = math.log(2 * math.pi)


def _spline_flows(channels: int, kernel_size: int, n_flows: int) -> nn.ModuleList:
    """[ElementwiseAffine, (ConvFlow, Flip) × n]: coupling i at index 1+2i."""
    flows = nn.ModuleList([ElementwiseAffine(2)])
    for _ in range(n_flows):
        flows.append(ConvFlow(2, channels, kernel_size, n_layers=3))
        flows.append(Flip())
    return flows


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model (reference ``models.py:17-95``)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        # the reference overrides filter_channels with in_channels
        # (models.py:20, "it needs to be removed from future version")
        fc = in_channels
        self.log_flow = Log()
        self.flows = _spline_flows(fc, kernel_size, n_flows)
        self.post_pre = conv1d(1, fc, 1)
        self.post_proj = conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.post_flows = _spline_flows(fc, kernel_size, 4)
        self.pre = conv1d(in_channels, fc, 1)
        self.proj = conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        if gin_channels:
            self.cond = conv1d(gin_channels, fc, 1)

    def forward(
        self,
        x: torch.Tensor,
        x_mask: torch.Tensor,
        w: Optional[torch.Tensor] = None,
        g: Optional[torch.Tensor] = None,
        reverse: bool = False,
        noise_scale: float = 1.0,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x: [B, C, T] text hiddens; x_mask: [B, 1, T]; w: [B, 1, T]
        durations (forward); g: [B, gin, 1] speaker conditioning."""
        x = self.pre(x.detach())
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.convs(x, x_mask)
        x = self.proj(x) * x_mask
        b, _, t = x.shape
        if noise is None:
            noise = torch.randn((b, 2, t), device=x.device, generator=generator)

        if not reverse:
            if w is None:
                raise ValueError("the forward direction needs durations w")
            h_w = self.post_pre(w)
            h_w = self.post_convs(h_w, x_mask)
            h_w = self.post_proj(h_w) * x_mask
            e_q = noise.to(x.dtype) * x_mask
            z_q = e_q
            logdet_tot_q = torch.zeros(b, device=x.device)
            for flow in self.post_flows:
                z_q, ld = flow(z_q, x_mask, g=x + h_w)
                logdet_tot_q = logdet_tot_q + ld
            z_u, z1 = z_q[:, :1], z_q[:, 1:]
            u = torch.sigmoid(z_u) * x_mask
            z0 = (w - u) * x_mask
            logdet_tot_q = logdet_tot_q + torch.sum(
                (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2)
            )
            logq = (
                torch.sum(-0.5 * (_LOG_2PI + e_q ** 2) * x_mask, dim=(1, 2))
                - logdet_tot_q
            )
            z0, logdet_tot = self.log_flow(z0, x_mask)
            z = torch.cat([z0, z1], dim=1)
            for flow in self.flows:
                z, ld = flow(z, x_mask, g=x)
                logdet_tot = logdet_tot + ld
            nll = (
                torch.sum(0.5 * (_LOG_2PI + z ** 2) * x_mask, dim=(1, 2))
                - logdet_tot
            )
            return nll + logq  # [B]

        # reversed flow order without the first coupling (index 1), whose
        # paired Flip (index 2) is kept
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]
        z = noise.to(x.dtype) * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[:, :1]  # logw [B, 1, T]


class DurationPredictor(nn.Module):
    """Deterministic conv duration predictor (reference ``models.py:98-132``)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float, gin_channels: int = 0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = conv1d(in_channels, filter_channels, kernel_size)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = conv1d(filter_channels, filter_channels, kernel_size)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = conv1d(filter_channels, 1, 1)
        if gin_channels:
            self.cond = conv1d(gin_channels, in_channels, 1)

    def forward(self, x, x_mask, g=None):
        x = x.detach()
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask
