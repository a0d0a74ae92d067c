"""GAN discriminators: one multi-scale (1-D) and five multi-period (2-D).

Counterpart of ``personalized_text_to_speech_tpu/models/discriminator.py``
(reference ``models.py:299-386``).  ``DiscriminatorS``
is a stack of grouped 1-D convs; ``DiscriminatorP`` pads the waveform with a
reflection to a whole number of periods and folds it into ``[B, 1, T/p, p]``.
The ensemble scores (real, generated) pairs with every member and returns
the logits and the feature maps of the feature-matching loss.

Module names are the reference's (``discriminators.{0..5}.convs.{i}``,
``conv_post``), so reference ``D_*.pth`` files load as they are.  Feature
maps are torch's ``[B, C, T]`` and ``[B, C, T/p, p]``; the JAX package keeps
channels last.

``use_spectral_norm`` (reference ``models.py:304,339``) swaps every conv's
weight norm, ``conv_post`` included, for spectral norm
(``models/layers.py``): keys ``weight_orig``/``weight_u``/``weight_v``.
The ensemble scores real then generated audio in two calls per member, so
inside :func:`~.layers.power_iteration` one ensemble call advances each
estimate twice (real at u1, fake at u2), as the JAX step does
(``train/step.py:45-53``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from personalized_text_to_speech_tpu_torch.models.layers import (
    LRELU_SLOPE,
    conv1d,
    conv2d,
)


class DiscriminatorP(nn.Module):
    """Period discriminator (reference ``models.py:299-333``)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        sn = use_spectral_norm
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            conv2d(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0),
                   spectral_norm=sn)
            for cin, cout in zip(chans[:-1], chans[1:])
        )
        self.convs.append(conv2d(1024, 1024, (kernel_size, 1), (1, 1), (pad, 0),
                                 spectral_norm=sn))
        self.conv_post = conv2d(1024, 1, (3, 1), (1, 1), (1, 0), spectral_norm=sn)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: ``[B, L]`` → (logits ``[B, N]``, feature maps)."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x.unsqueeze(1), (0, n_pad), mode="reflect").squeeze(1)
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator (reference ``models.py:336-361``)."""

    # (in, out, kernel, stride, groups, padding)
    SPECS = (
        (1, 16, 15, 1, 1, 7),
        (16, 64, 41, 4, 4, 20),
        (64, 256, 41, 4, 16, 20),
        (256, 1024, 41, 4, 64, 20),
        (1024, 1024, 41, 4, 256, 20),
        (1024, 1024, 5, 1, 1, 2),
    )

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        sn = use_spectral_norm
        self.convs = nn.ModuleList(
            conv1d(cin, cout, k, stride=s, groups=g, padding=p,
                   weight_norm=not sn, spectral_norm=sn)
            for cin, cout, k, s, g, p in self.SPECS
        )
        self.conv_post = conv1d(1024, 1, 3, padding=1, weight_norm=not sn,
                                spectral_norm=sn)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: ``[B, L]`` → (logits ``[B, N]``, feature maps)."""
        x = x.unsqueeze(1)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """1 scale + one period discriminator per period over (real, generated)
    pairs (reference ``models.py:364-386``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 use_spectral_norm: bool = False):
        super().__init__()
        sn = use_spectral_norm
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(sn)]
            + [DiscriminatorP(p, use_spectral_norm=sn) for p in periods]
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat: ``[B, L]`` → (real logits, generated logits, real
        feature maps, generated feature maps), one entry per member."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
