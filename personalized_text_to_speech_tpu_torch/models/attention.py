"""Relative-position multi-head attention and the text-encoder stack.

Counterpart of ``personalized_text_to_speech_tpu/models/attention.py``
(reference ``attentions.py:13-254``): scaled-dot attention with a windowed
relative-position bias (window 4, embeddings shared across heads) on keys
and values, post-LayerNorm residual blocks with conv-FFNs.

The windowed bias is computed banded, as in the JAX package: q is contracted
against the table's true K = 2·window+1 rows and a pad+reshape shuffle
(:func:`_band_to_full` / :func:`_full_to_band`) places the band in the
[T, T] score matrix.  The reference-shaped 2T−1 path is kept for
T < 2·window+1, where the shuffle's precondition fails, and as the oracle
in the tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from personalized_text_to_speech_tpu_torch.models.layers import FFN, LayerNorm, conv1d


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L−1] relative logits → [B, H, L, L] absolute
    (reference ``attentions.py:214-229``)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights → [B, H, L, 2L−1] relative
    (reference ``attentions.py:231-243``)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _band_to_full(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, L, K] banded values → [B, H, L, L] with
    ``out[t, s] = x[t, s − t + window]`` for |s − t| ≤ window, else 0.
    Needs K = 2·window+1 ≤ L+1 (callers guard with L ≥ 2·window+1)."""
    b, h, l, k = x.shape
    t_idx = torch.arange(l, device=x.device)[:, None]
    s_idx = t_idx + torch.arange(k, device=x.device)[None, :] - window
    x = x.masked_fill(~((s_idx >= 0) & (s_idx < l)), 0.0)
    x = F.pad(x, (0, l + 1 - k))
    x_flat = F.pad(x.reshape(b, h, l * (l + 1))[:, :, window:], (0, window))
    return x_flat[:, :, : l * l].reshape(b, h, l, l)


def _full_to_band(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, L, L] weights → [B, H, L, K] band, ``out[t, k] =
    x[t, t + k − window]`` for valid columns else 0 (inverse of
    :func:`_band_to_full`, same precondition)."""
    b, h, l, _ = x.shape
    t_idx = torch.arange(l, device=x.device)[:, None]
    s_idx = torch.arange(l, device=x.device)[None, :]
    x = x.masked_fill((s_idx - t_idx).abs() > window, 0.0)
    x_flat = F.pad(x.reshape(b, h, l * l), (window, l - window))
    return x_flat.reshape(b, h, l, l + 1)[:, :, :, : 2 * window + 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with a windowed relative-position bias
    (reference ``attentions.py:101-254``).  ``banded_rel=False`` forces the
    reference-shaped 2T−1 path (the test oracle)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 p_dropout: float = 0.0, window_size: Optional[int] = None,
                 banded_rel: bool = True):
        super().__init__()
        self.channels = channels
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.banded_rel = banded_rel
        self.drop = nn.Dropout(p_dropout)
        self.conv_q = conv1d(channels, channels, 1)
        self.conv_k = conv1d(channels, channels, 1)
        self.conv_v = conv1d(channels, channels, 1)
        self.conv_o = conv1d(channels, out_channels, 1)
        if window_size is not None:
            std = self.k_channels ** -0.5
            shape = (1, 2 * window_size + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.randn(shape) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(shape) * std)

    def _rel_embeddings(self, emb: torch.Tensor, length: int) -> torch.Tensor:
        """Center-crop/pad the ±window table to 2·length−1 rows
        (reference ``attentions.py:199-212``)."""
        w = self.window_size
        pad_len = max(length - (w + 1), 0)
        start = max((w + 1) - length, 0)
        if pad_len > 0:
            emb = F.pad(emb, (0, 0, pad_len, pad_len))
        return emb[:, start:start + 2 * length - 1]

    def forward(self, x, c, attn_mask=None):
        """x, c: [B, C, T]; attn_mask: [B, 1, T, T] (1 = attend)."""
        b, _, t_t = x.shape
        t_s = c.shape[2]
        h, dk = self.n_heads, self.k_channels
        q = self.conv_q(x).view(b, h, dk, t_t).transpose(2, 3)
        k = self.conv_k(c).view(b, h, dk, t_s).transpose(2, 3)
        v = self.conv_v(c).view(b, h, dk, t_s).transpose(2, 3)

        q = q * (1.0 / math.sqrt(dk))
        scores = torch.matmul(q, k.transpose(-2, -1))
        use_band = False
        if self.window_size is not None:
            if t_s != t_t:
                raise ValueError("relative attention needs self-attention")
            use_band = self.banded_rel and t_s >= 2 * self.window_size + 1
            if use_band:
                rel = torch.matmul(q, self.emb_rel_k.transpose(-2, -1).unsqueeze(0))
                scores = scores + _band_to_full(rel, self.window_size)
            else:
                key_rel = self._rel_embeddings(self.emb_rel_k, t_s)
                rel = torch.matmul(q, key_rel.transpose(-2, -1).unsqueeze(0))
                scores = scores + _relative_to_absolute(rel)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        output = torch.matmul(p_attn, v)
        if self.window_size is not None:
            if use_band:
                weights = _full_to_band(p_attn, self.window_size)
                value_rel = self.emb_rel_v
            else:
                weights = _absolute_to_relative(p_attn)
                value_rel = self._rel_embeddings(self.emb_rel_v, t_s)
            output = output + torch.matmul(weights, value_rel.unsqueeze(0))
        output = output.transpose(2, 3).reshape(b, self.channels, t_t)
        return self.conv_o(output)


class Encoder(nn.Module):
    """Rel-pos transformer encoder with post-LN residuals
    (reference ``attentions.py:13-47``)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 window_size: int = 4):
        super().__init__()
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads,
                               p_dropout=p_dropout, window_size=window_size)
            for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers)
        )
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size,
                p_dropout=p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_2 = nn.ModuleList(
            LayerNorm(hidden_channels) for _ in range(n_layers)
        )

    def forward(self, x, x_mask):
        """x: [B, C, T]; x_mask: [B, 1, T]."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # [B, 1, T, T]
        x = x * x_mask
        for i in range(self.n_layers):
            y = self.drop(self.attn_layers[i](x, x, attn_mask))
            x = self.norm_layers_1[i](x + y)
            y = self.drop(self.ffn_layers[i](x, x_mask))
            x = self.norm_layers_2[i](x + y)
        return x * x_mask
