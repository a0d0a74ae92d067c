"""The VITS synthesizer: text encoder, posterior encoder, flow bridge,
duration predictor, HiFi-GAN decoder, and the aligning forward and
inference graphs.

Counterpart of ``personalized_text_to_speech_tpu/models/synthesizer.py``
(reference ``models.py:135-533``).  Modules run ``[B, C, T]``; the public
methods of :class:`SynthesizerTrn` take and return the JAX package's
shapes (ids ``[B, T]``, noise and latents ``[B, T, C]``, masks
``[B, T, 1]``, alignments ``[B, T_y, T_x]``, wav ``[B, S·hop]``) so the two
compare like with like.

As in the JAX package, inference fills a canvas of ``max_len`` frames and
masks it to the predicted lengths, and the Generator re-zeroes activations
beyond each utterance after every stage, so a padded batch gives each
utterance the audio it gets alone.  MAS runs in :mod:`..ops.mas`: the
Hopper kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from personalized_text_to_speech_tpu_torch.models.attention import Encoder
from personalized_text_to_speech_tpu_torch.models.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
)
from personalized_text_to_speech_tpu_torch.models.flows import ResidualCouplingBlock
from personalized_text_to_speech_tpu_torch.models.layers import (
    LRELU_SLOPE,
    WN,
    ResBlock1,
    ResBlock2,
    conv1d,
    conv_transpose1d,
)
from personalized_text_to_speech_tpu_torch.ops.mas import maximum_path
from personalized_text_to_speech_tpu_torch.ops.masking import (
    generate_path,
    rand_slice_segments,
    sequence_mask,
    slice_segments,
)

_LOG_2PI = math.log(2 * math.pi)


def _t(x: torch.Tensor) -> torch.Tensor:
    """Swap time and channels: ``[B, T, C]`` ↔ ``[B, C, T]``."""
    return x.transpose(1, 2)


@torch.no_grad()
def mas_scores(z_p: torch.Tensor, m_p: torch.Tensor,
               logs_p: torch.Tensor) -> torch.Tensor:
    """Gaussian log-likelihood of every frame of ``z_p [B, D, Ts]`` under
    every token's prior ``m_p, logs_p [B, D, Tt]`` → ``neg_cent [B, Ts, Tt]``,
    the scores MAS aligns (reference ``models.py:470-480``; no gradient).
    Float32 throughout, autocast off, as the JAX package's
    ``preferred_element_type=float32`` products."""
    with torch.autocast(device_type=z_p.device.type, enabled=False):
        m_p32, logs_p32, z_p32 = m_p.float(), logs_p.float(), z_p.float()
        s_p_sq_r = torch.exp(-2.0 * logs_p32)  # [B, D, Tt]
        neg_cent1 = torch.sum(-0.5 * _LOG_2PI - logs_p32, dim=1)  # [B, Tt]
        neg_cent2 = torch.matmul(_t(-0.5 * z_p32 ** 2), s_p_sq_r)
        neg_cent3 = torch.matmul(_t(z_p32), m_p32 * s_p_sq_r)
        neg_cent4 = torch.sum(-0.5 * m_p32 ** 2 * s_p_sq_r, dim=1)
        return (neg_cent1[:, None, :] + neg_cent2 + neg_cent3
                + neg_cent4[:, None, :])


class TextEncoder(nn.Module):
    """Symbol embedding → rel-pos transformer → prior stats
    (reference ``models.py:135-176``)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size, p_dropout)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_lengths):
        """x: [B, T] ids → (h [B, H, T], m, logs [B, C, T], x_mask [B, 1, T])."""
        h = _t(self.emb(x) * math.sqrt(self.hidden_channels))
        x_mask = sequence_mask(x_lengths, x.shape[1]).unsqueeze(1).to(h.dtype)
        h = self.encoder(h, x_mask)
        stats = self.proj(h) * x_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        return h, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram → WN stack → posterior stats + reparameterized
    sample (reference ``models.py:212-241``)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y, y_lengths, g=None, noise=None, generator=None):
        """y: [B, spec, T]; noise: [B, C, T] → (z, m, logs, y_mask [B, 1, T])."""
        y_mask = sequence_mask(y_lengths, y.shape[2]).unsqueeze(1).to(y.dtype)
        h = self.pre(y) * y_mask
        h = self.enc(h, y_mask, g=g)
        stats = self.proj(h) * y_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        if noise is None:
            noise = torch.randn(m.shape, device=m.device, dtype=m.dtype,
                                generator=generator)
        z = (m + noise.to(m.dtype) * torch.exp(logs)) * y_mask
        return z, m, logs, y_mask


class Generator(nn.Module):
    """HiFi-GAN decoder: transposed-conv upsampling with multi-receptive-field
    fusion resblocks (reference ``models.py:244-296``)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_rates = list(upsample_rates)
        self.conv_pre = conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        block_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(conv_transpose1d(2 * ch, ch, k, u, (k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, tuple(rd)))
        self.conv_post = conv1d(ch, 1, 7, padding=3, bias=False)
        if gin_channels:
            self.cond = conv1d(gin_channels, upsample_initial_channel, 1)

    def forward(self, x, g=None, x_mask=None):
        """x: [B, C, T] latent frames; x_mask: optional [B, 1, T].

        With a mask, activations beyond each utterance are re-zeroed after
        every stage (``synthesizer.py:168-175`` of the JAX package), so a
        padded canvas gives the audio of the utterance at its exact length.
        """
        mask = x_mask
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        if mask is not None:
            x = x * mask
        for i, u in enumerate(self.upsample_rates):
            x = self.ups[i](F.leaky_relu(x, LRELU_SLOPE))
            if mask is not None:
                mask = torch.repeat_interleave(mask, u, dim=2)
                x = x * mask
            xs = None
            for j in range(self.num_kernels):
                block = self.resblocks[i * self.num_kernels + j](x, mask)
                xs = block if xs is None else xs + block
            x = xs / self.num_kernels
        x = F.leaky_relu(x)  # default slope 0.01, as the reference
        x = torch.tanh(self.conv_post(x))
        if mask is not None:
            x = x * mask
        return x


class SynthesizerTrn(nn.Module):
    """End-to-end VITS synthesizer (reference ``models.py:390-533``).

    Methods: :meth:`forward` (the aligning forward pass of training, whose
    graph the train step keeps for its backward), :meth:`infer` (TTS), and
    the two-stage serving split :meth:`infer_encode` → :meth:`infer_decode`
    (= :meth:`infer_expand` + :meth:`decode_frames`).
    """

    def __init__(self, n_vocab: int, spec_channels: int, segment_size: int,
                 inter_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, p_dropout: float,
                 resblock: str, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], n_speakers: int = 0,
                 gin_channels: int = 0, use_sdp: bool = True):
        super().__init__()
        self.spec_channels = spec_channels
        self.segment_size = segment_size
        self.inter_channels = inter_channels
        self.n_speakers = n_speakers
        self.use_sdp = use_sdp
        self.enc_p = TextEncoder(n_vocab, inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers, kernel_size,
                                 p_dropout)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels,
                                      hidden_channels, 5, 1, 16,
                                      gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1, 4,
                                          gin_channels=gin_channels)
        if use_sdp:
            self.dp = StochasticDurationPredictor(hidden_channels, 192, 3, 0.5, 4,
                                                  gin_channels=gin_channels)
        else:
            self.dp = DurationPredictor(hidden_channels, 256, 3, 0.5,
                                        gin_channels=gin_channels)
        if n_speakers >= 1:
            self.emb_g = nn.Embedding(n_speakers, gin_channels)

    @classmethod
    def from_hparams(cls, hps, **overrides) -> "SynthesizerTrn":
        kw = dict(
            n_vocab=len(hps.symbols),
            spec_channels=hps.data.filter_length // 2 + 1,
            segment_size=hps.train.segment_size // hps.data.hop_length,
            inter_channels=hps.model.inter_channels,
            hidden_channels=hps.model.hidden_channels,
            filter_channels=hps.model.filter_channels,
            n_heads=hps.model.n_heads,
            n_layers=hps.model.n_layers,
            kernel_size=hps.model.kernel_size,
            p_dropout=hps.model.p_dropout,
            resblock=hps.model.resblock,
            resblock_kernel_sizes=tuple(hps.model.resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in hps.model.resblock_dilation_sizes
            ),
            upsample_rates=tuple(hps.model.upsample_rates),
            upsample_initial_channel=hps.model.upsample_initial_channel,
            upsample_kernel_sizes=tuple(hps.model.upsample_kernel_sizes),
            n_speakers=hps.data.n_speakers,
            gin_channels=hps.model.gin_channels,
        )
        kw.update(overrides)
        return cls(**kw)

    def _speaker(self, sid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.n_speakers > 0 and sid is not None:
            return self.emb_g(sid.long()).unsqueeze(-1)  # [B, gin, 1]
        return None

    # ------------------------------------------------------------------
    # aligning forward pass (reference models.py:459-497)
    # ------------------------------------------------------------------
    def forward(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        slice_ids: Optional[torch.Tensor] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        dp_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """x: [B, Tt] ids; y: [B, Ts, spec] linear spectrogram.
        ``posterior_noise`` ([B, Ts, C]), ``dp_noise`` ([B, Tt, 2]) and
        ``slice_ids`` ([B]) replace the draws from ``generator``."""
        h_text, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        g = self._speaker(sid)
        z, m_q, logs_q, y_mask = self.enc_q(
            _t(y), y_lengths, g=g,
            noise=None if posterior_noise is None else _t(posterior_noise),
            generator=generator,
        )
        z_p = self.flow(z, y_mask, g=g)

        neg_cent = mas_scores(z_p, m_p, logs_p)  # [B, Ts, Tt]
        attn = maximum_path(neg_cent, x_lengths, y_lengths)

        w = attn.sum(dim=1).unsqueeze(1)  # [B, 1, Tt]
        if self.use_sdp:
            l_length = self.dp(
                h_text, x_mask, w=w, g=g,
                noise=None if dp_noise is None else _t(dp_noise),
                generator=generator,
            ) / torch.sum(x_mask)
        else:
            logw_ = torch.log(w + 1e-6) * x_mask
            logw = self.dp(h_text, x_mask, g=g)
            l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(x_mask)

        # expand the prior over frames (models.py:492-493)
        m_p_exp = torch.matmul(attn.to(m_p.dtype), _t(m_p))  # [B, Ts, D]
        logs_p_exp = torch.matmul(attn.to(logs_p.dtype), _t(logs_p))

        if slice_ids is None:
            z_slice, slice_ids = rand_slice_segments(
                z, y_lengths, self.segment_size, generator=generator
            )
        else:
            z_slice = slice_segments(z, slice_ids, self.segment_size)
        o = self.dec(z_slice, g=g)  # [B, 1, seg·hop]

        return {
            "wav_hat": o[:, 0],
            "l_length": l_length,
            "attn": attn,
            "x_mask": _t(x_mask),
            "y_mask": _t(y_mask),
            "z": _t(z),
            "z_p": _t(z_p),
            "m_p": m_p_exp,
            "logs_p": logs_p_exp,
            "m_q": _t(m_q),
            "logs_q": _t(logs_q),
        }

    # ------------------------------------------------------------------
    # inference (reference models.py:499-523), in the serving stages
    # ------------------------------------------------------------------
    def _encode(self, x, x_lengths, sid, length_scale, noise_scale_w, dp_noise,
                generator):
        """Text → (w_ceil [B, Tt], m_p, logs_p [B, D, Tt], x_mask [B, 1, Tt])."""
        h_text, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        g = self._speaker(sid)
        if self.use_sdp:
            logw = self.dp(
                h_text, x_mask, g=g, reverse=True, noise_scale=noise_scale_w,
                noise=None if dp_noise is None else _t(dp_noise),
                generator=generator,
            )
        else:
            logw = self.dp(h_text, x_mask, g=g)
        w = torch.exp(logw.float()) * x_mask * length_scale
        return torch.ceil(w)[:, 0], m_p, logs_p, x_mask

    def _expand(self, w_ceil, m_p, logs_p, x_mask, noise_scale, max_len,
                prior_noise, generator):
        """Durations + prior stats → (z_p [B, D, S], y_mask [B, 1, S],
        y_lengths [B], attn [B, S, Tt])."""
        y_lengths = torch.clamp(w_ceil.sum(dim=-1), 1, max_len).int()
        y_mask = sequence_mask(y_lengths, max_len).unsqueeze(1)
        attn = generate_path(w_ceil, max_len, x_mask * _t(y_mask))
        m_p_exp = torch.matmul(m_p, _t(attn).to(m_p.dtype))  # [B, D, S]
        logs_p_exp = torch.matmul(logs_p, _t(attn).to(logs_p.dtype))
        if prior_noise is None:
            noise = torch.randn(m_p_exp.shape, device=m_p.device,
                                dtype=m_p_exp.dtype, generator=generator)
        else:
            noise = _t(prior_noise).to(m_p_exp.dtype)
        z_p = m_p_exp + noise * torch.exp(logs_p_exp) * noise_scale
        return z_p, y_mask, y_lengths, attn

    def _decode(self, z_p, y_mask, sid):
        """Latent frames [B, D, S] → waveform [B, S·hop]."""
        g = self._speaker(sid)
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        return self.dec(z * y_mask, g=g, x_mask=y_mask)[:, 0]

    @staticmethod
    def _trim(o, y_lengths, max_len):
        hop = o.shape[1] // max_len
        return o * sequence_mask(y_lengths * hop, o.shape[1])

    def infer(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        max_len: int = 1000,
        dp_noise: Optional[torch.Tensor] = None,
        prior_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Text IDs → ``(wav [B, max_len·hop], y_lengths [B], attn [B, S, Tt],
        y_mask [B, S, 1])``; samples past ``y_lengths·hop`` are zero.
        ``dp_noise`` is [B, Tt, 2], ``prior_noise`` [B, max_len, C]."""
        w_ceil, m_p, logs_p, x_mask = self._encode(
            x, x_lengths, sid, length_scale, noise_scale_w, dp_noise, generator
        )
        z_p, y_mask, y_lengths, attn = self._expand(
            w_ceil, m_p, logs_p, x_mask, noise_scale, max_len, prior_noise,
            generator,
        )
        o = self._decode(z_p, y_mask, sid)
        return self._trim(o, y_lengths, max_len), y_lengths, attn, _t(y_mask)

    def infer_encode(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        dp_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Text → ``(w_ceil [B, Tt], m_p [B, Tt, D], logs_p [B, Tt, D],
        x_mask [B, Tt, 1])``; the frame count is ``sum(w_ceil)``."""
        w_ceil, m_p, logs_p, x_mask = self._encode(
            x, x_lengths, sid, length_scale, noise_scale_w, dp_noise, generator
        )
        return w_ceil, _t(m_p), _t(logs_p), _t(x_mask)

    def infer_expand(
        self,
        w_ceil: torch.Tensor,
        m_p: torch.Tensor,
        logs_p: torch.Tensor,
        x_mask: torch.Tensor,
        noise_scale: float = 0.667,
        max_len: int = 1000,
        prior_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Durations + prior stats → ``(z_p [B, S, D], y_mask [B, S, 1],
        y_lengths [B])``, the per-frame part of :meth:`infer_decode`."""
        z_p, y_mask, y_lengths, _ = self._expand(
            w_ceil, _t(m_p), _t(logs_p), _t(x_mask), noise_scale, max_len,
            prior_noise, generator,
        )
        return _t(z_p), _t(y_mask), y_lengths

    def decode_frames(
        self,
        z_p: torch.Tensor,
        y_mask: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Latent frames ``[B, S, D]`` → waveform ``[B, S·hop]``: reverse flow
        + HiFi-GAN, the convolutional tail of :meth:`infer_decode`."""
        return self._decode(_t(z_p), _t(y_mask), sid)

    def infer_decode(
        self,
        w_ceil: torch.Tensor,
        m_p: torch.Tensor,
        logs_p: torch.Tensor,
        x_mask: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        noise_scale: float = 0.667,
        max_len: int = 1000,
        prior_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Durations + prior stats → ``(wav [B, max_len·hop], y_lengths)``."""
        z_p, y_mask, y_lengths, _ = self._expand(
            w_ceil, _t(m_p), _t(logs_p), _t(x_mask), noise_scale, max_len,
            prior_noise, generator,
        )
        o = self._decode(z_p, y_mask, sid)
        return self._trim(o, y_lengths, max_len), y_lengths
