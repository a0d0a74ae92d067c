"""Linear and mel spectrograms on the device, as one windowed-DFT matmul.

Counterpart of ``personalized_text_to_speech_tpu/ops/spectrogram.py``
(``mel_filterbank`` at ``:63``, ``_dft_matrices`` at ``:95``,
``linear_spectrogram`` at ``:161``), itself the reference's ``torch.stft`` path
(reference ``mel_processing.py:51-112``): reflect pad ``(n_fft-hop)/2``,
``center=False`` framing, periodic Hann window, magnitude
``sqrt(re²+im²+1e-6)``, Slaney mel filterbank, log with clamp 1e-5.

The JAX package folds the window into a cosine and a sine basis and runs the
DFT as a product; the port keeps that form, with the two bases side by side
in one ``[n_fft, 2·n_freq]`` matrix so the frames meet it in one
``torch.matmul``.  This is a plain product outside any Pallas kernel, left to
cuBLAS as the JAX package left it to XLA.  Everything here runs in float32,
with autocast switched off, whatever region the caller is in: the train
step's targets and its mel loss must not round to bf16.

Layouts follow the JAX package: waveforms ``[B, L]``, spectrograms
``[B, T, F]`` (frames first).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# Slaney-style mel filterbank (librosa.filters.mel with htk=False,
# norm='slaney', as at reference mel_processing.py:78)
# --------------------------------------------------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_mel, f / _F_SP)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    log_hz = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, log_hz, m * _F_SP)


def mel_filterbank(
    sampling_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Triangular Slaney-normalised mel filterbank, ``[n_mels, n_freq]``."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_freq = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, n_freq)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalisation
    weights *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Hann-windowed DFT basis ``[n_fft, 2·n_freq]``: cosines, then sines.

    ``re[k] = Σ_n x[n]·w[n]·cos(2πnk/N)``, ``im[k] = -Σ_n x[n]·w[n]·sin(…)``;
    only ``|X|`` is used, so the sign of ``im`` does not matter.
    """
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_freq)[None, :].astype(np.float64)
    # periodic Hann (torch.hann_window's default), centred if win < n_fft
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    window = np.zeros(n_fft)
    pad = (n_fft - win_length) // 2
    window[pad : pad + win_length] = win
    ang = 2.0 * np.pi * n * k / n_fft
    # each half rounded to float32 on its own, as the JAX package's two bases
    return np.concatenate(
        [(window[:, None] * np.cos(ang)).astype(np.float32),
         (window[:, None] * np.sin(ang)).astype(np.float32)], axis=1,
    )


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Audio analysis settings (reference ``configs/finetune_speaker.json:24-30``)."""

    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1

    @classmethod
    def from_hparams(cls, hps) -> "MelConfig":
        return cls(
            sampling_rate=hps.data.sampling_rate,
            n_fft=hps.data.filter_length,
            hop_length=hps.data.hop_length,
            win_length=hps.data.win_length,
            n_mels=hps.data.n_mel_channels,
            fmin=hps.data.mel_fmin,
            fmax=hps.data.mel_fmax,
        )


# the constants live on each device once: a train step takes two
# spectrograms, and a 4 MB copy from the host per call would cost more
# than the product.  They are made outside inference mode whatever the
# first caller's mode (serving's voice conversion runs in it): an inference
# tensor in the cache could not be saved for a later train step's backward
@functools.lru_cache(maxsize=16)
def _basis_on(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(dft_basis(n_fft, win_length)).to(device)


@functools.lru_cache(maxsize=16)
def _filterbank_on(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    with torch.inference_mode(False):
        return torch.from_numpy(fb).t().contiguous().to(device)  # [n_freq, n_mels]


def linear_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveform ``[B, L]`` → linear magnitude spectrogram ``[B, T, n_freq]``
    with ``T = 1 + (L + 2·pad − n_fft) // hop``, in float32."""
    with torch.autocast(device_type=y.device.type, enabled=False):
        pad = (cfg.n_fft - cfg.hop_length) // 2
        y = y.float()
        if pad:
            y = F.pad(y.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
        frames = y.unfold(-1, cfg.n_fft, cfg.hop_length)  # [B, T, n_fft]
        spec = torch.matmul(frames, _basis_on(cfg.n_fft, cfg.win_length, y.device))
        re, im = spec[..., : cfg.n_freq], spec[..., cfg.n_freq :]
        return torch.sqrt(re * re + im * im + 1e-6)


def spec_to_mel(spec: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Linear spectrogram ``[B, T, n_freq]`` → log-mel ``[B, T, n_mels]``
    (reference ``spec_to_mel_torch``, ``mel_processing.py:73-82``)."""
    with torch.autocast(device_type=spec.device.type, enabled=False):
        mel = torch.matmul(spec.float(), _filterbank_on(cfg, spec.device))
        return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveform ``[B, L]`` → log-mel ``[B, T, n_mels]`` (reference
    ``mel_spectrogram_torch``, ``mel_processing.py:85-112``)."""
    return spec_to_mel(linear_spectrogram(y, cfg), cfg)
