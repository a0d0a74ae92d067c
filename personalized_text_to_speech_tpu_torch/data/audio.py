"""Waveform IO and resampling through scipy.

The port's own copy of ``personalized_text_to_speech_tpu/data/audio.py``
(reference ``data_utils.py:78``, ``cmd_inference.py:117``): ``scipy.io.wavfile``
both ways, integer PCM normalised to float32 in [-1, 1] as
``torchaudio.load(normalize=True)`` does, channel-mean mono, polyphase
resampling.
"""

from __future__ import annotations

from math import gcd
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file → (float32 ``[C, L]`` array, sampling rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return (data[None, :] if data.ndim == 1 else data.T), sr


def save_wav(path: str, wav: np.ndarray, sampling_rate: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    pcm = np.clip(np.asarray(wav, dtype=np.float32).squeeze(), -1.0, 1.0)
    wavfile.write(path, sampling_rate, (pcm * 32767.0).astype(np.int16))


def to_mono(wav: np.ndarray) -> np.ndarray:
    """``[C, L]`` → ``[L]`` by channel averaging."""
    return wav.mean(axis=0) if wav.ndim == 2 else wav


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == target_sr:
        return wav
    g = gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32
    )


def load_wav_mono(path: str, target_sr: int) -> np.ndarray:
    """Read → mono → resample to ``target_sr`` → float32 ``[L]``."""
    wav, sr = load_wav(path)
    return resample(to_mono(wav), sr, target_sr)
