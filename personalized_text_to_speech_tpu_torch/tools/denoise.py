"""Vocal isolation / denoising of raw recordings (reference
``scripts/denoise_audio.py``: demucs two-stem separation), with a built-in
spectral gate where demucs is not installed:

    python -m personalized_text_to_speech_tpu_torch.tools.denoise \
        --in_dir raw_audio --out_dir denoised_audio --method spectral

The port's copy of ``tools/denoise.py``, with its flags.  ``--method auto``
takes demucs when its command is on the ``PATH``, else the spectral gate: a
noise profile from the quietest frames and per-bin spectral subtraction with
temporal smoothing, far lighter than demucs but dependency-free and
effective on stationary noise.  Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np


def spectral_gate(wav: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 256,
                  reduction_db: float = 18.0) -> np.ndarray:
    """Simple spectral-subtraction denoiser (noise profile from the quietest
    10% of frames)."""
    window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    y = np.pad(wav.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.abs(spec)

    frame_energy = mag.mean(axis=1)
    k = max(int(0.1 * n_frames), 1)
    noise_profile = mag[np.argsort(frame_energy)[:k]].mean(axis=0)

    gain_floor = 10 ** (-reduction_db / 20.0)
    gain = np.maximum(1.0 - (noise_profile[None, :] / np.maximum(mag, 1e-10)), gain_floor)
    # temporal smoothing of the gain to avoid musical noise
    for t in range(1, n_frames):
        gain[t] = 0.6 * gain[t] + 0.4 * gain[t - 1]
    spec *= gain

    out = np.zeros(len(y))
    norm = np.zeros(len(y))
    rec = np.fft.irfft(spec, n=n_fft, axis=-1) * window
    for t in range(n_frames):
        out[t * hop : t * hop + n_fft] += rec[t]
        norm[t * hop : t * hop + n_fft] += window ** 2
    out /= np.maximum(norm, 1e-8)
    return out[pad:-pad].astype(np.float32)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.denoise")
    parser.add_argument("--in_dir", default="./raw_audio")
    parser.add_argument("--out_dir", default="./denoised_audio")
    parser.add_argument("--sr", type=int, default=22050)
    parser.add_argument("--method", choices=["auto", "demucs", "spectral"],
                        default="auto")
    args = parser.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.data.audio import (
        load_wav, resample, save_wav, to_mono,
    )

    have_demucs = shutil.which("demucs") is not None
    method = args.method
    if method == "auto":
        method = "demucs" if have_demucs else "spectral"
    if method == "demucs" and not have_demucs:
        raise SystemExit("demucs not installed; use --method spectral")

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.in_dir)):
        if not name.lower().endswith(".wav"):
            continue
        path = os.path.join(args.in_dir, name)
        if method == "demucs":
            subprocess.run(["demucs", "--two-stems", "vocals", path], check=True)
            stem = os.path.join(
                "separated", "htdemucs", os.path.splitext(name)[0], "vocals.wav"
            )
            wav, sr = load_wav(stem)
            mono = to_mono(wav)
        else:
            wav, sr = load_wav(path)
            mono = spectral_gate(to_mono(wav), sr)
        save_wav(os.path.join(args.out_dir, name), resample(mono, sr, args.sr),
                 args.sr)
        n += 1
    print(f"denoised {n} files ({method}) → {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
