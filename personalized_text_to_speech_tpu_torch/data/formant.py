"""Rule-based formant speech synthesizer (Klatt-style, numpy, offline).

Purpose: produce a *real* text↔audio training corpus in an environment with
no recorded speech and no network.  The reference's workflow assumes the
user records or uploads voice clips (reference ``README.md:50-70``,
``scripts/denoise_audio.py``); here the corpus is generated by an
independent source-filter synthesizer, so a fine-tuned VITS model must
genuinely learn alignment, duration, F0 and spectral envelope — and the
objective quality gates (``eval/metrics.py``: MCD/LSD/F0/MRSTFT) measure a
meaningful distance between model output and ground truth.

Design (classic cascade formant synthesis):

* input is CLEANED IPA text (the output of the package's own G2P, so the
  corpus is phonetically consistent with what the TTS model sees as input),
* each phone carries (duration, voicing, formant targets F1-F3, frication
  band, amplitude); targets interpolate linearly across phone boundaries
  for coarticulation,
* voiced source = anti-aliased sawtooth with jitter; F0 follows a
  declining utterance contour with per-phone accents,
* the source passes a cascade of three time-varying 2nd-order resonators
  (5 ms frames, biquad state carried across frames),
* fricatives/stops mix band-shaped noise; stops get closure + burst.

Speakers differ in base F0, formant scale (vocal-tract length) and rate.

The port's own copy of ``personalized_text_to_speech_tpu/data/formant.py``:
the same table, rules and draws, so both packages write the same corpus;
:func:`synthesize_text` cleans its text with the port's own G2P.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import signal

SR = 22050
FRAME = 110  # 5 ms @ 22.05 kHz


# --------------------------------------------------------------------------
# phone table: (F1, F2, F3, voiced, frication_band, kind)
# kind: V vowel, N nasal, L liquid/glide, F fricative, S stop, A affricate
# frication band: (low, high) Hz of shaped noise, or None
# --------------------------------------------------------------------------

@dataclass
class Phone:
    f1: float
    f2: float
    f3: float
    voiced: bool
    kind: str
    noise: Optional[Tuple[float, float]] = None
    dur: float = 0.08  # seconds, base


_V = lambda f1, f2, f3, dur=0.12: Phone(f1, f2, f3, True, "V", None, dur)

PHONES: Dict[str, Phone] = {
    # vowels (averaged adult targets)
    "i": _V(280, 2250, 2890), "ɪ": _V(400, 1920, 2560),
    "e": _V(450, 2050, 2700), "ɛ": _V(550, 1770, 2490),
    "æ": _V(690, 1660, 2490), "a": _V(710, 1100, 2540),
    "ɑ": _V(750, 940, 2540), "ɔ": _V(590, 880, 2540),
    "o": _V(460, 800, 2530), "ʊ": _V(470, 1160, 2680),
    "u": _V(310, 870, 2250), "ɯ": _V(300, 1300, 2250),
    "ʌ": _V(620, 1220, 2550), "ə": _V(500, 1400, 2500, 0.07),
    "ɚ": _V(490, 1350, 1690), "ɹ̩": _V(490, 1350, 1690),
    "y": _V(290, 1900, 2100), "ø": _V(450, 1600, 2200),
    "ɥ": _V(290, 1900, 2100, 0.06),
    # nasals
    "m": Phone(250, 1000, 2200, True, "N", None, 0.07),
    "n": Phone(250, 1500, 2500, True, "N", None, 0.07),
    "ŋ": Phone(250, 1200, 2300, True, "N", None, 0.08),
    "ɲ": Phone(250, 1800, 2500, True, "N", None, 0.07),
    # liquids / glides
    "l": Phone(360, 1300, 2800, True, "L", None, 0.06),
    "ɫ": Phone(380, 900, 2600, True, "L", None, 0.07),
    "ɹ": Phone(330, 1150, 1550, True, "L", None, 0.07),
    "r": Phone(330, 1300, 1900, True, "L", None, 0.05),
    "w": Phone(300, 700, 2200, True, "L", None, 0.06),
    "j": Phone(290, 2200, 2900, True, "L", None, 0.06),
    # fricatives
    "f": Phone(400, 1400, 2500, False, "F", (3500, 8500), 0.09),
    "v": Phone(300, 1300, 2400, True, "F", (3500, 8500), 0.06),
    "θ": Phone(400, 1500, 2600, False, "F", (4500, 9000), 0.08),
    "ð": Phone(300, 1400, 2500, True, "F", (4500, 9000), 0.05),
    "s": Phone(320, 1600, 2600, False, "F", (4800, 10000), 0.1),
    "z": Phone(300, 1500, 2500, True, "F", (4800, 10000), 0.07),
    "ʃ": Phone(300, 1800, 2500, False, "F", (2200, 7000), 0.1),
    "ʒ": Phone(300, 1700, 2400, True, "F", (2200, 7000), 0.07),
    "ç": Phone(300, 2000, 2700, False, "F", (3000, 8000), 0.08),
    "x": Phone(350, 1300, 2500, False, "F", (1500, 5000), 0.08),
    "h": Phone(500, 1400, 2500, False, "F", (500, 4000), 0.06),
    "ɸ": Phone(400, 1200, 2400, False, "F", (1000, 6000), 0.07),
    "ʂ": Phone(300, 1700, 2300, False, "F", (1800, 6000), 0.1),
    "ɕ": Phone(300, 2100, 2700, False, "F", (2800, 8000), 0.1),
    # stops (closure + burst handled in synthesis)
    "p": Phone(400, 1100, 2500, False, "S", (500, 3000), 0.08),
    "b": Phone(350, 1000, 2400, True, "S", (500, 3000), 0.06),
    "t": Phone(400, 1700, 2600, False, "S", (2500, 8000), 0.08),
    "d": Phone(350, 1700, 2600, True, "S", (2500, 8000), 0.06),
    "k": Phone(350, 1800, 2500, False, "S", (1200, 4000), 0.08),
    "g": Phone(300, 1800, 2500, True, "S", (1200, 4000), 0.06),
    "ʔ": Phone(400, 1400, 2500, False, "S", None, 0.04),
    # affricates
    "ʧ": Phone(300, 1800, 2500, False, "A", (2200, 7000), 0.1),
    "ʤ": Phone(300, 1800, 2500, True, "A", (2200, 7000), 0.08),
    "ʦ": Phone(320, 1600, 2600, False, "A", (4800, 10000), 0.09),
    "ʣ": Phone(320, 1600, 2600, True, "A", (4800, 10000), 0.08),
}

# cleaned-text modifiers and prosody marks handled by the parser
_MODIFIERS = set("ːˑ*#^`→↑↓⁼ʰ's̪ `")


@dataclass
class Speaker:
    base_f0: float = 120.0
    formant_scale: float = 1.0
    rate: float = 1.0
    jitter: float = 0.01


SPEAKERS = {
    "klatt_m": Speaker(base_f0=112.0, formant_scale=0.98, rate=1.0),
    "klatt_f": Speaker(base_f0=205.0, formant_scale=1.12, rate=1.05),
    "klatt_c": Speaker(base_f0=260.0, formant_scale=1.22, rate=1.1),
    "klatt_d": Speaker(base_f0=95.0, formant_scale=0.92, rate=0.92),
}


def parse_ipa(text: str) -> List[Tuple[Phone, float, float]]:
    """Cleaned IPA → [(phone, dur_s, f0_accent)].  Handles length marks,
    tone arrows (as accent multipliers), stress and pauses."""
    out: List[Tuple[Phone, float, float]] = []
    accent = 1.0
    i = 0
    while i < len(text):
        ch = text[i]
        nxt = text[i + 1] if i + 1 < len(text) else ""
        if ch in " ,.!?…—-;:\"'()":
            pause = 0.18 if ch in ".!?…" else (0.1 if ch in ",;:—" else 0.04)
            out.append((None, pause, accent))
            i += 1
            continue
        if ch == "↑":
            accent = 1.15
            i += 1
            continue
        if ch == "↓":
            accent = 0.85
            i += 1
            continue
        if ch == "→":
            accent = 1.0
            i += 1
            continue
        ph = PHONES.get(ch)
        if ph is None:
            i += 1  # modifier or unknown symbol: skip
            continue
        dur = ph.dur
        j = i + 1
        while j < len(text) and text[j] in "ːˑ":
            dur *= 1.6 if text[j] == "ː" else 1.3
            j += 1
        # geminate marker from JA sokuon (t#t etc.) lengthens closure
        if nxt == "#":
            dur *= 1.4
        out.append((ph, dur, accent))
        accent = 1.0 if accent != 1.0 and ph.kind == "V" else accent
        i = j
    return out


def _resonator_coefs(f: float, bw: float, sr: int = SR):
    """2nd-order resonator (Klatt): poles at f with bandwidth bw."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * f / sr
    a1 = -2 * r * np.cos(theta)
    a2 = r * r
    b0 = 1 - 2 * r * np.cos(theta) + r * r
    return np.array([b0, 0.0, 0.0]), np.array([1.0, a1, a2])


def synthesize(
    ipa: str,
    speaker: Speaker = None,
    seed: int = 0,
    sr: int = SR,
) -> np.ndarray:
    """Cleaned-IPA string → float32 waveform."""
    spk = speaker or SPEAKERS["klatt_m"]
    rng = np.random.default_rng(seed)
    seq = parse_ipa(ipa)
    if not seq:
        return np.zeros(sr // 10, dtype=np.float32)

    # frame-level target tracks
    f0_t, f1_t, f2_t, f3_t, voice_t, noise_lo, noise_hi, noise_amp = (
        [] for _ in range(8)
    )
    stop_burst: List[int] = []  # frame indices where a burst fires
    n_phones = sum(1 for p, _, _ in seq if p is not None)
    v_idx = 0
    for ph, dur, accent in seq:
        frames = max(int(dur / spk.rate * sr / FRAME), 1)
        if ph is None:  # silence
            for _ in range(frames):
                f0_t.append(0.0)
                f1_t.append(500.0)
                f2_t.append(1500.0)
                f3_t.append(2500.0)
                voice_t.append(0.0)
                noise_lo.append(0.0)
                noise_hi.append(0.0)
                noise_amp.append(0.0)
            continue
        # utterance F0 declination + accent
        pos = v_idx / max(n_phones - 1, 1)
        f0 = spk.base_f0 * (1.12 - 0.22 * pos) * accent
        v_idx += 1
        fs = spk.formant_scale
        if ph.kind == "S":
            closure = max(frames - 2, 1)
            for k in range(frames):
                is_burst = k >= closure
                f0_t.append(f0 if ph.voiced else 0.0)
                f1_t.append(ph.f1 * fs)
                f2_t.append(ph.f2 * fs)
                f3_t.append(ph.f3 * fs)
                voice_t.append(0.25 if ph.voiced else 0.0)
                if is_burst and ph.noise:
                    noise_lo.append(ph.noise[0])
                    noise_hi.append(ph.noise[1])
                    noise_amp.append(0.9)
                else:
                    noise_lo.append(0.0)
                    noise_hi.append(0.0)
                    noise_amp.append(0.0)
            stop_burst.append(len(f0_t) - (frames - closure))
            continue
        for _ in range(frames):
            f0_t.append(f0 * (1 + spk.jitter * rng.standard_normal()))
            f1_t.append(ph.f1 * fs)
            f2_t.append(ph.f2 * fs)
            f3_t.append(ph.f3 * fs)
            amp = {"V": 1.0, "N": 0.55, "L": 0.7, "F": 0.35, "A": 0.4}[
                ph.kind
            ]
            voice_t.append(amp if ph.voiced else 0.0)
            if ph.noise is not None:
                noise_lo.append(ph.noise[0])
                noise_hi.append(ph.noise[1])
                noise_amp.append(0.55 if not ph.voiced else 0.3)
            else:
                noise_lo.append(0.0)
                noise_hi.append(0.0)
                noise_amp.append(0.0)

    n_frames = len(f0_t)
    # smooth formant tracks for coarticulation (3-frame box, twice)
    def smooth(x):
        x = np.asarray(x, dtype=np.float64)
        k = np.ones(5) / 5.0
        for _ in range(2):
            x = np.convolve(x, k, mode="same")
        return x

    f1s, f2s, f3s = smooth(f1_t), smooth(f2_t), smooth(f3_t)
    f0s = np.asarray(f0_t)
    voices = smooth(voice_t)
    namp = smooth(noise_amp)

    n_samples = n_frames * FRAME
    # voiced source: band-limited sawtooth via cumulative phase
    phase = np.zeros(n_samples)
    f0_up = np.repeat(f0s, FRAME)
    np.cumsum(2 * np.pi * np.maximum(f0_up, 1.0) / sr, out=phase)
    saw = signal.sawtooth(phase)
    # glottal spectral tilt: one-pole lowpass
    saw = signal.lfilter([1.0], [1.0, -0.96], saw)
    saw /= max(np.abs(saw).max(), 1e-9)
    voiced_src = saw * np.repeat(voices, FRAME) * (f0_up > 0)

    white = rng.standard_normal(n_samples)

    out = np.zeros(n_samples)
    # cascade resonators, frame-varying; carry biquad state
    z1 = np.zeros(2)
    z2 = np.zeros(2)
    z3 = np.zeros(2)
    zn = np.zeros(2)
    for t in range(n_frames):
        s = slice(t * FRAME, (t + 1) * FRAME)
        frame_src = voiced_src[s]
        b1, a1 = _resonator_coefs(f1s[t], 60 + f1s[t] * 0.05)
        b2, a2 = _resonator_coefs(f2s[t], 90 + f2s[t] * 0.04)
        b3, a3 = _resonator_coefs(f3s[t], 150 + f3s[t] * 0.03)
        y, z1 = signal.lfilter(b1, a1, frame_src, zi=z1)
        y, z2 = signal.lfilter(b2, a2, y, zi=z2)
        y, z3 = signal.lfilter(b3, a3, y, zi=z3)
        out[s] += y * 18.0
        if namp[t] > 1e-3 and noise_hi[t] > 0:
            center = 0.5 * (noise_lo[t] + noise_hi[t])
            bw = max(noise_hi[t] - noise_lo[t], 200.0)
            bn, an = _resonator_coefs(min(center, sr / 2 - 500), bw)
            nz, zn = signal.lfilter(bn, an, white[s], zi=zn)
            out[s] += nz * namp[t] * 2.2
    # gentle highpass to remove rumble, then normalize
    b, a = signal.butter(2, 60.0 / (sr / 2), "highpass")
    out = signal.lfilter(b, a, out)
    peak = np.abs(out).max()
    out = out / max(peak, 1e-9) * 0.42
    # fade edges
    edge = min(256, n_samples // 4)
    env = np.ones(n_samples)
    env[:edge] = np.linspace(0, 1, edge)
    env[-edge:] = np.linspace(1, 0, edge)
    return (out * env).astype(np.float32)


def synthesize_text(
    text: str,
    language: str = "English",
    speaker: str = "klatt_m",
    seed: int = 0,
) -> Tuple[np.ndarray, str]:
    """Plain text → (waveform, cleaned IPA) through the package's own G2P
    (same cleaners the TTS model trains on)."""
    from personalized_text_to_speech_tpu_torch.text import _clean_text

    mark = {"English": "[EN]", "Chinese": "[ZH]", "Japanese": "[JA]"}[language]
    cleaned = _clean_text(f"{mark}{text}{mark}", ["cjke_cleaners2"])
    wav = synthesize(cleaned, SPEAKERS[speaker], seed=seed)
    return wav, cleaned
