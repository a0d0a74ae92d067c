"""The port's on-device spectrogram (``ops/spectrogram.py``) against the JAX
package's, on the same waveforms.

Both build the same numpy constants (Slaney filterbank, Hann-windowed DFT
bases) and take the windowed DFT as a matrix product, so the filterbank
must be equal bit for bit and the spectrograms agree to fp32 rounding of
sums in another order: 1e-4 absolute on waveforms of amplitude ≤ 0.6
(linear magnitudes up to ~150 at n_fft 1024), and on the log-mels.
"""

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.ops import spectrogram as jax_spec
from personalized_text_to_speech_tpu_torch.ops import spectrogram as port_spec

torch.set_num_threads(2)

TOL = 1e-4

# (sampling rate, n_fft, hop, win, n_mels): the train tests' tiny setup,
# the port's tiny config, and the fine-tuning config's analysis
CONFIGS = {
    "tiny-64": (800, 64, 8, 64, 20),
    "tiny-256": (8000, 256, 64, 256, 20),
    "full-1024": (22050, 1024, 256, 1024, 80),
}


def _configs(name):
    sr, n_fft, hop, win, n_mels = CONFIGS[name]
    kw = dict(sampling_rate=sr, n_fft=n_fft, hop_length=hop, win_length=win,
              n_mels=n_mels)
    return jax_spec.MelConfig(**kw), port_spec.MelConfig(**kw)


def _wav(hop, frames, seed=0):
    """Two utterances of sines plus noise, whole hops long."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames * hop) / (frames * hop)
    wav = np.stack([0.4 * np.sin(2 * np.pi * 37 * t),
                    0.3 * np.sin(2 * np.pi * 91 * t + 1.0)])
    return (wav + 0.05 * rng.normal(size=wav.shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_filterbank_equals_jax(name):
    jcfg, _ = _configs(name)
    args = (jcfg.sampling_rate, jcfg.n_fft, jcfg.n_mels, jcfg.fmin, jcfg.fmax)
    np.testing.assert_array_equal(port_spec.mel_filterbank(*args),
                                  jax_spec.mel_filterbank(*args))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spectrograms_match_jax(name):
    jcfg, pcfg = _configs(name)
    wav = _wav(pcfg.hop_length, 40)
    want_lin = np.array(jax_spec.linear_spectrogram(wav, jcfg))
    want_mel = np.asarray(jax_spec.spec_to_mel(want_lin, jcfg))
    want_full = np.asarray(jax_spec.mel_spectrogram(wav, jcfg))
    lin = port_spec.linear_spectrogram(torch.from_numpy(wav), pcfg)
    assert lin.shape == (2, 40, pcfg.n_freq) and lin.dtype == torch.float32
    np.testing.assert_allclose(lin.numpy(), want_lin, rtol=0, atol=TOL)
    mel = port_spec.spec_to_mel(torch.from_numpy(want_lin), pcfg)
    np.testing.assert_allclose(mel.numpy(), want_mel, rtol=0, atol=TOL)
    full = port_spec.mel_spectrogram(torch.from_numpy(wav), pcfg)
    np.testing.assert_allclose(full.numpy(), want_full, rtol=0, atol=TOL)


def test_spectrogram_stays_fp32_under_autocast():
    """Inside the step's bf16 autocast region the spectrogram must neither
    round to bf16 nor change: it leaves autocast."""
    _, pcfg = _configs("tiny-256")
    wav = torch.from_numpy(_wav(pcfg.hop_length, 24, seed=1))
    want = port_spec.mel_spectrogram(wav, pcfg)
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        got = port_spec.mel_spectrogram(wav.bfloat16(), pcfg)
    assert got.dtype == torch.float32
    # the input itself was rounded to bf16 (8 bits): compare loosely, then
    # exactly on the same rounded input outside autocast
    assert torch.equal(got, port_spec.mel_spectrogram(wav.bfloat16().float(), pcfg))
    assert (got - want).abs().max() < 0.1


def test_gradient_flows_through_mel():
    """The mel loss back-propagates into the generated waveform."""
    _, pcfg = _configs("tiny-64")
    wav = torch.from_numpy(_wav(pcfg.hop_length, 16)).requires_grad_(True)
    port_spec.mel_spectrogram(wav, pcfg).abs().mean().backward()
    assert wav.grad is not None and torch.isfinite(wav.grad).all()
    assert wav.grad.abs().max() > 0
