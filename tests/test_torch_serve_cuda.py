"""The port's serving paths on the card against the same paths on the CPU
and against its own two-stage render.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_serve_cuda.py -m cuda --noconftest

At the tiny geometry of ``tiny_model_config()``, fp32 with TF32 off; one
set of random weights (zero tensors redrawn) on both devices.

* The stream seam on the card: ``stream_tts`` concatenates to ``tts`` with
  the same seed (the card's generator takes the same draws in the same
  order on both paths) within 1e-4 of the wav's largest value.
* Voice conversion, card against CPU: the same wav through
  ``vc_spectrogram`` on each device, then ``SynthesizerTrn.voice_conversion``
  with the same injected noise (the two devices' generators draw different
  numbers); spectrogram and waveform within 1e-4 of their largest values.
* bf16 and PCM16 on the card: finite audio; PCM16 equals the clipped,
  truncated float path exactly.
"""

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

REL_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's paths")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _engines(dtype="float32"):
    cpu = TTSEngine(tiny_model_config(), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in cpu.model.parameters():
            if not p.any():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    card = TTSEngine(tiny_model_config(), state_dict=cpu.model.state_dict(),
                     device="cuda", dtype=dtype)
    return card, cpu


def _assert_rel(got, want, name):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= REL_TOL * scale, f"{name}: {err} against {REL_TOL} x {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("text,language", [
    ("The quick brown fox.", "English"), ("你好，世界。", "Chinese")])
def test_stream_seam_on_the_card(cuda_device, text, language):
    card, _ = _engines()
    _, full = card.tts(text, speaker=1, language=language, rng=11)
    pieces = [w for _, w in card.stream_tts(text, speaker=1, language=language,
                                            rng=11, chunk_frames=24,
                                            halo_frames=48)]
    assert len(pieces) >= 2
    stream = np.concatenate(pieces)
    assert stream.shape == full.shape
    _assert_rel(stream, full, "stream against tts")


@pytest.mark.cuda
def test_voice_conversion_card_against_cpu(cuda_device):
    card, cpu = _engines()
    hop = card.hop_length
    t = np.arange(5000) / card.sampling_rate
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)
           + 0.1 * np.sin(2 * np.pi * 470 * t)).astype(np.float32)
    sr, out = card.voice_conversion(wav, "alice", "bob", rng=5)
    assert len(out) == (len(wav) // hop) * hop and np.isfinite(out).all()
    specs, wavs = {}, {}
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 128, card.model.inter_channels)).astype(np.float32))
    for eng in (card, cpu):
        spec, spec_len = eng.vc_spectrogram(wav)
        with torch.no_grad():
            o, _, _ = eng.model.voice_conversion(
                spec, torch.tensor([spec_len], device=eng.device),
                torch.tensor([0], device=eng.device),
                torch.tensor([1], device=eng.device),
                noise=noise.to(eng.device))
        specs[eng.device.type] = spec.cpu().numpy()
        wavs[eng.device.type] = o[0, : spec_len * hop].cpu().numpy()
    _assert_rel(specs["cuda"], specs["cpu"], "spectrogram")
    _assert_rel(wavs["cuda"], wavs["cpu"], "converted wav")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modes_on_the_card(cuda_device, dtype):
    card, _ = _engines(dtype)
    ids = [card.text_to_ids(t, "English") for t in ("Hello there.", "Bye now.")]
    floats = card.synthesize_ids(ids, [0, 1], rng=4)
    pcm = card.synthesize_ids(ids, [0, 1], rng=4, pcm16=True)
    for f, p in zip(floats, pcm):
        assert np.isfinite(f).all() and len(f) > 0
        np.testing.assert_array_equal(
            p, (np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))
    _, fused = card.tts_low_latency("Hello there.", language="English", rng=2)
    assert np.isfinite(fused).all() and len(fused) > 0
