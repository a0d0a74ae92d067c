"""The port's bf16 and PCM16 serving modes on the CPU.

* bf16: the port runs its model under ``torch.autocast(bfloat16)`` (the
  train step's policy), the JAX package builds its modules with
  ``dtype=bfloat16``.  The two policies round in different places, so the
  port's bf16 decode is held to JAX's bf16 decode within twice the gap that
  JAX's own bf16 decode shows against its fp32 decode on the same inputs
  (measured here and printed).  Both decodes are fed the fp32 encode's
  ``w_ceil``: a bf16 ``logw`` next to an integer moves a frame count, and
  with it the whole waveform.
* PCM16: ``pcm16=True`` quantizes on the device; the result equals the
  float path clipped to [-1, 1], scaled by 32767 and truncated toward zero,
  exactly, in fp32 and in bf16; ``collect`` brings it back as float by
  dividing by 32767.
"""

import jax
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.config import tiny_model_config as jax_tiny
from personalized_text_to_speech_tpu.models.synthesizer import (
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine, to_pcm16
from tests.test_torch_vc import carried_weights

torch.set_num_threads(2)

B, T_TEXT, MAX_LEN = 2, 16, 128
X_LENGTHS = np.array([16, 11], np.int32)
SID = np.array([1, 3], np.int32)


@pytest.fixture(scope="module")
def models():
    """JAX fp32 and bf16 models on one set of params, and fp32 and bf16
    port engines carrying the same weights."""
    jm32 = JaxSynth.from_hparams(jax_tiny())
    jm16 = JaxSynth.from_hparams(jax_tiny(), dtype=jax.numpy.bfloat16)
    params, state = carried_weights(jm32)
    engines = {dt: TTSEngine(tiny_model_config(), state_dict=state,
                             device="cpu", dtype=dt)
               for dt in ("float32", "bfloat16")}
    return jm32, jm16, params, engines


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.integers(1, 60, size=(B, T_TEXT)).astype(np.int32),
        dp_noise=rng.normal(size=(B, T_TEXT, 2)).astype(np.float32),
        prior_noise=rng.normal(size=(B, MAX_LEN, 8)).astype(np.float32),
    )


def _jax_render(jm):
    """Jitted: encode, then decode with the ``w_ceil`` given →
    ``(own w_ceil, wav, y_lengths)``."""
    def run(params, x, dp_noise, prior_noise, w_ceil):
        own, m_p, logs_p, x_mask = jm.apply(params, x, X_LENGTHS, SID,
                                            dp_noise=dp_noise,
                                            method=jm.infer_encode)
        wav, y_len = jm.apply(params, w_ceil, m_p, logs_p, x_mask, SID,
                              max_len=MAX_LEN, prior_noise=prior_noise,
                              method=jm.infer_decode)
        return own, wav.astype(jax.numpy.float32), y_len
    return jax.jit(run)


def test_bf16_decode_within_twice_jax_own_bf16_gap(models, inputs):
    jm32, jm16, params, engines = models
    args = (params, inputs["x"], inputs["dp_noise"], inputs["prior_noise"])
    render32 = _jax_render(jm32)
    w_ceil = np.array(render32(*args, np.zeros((B, T_TEXT), np.float32))[0])
    _, want32, y_len = map(np.asarray, render32(*args, w_ceil))
    _, want16, y_len16 = map(np.asarray, _jax_render(jm16)(*args, w_ceil))
    np.testing.assert_array_equal(y_len16, y_len)
    assert (y_len < MAX_LEN).all(), "the canvas must not saturate"
    jax_gap = np.abs(want16 - want32).max()

    eng = engines["bfloat16"]
    with torch.no_grad(), eng._autocast():
        enc = eng.model.infer_encode(
            torch.from_numpy(inputs["x"]).long(), torch.from_numpy(X_LENGTHS),
            torch.from_numpy(SID), dp_noise=torch.from_numpy(inputs["dp_noise"]))
        wav, got_len = eng.model.infer_decode(
            torch.from_numpy(w_ceil), *enc[1:], torch.from_numpy(SID),
            max_len=MAX_LEN, prior_noise=torch.from_numpy(inputs["prior_noise"]))
    got = wav.float().numpy()
    np.testing.assert_array_equal(got_len.numpy(), y_len)
    port_gap = np.abs(got - want16).max()
    print(f"bf16: JAX bf16 against JAX fp32 {jax_gap:.3e}; port bf16 against "
          f"JAX bf16 {port_gap:.3e}; wav max {np.abs(want32).max():.3e}")
    assert 0 < jax_gap < 0.1 * np.abs(want32).max()
    assert port_gap <= 2 * jax_gap


def test_bf16_engine_serves_float32_audio(models):
    eng = models[3]["bfloat16"]
    sr, wav = eng.tts("Hello there.", speaker="alice", language="English", rng=2)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    assert len(wav) > 0 and len(wav) % eng.hop_length == 0
    pieces = [w for _, w in eng.stream_tts("Hello there.", speaker="alice",
                                           language="English", rng=2,
                                           chunk_frames=16, halo_frames=40)]
    assert sum(len(p) for p in pieces) == len(wav)


def test_dtype_is_checked():
    with pytest.raises(ValueError, match="dtype"):
        TTSEngine(tiny_model_config(), device="cpu", dtype="float16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pcm16_is_the_clipped_truncated_float_path(models, dtype):
    eng = models[3][dtype]
    ids = [eng.text_to_ids(t, "English") for t in ("Hello there.", "Bye now.")]
    floats = eng.synthesize_ids(ids, [0, 1], rng=4)
    pcm = eng.synthesize_ids(ids, [0, 1], rng=4, pcm16=True)
    for f, p in zip(floats, pcm):
        assert p.dtype == np.int16
        np.testing.assert_array_equal(
            p, (np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))
    handle = eng.submit_ids(ids, [0, 1], rng=4, pcm16=True)
    assert handle[0].dtype == torch.int16
    for f, p in zip(eng.collect(handle, eng.hop_length), pcm):
        assert f.dtype == np.float32
        np.testing.assert_array_equal(f, p.astype(np.float32) / 32767.0)


def test_pcm16_clips_and_truncates_toward_zero():
    x = np.array([1.5, -2.0, 0.99999, -0.99999, 0.5 / 32767, -1.7 / 32767,
                  2.9 / 32767, 0.0], np.float32)
    got = to_pcm16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.array([32767, -32767, 32766, -32766, 0, -1, 2, 0], np.int16))
    bf = to_pcm16(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.int16  # rounds the bf16 values, not the path
