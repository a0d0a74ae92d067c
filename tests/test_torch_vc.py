"""Voice conversion of the PyTorch port against the JAX package, at the
tiny geometry of ``tiny_model_config()`` on the CPU.

Weights: the port's random init, its all-zero tensors (the flows' last
layers) redrawn from a seed so no flow is the identity, carried into a flax
tree shaped by ``jax.eval_shape`` of the JAX init (the JAX package's
``torch_to_flax``), and back into the port's engine with the port's own
``flax_to_torch``, loaded strictly (:func:`carried_weights`; the other
``test_torch_*`` serving files use it too).  A traced init costs ~3 s where
an eager flax init of the whole model costs ~30 s.

* ``SynthesizerTrn.voice_conversion``: the same spectrogram, lengths,
  speakers and numpy posterior noise through both; waveform and latents
  within 1e-3 (the fp32 parity bound), the mask exactly.
* ``TTSEngine.voice_conversion`` against the JAX engine's procedure
  (``personalized_text_to_speech_tpu/infer/engine.py:727-777``): the wav cut
  to whole hops and zero-padded to its frame bucket, the JAX spectrogram,
  ``spec_len = n // hop``, the output cut to ``spec_len · hop``.  The noise
  is the port's own draw (one ``[1, C, f_bucket]`` normal from the call's
  CPU generator), recreated here and handed to JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.config import tiny_model_config as jax_tiny
from personalized_text_to_speech_tpu.models.synthesizer import (
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu.ops.spectrogram import (
    MelConfig as JaxMelConfig,
    linear_spectrogram as jax_linear_spectrogram,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.utils.torch_compat import flax_to_torch

torch.set_num_threads(2)

WAV_TOL = 1e-3
B, T_SPEC = 2, 40
Y_LENGTHS = np.array([40, 29], np.int32)
SID_SRC = np.array([0, 2], np.int32)
SID_TGT = np.array([3, 1], np.int32)


def carried_weights(jm, seed: int = 0):
    """The port's random init (zero tensors redrawn, N(0, 0.1)) as flax
    params for ``jm`` → ``(params, flax_to_torch(params))``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        state = SynthesizerTrn.from_hparams(tiny_model_config()).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    state = {k: v if v.any() else 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in state.items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        jm.init, {"params": key, "noise": key, "slice": key, "dropout": key},
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, T_SPEC, jm.spec_channels)), jnp.array([T_SPEC]),
        jnp.array([0]),
    )
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = jax_tc.torch_to_flax({k: v.numpy() for k, v in state.items()},
                                  template, strict=True)
    return params, flax_to_torch(params)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's engine carrying the same weights,
    the JAX model's ``voice_conversion`` jitted)."""
    jm = JaxSynth.from_hparams(jax_tiny())
    params, state = carried_weights(jm)
    engine = TTSEngine(tiny_model_config(), state_dict=state, device="cpu")
    vc = jax.jit(functools.partial(jm.apply, method=jm.voice_conversion))
    return jm, params, engine, vc


def _close(got, want, tol=WAV_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_model_voice_conversion_matches_jax(pair):
    jm, params, engine, vc = pair
    rng = np.random.default_rng(0)
    spec = np.abs(rng.normal(size=(B, T_SPEC, jm.spec_channels))).astype(np.float32)
    noise = rng.normal(size=(B, T_SPEC, jm.inter_channels)).astype(np.float32)
    want_o, want_mask, want_lat = vc(params, spec, Y_LENGTHS, SID_SRC, SID_TGT,
                                     noise=noise)
    with torch.no_grad():
        o, y_mask, lat = engine.model.voice_conversion(
            torch.from_numpy(spec), torch.from_numpy(Y_LENGTHS),
            torch.from_numpy(SID_SRC), torch.from_numpy(SID_TGT),
            noise=torch.from_numpy(noise),
        )
    assert o.shape == (B, T_SPEC * engine.hop_length)
    np.testing.assert_array_equal(y_mask.numpy(), np.asarray(want_mask))
    _close(o, want_o)
    for got, want in zip(lat, want_lat):  # z, z_p, z_hat
        _close(got, want)
    # past each length the output is silent, as in JAX
    assert not o[1, Y_LENGTHS[1] * engine.hop_length:].any()


def test_voice_conversion_needs_speakers():
    model = SynthesizerTrn.from_hparams(tiny_model_config(n_speakers=0))
    spec = torch.zeros(1, 8, model.spec_channels)
    with pytest.raises(AssertionError, match="speaker"):
        model.voice_conversion(spec, torch.tensor([8]), torch.tensor([0]),
                               torch.tensor([1]))


def _jax_engine_vc(pair, wav, src, tgt, noise):
    """The JAX engine's procedure (``engine.py:755-776``), noise given."""
    _, params, engine, vc = pair
    hop = engine.hop_length
    n = (len(wav) // hop) * hop
    f_bucket = next(b for b in engine.frame_buckets if max(n // hop, 1) <= b)
    padded = np.zeros((1, f_bucket * hop), dtype=np.float32)
    padded[0, :n] = wav[:n]
    spec = jax_linear_spectrogram(jnp.asarray(padded),
                                  JaxMelConfig.from_hparams(jax_tiny()))
    spec_len = np.asarray([n // hop], np.int32)
    o, _, _ = vc(params, spec, spec_len, np.asarray([src], np.int32),
                 np.asarray([tgt], np.int32), noise=noise)
    return np.asarray(o)[0, : int(spec_len[0]) * hop], f_bucket


# three lengths in the 128-frame bucket: one JAX compile
@pytest.mark.parametrize("n_samples", [5000, 70 * 64, 8000],
                         ids=["partial-hop", "whole-hops", "near-bucket-end"])
def test_engine_voice_conversion_matches_jax_engine(pair, n_samples):
    engine = pair[2]
    t = np.arange(n_samples) / engine.sampling_rate
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)
           + 0.1 * np.sin(2 * np.pi * 470 * t)).astype(np.float32)
    sr, got = engine.voice_conversion(wav, "alice", "bob", rng=5)
    assert sr == engine.sampling_rate
    hop = engine.hop_length
    assert len(got) == (n_samples // hop) * hop
    # the port's one draw: the posterior noise [1, C, f_bucket]
    f_bucket = next(b for b in engine.frame_buckets
                    if max(n_samples // hop, 1) <= b)
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn((1, engine.model.inter_channels, f_bucket),
                        generator=gen).numpy().transpose(0, 2, 1)
    want, want_bucket = _jax_engine_vc(pair, wav, 0, 1, noise)
    assert want_bucket == f_bucket
    _close(got, want)


def test_engine_vc_spectrogram_is_padded_to_the_bucket(pair):
    engine = pair[2]
    hop = engine.hop_length
    wav = np.random.default_rng(3).normal(size=70 * hop + 17).astype(np.float32)
    spec, spec_len = engine.vc_spectrogram(wav)
    assert spec_len == 70
    assert spec.shape == (1, 128, engine.model.spec_channels)  # bucket 128
    with pytest.raises(ValueError, match="frame bucket"):
        engine.voice_conversion(np.zeros(129 * hop, np.float32), 0, 1)


def test_serving_leaves_the_spectrogram_constants_usable_for_training(pair):
    """Voice conversion runs in inference mode and may be the first caller
    of the spectrogram in a process: the constants it caches on the device
    must still serve a train step's backward afterwards."""
    from personalized_text_to_speech_tpu_torch.ops import spectrogram as spec_ops

    engine = pair[2]
    spec_ops._basis_on.cache_clear()
    spec_ops._filterbank_on.cache_clear()
    engine.voice_conversion(np.zeros(2000, np.float32), 0, 1, rng=1)
    with torch.inference_mode():
        spec_ops.mel_spectrogram(torch.zeros(1, 2048), engine.mel_cfg)
    y = torch.randn(1, 2048, requires_grad=True)
    spec_ops.mel_spectrogram(y, engine.mel_cfg).sum().backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0
