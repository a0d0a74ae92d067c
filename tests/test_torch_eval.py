"""The port's objective metrics and formant synthesizer against the JAX
package's, on the same signals (both are numpy/scipy on the host).

Two short sentences, one English and one Chinese, are synthesized by both
packages' ``formant.synthesize_text`` with a seed drawn from numpy, once
per speaker; the waveforms must agree to 1e-12 (they are the same float32
arithmetic) and the cleaned IPA exactly.  Each language's pair (speaker
``klatt_m`` as the reference, ``klatt_f`` as the synthesis) is scored by
both packages' ``evaluate_pair`` with and without DTW (every metric within
1e-9 relative), and both packages' ``pyin_f0`` and ``yin_f0`` give the same
voicing and F0 within 1e-9 relative.
"""

import dataclasses
import functools

import numpy as np
import pytest

from personalized_text_to_speech_tpu.data import formant as jax_formant
from personalized_text_to_speech_tpu.eval import metrics as jax_metrics
from personalized_text_to_speech_tpu_torch.data import formant
from personalized_text_to_speech_tpu_torch.eval import metrics

REL = 1e-9
WAV_TOL = 1e-12
SENTENCES = {
    "English": "A cup of tea.",
    "Chinese": "我喜欢喝热茶。",
}
SEEDS = {lang: int(s) for lang, s in zip(
    SENTENCES, np.random.default_rng(7).integers(0, 2 ** 16, size=len(SENTENCES)))}


@functools.lru_cache(maxsize=None)
def clips(language):
    """``{speaker: (port wav, port ipa, JAX wav, JAX ipa)}`` for the
    language's sentence."""
    out = {}
    for spk in ("klatt_m", "klatt_f"):
        kw = dict(language=language, speaker=spk, seed=SEEDS[language])
        out[spk] = (*formant.synthesize_text(SENTENCES[language], **kw),
                    *jax_formant.synthesize_text(SENTENCES[language], **kw))
    return out


@pytest.mark.parametrize("language", list(SENTENCES))
def test_formant_waveforms_match_jax(language):
    for spk, (wav, ipa, jwav, jipa) in clips(language).items():
        assert ipa == jipa, spk
        assert wav.dtype == jwav.dtype == np.float32
        assert wav.shape == jwav.shape and len(wav) > formant.SR // 4
        assert np.abs(wav.astype(np.float64) - jwav).max() <= WAV_TOL, spk


def _fields(table):
    return {k: dataclasses.astuple(v) for k, v in table.items()}


def test_formant_tables_are_the_same():
    assert _fields(formant.PHONES) == _fields(jax_formant.PHONES)
    assert _fields(formant.SPEAKERS) == _fields(jax_formant.SPEAKERS)
    text = "ˈɹidɪŋ bʊks, ʧa↑ ʃu↓."

    def parsed(mod):
        return [(None if p is None else dataclasses.astuple(p), d, a)
                for p, d, a in mod.parse_ipa(text)]

    assert parsed(formant) == parsed(jax_formant)


def _pair(language):
    c = clips(language)
    return c["klatt_m"][0], c["klatt_f"][0]


@pytest.mark.parametrize("use_dtw", [True, False], ids=["dtw", "no_dtw"])
@pytest.mark.parametrize("language", list(SENTENCES))
def test_evaluate_pair_matches_jax(language, use_dtw):
    ref, syn = _pair(language)
    got = metrics.evaluate_pair(ref, syn, formant.SR, use_dtw=use_dtw)
    want = jax_metrics.evaluate_pair(ref, syn, formant.SR, use_dtw=use_dtw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=0, err_msg=k)
    assert np.isfinite(got["MCD"]) and got["MCD"] > 0


@pytest.mark.parametrize("language", list(SENTENCES))
def test_pitch_trackers_match_jax(language):
    ref, _ = _pair(language)
    f0, voiced, prob = metrics.pyin_f0(ref, formant.SR)
    jf0, jvoiced, jprob = jax_metrics.pyin_f0(ref, formant.SR)
    np.testing.assert_array_equal(voiced, jvoiced)
    np.testing.assert_allclose(f0, jf0, rtol=REL, atol=0)
    np.testing.assert_allclose(prob, jprob, rtol=REL, atol=0)
    assert voiced.any()
    yf0, yvoiced = metrics.yin_f0(ref, formant.SR)
    jyf0, jyvoiced = jax_metrics.yin_f0(ref, formant.SR)
    np.testing.assert_array_equal(yvoiced, jyvoiced)
    np.testing.assert_allclose(yf0, jyf0, rtol=REL, atol=0)


def test_mfcc_and_stft_match_jax():
    ref, syn = _pair("English")
    np.testing.assert_allclose(metrics.mfcc_features(ref, formant.SR),
                               jax_metrics.mfcc_features(ref, formant.SR),
                               rtol=REL, atol=1e-12)
    np.testing.assert_allclose(metrics.stft_mag(syn, 1024, 256, 512),
                               jax_metrics.stft_mag(syn, 1024, 256, 512),
                               rtol=REL, atol=1e-12)
