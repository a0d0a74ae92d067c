"""The port's streaming, long-form and one-call serving paths on the CPU,
held to the port's own two-stage render (``tests/test_engine.py:232-263,
319-345`` hold the JAX engine the same way).

One engine at the tiny geometry of ``tiny_model_config()``: random weights
from a seed, the all-zero tensors (the flows' last layers) redrawn so no
flow is the identity and the seams cross the flow's full reach.

* ``stream_tts``: the pieces concatenate to ``tts`` with the same seed
  within 2e-4 (the JAX engine's seam bound); the first piece is one chunk;
  text past the largest bucket streams piece by piece.
* ``stream_long_form``: sentence order, with and without chunks.
* ``long_form``: the sentences of one batch joined by the pauses.
* ``tts_low_latency``: ``model.infer`` with the same draws, exactly; a
  saturated canvas and over-bucket text fall back to ``tts`` exactly.
"""

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import (
    TTSEngine,
    _chunk_ids,
    _next_bucket,
)

torch.set_num_threads(2)

SEAM_TOL = 2e-4
OVER_BUCKET = "One two three four five six seven eight nine ten eleven."


@pytest.fixture(scope="module")
def engine():
    eng = TTSEngine(tiny_model_config(), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in eng.model.parameters():
            if not p.any():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return eng


@pytest.mark.parametrize("text,language,chunk,halo", [
    ("The quick brown fox.", "English", 24, 48),
    ("The quick brown fox.", "English", 16, 40),
    ("你好，世界。", "Chinese", 24, 48),
], ids=["en-24-48", "en-16-40", "zh-24-48"])
def test_stream_concatenates_to_tts(engine, text, language, chunk, halo):
    assert len(engine.text_to_ids(text, language)) <= engine.text_buckets[-1]
    _, full = engine.tts(text, speaker=1, language=language, rng=11)
    pieces = [w for _, w in engine.stream_tts(
        text, speaker=1, language=language, rng=11, chunk_frames=chunk,
        halo_frames=halo)]
    assert len(pieces) >= 2, "a seam test needs several chunks"
    assert all(len(p) == chunk * engine.hop_length for p in pieces[:-1])
    stream = np.concatenate(pieces)
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, rtol=0, atol=SEAM_TOL)


def test_stream_first_piece_is_one_chunk(engine):
    gen = engine.stream_tts(
        "Speech synthesis converts text into audible speech today.",
        speaker=1, language="English", rng=12, chunk_frames=16, halo_frames=32)
    sr, first = next(gen)
    assert sr == engine.sampling_rate
    assert len(first) == 16 * engine.hop_length
    assert sum(len(w) for _, w in gen) > 0


def test_over_bucket_text_streams_piece_by_piece(engine):
    """Zero noise makes each piece's audio independent of the draws, so the
    stream equals each bucket-sized piece rendered alone."""
    kw = dict(noise_scale=0.0, noise_scale_w=0.0)
    ids = engine.text_to_ids(OVER_BUCKET, "English")
    pieces = _chunk_ids(ids, engine.text_buckets[-1])
    assert len(pieces) == 2
    stream = np.concatenate([w for _, w in engine.stream_tts(
        OVER_BUCKET, speaker=0, language="English", chunk_frames=24,
        halo_frames=48, **kw)])
    alone = np.concatenate([engine.synthesize_ids([p], [0], **kw)[0]
                            for p in pieces])
    assert stream.shape == alone.shape
    np.testing.assert_allclose(stream, alone, rtol=0, atol=SEAM_TOL)


SENTENCES = ["One two.", "Three four five!", "Six?"]


@pytest.mark.parametrize("chunk", [None, 16], ids=["per-sentence", "chunked"])
def test_stream_long_form_keeps_sentence_order(engine, chunk):
    text = " ".join(SENTENCES)
    assert engine.split_sentences(text) == SENTENCES
    got = [w for _, w in engine.stream_long_form(
        text, speaker="alice", language="English", chunk_frames=chunk, rng=21)]
    if chunk is None:
        want = [engine.tts(s, speaker=0, language="English", rng=21)[1]
                for s in SENTENCES]
        assert len(got) == len(SENTENCES)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        want = [w for s in SENTENCES for _, w in engine.stream_tts(
            s, speaker=0, language="English", chunk_frames=chunk, rng=21)]
        assert len(got) == len(want) > len(SENTENCES)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pause_ms", [120.0, 0.0])
def test_long_form_is_the_batch_joined_by_pauses(engine, pause_ms):
    text = " ".join(SENTENCES)
    sr, wav = engine.long_form(text, speaker="bob", language="English",
                               pause_ms=pause_ms, rng=8)
    ids = [engine.text_to_ids(s, "English") for s in SENTENCES]
    pieces = engine.synthesize_ids(ids, [1] * len(ids), rng=8)
    pause = int(sr * pause_ms / 1000.0)
    assert len(wav) == sum(len(p) for p in pieces) + pause * (len(pieces) - 1)
    at = 0
    for i, p in enumerate(pieces):
        np.testing.assert_array_equal(wav[at:at + len(p)], p)
        at += len(p)
        if i < len(pieces) - 1:
            assert not wav[at:at + pause].any()
            at += pause


def test_low_latency_is_one_infer_call(engine):
    # the random weights give ~3.3 frames per token: a canvas of 5 per
    # token (85 frames → the 128 bucket) holds this text's 57
    text, per_token = "Hi there.", 5.0
    ids = engine.text_to_ids(text, "English")
    f_bucket = _next_bucket(int(len(ids) * per_token), engine.frame_buckets)
    t_bucket = _next_bucket(len(ids), engine.text_buckets)
    sr, got = engine.tts_low_latency(text, speaker="alice", language="English",
                                     frames_per_token=per_token, rng=5)
    x = torch.zeros((1, t_bucket), dtype=torch.long)
    x[0, : len(ids)] = torch.tensor(ids)
    with torch.no_grad():
        wav, y_len, _, _ = engine.model.infer(
            x, torch.tensor([len(ids)], dtype=torch.int32), torch.tensor([0]),
            max_len=f_bucket, generator=torch.Generator().manual_seed(5))
    n = int(y_len[0])
    assert n < f_bucket, "the canvas must not saturate here"
    np.testing.assert_array_equal(got, wav[0, : n * engine.hop_length].numpy())


@pytest.mark.parametrize("text,frames_per_token", [
    ("This sentence is long enough to saturate.", 0.05),
    (OVER_BUCKET, 2.5),
], ids=["saturated-canvas", "over-bucket"])
def test_low_latency_falls_back_to_tts(engine, text, frames_per_token):
    _, got = engine.tts_low_latency(text, speaker="bob", language="English",
                                    frames_per_token=frames_per_token, rng=6)
    _, want = engine.tts(text, speaker="bob", language="English", rng=6)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
