"""The PyTorch port's serving engine and text frontend on the CPU, and the
port's isolation from JAX.

* The frontend is the port's own copy of the JAX package's ``text``: both
  must map the same sentences to the same ids.
* ``TTSEngine(device="cpu")`` with random weights: true-length outputs,
  batch-invariant audio (the Generator's per-stage re-masking), chunking of
  over-long input, speaker lookup, seeded noise.  ``TTSEngine()`` defaults
  to the card and raises where there is none.
* No module of the port, and nothing in ``chip_smoke.py``, imports
  ``jax``, ``flax`` or the JAX package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu import text as jax_text
from personalized_text_to_speech_tpu_torch import text as port_text
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import (
    TTSEngine,
    _chunk_ids,
    _next_bucket,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "personalized_text_to_speech_tpu_torch"

SENTENCES = [
    "[EN]Hello world, this is a test.[EN]",
    "[EN]It costs $3.50 on Jan. 2nd, 2024![EN]",
    "[ZH]你好，世界。今天天气很好。[ZH]",
    "[ZH]我有3个苹果和12本书。[ZH]",
    "[JA]こんにちは、世界。[JA]",
    "[JA]東京は日本の首都です。[JA]",
    "[KO]안녕하세요 세계.[KO]",
    "[ZH]我爱你[ZH][EN]I love you.[EN][JA]愛してる[JA]",
]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_frontend_copy_matches_jax_package(sentence):
    symbols = list(port_text.SYMBOLS)
    assert symbols == list(jax_text.SYMBOLS)
    want = jax_text.text_to_sequence(sentence, symbols, ["cjke_cleaners2"])
    got = port_text.text_to_sequence(sentence, symbols, ["cjke_cleaners2"])
    assert got == want and len(got) > 0
    assert port_text.intersperse(got, 0) == jax_text.intersperse(want, 0)


@pytest.fixture(scope="module")
def engine():
    return TTSEngine(tiny_model_config(), device="cpu", seed=7)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTSEngine(tiny_model_config())


def test_engine_weights_follow_seed():
    a = TTSEngine(tiny_model_config(), device="cpu", seed=3).model.state_dict()
    b = TTSEngine(tiny_model_config(), device="cpu", seed=3).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_buckets_and_chunks():
    assert _next_bucket(5, [16, 32]) == 16
    assert _next_bucket(17, [16, 32]) == 32
    assert _next_bucket(99, [16, 32]) == 32
    assert _chunk_ids(list(range(5)), 2) == [[0, 1], [2, 3], [4]]


def test_tts_true_length(engine):
    sr, wav = engine.tts("Hello there.", speaker=0, language="English", rng=1)
    assert sr == 8000
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    ids = engine.text_to_ids("Hello there.", "English")
    wav_dev, y_len = engine.submit_ids([ids], [0], rng=1)
    n = int(y_len[0])
    assert 1 <= n <= wav_dev.shape[1] // engine.hop_length
    assert len(wav) == n * engine.hop_length
    np.testing.assert_array_equal(wav, wav_dev[0, : len(wav)].numpy())
    assert not wav_dev[0, len(wav):].any()  # canvas past the length is zero


def test_batch_gives_each_utterance_its_audio_alone(engine):
    """Zero noise makes synthesis deterministic; the short utterance then
    decodes on a larger frame canvas inside the batch than alone, and the
    Generator's re-masking keeps its audio the same (to fp32 rounding of
    convolutions over another canvas length)."""
    kw = dict(noise_scale=0.0, noise_scale_w=0.0)
    short = engine.text_to_ids("Hi.", "English")
    long = engine.text_to_ids("This one is a good deal longer.", "English")
    alone = [engine.synthesize_ids([s], [i], **kw)[0]
             for i, s in enumerate((short, long))]
    batch = engine.synthesize_ids([short, long], [0, 1], **kw)
    _, lens_alone = engine.submit_ids([short], [0], **kw)
    wav_batch, _ = engine.submit_ids([short, long], [0, 1], **kw)
    assert wav_batch.shape[1] > _next_bucket(
        int(lens_alone[0]), engine.frame_buckets) * engine.hop_length
    for a, b in zip(alone, batch):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_overlong_input_is_chunked_not_dropped(engine):
    cap = engine.text_buckets[-1]
    ids = (engine.text_to_ids("One two three four five six.", "English") * 8)
    assert len(ids) > cap
    kw = dict(noise_scale=0.0, noise_scale_w=0.0)
    (whole,) = engine.synthesize_ids([ids], [0], **kw)
    pieces = [engine.synthesize_ids([p], [0], **kw)[0]
              for p in _chunk_ids(ids, cap)]
    assert len(whole) == sum(len(p) for p in pieces)
    np.testing.assert_allclose(whole, np.concatenate(pieces), rtol=0, atol=1e-6)


def test_speaker_lookup(engine):
    assert engine.speaker_id("alice") == 0
    assert engine.speaker_id("bob") == 1
    assert engine.speaker_id("3") == 3
    assert engine.speaker_id(2) == 2
    with pytest.raises(KeyError):
        engine.speaker_id("nobody")
    _, a = engine.tts("Same words.", speaker="bob", language="English", rng=5)
    _, b = engine.tts("Same words.", speaker=1, language="English", rng=5)
    _, c = engine.tts("Same words.", speaker=0, language="English", rng=5)
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)


def test_seeded_noise(engine):
    _, a = engine.tts("Seeded.", speaker=0, language="English", rng=9)
    _, b = engine.tts("Seeded.", speaker=0, language="English", rng=9)
    _, c = engine.tts("Seeded.", speaker=0, language="English", rng=10)
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)


def test_symbol_input_skips_cleaners(engine):
    ids = engine.text_to_ids("həlˈoʊ", is_symbol=True)
    assert ids == port_text.intersperse(
        port_text.cleaned_text_to_sequence("həlˈoʊ", engine.symbols), 0
    )


# --------------------------------------------------------------------------
# isolation from JAX
# --------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "personalized_text_to_speech_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import personalized_text_to_speech_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, *loaded = proc.stdout.split("\n")
    assert int(n_mods) >= 20
    assert not [m for m in loaded if _forbidden(m)]
