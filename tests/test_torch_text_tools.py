"""The port's text-coverage tools against the JAX package's, in process.

``tools.eval_g2p``, ``tools.eval_zh_coverage`` and ``tools.eval_ja_coverage``
run against the port's own ``text/`` and read the JAX tools' goldens
(``tools/*_goldens.tsv``).  On the goldens (``--accuracy``) and on the
coverage corpora (a small English corpus file; jieba's dictionary; the
embedded kanji ranking) each prints exactly what its JAX tool prints: the
JSON line and the lines around it.
"""

import json
import os

import pytest

from personalized_text_to_speech_tpu_torch.tools import (
    eval_g2p,
    eval_ja_coverage,
    eval_zh_coverage,
)
from tests.test_torch_offline_tools import jax_tool, run

CORPUS = """\
The quick brown fox jumps over the lazy dog. Installing packages with pip
is easy; `pip install numpy` brings arrays. Tokenizers, vocoders and
spectrograms: the synthesizer's recipes rely on https://example.org docs.
Recursively unzipped archives overwhelmed the preprocessing pipelines.
"""

PORT = {"eval_g2p": eval_g2p, "eval_zh_coverage": eval_zh_coverage,
        "eval_ja_coverage": eval_ja_coverage}


@pytest.mark.parametrize("name,argv", [
    ("eval_g2p", ["--accuracy"]),
    ("eval_g2p", ["--corpus", "{corpus}", "--top", "5"]),
    ("eval_zh_coverage", ["--accuracy"]),
    ("eval_zh_coverage", ["--top", "5"]),
    ("eval_ja_coverage", ["--accuracy"]),
    ("eval_ja_coverage", ["--top", "5"]),
], ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_tool_prints_what_the_jax_tool_prints(name, argv, tmp_path,
                                              monkeypatch, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS, encoding="utf-8")
    argv = [a.format(corpus=corpus) for a in argv]
    jax_mod = jax_tool(name)
    assert os.path.samefile(PORT[name].GOLDENS_PATH, jax_mod.GOLDENS_PATH)
    _, want = run(jax_mod.main, argv, monkeypatch, capsys)
    PORT[name].main(argv)
    got = capsys.readouterr().out
    assert got == want
    lines = [json.loads(line) for line in got.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["metric"]
