"""Measure the builtin English G2P's lexicon coverage on real text: the
port's counterpart of ``tools/eval_g2p.py``, run against the port's own
``text/english.py``, with the same flags, goldens and JSON line.

The reference resolves every English word through the full ``eng_to_ipa``
dictionary (reference text/english.py:160-166); this environment has no such
dependency, so our frontend uses a curated lexicon + letter-to-sound rules.
This tool quantifies that tradeoff on realistic prose: the fraction of word
tokens (and distinct words) that hit the lexicon vs fall through to LTS,
plus the highest-frequency fallback words (candidates for lexicon tranches).

Corpus: ``--corpus FILE...`` or, with no args, the long-description
METADATA of every package installed in the interpreter's site-packages
(real English prose, available offline).

    python -m personalized_text_to_speech_tpu_torch.tools.eval_g2p
    python -m personalized_text_to_speech_tpu_torch.tools.eval_g2p --top 40
    python -m personalized_text_to_speech_tpu_torch.tools.eval_g2p --accuracy
"""

import argparse
import glob
import json
import os
import re
import site
from pathlib import Path
from typing import Optional, Sequence

WORD_RE = re.compile(r"[a-z']+")
# markdown/rst/code punctuation stripped before word extraction
CODE_RE = re.compile(r"```.*?```|`[^`]*`|\bhttps?://\S+", re.S)


def default_corpus_text() -> str:
    """Aggregate long_description prose from installed package metadata."""
    texts = []
    paths = []
    for directory in site.getsitepackages():
        paths += sorted(glob.glob(os.path.join(directory, "*.dist-info",
                                               "METADATA")))
    for path in paths:
        try:
            raw = open(path, encoding="utf-8", errors="ignore").read()
        except OSError:
            continue
        # body after the header block is the README/long description
        body = raw.split("\n\n", 1)
        if len(body) == 2:
            texts.append(body[1])
    return "\n".join(texts)


# the hand-verified goldens the JAX package's tools read, beside them
GOLDENS_DIR = Path(__file__).resolve().parents[2] / "tools"
GOLDENS_PATH = str(GOLDENS_DIR / "g2p_goldens.tsv")


def load_goldens(path=GOLDENS_PATH):
    """[(word, gold_ipa, expected_resolver)] from the hand-verified table."""
    rows = []
    for line in open(path, encoding="utf-8"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        word, gold, resolver = line.split("\t")
        rows.append((word, gold, resolver))
    return rows


def _strip_stress(ipa: str) -> str:
    return ipa.replace("ˈ", "").replace("ˌ", "")


def measure_accuracy(E, verbose=False):
    """Word-accuracy of the fallback pipeline (morph→compound→LTS) on
    the goldens.  Returns (correct, total, failures)."""
    correct, total, failures = 0, 0, []
    for word, gold, resolver in load_goldens():
        assert word not in E._LEXICON, (
            f"golden '{word}' is in the lexicon — it no longer measures the "
            f"fallback path; remove it or pick another word"
        )
        morphed = E._morph_word(word)
        compounded = None if morphed else E._compound_word(word)
        got = morphed or compounded or E._lts_word(word)
        got_via = ("morph" if morphed
                   else "compound" if compounded else "lts")
        total += 1
        if _strip_stress(got) == _strip_stress(gold):
            correct += 1
        else:
            failures.append((word, gold, got, got_via, resolver))
    if verbose:
        for word, gold, got, got_via, resolver in failures:
            print(f"FAIL {word:14s} gold={gold:16s} got={got:16s} "
                  f"(via {got_via}, expected {resolver})")
    return correct, total, failures


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_g2p")
    ap.add_argument("--corpus", nargs="*", default=None,
                    help="text files (default: installed-package metadata)")
    ap.add_argument("--top", type=int, default=0,
                    help="print the N most frequent fallback words")
    ap.add_argument("--accuracy", action="store_true",
                    help="measure fallback G2P word accuracy on the "
                         "hand-verified goldens (tools/g2p_goldens.tsv)")
    ap.add_argument("--max-words", type=int, default=200000)
    args = ap.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.text import english as E

    if args.accuracy:
        correct, total, failures = measure_accuracy(E, verbose=True)
        print(json.dumps({
            "metric": "english fallback G2P word accuracy (hand goldens)",
            "correct": correct,
            "total": total,
            "accuracy": round(correct / max(total, 1), 4),
        }))
        return

    if args.corpus:
        text = "\n".join(
            open(p, encoding="utf-8", errors="ignore").read()
            for p in args.corpus
        )
    else:
        text = default_corpus_text()
    text = CODE_RE.sub(" ", text).lower()

    tokens = WORD_RE.findall(text)[: args.max_words]
    total = 0
    morph_tokens = 0
    compound_tokens = 0
    spelled_tokens = 0
    miss_tokens = 0
    freq = {}
    miss_freq = {}
    for tok in tokens:
        word = tok.replace("'", "")
        if not word:
            continue
        total += 1
        freq[word] = freq.get(word, 0) + 1
        if word in E._LEXICON:
            continue
        if len(word) > 1 and not any(c in "aeiouy" for c in word):
            spelled_tokens += 1  # initialism — spelled as letter names
            continue
        if E._morph_word(word) is not None:
            morph_tokens += 1  # inflection of a lexicon stem — covered
            continue
        if E._compound_word(word) is not None:
            compound_tokens += 1  # closed compound of lexicon parts
            continue
        miss_tokens += 1
        miss_freq[word] = miss_freq.get(word, 0) + 1

    types = len(freq)
    miss_types = len(miss_freq)
    out = {
        "metric": "english G2P lexicon coverage (builtin fallback)",
        "corpus_word_tokens": total,
        "distinct_words": types,
        "lexicon_size": len(E._LEXICON),
        "morph_token_rate": round(morph_tokens / max(total, 1), 4),
        "compound_token_rate": round(compound_tokens / max(total, 1), 4),
        "spelled_token_rate": round(spelled_tokens / max(total, 1), 4),
        "oov_token_rate": round(miss_tokens / max(total, 1), 4),
        "oov_type_rate": round(miss_types / max(types, 1), 4),
        "lts_fallback_tokens": miss_tokens,
    }
    print(json.dumps(out))
    if args.top:
        top = sorted(miss_freq.items(), key=lambda kv: -kv[1])[: args.top]
        for w, c in top:
            print(f"{c:6d}  {w:24s} {E._lts_word(w)}")


if __name__ == "__main__":
    main()
