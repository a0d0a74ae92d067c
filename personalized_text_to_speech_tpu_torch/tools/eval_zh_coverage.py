"""Frequency-weighted hanzi coverage of the standalone ZH G2P table: the
port's counterpart of ``tools/eval_zh_coverage.py``, run against the port's
own ``text/mandarin.py``, with the same flags, goldens and JSON line.

The reference gets full hanzi coverage from the ``pypinyin`` dependency
(reference ``text/mandarin.py:243-257``); this repo embeds its own table
(text/hanzi_pinyin_data.py).  This tool measures what fraction of real
Chinese text that table covers, using the bundled jieba dictionary
(~349k words with corpus frequencies, ~12k distinct hanzi) as a
frequency-weighted proxy corpus, and lists the top uncovered characters
to drive the next data tranche.

Note: jieba's dict contains a small amount of mojibake (GBK-as-UTF8
artifacts); the --top list needs a human filter before adding entries.

Usage:
    python -m personalized_text_to_speech_tpu_torch.tools.eval_zh_coverage [--top N]
    python -m personalized_text_to_speech_tpu_torch.tools.eval_zh_coverage --accuracy
"""

import argparse
import collections
import json
import os
from pathlib import Path
from typing import Optional, Sequence


def hanzi_frequencies():
    import jieba

    path = os.path.join(os.path.dirname(jieba.__file__), "dict.txt")
    freq = collections.Counter()
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            word, count = parts[0], int(parts[1])
            for ch in word:
                if "一" <= ch <= "鿿":
                    freq[ch] += count
    return freq


# the hand-verified goldens the JAX package's tools read, beside them
GOLDENS_DIR = Path(__file__).resolve().parents[2] / "tools"
GOLDENS_PATH = str(GOLDENS_DIR / "zh_goldens.tsv")

_PY_TOKEN_RE = None  # set lazily (needs the module import)


def load_goldens(path=GOLDENS_PATH):
    rows = []
    for line in open(path, encoding="utf-8"):
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        sentence, gold = line.split("\t")
        rows.append((sentence, gold))
    return rows


_FW_PUNCT = str.maketrans({"，": ",", "。": ".", "！": "!", "？": "?",
                           "—": "-"})
_TONE_MARKS = "ˉˊˇˋ˙"


def _gold_to_bopomofo(gold: str, M) -> str:
    """Gold token string → the bopomofo string ``chinese_to_bopomofo``
    would produce for a perfect resolution: pinyin words become
    concatenated syllable bopomofo separated by single spaces; punctuation
    attaches to the preceding word (matching the pipeline's joiner)."""
    import re as _re

    out = ""
    for tok in gold.split():
        sylls = _re.findall(r"[a-zü]+[0-5]", tok)
        if sylls and "".join(sylls) == tok:
            bopo = "".join(M.pinyin_syllable_to_bopomofo(s) for s in sylls)
            assert not _re.search(r"[a-z0-9]", bopo), (
                f"gold token {tok!r} did not fully convert: {bopo!r}")
            out += (" " if out else "") + bopo
        else:
            out += tok  # punctuation: attaches directly, like the pipeline
    return out


def _split_syllables(bopo_nospace: str):
    """Split a space-stripped bopomofo string into tone-terminated
    syllable units (trailing punctuation rides the following unit, or
    forms a final residue unit)."""
    import re as _re

    return _re.findall(
        rf"[^{_TONE_MARKS}]*[{_TONE_MARKS}]|[^{_TONE_MARKS}]+$", bopo_nospace
    )


def measure_accuracy(verbose=False):
    """Syllable/sentence accuracy of the fallback hanzi→reading path
    against the hand goldens, plus end-to-end IPA exactness through the
    full cjke_cleaners2 pipeline (``chinese_to_ipa``)."""
    import difflib

    from personalized_text_to_speech_tpu_torch.text import mandarin as M

    assert not M.hanzi_available() or True  # fallback path always measured
    syll_correct = syll_total = 0
    sent_exact = ipa_exact = total = 0
    failures = []
    for sentence, gold in load_goldens():
        total += 1
        got_bopo = M.chinese_to_bopomofo(
            M.number_to_chinese(sentence)
        ).translate(_FW_PUNCT)
        gold_bopo = _gold_to_bopomofo(gold, M)
        got_s = _split_syllables(got_bopo.replace(" ", ""))
        gold_s = _split_syllables(gold_bopo.replace(" ", ""))
        sm = difflib.SequenceMatcher(None, gold_s, got_s, autojunk=False)
        matched = sum(b.size for b in sm.get_matching_blocks())
        syll_correct += matched
        syll_total += len(gold_s)
        if gold_s == got_s:
            sent_exact += 1
        elif verbose:
            diffs = [
                (a, b) for a, b in
                zip(gold_s + ["∅"] * len(got_s), got_s + ["∅"] * len(gold_s))
                if a != b
            ][:4]
            failures.append((sentence, gold_bopo, got_bopo, diffs))
        # end-to-end IPA: full pipeline vs gold-derived (spaces stripped —
        # segmentation granularity is not an error)
        ipa_got = M.chinese_to_ipa(sentence).replace(" ", "")
        ipa_gold = M._ipa_glide_apical(
            M.bopomofo_to_ipa(gold_bopo)
        ).replace(" ", "")
        if ipa_got == ipa_gold:
            ipa_exact += 1
    if verbose:
        for sentence, gold_bopo, got_bopo, _diffs in failures:
            print(f"FAIL {sentence}\n  gold {gold_bopo}\n  got  {got_bopo}")
    return {
        "metric": "mandarin fallback G2P accuracy (hand goldens)",
        "sentences": total,
        "syllables": syll_total,
        "syllable_accuracy": round(syll_correct / max(syll_total, 1), 4),
        "sentence_exact": round(sent_exact / max(total, 1), 4),
        "ipa_sentence_exact": round(ipa_exact / max(total, 1), 4),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_zh_coverage")
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N most frequent uncovered hanzi")
    ap.add_argument("--accuracy", action="store_true",
                    help="measure fallback reading accuracy on the "
                         "hand-verified sentence goldens (zh_goldens.tsv)")
    args = ap.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.text import mandarin

    if args.accuracy:
        print(json.dumps(measure_accuracy(verbose=True),
                         ensure_ascii=False))
        return

    freq = hanzi_frequencies()
    table = mandarin._HANZI_PINYIN
    total = sum(freq.values())
    covered = sum(c for ch, c in freq.items() if ch in table)
    covered_types = sum(1 for ch in freq if ch in table)
    missing = [(ch, c) for ch, c in freq.most_common() if ch not in table]

    print(json.dumps({
        "metric": "mandarin hanzi coverage (builtin fallback)",
        "table_size": len(table),
        "corpus_distinct_hanzi": len(freq),
        "corpus_weighted_tokens": total,
        "token_coverage": round(covered / total, 5),
        "type_coverage": round(covered_types / len(freq), 4),
    }))
    for ch, c in missing[: args.top]:
        print(f"{c:>10}  {ch}  U+{ord(ch):04X}")


if __name__ == "__main__":
    main()
