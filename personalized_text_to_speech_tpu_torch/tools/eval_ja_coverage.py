"""Frequency-weighted kanji coverage of the standalone JA reading tables:
the port's counterpart of ``tools/eval_ja_coverage.py``, run against the
port's own ``text/japanese.py`` and ``text/kanji_kana_data.py``, with the
same flags, goldens and JSON line.

The reference reads kanji through ``pyopenjtalk``'s full dictionary
(reference ``text/japanese.py:74-112``); this repo embeds its own reading
tables (text/kanji_kana_data.py).  No Japanese corpus or dictionary exists
in this environment (pyopenjtalk/unidic/ipadic are not installed and there
is no network), so this tool embeds the well-known newspaper-frequency
kanji ranking (KANJIDIC frequency order, most→least frequent) as the proxy
corpus, Zipf-weighted (weight 1/rank).  The ordering of the embedded list
is approximate in the tail; the banded type-coverage numbers (top 100/250/
500) are robust to local ordering noise and are the headline metric.

A character counts as covered when it resolves STANDALONE — via
CHAR_READINGS, a single-char WORD entry, or a VERB_STEMS entry (stems fire
on the char's dominant verb/adjective use).  Characters reachable only
inside multi-char word keys are reported separately as context-only.

Usage:
    python -m personalized_text_to_speech_tpu_torch.tools.eval_ja_coverage [--top N]
    python -m personalized_text_to_speech_tpu_torch.tools.eval_ja_coverage --accuracy
"""

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

# KANJIDIC newspaper-frequency ranking, most frequent first (top ~500).
_RANKED = (
    "日一国会人年大十二本中長出三同時政事自行社見月分議後前民生連五発間"
    "対上部東者党地合市業内相方四定今回新場金員九入選立開手米力学問高代"
    "明実円関決子動京全目表戦経通外最言氏現理調体化田当八六約主題下首意"
    "法不来作性的要用制治度務強気小七成期公持野協取都和統以機平総加山思"
    "家話世受区領多県続進正安設保改数記院女初北午指権心界支第産結百派点"
    "教報済書府活原先共得解名交資予川向際査勝面委告軍文反元重近千考判認"
    "画海参売利組知案道信策集在件団別物側任引使求所次水半品昨論計死官増"
    "係感特情投示変打男基私各始島直両朝革価式確村提運終挙果西勢減台広容"
    "必応演電歳住争談能無再位置企真流格有疑口過局少放税検藤町常校料沢裁"
    "状工建語球営空職証土与急止送援供可役構木割聞身費付施切由説転食比難"
    "防補車優夫研収断井何南石足違消境神番規術護展態導鮮備宅害配副算視条"
    "幹独警宮究育席輸訪楽起万着乗店述残想線率病農州武声質念待試族象銀域"
    "助労例衛然早張映限親額監環験追審商葉義伝働形景落欧担好退準賞訴辺造"
    "英被株頭技低毎医復仕去姿味負閣韓渋群"
)

# Common everyday kanji (JLPT N5–N3 style) that sit below the newspaper
# top-500 but dominate conversational TTS input; weighted as one shared
# tail band (rank = len(_RANKED)+1 .. ).
_EVERYDAY = (
    "犬猫鳥魚花茶肉菜飯酒塩卵乳飲寝遊泳歩走読買洗習服靴傘帽窓戸庭池弟妹"
    "兄姉父母妻娘息孫友春夏秋冬雪風熱寒暑暖涼甘辛古遅遠弱暗悪狭軽重太細"
    "赤青白黒緑色週曜昼夜晩朝夕午歌絵紙字辞典漢羽匹冊枚階堂館園病院薬医"
    "歯耳鼻顔首腕胸腹背骨皮膚涙汗声笑泣怒驚悲嬉楽恥困疲眠忙暇静賑綺麗汚"
    "届借返貸忘覚教習練復予宿題験卒業就職働休暇旅館泊乗降換払釣割引安値"
)


def ranked_kanji():
    """(char, rank) pairs, deduplicated keeping the first occurrence."""
    seen = set()
    out = []
    for ch in _RANKED + _EVERYDAY:
        if ch not in seen:
            seen.add(ch)
            out.append(ch)
    return out, len(dict.fromkeys(_RANKED))


# the hand-verified goldens the JAX package's tools read, beside them
GOLDENS_DIR = Path(__file__).resolve().parents[2] / "tools"
GOLDENS_PATH = str(GOLDENS_DIR / "ja_goldens.tsv")


def load_goldens(path=GOLDENS_PATH):
    """[(sentence, gold_reading, gold_ipa2_or_None)]"""
    rows = []
    for line in open(path, encoding="utf-8"):
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        rows.append((parts[0], parts[1],
                     parts[2] if len(parts) > 2 and parts[2] else None))
    return rows


def measure_accuracy(verbose=False):
    """Reading accuracy of the fallback kanji→kana path (the function
    pyopenjtalk's dictionary performs for the reference) on hand-verified
    sentence goldens, char-level via sequence alignment, plus end-to-end
    ``japanese_to_ipa2`` exactness on the subset with hand-written IPA."""
    import difflib

    from personalized_text_to_speech_tpu_torch.text import japanese as J
    from personalized_text_to_speech_tpu_torch.text import ja_numbers

    assert J._pyopenjtalk is None, (
        "accuracy eval measures the FALLBACK path; pyopenjtalk is installed"
    )
    char_correct = char_total = 0
    sent_exact = total = 0
    ipa_exact = ipa_total = 0
    failures, ipa_failures = [], []
    for sentence, gold, gold_ipa in load_goldens():
        total += 1
        got = J.kanji_to_kana(ja_numbers.convert_numbers(sentence))
        sm = difflib.SequenceMatcher(None, gold, got, autojunk=False)
        char_correct += sum(b.size for b in sm.get_matching_blocks())
        char_total += len(gold)
        if got == gold:
            sent_exact += 1
        else:
            failures.append((sentence, gold, got))
        if gold_ipa is not None:
            ipa_total += 1
            got_ipa = J.japanese_to_ipa2(sentence)
            if got_ipa == gold_ipa:
                ipa_exact += 1
            else:
                ipa_failures.append((sentence, gold_ipa, got_ipa))
    if verbose:
        for sentence, gold, got in failures:
            print(f"FAIL {sentence}\n  gold {gold}\n  got  {got}")
        for sentence, gold, got in ipa_failures:
            print(f"IPA FAIL {sentence}\n  gold {gold}\n  got  {got}")
    out = {
        "metric": "japanese fallback kanji-reading accuracy (hand goldens)",
        "sentences": total,
        "reading_char_accuracy": round(char_correct / max(char_total, 1), 4),
        "reading_sentence_exact": round(sent_exact / max(total, 1), 4),
    }
    if ipa_total:
        out["ipa_subset_sentences"] = ipa_total
        out["ipa_sentence_exact"] = round(ipa_exact / ipa_total, 4)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_ja_coverage")
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N most frequent uncovered kanji")
    ap.add_argument("--accuracy", action="store_true",
                    help="measure fallback reading accuracy on the "
                         "hand-verified sentence goldens (ja_goldens.tsv)")
    args = ap.parse_args(argv)

    if args.accuracy:
        print(json.dumps(measure_accuracy(verbose=True),
                         ensure_ascii=False))
        return

    from personalized_text_to_speech_tpu_torch.text import kanji_kana_data as K

    chars, n_ranked = ranked_kanji()
    # a char counts covered when its TYPICAL occurrence resolves: via a
    # char default, a single-char word entry, or a single-char verb/adj
    # stem (whose natural occurrence is conjugated).  First chars of
    # multi-char stems (泊ま→泊) do NOT resolve alone and need their own
    # char defaults — crediting them here once inflated the figure.
    standalone = (
        set(K.CHAR_READINGS)
        | {w for w in K.WORD_READINGS if len(w) == 1}
        | {s for s in K.VERB_STEMS if len(s) == 1}
    )
    context_only = {ch for w in K.WORD_READINGS for ch in w} - standalone

    def band(n):
        sub = chars[:n]
        return round(sum(ch in standalone for ch in sub) / len(sub), 4)

    # Zipf-weighted token coverage: weight 1/rank; everyday tail shares
    # the flat post-ranked weight
    total = cov = 0.0
    missing = []
    for rank, ch in enumerate(chars, start=1):
        w = 1.0 / min(rank, n_ranked + 1)
        total += w
        if ch in standalone:
            cov += w
        elif ch in context_only:
            cov += 0.5 * w  # readable in covered compounds only
            missing.append((rank, ch, "context-only"))
        else:
            missing.append((rank, ch, "missing"))

    print(json.dumps({
        "metric": "japanese kanji coverage (builtin fallback)",
        "tables": {
            "word": len(K.WORD_READINGS),
            "stems": len(K.VERB_STEMS),
            "char": len(K.CHAR_READINGS),
        },
        "proxy_corpus_kanji": len(chars),
        "zipf_token_coverage": round(cov / total, 4),
        "type_coverage_top100": band(100),
        "type_coverage_top250": band(250),
        "type_coverage_top500": band(min(500, n_ranked)),
        "type_coverage_everyday": round(
            sum(ch in standalone for ch in chars[n_ranked:])
            / max(1, len(chars) - n_ranked), 4),
    }, ensure_ascii=False))
    for rank, ch, kind in missing[: args.top]:
        print(f"{rank:>5}  {ch}  U+{ord(ch):04X}  {kind}")


if __name__ == "__main__":
    main()
