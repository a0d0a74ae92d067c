"""Japanese text → romaji-with-accent → IPA.

Pipeline parity with the reference (reference ``text/japanese.py:74-153``):
full-context-label G2P with pitch-accent arrows ``↑``/``↓`` and accent-phrase
spaces, sokuon (っ) / hatsuon (ん) assimilation rewrites, then romaji→IPA
substitution tables.

The reference requires ``pyopenjtalk``; here it is optional:

* with ``pyopenjtalk`` installed, the accent-aware path matches the reference,
* without it, a built-in kana→phoneme converter handles hiragana/katakana text
  WITH estimated Tokyo pitch-accent arrows: mora segmentation + an embedded
  accent-type dictionary of common words (particle suffixes stripped) with a
  heiban (type-0, flat) default — the single most common accent class.  The
  arrow placement semantics match the reference exactly (``↓`` after the
  accent-nucleus mora when the phrase continues, ``↑`` after the first mora
  of a non-atamadaka phrase of ≥2 moras, reference ``japanese.py:99-109``).
  Kanji are read through the embedded three-layer dictionary in
  ``kanji_kana_data.py`` (``kanji_to_kana`` below); unknown kanji are
  logged once and passed through, never silently reinterpreted.
"""

from __future__ import annotations

import logging as _logging
import re

from personalized_text_to_speech_tpu_torch.text import ja_numbers as _ja_numbers
from personalized_text_to_speech_tpu_torch.text import kanji_kana_data as _kanji_data
from personalized_text_to_speech_tpu_torch.text.english import ascii_fold

_logger = _logging.getLogger(__name__)

try:  # pragma: no cover - depends on environment
    import pyopenjtalk as _pyopenjtalk  # type: ignore
except Exception:  # pragma: no cover
    _pyopenjtalk = None


_JAPANESE_CHARACTERS = re.compile(
    r"[A-Za-z\d々〇぀-ヿ一-鿿１-９Ａ-Ｚａ-ｚｦ-ﾝ]"
)
_JAPANESE_MARKS = re.compile(
    r"[^A-Za-z\d々〇぀-ヿ一-鿿１-９Ａ-Ｚａ-ｚｦ-ﾝ]"
)

_SYMBOLS_TO_JAPANESE = [(re.compile("％"), "パーセント")]


# --------------------------------------------------------------------------
# Built-in kana → openjtalk-style phoneme fallback
# --------------------------------------------------------------------------

_KANA_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "ʃi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "ʧi", "つ": "ʦu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "bu",
}
_KANA_YOON = {
    "きゃ": "kya", "きゅ": "kyu", "きょ": "kyo",
    "しゃ": "ʃa", "しゅ": "ʃu", "しょ": "ʃo",
    "ちゃ": "ʧa", "ちゅ": "ʧu", "ちょ": "ʧo",
    "にゃ": "nya", "にゅ": "nyu", "にょ": "nyo",
    "ひゃ": "hya", "ひゅ": "hyu", "ひょ": "hyo",
    "みゃ": "mya", "みゅ": "myu", "みょ": "myo",
    "りゃ": "rya", "りゅ": "ryu", "りょ": "ryo",
    "ぎゃ": "gya", "ぎゅ": "gyu", "ぎょ": "gyo",
    "じゃ": "ja", "じゅ": "ju", "じょ": "jo",
    "ぢゃ": "ja", "ぢゅ": "ju", "ぢょ": "jo",
    "びゃ": "bya", "びゅ": "byu", "びょ": "byo",
    "ぴゃ": "pya", "ぴゅ": "pyu", "ぴょ": "pyo",
    # loanword combinations (ティ/ディ/ファ行/ウィ行/チェ/シェ/ジェ)
    "てぃ": "ti", "でぃ": "di", "とぅ": "tu", "どぅ": "du",
    "ふぁ": "fa", "ふぃ": "fi", "ふぇ": "fe", "ふぉ": "fo",
    "うぃ": "wi", "うぇ": "we", "うぉ": "wo",
    "ちぇ": "ʧe", "しぇ": "ʃe", "じぇ": "je",
    "ゔぁ": "ba", "ゔぃ": "bi", "ゔぇ": "be", "ゔぉ": "bo",
}
_VOWELS = "aiueo"

# o-final verb stems whose dictionary-form う is NOT a long vowel
# (思う [omoɯ], 通う [kajoɯ] — not [omoː]); keyed by the two kana
# before the う.  拾う/披露 are kana-identical with opposite values and
# 追う/問う collide with 王/塔-style long vowels — those stay long.
_OU_VERB_STEMS = frozenset(("おも", "かよ", "まよ", "さそ"))

# kana that continue an いる-conjugation after て/で: the い of the
# progressive (食べている, 住んでいます) is a morpheme of its own and
# must not merge into a long e
_TE_IRU_CONT = frozenset("るまたてなれよ")


def _kata_to_hira(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if 0x30A1 <= code <= 0x30F6:  # katakana → hiragana
            out.append(chr(code - 0x60))
        else:
            out.append(ch)
    return "".join(out)


def _kana_to_moras(text: str) -> list:
    """Hiragana/katakana → list of openjtalk-style phoneme strings, ONE
    PER MORA (yoon merges with its base kana; っ/ん/ー are their own
    moras — the units Tokyo pitch accent counts).

    Tokyo long-vowel normalization, matching openjtalk's lexicon forms
    (東京→トーキョー emits "o o", 先生→センセー emits "e e"): う after an
    o-vowel mora reads o, い after an e-vowel mora reads e.  Exceptions,
    since the rule is mora-level and morpheme-blind:

    * u-verbs whose stem ends in お (思う/通う/迷う/誘う) keep [oɯ] —
      their う is the dictionary-form okurigana (拾う and 追う/問う are
      kana-ambiguous with genuine long vowels and stay long);
    * the い of ている/でいる progressives (食べている, 住んでいます)
      is the verb いる, not a long e — detected by て/で before and an
      いる-conjugation kana after;
    * katakana ウ/イ stay diphthongs (ソウル [soɯɾɯ]) — loanwords spell
      real long vowels with ー, so an explicit vowel kana is meant."""
    kata = [0x30A1 <= ord(c) <= 0x30F6 for c in text]
    text = _kata_to_hira(text)
    out = []
    i = 0
    n = len(text)
    while i < n:
        two = text[i : i + 2]
        ch = text[i]
        if two in _KANA_YOON:
            out.append(_KANA_YOON[two])
            i += 2
            continue
        if ch == "っ":
            out.append("Q")
            i += 1
            continue
        if ch == "ー":
            # long-vowel mark: repeat previous vowel
            if out and out[-1] and out[-1][-1] in _VOWELS:
                out.append(out[-1][-1])
            i += 1
            continue
        if ch in _KANA_BASE:
            mora = _KANA_BASE[ch]
            if out and out[-1] and not kata[i]:
                prev_v = out[-1][-1]
                if mora == "u" and prev_v == "o" and \
                        text[max(0, i - 2):i] not in _OU_VERB_STEMS:
                    mora = "o"
                elif mora == "i" and prev_v == "e" and not (
                    text[i - 1] in "てで"
                    and i + 1 < n and text[i + 1] in _TE_IRU_CONT
                ):
                    mora = "e"
            out.append(mora)
            i += 1
            continue
        out.append(ascii_fold(ch))
        i += 1
    return out


def _kana_to_phonemes(text: str) -> str:
    """Hiragana/katakana → openjtalk-style phoneme string (no accent info)."""
    return "".join(_kana_to_moras(text))


# --------------------------------------------------------------------------
# Latin acronyms → letter-name kana (fallback only; openjtalk reads
# letters natively).  Uppercase runs not followed by lowercase (JR, OK,
# TPU — but not the H of Hello) read as Japanese letter names.
# --------------------------------------------------------------------------

_LETTER_KANA = {
    "A": "えー", "B": "びー", "C": "しー", "D": "でぃー", "E": "いー",
    "F": "えふ", "G": "じー", "H": "えいち", "I": "あい", "J": "じぇー",
    "K": "けー", "L": "える", "M": "えむ", "N": "えぬ", "O": "おー",
    "P": "ぴー", "Q": "きゅー", "R": "あーる", "S": "えす", "T": "てぃー",
    "U": "ゆー", "V": "ぶい", "W": "だぶりゅー", "X": "えっくす",
    "Y": "わい", "Z": "ぜっと",
}
_ACRONYM_RE = re.compile(r"[A-Z]+(?![a-z])")
_FW_UPPER = str.maketrans(
    {chr(0xFF21 + i): chr(ord("A") + i) for i in range(26)})


def _read_acronyms(text: str) -> str:
    text = text.translate(_FW_UPPER)
    return _ACRONYM_RE.sub(
        lambda m: "".join(_LETTER_KANA[c] for c in m.group(0)), text)


# --------------------------------------------------------------------------
# Kanji → kana readings (fallback path only; pyopenjtalk reads kanji
# natively through its full dictionary, reference japanese.py:74-112)
# --------------------------------------------------------------------------

_KANJI_RE = re.compile(r"[一-鿿〇]")
_warned_kanji: set = set()


def _kanji_to_kana_tokens(text: str):
    """Replace kanji spans with hiragana readings via the embedded
    three-layer dictionary (``kanji_kana_data.py``): greedy longest-match
    words (incl. okurigana-prefixed conjugation stems like 食べ/新し),
    五段-verb/i-adjective stems gated on the following okurigana
    (行く→いく but 行きます→いきます), then single-character defaults.
    Unknown kanji are logged once and passed through — downstream drops
    them, which was the old behavior for *all* kanji.

    Returns ``(kana, intervals)`` where intervals are ``(start, end,
    kind)`` spans into ``kana``: kind ``"word"`` for word/char-layer
    readings (atomic — the accent segmenter must not split inside) and
    ``"stem"`` for verb/adjective stems (no split inside, but a longer
    dictionary match may extend past the okurigana: たかい over stem
    たか)."""
    word = _kanji_data.WORD_READINGS
    stems = _kanji_data.VERB_STEMS
    char = _kanji_data.CHAR_READINGS
    onyomi = _kanji_data.CHAR_ONYOMI
    max_len = _kanji_data.max_word_len()
    out = []
    intervals = []
    pos = 0  # length of joined output so far
    last_was_word = False  # previous emit produced a word interval
    last_key_pure_kanji = False  # ...from a key with no okurigana
    last_reading = ""  # for the 々 iteration mark
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        # 1) multi-character words, longest first — attempted at EVERY
        #    position: keys may start with kana (お金, ご飯, 買い物), and
        #    all keys contain a kanji so plain kana text cannot mis-match
        hit = None
        kind = "word"
        for length in range(min(max_len, n - i), 1, -1):
            cand = text[i : i + length]
            if cand in word:
                hit = (length, word[cand])
                break
        if hit is None and not _KANJI_RE.match(ch):
            if ch == "々" and last_reading:
                # iteration mark repeats the previous kanji's reading
                # (word entries cover the rendaku cases: 人々/時々/色々);
                # extend the previous interval so 山々 stays one word
                out.append(last_reading)
                if last_was_word and intervals:
                    s, _e, k = intervals[-1]
                    intervals[-1] = (s, pos + len(last_reading), k)
                pos += len(last_reading)
            else:
                out.append(ch)
                pos += len(ch)
                last_reading = ""
                last_was_word = False
            i += 1
            continue
        # 2) verb/adjective stems, valid only before specific okurigana
        if hit is None and ch in stems and i + 1 < n:
            nxt = text[i + 1]
            for reading, allowed in stems[ch]:
                if nxt in allowed:
                    hit = (1, reading)
                    kind = "stem"
                    break
        if hit is None and i + 2 <= n and text[i : i + 2] in stems and i + 2 < n:
            nxt = text[i + 2]
            for reading, allowed in stems[text[i : i + 2]]:
                if nxt in allowed:
                    hit = (2, reading)
                    kind = "stem"
                    break
        # 3) compound context (an adjacent kanji on either side): OOV
        #    Sino-Japanese compounds concatenate bound on'yomi
        #    (水道→すいどう, 話題→わだい); standalone kun defaults would
        #    misread them (みずどう)
        if hit is None and ch in onyomi and (
            (i + 1 < n and _KANJI_RE.match(text[i + 1]))
            or (i > 0 and _KANJI_RE.match(text[i - 1]))
        ):
            hit = (1, onyomi[ch])
        # 4) single-character defaults (word layer first: 話→はなし
        #    standalone but 話す→はなす through the stem above)
        if hit is None and ch in word:
            hit = (1, word[ch])
        if hit is None and ch in char:
            hit = (1, char[ch])
        if hit is None:
            if ch not in _warned_kanji:
                _warned_kanji.add(ch)
                _logger.warning(
                    "no kana reading for %r (U+%04X) — passed through; "
                    "install pyopenjtalk for full kanji coverage",
                    ch, ord(ch),
                )
            out.append(ch)
            pos += len(ch)
            last_reading = ""
            last_was_word = False
            i += 1
            continue
        length, reading = hit
        out.append(reading)
        # adjacent readings with no kana between them form ONE compound
        # accent phrase (大学生, 研究所, 政府 via per-char on'yomi) —
        # merge instead of stacking word-starts, which would insert a
        # phrase break and pitch rise per kanji (sɯ↑i do↑ɯ for 水道).
        # A trailing stem keeps stem semantics so the okurigana and
        # endings still fuse (受け取る → うけとる, one span) — but ONLY
        # after an okurigana-bearing word key (受け/買い renyokei forms):
        # a pure-kanji word before a verb stem is a separate constituent
        # (毎朝+読み, 新聞+読んだ), and merging it used to hide the word
        # from the accent dictionary (まいあさよ… read heiban).
        key_src = text[i : i + length]
        merge_ok = intervals and intervals[-1][1] == pos and not (
            kind == "stem"
            and last_was_word
            and last_key_pure_kanji
        )
        if merge_ok:
            s, _e, _k = intervals[-1]
            intervals[-1] = (s, pos + len(reading), kind)
        else:
            intervals.append((pos, pos + len(reading), kind))
        pos += len(reading)
        last_reading = reading
        last_was_word = kind == "word"
        last_key_pure_kanji = all(_KANJI_RE.match(c) for c in key_src)
        i += length
    return "".join(out), intervals


def kanji_to_kana(text: str) -> str:
    """Kana reading of ``text`` (see ``_kanji_to_kana_tokens``)."""
    return _kanji_to_kana_tokens(text)[0]


# --------------------------------------------------------------------------
# Fallback pitch-accent estimation (Tokyo dialect)
#
# Accent type N = index of the accent-nucleus mora (0 = heiban, no fall).
# Dictionary of common words keyed by hiragana, high-confidence entries
# only; lookups strip trailing particles so 「あめが」 matches 「あめ」 and
# the particle moras ride the same phrase.  Unknown phrases default to
# heiban — the most common class and the least-wrong guess (a spurious ↓
# is far more audible than a missing one).
# --------------------------------------------------------------------------

_ACCENT_DICT = {
    # type 1 (atamadaka: fall after the first mora)
    "あめ": 1, "ねこ": 1, "てんき": 1, "めがね": 1, "ほん": 1, "はし": 1,
    "かさ": 1, "うみ": 1, "みどり": 1, "じしょ": 1, "いのち": 1,
    "らいげつ": 1, "ばんぐみ": 1, "えき": 1, "ちず": 1, "にく": 1,
    "しろ": 1, "あき": 1, "ふたり": 1, "まいにち": 1, "まいあさ": 1,
    "げんき": 1, "てがみ": 1, "ぎゅうにく": 1,
    # type 2
    "やま": 2, "かわ": 2, "はな": 2, "ふゆ": 2, "いぬ": 2, "にほん": 2,
    "こころ": 2, "むすめ": 2, "ひだり": 2, "あなた": 2, "あたま": 2,
    "ゆき": 2, "なつ": 2, "はる": 2, "まち": 2, "みせ": 2, "やすみ": 2,
    "たべもの": 2, "のみもの": 2, "くに": 2, "いけ": 2, "うた": 2,
    # type 3
    "せんせい": 3, "おとこ": 3, "おんな": 3, "ことば": 3, "こうえん": 3,
    "びょういん": 3, "だいがく": 3, "めざまし": 3, "はたち": 3,
    # type 4
    "おとうと": 4, "いもうと": 4, "みなみ": 3,
    # kinship words ending in は/へ — listed so the raw-span particle
    # heuristic below can never rewrite their final kana
    "はは": 1, "ちち": 1,
    # common i-adjectives and dictionary-form verbs (high-confidence NHK
    # accent types); these also anchor segmentation so a preceding topic
    # は splits off and reads わ (すしはたかい → すしわ・たかい)
    "たかい": 2, "やすい": 2, "おおきい": 3, "ちいさい": 3,
    "あたらしい": 4, "ふるい": 2, "さむい": 2, "あつい": 2,
    "たのしい": 3, "うれしい": 3, "ながい": 2, "はやい": 2,
    "つよい": 2, "よわい": 2, "しろい": 2, "くろい": 2,
    "あまい": 0, "とおい": 0, "ちかい": 2,
    "いく": 0, "くる": 1, "たべる": 2, "のむ": 1, "みる": 1,
    "きく": 0, "よむ": 1, "かく": 1, "はなす": 2, "あるく": 2,
    "はしる": 2, "かう": 0,
    # demonstratives/pronouns (particle-は after these is very frequent:
    # これは/それは must read …わ)
    "これ": 0, "それ": 0, "あれ": 0, "どれ": 1,
    "ここ": 0, "そこ": 0, "あそこ": 0, "どこ": 1, "かれ": 1,
    # type 0 (heiban — listed so particles attach without dictionary miss)
    "わたし": 0, "さくら": 0, "とけい": 0, "くるま": 0, "さかな": 0,
    "がっこう": 0, "かばん": 0, "でんわ": 0, "ともだち": 0, "みず": 0,
    "にほんご": 0, "えいご": 0, "ぎんこう": 0, "かいしゃ": 0, "こども": 0,
    "ごはん": 0, "おちゃ": 0, "さとう": 0, "しんぶん": 0, "つくえ": 0,
    "ねだん": 0, "はがき": 0, "ひこうき": 0, "ふく": 0, "へや": 0,
    "ほんや": 0, "まど": 0, "みち": 0, "むら": 0, "やさい": 0,
    # round-4 (cont.) tranche: readings the kanji layer now produces
    # frequently (NHK accent, high-confidence entries only); type-0
    # entries also anchor segmentation so particles attach correctly
    # NOTE: short kana entries split longer OOV words (greedy scan), so
    # いま is deliberately absent (it sits inside every polite 〜います)
    # and きょう's common supersets are listed so they win at their start
    "きょう": 1, "とうきょう": 0, "きょうと": 1, "きょういく": 0,
    "きょうかい": 0, "きょうしつ": 0, "きょうみ": 1,
    "あした": 3, "きのう": 2, "でんき": 1,
    "えいが": 1, "おんがく": 1, "くうき": 1, "けしき": 1, "りょうり": 1,
    "かいぎ": 1, "いみ": 1, "かぞく": 1, "りょうしん": 1, "せいと": 1,
    "かのじょ": 1, "たいよう": 1,
    "たまご": 2, "くだもの": 2, "こたえ": 2, "じてんしゃ": 2,
    "もの": 2, "だいすき": 1,
    "はれ": 2, "としょかん": 2,
    "べんとう": 3, "くもり": 3,
    "がくせい": 0, "じかん": 0, "しごと": 0, "べんきょう": 0,
    "しゅくだい": 0, "りょこう": 0, "ざっし": 0, "くすり": 0,
    "かぜ": 0, "どうぶつ": 0, "しぜん": 0, "ぎゅうにゅう": 0,
    "やくそく": 0, "よてい": 0, "れんしゅう": 0, "しつもん": 0,
    "もんだい": 0, "きもち": 0, "じしん": 0, "ちかてつ": 0,
    "でんしゃ": 0, "おとな": 0, "むすこ": 0, "いしゃ": 0,
    "けいさつ": 0, "こうこう": 0, "せかい": 0, "てんいん": 0,
    # verbs (dictionary form)
    "かえる": 1, "はいる": 1, "でる": 1, "まつ": 1, "もつ": 1,
    "とる": 1, "あう": 1,
    "およぐ": 2, "やすむ": 2, "つくる": 2, "おきる": 2, "わかる": 2,
    "ならう": 2, "おもう": 2, "しめる": 2,
    "する": 0, "あそぶ": 0, "はたらく": 0, "うる": 0, "おくる": 0,
    "しぬ": 0, "ねる": 0, "わすれる": 0, "おしえる": 0, "つかう": 0,
    "いう": 0, "よぶ": 0, "あける": 0, "けす": 0, "はじまる": 0,
    "おわる": 0, "うまれる": 0, "おぼえる": 3,
    "のぼる": 0, "あらう": 0, "かよう": 0, "さがす": 0,
    "はこぶ": 0, "ならぶ": 0, "すすむ": 0, "さそう": 0,
    "はらう": 2, "たのむ": 2, "えらぶ": 2, "うごく": 2,
    "とどく": 2, "まよう": 2, "かえす": 1,
    # i-adjectives
    "おいしい": 0, "やさしい": 0, "つめたい": 0, "あかるい": 0,
    "おもい": 0, "かるい": 0,
    "ひくい": 2, "ひろい": 2, "せまい": 2,
    "すずしい": 3,
    "むずかしい": 4, "いそがしい": 4, "あたたかい": 4,
}

# dictionary words indexed by first kana, longest first (the segmenter
# probes every position; a flat longest-first scan of the whole dict per
# position dominated frontend cost)
def _build_word_index():
    idx = {}
    for w in sorted(_ACCENT_DICT, key=len, reverse=True):
        idx.setdefault(w[0], []).append(w)
    return idx


_WORD_INDEX = _build_word_index()

# particles that attach to the preceding accent phrase
_PARTICLES = (
    "までは", "からは", "には", "とは", "では", "へは",
    "まで", "から", "より", "ほど", "だけ", "でも", "しか",
    "は", "が", "を", "に", "で", "と", "も", "の", "へ", "や", "ね", "よ",
    "か",
)


# accentless endings (copula/polite forms) that ride the preceding word's
# accent phrase, like particles do; する-verb conjugations are included so
# noun+する compounds stay one accent phrase (掃除しました, 勉強しています)
_ENDINGS = (
    "していました", "しています", "している", "しましょう",
    "しませんか", "しました", "しません", "します", "して",
    "でした", "ました", "ません", "ましょう",
    "です", "ます", "たい", "だ",
)

_ATTACH = sorted(_PARTICLES + _ENDINGS, key=len, reverse=True)
_PARTICLE_SET = set(_PARTICLES)


def _accent_type(phrase_hira: str) -> int:
    """Accent-nucleus mora index for a hiragana phrase (0 = heiban)."""
    if phrase_hira in _ACCENT_DICT:
        return _ACCENT_DICT[phrase_hira]
    for p in _PARTICLES + _ENDINGS:  # longest first within each group
        if phrase_hira.endswith(p) and phrase_hira[: -len(p)] in _ACCENT_DICT:
            return _ACCENT_DICT[phrase_hira[: -len(p)]]
    return 0


def _particle_reading(p: str) -> str:
    """Particles は and へ read わ and え (には→にわ, へは→えわ)."""
    if p.endswith("は"):
        p = p[:-1] + "わ"
    if p.startswith("へ"):
        p = "え" + p[1:]
    return p


def _raw_span_reading(raw: str) -> str:
    """Particle reading for an UNMATCHED span: its final kana sits at a
    segmentation boundary (a dictionary word or end of text follows), so a
    span-final は/へ is almost always the topic/direction particle — read
    わ/え (すしは→すしわ even though すし is out-of-dictionary).  Words
    ending in these kana (はは, ちち) are protected by dictionary entries.
    A particle *inside* an unmatched span is indistinguishable from a
    word-internal kana without morphological analysis and is left alone."""
    if len(raw) >= 2 and raw.endswith("は"):
        return raw[:-1] + "わ"
    if len(raw) >= 2 and raw.endswith("へ"):
        return raw[:-1] + "え"
    return raw


def _segment_accent_phrases(hira: str, intervals=()) -> list:
    """Greedy longest-match split of a kana run into accent phrases: a
    dictionary word plus any attached particles/endings forms one phrase;
    unmatched spans between matches form their own (heiban) phrases.  A
    lightweight stand-in for openjtalk's accent-phrase analysis.

    ``intervals`` are kanji-reading spans from ``_kanji_to_kana_tokens``:
    dictionary matches and particle absorption may not start inside one
    (週末→しゅうまつ must not re-split as しゅう|まつ); a ``"word"`` span
    is itself a match at its start; a match may extend past a ``"stem"``
    span (たかい over stem たか) but may not equal it (はな alone is a
    verb fragment, not 花).

    Returns ``(reading, nucleus)`` pairs: the reading has particle は/へ
    corrected to わ/え; the accent type is looked up on the raw text."""
    attach = _ATTACH
    particles = _PARTICLE_SET
    word_start = {s: e for s, e, k in intervals if k == "word"}
    word_spans = [(s, e) for s, e, k in intervals if k == "word"]
    stem_spans = [(s, e) for s, e, k in intervals if k == "stem"]
    # positions where neither a dict match nor absorption may begin
    guard = set()
    for s, e, _k in intervals:
        guard.update(range(s + 1, e))
    absorb_guard = guard | {s for s, e, _k in intervals}

    def _candidate_ok(i, length):
        end = i + length
        for s, e in word_spans:
            if end <= s or i >= e:
                continue
            if i <= s and end >= e:  # fully contains the word
                continue
            return False
        for s, e in stem_spans:
            if end <= s or i >= e:
                continue
            if i == s and end == e:  # the bare stem is not a word here
                return False
            if i <= s and end >= e:  # extends past the okurigana
                continue
            return False
        return True

    phrases = []
    i = start = 0
    n = len(hira)
    while i < n:
        hit = None
        if i not in guard:
            for w in _WORD_INDEX.get(hira[i], ()):
                if hira.startswith(w, i) and _candidate_ok(i, len(w)):
                    hit = w
                    break
            if hit is None and i in word_start:
                hit = hira[i : word_start[i]]
        if hit is None:
            i += 1
            continue
        if i > start:
            raw = hira[start:i]
            phrases.append((_raw_span_reading(raw), _accent_type(raw)))
        j = i + len(hit)
        reading = hit
        # absorb trailing endings (です/ました may chain: たいです), then
        # at most one particle — a particle CLOSES the accent phrase
        # (particle chains like をの are ungrammatical; the real chains
        # には/では/とは/までは are whole entries in _PARTICLES), so the
        # next dictionary word starts fresh (みずを|のむ, not みずをの|む)
        while True:
            hit_a = None
            for a in attach:
                if (
                    hira.startswith(a, j)
                    and all(p not in absorb_guard
                            for p in range(j, j + len(a)))
                ):
                    hit_a = a
                    break
            if hit_a is None:
                break
            if (
                hit_a == "も"
                and hira[j : j + 2] == "もの"
                and reading.endswith("い")
            ):
                # i-adjective + もの is the noun (甘いもの, 冷たいもの),
                # not the particle も — close the phrase and let the
                # dictionary word もの start the next one
                break
            j += len(hit_a)
            if hit_a in particles:
                reading += _particle_reading(hit_a)
                break
            reading += hit_a
        phrases.append((reading, _accent_type(hira[i:j])))
        i = start = j
    if start < n:
        raw = hira[start:]
        phrases.append((_raw_span_reading(raw), _accent_type(raw)))
    return phrases


# Vowel devoicing (fallback only): openjtalk marks devoiced vowels as
# capital I/U in its label phonemes — that is what the reference's
# I→i* / U→ɯ* IPA rules consume (reference japanese.py:115-144).  The
# fallback estimates them with the classic rule: a high vowel between
# voiceless consonants devoices (しか→ʃIka, です→desU before sokuon or
# voiceless onset), plus utterance-final u after s/ʃ/ʦ (です/ます).  The
# accent nucleus (followed by ↓) resists devoicing — the lookahead only
# passes over a rise marker.
_DEVOICE_RE = re.compile(r"(?<=[ksʃtpfhʧʦ])([iu])(?=↑?[ksʃtpfhʧʦQ])")
_DEVOICE_FINAL_RE = re.compile(r"(?<=[sʃʦ])u$")


def _apply_devoicing(text: str) -> str:
    text = _DEVOICE_RE.sub(lambda m: m.group(1).upper(), text)
    return _DEVOICE_FINAL_RE.sub("U", text)


def _kana_to_phonemes_with_accent(text: str, intervals=()) -> str:
    """Fallback G2P WITH estimated pitch-accent arrows, mirroring the
    reference's placement rules (reference ``japanese.py:99-109``): ``↓``
    after the nucleus mora when another mora follows in the phrase; ``↑``
    after the first mora of a ≥2-mora phrase unless the fall already
    happened there (atamadaka)."""
    hira = _kata_to_hira(text)  # length-preserving: intervals stay valid
    pieces = []
    for phrase, nucleus in _segment_accent_phrases(hira, intervals):
        moras = _kana_to_moras(phrase)
        n = len(moras)
        if n == 0:
            continue
        out = []
        for idx, mora in enumerate(moras, start=1):  # 1-based mora index
            out.append(mora)
            if idx == nucleus and idx < n:
                out.append("↓")
            elif idx == 1 and nucleus != 1 and n >= 2:
                out.append("↑")
        pieces.append("".join(out))
    # accent-phrase boundaries surface as spaces (reference japanese.py:103)
    return _apply_devoicing(" ".join(pieces))


# --------------------------------------------------------------------------
# Accent-aware G2P via pyopenjtalk full-context labels
# (reference japanese.py:74-112)
# --------------------------------------------------------------------------

def _openjtalk_romaji_with_accent(sentence: str) -> str:
    text = ""
    labels = _pyopenjtalk.extract_fullcontext(sentence)
    for n, label in enumerate(labels):
        phoneme = re.search(r"\-([^\+]*)\+", label).group(1)
        if phoneme in ("sil", "pau"):
            continue
        text += (
            phoneme.replace("ch", "ʧ").replace("sh", "ʃ").replace("cl", "Q")
        )
        a1 = int(re.search(r"/A:(\-?[0-9]+)\+", label).group(1))
        a2 = int(re.search(r"\+(\d+)\+", label).group(1))
        a3 = int(re.search(r"\+(\d+)/", label).group(1))
        if re.search(r"\-([^\+]*)\+", labels[n + 1]).group(1) in ("sil", "pau"):
            a2_next = -1
        else:
            a2_next = int(re.search(r"\+(\d+)\+", labels[n + 1]).group(1))
        if a3 == 1 and a2_next == 1:
            text += " "  # accent phrase boundary
        elif a1 == 0 and a2_next == a2 + 1:
            text += "↓"  # pitch fall
        elif a2 == 1 and a2_next == 2:
            text += "↑"  # pitch rise
    return text


def japanese_to_romaji_with_accent(text: str) -> str:
    for regex, replacement in _SYMBOLS_TO_JAPANESE:
        text = re.sub(regex, replacement, text)
    if _pyopenjtalk is None:
        # openjtalk normalizes digits itself; the fallback reads
        # number+counter before sentence splitting (decimal points and
        # comma groups sit at mark boundaries) and before kanji_to_kana
        # (which would read the counter kanji standalone)
        text = _ja_numbers.convert_numbers(text)
        text = _read_acronyms(text)
    sentences = re.split(_JAPANESE_MARKS, text)
    marks = re.findall(_JAPANESE_MARKS, text)
    out = ""
    for i, sentence in enumerate(sentences):
        if re.match(_JAPANESE_CHARACTERS, sentence):
            if out != "":
                out += " "
            if _pyopenjtalk is not None:
                out += _openjtalk_romaji_with_accent(sentence)
            else:
                sentence, intervals = _kanji_to_kana_tokens(sentence)
                # lexicalized greetings keep the historical topic-particle
                # spelling but read わ (openjtalk resolves these natively;
                # both rewrites are length-preserving so intervals hold)
                sentence = sentence.replace(
                    "こんにちは", "こんにちわ"
                ).replace("こんばんは", "こんばんわ")
                out += _kana_to_phonemes_with_accent(sentence, intervals)
        if i < len(marks):
            out += ascii_fold(marks[i]).replace(" ", "")
    return out


# --------------------------------------------------------------------------
# Assimilation + romaji→IPA tables (reference japanese.py:20-65,115-144)
# --------------------------------------------------------------------------

_REAL_SOKUON = [(re.compile(p), r) for p, r in [
    (r"Q([↑↓]*[kg])", r"k#\1"),
    # ʦ included: the fallback kana table pre-substitutes つ→ʦu, while the
    # reference sees "ts" here (its ts→ʦ rewrite runs after sokuon) —
    # same final output t#ʦ either way (reference japanese.py:20-28)
    (r"Q([↑↓]*[tdjʧʦ])", r"t#\1"),
    (r"Q([↑↓]*[sʃ])", r"s\1"),
    (r"Q([↑↓]*[pb])", r"p#\1"),
]]

_REAL_HATSUON = [(re.compile(p), r) for p, r in [
    (r"N([↑↓]*[pbm])", r"m\1"),
    (r"N([↑↓]*[ʧʥj])", r"n^\1"),
    # ʦ included for the same pre-substitution reason as the sokuon
    # table above: the reference sees "Nts" and assimilates on the t
    (r"N([↑↓]*[tdnʦ])", r"n\1"),
    (r"N([↑↓]*[kg])", r"ŋ\1"),
]]

_ROMAJI_TO_IPA = [(re.compile(p), r) for p, r in [
    ("ts", "ʦ"), ("u", "ɯ"), ("j", "ʥ"), ("y", "j"), ("ni", "n^i"),
    ("nj", "n^"), ("hi", "çi"), ("hI", "çI"), ("hj", "ç"), ("f", "ɸ"),
    ("I", "i*"), ("U", "ɯ*"), ("r", "ɾ"),
]]

_ROMAJI_TO_IPA2 = [(re.compile(p), r) for p, r in [
    # the fallback kana table pre-substitutes つ→ʦ, but the reference's
    # ipa2 path never maps ts→ʦ (that rewrite is v1-only, reference
    # japanese.py:115-136), so its cjke output spells つ as "ts"+vowel
    # and ʦ is NOT in the cjke symbol vocab — lower it back first
    ("ʦ", "ts"),
    ("u", "ɯ"), ("ʧ", "tʃ"), ("j", "dʑ"), ("y", "j"), ("ni", "n^i"),
    ("nj", "n^"), ("hi", "çi"), ("hI", "çI"), ("hj", "ç"), ("f", "ɸ"),
    ("I", "i*"), ("U", "ɯ*"), ("r", "ɾ"),
]]


def get_real_sokuon(text: str) -> str:
    for regex, replacement in _REAL_SOKUON:
        text = re.sub(regex, replacement, text)
    return text


def get_real_hatsuon(text: str) -> str:
    for regex, replacement in _REAL_HATSUON:
        text = re.sub(regex, replacement, text)
    return text


def japanese_to_ipa(text: str) -> str:
    text = japanese_to_romaji_with_accent(text).replace("...", "…")
    text = re.sub(
        r"([aiueo])\1+",
        lambda m: m.group(0)[0] + "ː" * (len(m.group(0)) - 1),
        text,
    )
    text = get_real_sokuon(text)
    text = get_real_hatsuon(text)
    for regex, replacement in _ROMAJI_TO_IPA:
        text = re.sub(regex, replacement, text)
    return text


def japanese_to_ipa2(text: str) -> str:
    """The cjke_cleaners2 Japanese path (reference ``japanese.py:138-144``)."""
    text = japanese_to_romaji_with_accent(text).replace("...", "…")
    text = get_real_sokuon(text)
    text = get_real_hatsuon(text)
    for regex, replacement in _ROMAJI_TO_IPA2:
        text = re.sub(regex, replacement, text)
    return text


def japanese_to_ipa3(text: str) -> str:
    text = (
        japanese_to_ipa2(text)
        .replace("n^", "ȵ")
        .replace("ʃ", "ɕ")
        .replace("*", "̥")
        .replace("#", "̚")
    )
    text = re.sub(
        r"([aiɯeo])\1+",
        lambda m: m.group(0)[0] + "ː" * (len(m.group(0)) - 1),
        text,
    )
    text = re.sub(r"((?:^|\s)(?:ts|tɕ|[kpt]))", r"\1ʰ", text)
    return text
