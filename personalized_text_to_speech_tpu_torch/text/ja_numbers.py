"""Japanese number → kana reading for the fallback G2P.

The reference delegates digit reading to pyopenjtalk's text-normalization
front end (reference ``text/japanese.py:74-112`` — openjtalk reads digits
inside the sentence natively); without it, digits previously leaked into
the phoneme stream verbatim ("3時" → "3とき").  This module reads:

* bare cardinals up to 10^16 with the euphonic changes
  (さんびゃく/ろっぴゃく/はっせん/いっせんまん…),
* decimals (3.14 → さんてんいちよん), comma-grouped numbers, leading-zero
  strings digit-by-digit (007 → ゼロゼロなな),
* counter-suffixed numbers with the gemination/rendaku system:
  per-counter consonant class (k/s/t/h) drives っ-gemination of
  1/6/8/10/100 and the は行→ぱ行/ば行 shifts (1分→いっぷん, 3本→さんぼん,
  6匹→ろっぴき, 10階→じゅっかい), plus the irregular series for
  時/月/人/日/つ/歳 (4時→よじ, 1人→ひとり, 20日→はつか, 20歳→はたち).

``convert_numbers(text)`` rewrites every number(+counter) occurrence in a
raw sentence, consuming the counter kanji so the kanji→kana layer never
sees it.  Pure tables + string code — no dependencies.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

_DIGITS = ["ゼロ", "いち", "に", "さん", "よん", "ご", "ろく", "なな",
           "はち", "きゅう"]

# (reading, euphonic overrides) for the in-group positions
_TENS = {1: "じゅう", 3: "さんじゅう"}
_HUNDREDS = {1: "ひゃく", 3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"}
_THOUSANDS = {1: "せん", 3: "さんぜん", 8: "はっせん"}
_MYRIADS = ["", "まん", "おく", "ちょう", "けい"]


def _group_to_kana(g: int) -> str:
    """0 < g < 10000 → kana (no myriad suffix)."""
    out = []
    th, rem = divmod(g, 1000)
    hu, rem = divmod(rem, 100)
    te, on = divmod(rem, 10)
    if th:
        out.append(_THOUSANDS.get(th, _DIGITS[th] + "せん"))
    if hu:
        out.append(_HUNDREDS.get(hu, _DIGITS[hu] + "ひゃく"))
    if te:
        out.append(_TENS.get(te, _DIGITS[te] + "じゅう"))
    if on:
        out.append(_DIGITS[on])
    return "".join(out)


def number_to_kana(n: int) -> str:
    """Cardinal reading of a non-negative integer (up to 10^20-1)."""
    if n == 0:
        return _DIGITS[0]
    groups = []
    while n:
        n, g = divmod(n, 10000)
        groups.append(g)
    out = []
    for idx in range(len(groups) - 1, -1, -1):
        g = groups[idx]
        if not g:
            continue
        kana = _group_to_kana(g)
        unit = _MYRIADS[idx] if idx < len(_MYRIADS) else ""
        if unit:
            # 1万 → いちまん but 1000万 → いっせんまん; 1兆 → いっちょう
            if kana == "せん":
                kana = "いっせん"
            if kana == "いち" and unit in ("ちょう", "けい"):
                kana = "いっ"
            if kana.endswith("はち") and unit == "ちょう":
                kana = kana[:-2] + "はっ"
            if kana.endswith("じゅう") and unit == "ちょう":
                kana = kana[:-3] + "じゅっ"
        out.append(kana + unit)
    return "".join(out)


def digits_to_kana(s: str) -> str:
    """Digit-by-digit reading (leading-zero strings, long ID numbers)."""
    return "".join(_DIGITS[int(c)] for c in s)


# --------------------------------------------------------------------------
# Counters.  spec = (base_kana, cls, final_overrides, value_overrides)
#   cls: consonant class of the base — drives っ-gemination
#     "k"/"s"/"t": geminate 1/8/10(/6,100 for k); base unchanged
#     "h": geminate 1/6/8/10/100 AND shift は行→ぱ行; rendaku/ぱ per final
#     "" : no sound changes
#   final_overrides: final number component (いち/さん/よん/ろく/はち…)
#     → (replacement number reading or None, replacement counter or None):
#     時: {"よん": ("よ", None)} reads よじ; 本: {"さん": (None, "ぼん")}
#     reads さんぼん
#   value_overrides: whole value → complete reading (1人→ひとり, 20歳→はたち)
# --------------------------------------------------------------------------

_P_SHIFT = {"は": "ぱ", "ひ": "ぴ", "ふ": "ぷ", "へ": "ぺ", "ほ": "ぽ"}
_B_SHIFT = {"は": "ば", "ひ": "び", "ふ": "ぶ", "へ": "べ", "ほ": "ぼ"}

_TIME_FINALS = {"よん": ("よ", None), "きゅう": ("く", None),
                "なな": ("しち", None)}
_COUNTERS: Dict[str, tuple] = {
    "時間": ("じかん", "", _TIME_FINALS, {}),
    "時":   ("じ", "", _TIME_FINALS, {}),
    "分間": ("ふんかん", "h",
             {"さん": (None, "ぷんかん"), "よん": (None, "ぷんかん")}, {}),
    "分":   ("ふん", "h", {"さん": (None, "ぷん"), "よん": (None, "ぷん")}, {}),
    "秒":   ("びょう", "", {}, {}),
    "日":   ("にち", "", {}, {
        1: "ついたち", 2: "ふつか", 3: "みっか", 4: "よっか", 5: "いつか",
        6: "むいか", 7: "なのか", 8: "ようか", 9: "ここのか", 10: "とおか",
        14: "じゅうよっか", 20: "はつか", 24: "にじゅうよっか",
    }),
    "月":   ("がつ", "", {"よん": ("し", None), "なな": ("しち", None),
                          "きゅう": ("く", None)}, {}),
    "年間": ("ねんかん", "", {"よん": ("よ", None)}, {}),
    "年":   ("ねん", "", {"よん": ("よ", None)}, {}),
    "週間": ("しゅうかん", "s", {}, {}),
    "ヶ月": ("かげつ", "k", {}, {}),
    "か月": ("かげつ", "k", {}, {}),
    "ヵ月": ("かげつ", "k", {}, {}),
    "カ月": ("かげつ", "k", {}, {}),
    "人":   ("にん", "", {"よん": ("よ", None)},
             {1: "ひとり", 2: "ふたり"}),
    "つ":   ("つ", "", {}, {
        1: "ひとつ", 2: "ふたつ", 3: "みっつ", 4: "よっつ", 5: "いつつ",
        6: "むっつ", 7: "ななつ", 8: "やっつ", 9: "ここのつ",
    }),
    "歳":   ("さい", "s", {}, {20: "はたち"}),
    "才":   ("さい", "s", {}, {20: "はたち"}),
    "円":   ("えん", "", {"よん": ("よ", None)}, {}),
    # 円札 as one counter: number conversion otherwise consumes 千円 and
    # strands 札 without kanji context (千円札 → せんえんふだ)
    "円札": ("えんさつ", "", {"よん": ("よ", None)}, {}),
    "本":   ("ほん", "h", {"さん": (None, "ぼん")}, {}),
    "匹":   ("ひき", "h", {"さん": (None, "びき")}, {}),
    "杯":   ("はい", "h", {"さん": (None, "ばい")}, {}),
    "泊":   ("はく", "h", {"さん": (None, "ぱく")}, {}),
    "発":   ("はつ", "h", {"さん": (None, "ぱつ")}, {}),
    "票":   ("ひょう", "h", {"さん": (None, "びょう")}, {}),
    "階":   ("かい", "k", {"さん": (None, "がい")}, {}),
    "回":   ("かい", "k", {}, {}),
    "個":   ("こ", "k", {}, {}),
    "課":   ("か", "k", {}, {}),
    "軒":   ("けん", "k", {"さん": (None, "げん")}, {}),
    "件":   ("けん", "k", {}, {}),
    "冊":   ("さつ", "s", {}, {}),
    "足":   ("そく", "s", {"さん": (None, "ぞく")}, {}),
    "頭":   ("とう", "t", {}, {}),
    "点":   ("てん", "t", {}, {}),
    "通":   ("つう", "t", {}, {}),
    "枚":   ("まい", "", {}, {}),
    "台":   ("だい", "", {}, {}),
    "度":   ("ど", "", {}, {}),
    "番":   ("ばん", "", {}, {}),
    "号":   ("ごう", "", {}, {}),
    "名":   ("めい", "", {}, {}),
    "倍":   ("ばい", "", {}, {}),
    "部":   ("ぶ", "", {}, {}),
    "頁":   ("ぺーじ", "", {}, {}),
}
# 日間 shares 日's native-series durations (二日間 ふつかかん) except
# 一日間, which reads いちにちかん, not ついたちかん
_COUNTERS["日間"] = ("にちかん", "", {}, {
    k: v + "かん" for k, v in _COUNTERS["日"][3].items() if k != 1})

# final components eligible for gemination, by class (the hundreds keep
# their voiced variants: 300本 さんびゃっぽん, 600匹 ろっぴゃっぴき)
_HUNDRED_FINALS = ("ひゃく", "びゃく", "ぴゃく")
_GEMINATE = {
    "k": ("いち", "ろく", "はち", "じゅう") + _HUNDRED_FINALS,
    "s": ("いち", "はち", "じゅう"),
    "t": ("いち", "はち", "じゅう"),
    "h": ("いち", "ろく", "はち", "じゅう") + _HUNDRED_FINALS,
}
_FINALS = ("いち", "さん", "よん", "ろく", "なな", "はち", "きゅう",
           "じゅう", "せん", "ぜん", "まん", "おく", "に", "ご",
           ) + _HUNDRED_FINALS
_FINALS_BY_LEN = tuple(sorted(_FINALS, key=len, reverse=True))


def _final_component(kana: str) -> Optional[str]:
    for f in _FINALS_BY_LEN:
        if kana.endswith(f):
            return f
    return None


def counter_reading(value: int, counter: str) -> str:
    """Number + counter → kana with gemination/rendaku applied."""
    base, cls, finals, values = _COUNTERS[counter]
    if value in values:
        return values[value]
    kana = number_to_kana(value)
    fin = _final_component(kana)
    if fin in finals:
        new_num, new_counter = finals[fin]
        if new_num is not None:
            kana = kana[: -len(fin)] + new_num
        return kana + (new_counter if new_counter is not None else base)
    if cls and fin in _GEMINATE.get(cls, ()):
        head = _P_SHIFT.get(base[0], base[0]) if cls == "h" else base[0]
        return kana[:-1] + "っ" + head + base[1:]
    if cls == "h" and fin in ("さん", "せん", "ぜん", "まん"):
        # default h-counter rendaku after the nasal finals さん/せん/ぜん/
        # まん (さんぼん, せんぼん, いちまんぼん) — but NOT よん
        # (よんほん); 本/匹/杯 list さん explicitly, 分 overrides to ぷん
        return kana + _B_SHIFT.get(base[0], base[0]) + base[1:]
    return kana + base


# --------------------------------------------------------------------------
# Sentence rewriting
# --------------------------------------------------------------------------

_FULLWIDTH = str.maketrans("０１２３４５６７８９．，", "0123456789.,")
_COUNTER_ALT = "|".join(
    sorted(map(re.escape, _COUNTERS), key=len, reverse=True))
_NUMBER_RE = re.compile(
    r"(?<![0-9.])(\d{1,3}(?:,\d{3})+|\d+)(?:\.(\d+))?"
    r"([千万億兆]*)(" + _COUNTER_ALT + r")?")
_MULT_VALUE = {"千": 1000, "万": 10 ** 4, "億": 10 ** 8, "兆": 10 ** 12}
_MULT_KANA = {"千": "せん", "万": "まん", "億": "おく", "兆": "ちょう"}

# kanji numerals followed by a counter (三人, 五百円, 二万人); bare kanji
# numerals are left to the kanji→kana word/char layers
_KANJI_DIGITS = {"一": 1, "二": 2, "三": 3, "四": 4, "五": 5, "六": 6,
                 "七": 7, "八": 8, "九": 9}
_KANJI_UNITS = {"十": 10, "百": 100, "千": 1000}
_KANJI_NUM_RE = re.compile(
    "([一二三四五六七八九十百千万]+)(" + _COUNTER_ALT + ")")
# ambiguous surface forms whose non-numeric reading dominates: 十分
# "enough" (じゅうぶん), 一日 "one day / all day" (いちにち) — both have
# word-layer entries; digit forms (10分, 1日) still read as numbers
_KANJI_NUM_EXCLUDE = {"十分", "一日"}

# positional kanji numerals: a digit run containing 〇 is place-value
# notation (二〇二四年 = 2024年), not the 十/百/千 compositional form —
# rewrite to ascii digits and let the number pass read it
_KANJI_POSITIONAL_RE = re.compile("[〇一二三四五六七八九]*〇[〇一二三四五六七八九]*")
_KANJI_DIGIT_TRANS = str.maketrans("〇一二三四五六七八九", "0123456789")


def kanji_numeral_to_int(s: str) -> int:
    """一/十/百/千/万-composed numeral → int (三十五 → 35, 二万 → 20000)."""
    total = section = cur = 0
    for ch in s:
        if ch in _KANJI_DIGITS:
            cur = _KANJI_DIGITS[ch]
        elif ch in _KANJI_UNITS:
            section += (cur or 1) * _KANJI_UNITS[ch]
            cur = 0
        elif ch == "万":
            total += (section + cur or 1) * 10000
            section = cur = 0
    return total + section + cur


def _read_match(m: re.Match) -> str:
    intpart, frac, mult, counter = m.groups()
    digits = intpart.replace(",", "")
    if len(digits) > 1 and digits[0] == "0" and not mult:
        # leading zeros: read digit-by-digit (codes, phone fragments)
        out = digits_to_kana(digits)
        return out + (_COUNTERS[counter][0] if counter else "")
    value = int(digits)
    if mult:
        # digit+multiplier forms (3万円, 1.5万人, 5千): fold the
        # multiplier into the value when the result stays integral
        factor = 1
        for ch in mult:
            factor *= _MULT_VALUE[ch]
        if frac is not None:
            scaled = int(frac) * factor
            if scaled % (10 ** len(frac)) == 0:
                value = value * factor + scaled // (10 ** len(frac))
                frac = None
            else:  # non-integral (1.23456万): read digits then the unit
                unit = "".join(_MULT_KANA[ch] for ch in mult)
                out = (number_to_kana(value) + "てん" + digits_to_kana(frac)
                       + unit)
                return out + (_COUNTERS[counter][0] if counter else "")
        else:
            value *= factor
    if frac is not None:
        out = number_to_kana(value) + "てん" + digits_to_kana(frac)
        # decimals take the counter's base form, no gemination
        return out + (_COUNTERS[counter][0] if counter else "")
    if counter:
        return counter_reading(value, counter)
    return number_to_kana(value)


def _read_kanji_match(m: re.Match) -> str:
    if m.group(0) in _KANJI_NUM_EXCLUDE:
        return m.group(0)
    return counter_reading(kanji_numeral_to_int(m.group(1)), m.group(2))


def convert_numbers(text: str) -> str:
    """Rewrite every number(+counter) in raw JA text to kana, consuming
    the counter kanji.  Run BEFORE sentence splitting (decimal points and
    comma groups would be cut at mark boundaries) and before the
    kanji→kana layer (which would read the counter kanji standalone)."""
    text = text.translate(_FULLWIDTH)
    text = _KANJI_POSITIONAL_RE.sub(
        lambda m: m.group(0).translate(_KANJI_DIGIT_TRANS), text)
    text = _NUMBER_RE.sub(_read_match, text)
    return _KANJI_NUM_RE.sub(_read_kanji_match, text)
