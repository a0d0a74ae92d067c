"""Cleaner pipelines: language-tag routing over per-language G2P backends.

Parity with the reference cleaner set (reference ``text/cleaners.py:13-105``):
text is wrapped in ``[ZH]…[ZH]`` / ``[JA]…[JA]`` / ``[KO]…[KO]`` / ``[EN]…[EN]``
spans; each cleaner routes spans to the matching G2P and concatenates the IPA
with a trailing space per span, finally ensuring sentence-final punctuation.

The active pipeline for the pretrained trilingual checkpoints is
``cjke_cleaners2``.
"""

from __future__ import annotations

import re

from personalized_text_to_speech_tpu_torch.text.english import (
    english_to_ipa2,
    english_to_lazy_ipa,
    english_to_lazy_ipa2,
)
from personalized_text_to_speech_tpu_torch.text.japanese import (
    japanese_to_ipa,
    japanese_to_ipa2,
    japanese_to_romaji_with_accent,
)
from personalized_text_to_speech_tpu_torch.text.korean import (
    divide_hangul,
    korean_to_ipa,
    korean_to_lazy_ipa,
    latin_to_hangul,
    number_to_hangul,
)
from personalized_text_to_speech_tpu_torch.text.mandarin import (
    chinese_to_bopomofo,
    chinese_to_ipa,
    chinese_to_lazy_ipa,
    chinese_to_romaji,
    latin_to_bopomofo,
    number_to_chinese,
)
from personalized_text_to_speech_tpu_torch.text.sanskrit import devanagari_to_ipa
from personalized_text_to_speech_tpu_torch.text.thai import latin_to_thai, num_to_thai


def _route(text: str, tag: str, fn) -> str:
    return re.sub(
        rf"\[{tag}\](.*?)\[{tag}\]", lambda m: fn(m.group(1)) + " ", text
    )


def _finalize(text: str) -> str:
    text = re.sub(r"\s+$", "", text)
    text = re.sub(r"([^\.,!\?\-…~])$", r"\1.", text)
    return text


def japanese_cleaners(text: str) -> str:
    text = japanese_to_romaji_with_accent(text)
    text = re.sub(r"([A-Za-z])$", r"\1.", text)
    return text


def japanese_cleaners2(text: str) -> str:
    return japanese_cleaners(text).replace("ts", "ʦ").replace("...", "…")


def korean_cleaners(text: str) -> str:
    text = latin_to_hangul(text)
    text = number_to_hangul(text)
    text = divide_hangul(text)
    text = re.sub(r"([ㄱ-ㅣ])$", r"\1.", text)
    return text


def chinese_cleaners(text: str) -> str:
    text = text.replace("[ZH]", "")
    text = number_to_chinese(text)
    text = chinese_to_bopomofo(text)
    text = latin_to_bopomofo(text)
    text = re.sub(r"([ˉˊˇˋ˙])$", r"\1。", text)
    return text


def zh_ja_mixture_cleaners(text: str) -> str:
    text = _route(text, "ZH", chinese_to_romaji)
    text = _route(
        text,
        "JA",
        lambda t: japanese_to_romaji_with_accent(t)
        .replace("ts", "ʦ")
        .replace("u", "ɯ")
        .replace("...", "…"),
    )
    return _finalize(text)


def sanskrit_cleaners(text: str) -> str:
    text = text.replace("॥", "।").replace("ॐ", "ओम्")
    text = re.sub(r"([^।])$", r"\1।", text)
    return text


def cjks_cleaners(text: str) -> str:
    text = _route(text, "ZH", chinese_to_lazy_ipa)
    text = _route(text, "JA", japanese_to_ipa)
    text = _route(text, "KO", korean_to_lazy_ipa)
    text = _route(text, "SA", devanagari_to_ipa)
    text = _route(text, "EN", english_to_lazy_ipa)
    return _finalize(text)


def cjke_cleaners(text: str) -> str:
    text = _route(
        text,
        "ZH",
        lambda t: chinese_to_lazy_ipa(t)
        .replace("ʧ", "tʃ")
        .replace("ʦ", "ts")
        .replace("ɥan", "ɥæn"),
    )
    text = _route(
        text,
        "JA",
        lambda t: japanese_to_ipa(t)
        .replace("ʧ", "tʃ")
        .replace("ʦ", "ts")
        .replace("ɥan", "ɥæn")
        .replace("ʥ", "dz"),
    )
    text = _route(text, "KO", korean_to_ipa)
    text = _route(
        text,
        "EN",
        lambda t: english_to_ipa2(t)
        .replace("ɑ", "a")
        .replace("ɔ", "o")
        .replace("ɛ", "e")
        .replace("ɪ", "i")
        .replace("ʊ", "u"),
    )
    return _finalize(text)


def cjke_cleaners2(text: str) -> str:
    """The production trilingual pipeline (reference ``cleaners.py:88-99``)."""
    text = _route(text, "ZH", chinese_to_ipa)
    text = _route(text, "JA", japanese_to_ipa2)
    text = _route(text, "KO", korean_to_ipa)
    text = _route(text, "EN", english_to_ipa2)
    return _finalize(text)


def thai_cleaners(text: str) -> str:
    text = num_to_thai(text)
    text = latin_to_thai(text)
    return text


# --------------------------------------------------------------------------
# Automatic language tagging for untagged mixed-script input.
# (the reference carries an unused utils.tag_cjke for this, utils.py:28-144)
# --------------------------------------------------------------------------

_SCRIPT_PATTERNS = [
    ("JA", re.compile(r"[ぁ-ゟ゠-ヿ]")),
    ("ZH", re.compile(r"[一-鿿]")),
    ("KO", re.compile(r"[가-힣ᄀ-ᇿㄱ-ㆎ]")),
    ("EN", re.compile(r"[A-Za-z]")),
]


def detect_language(text: str) -> str:
    """Dominant script of a text span (JA wins over ZH when kana present)."""
    for tag, pattern in _SCRIPT_PATTERNS:
        if pattern.search(text):
            return tag
    return "EN"


def auto_tag(text: str) -> str:
    """Wrap maximal same-script runs in language tags.

    ``"你好hello"`` → ``"[ZH]你好[ZH][EN]hello[EN]"``.  Kana anywhere in the
    input biases han characters to Japanese, since regex alone cannot split
    han usage between the two languages.
    """
    has_kana = re.search(r"[ぁ-ゟ゠-ヿ]", text) is not None

    def char_lang(ch: str):
        if re.match(r"[ぁ-ゟ゠-ヿ]", ch):
            return "JA"
        if re.match(r"[一-鿿]", ch):
            return "JA" if has_kana else "ZH"
        if re.match(r"[가-힣ᄀ-ᇿㄱ-ㆎ]", ch):
            return "KO"
        if re.match(r"[A-Za-z0-9]", ch):
            return "EN"
        return None

    out = []
    cur_lang = None
    buf = ""

    def flush():
        nonlocal buf, cur_lang
        if buf:
            if cur_lang is None:
                out.append(buf)
            else:
                out.append(f"[{cur_lang}]{buf}[{cur_lang}]")
        buf = ""

    for ch in text:
        lang = char_lang(ch)
        if lang is None:
            # punctuation rides along with the current span
            buf += ch
            continue
        if lang != cur_lang:
            flush()
            cur_lang = lang
        buf += ch
    flush()
    return "".join(out)
