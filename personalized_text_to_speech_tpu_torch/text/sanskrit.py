"""Sanskrit (Devanagari) → IPA.

The reference ships only compiled bytecode for this module (strings show an
``indic_transliteration`` DEVANAGARI→IAST→IPA pipeline).  This rebuild maps
Devanagari directly to IPA with a self-contained table; ``indic_transliteration``
is not required.
"""

from __future__ import annotations

_CONSONANTS = {
    "क": "k", "ख": "kʰ", "ग": "g", "घ": "gʱ", "ङ": "ŋ",
    "च": "tɕ", "छ": "tɕʰ", "ज": "dʑ", "झ": "dʑʱ", "ञ": "ɲ",
    "ट": "ʈ", "ठ": "ʈʰ", "ड": "ɖ", "ढ": "ɖʱ", "ण": "ɳ",
    "त": "t", "थ": "tʰ", "द": "d", "ध": "dʱ", "न": "n",
    "प": "p", "फ": "pʰ", "ब": "b", "भ": "bʱ", "म": "m",
    "य": "j", "र": "r", "ल": "l", "व": "ʋ",
    "श": "ɕ", "ष": "ʂ", "स": "s", "ह": "ɦ", "ळ": "ɭ",
}
_INDEPENDENT_VOWELS = {
    "अ": "ə", "आ": "aː", "इ": "i", "ई": "iː", "उ": "u", "ऊ": "uː",
    "ऋ": "ri", "ॠ": "riː", "ऌ": "li", "ए": "eː", "ऐ": "əi",
    "ओ": "oː", "औ": "əu",
}
_VOWEL_SIGNS = {
    "ा": "aː", "ि": "i", "ी": "iː", "ु": "u", "ू": "uː", "ृ": "ri",
    "ॄ": "riː", "ॢ": "li", "े": "eː", "ै": "əi", "ो": "oː", "ौ": "əu",
}
_OTHER = {"ं": "m", "ः": "h", "ऽ": "", "।": ".", "॥": "."}
_VIRAMA = "्"


def devanagari_to_ipa(text: str) -> str:
    out = []
    chars = list(text)
    i = 0
    while i < len(chars):
        ch = chars[i]
        if ch in _CONSONANTS:
            out.append(_CONSONANTS[ch])
            nxt = chars[i + 1] if i + 1 < len(chars) else ""
            if nxt in _VOWEL_SIGNS:
                out.append(_VOWEL_SIGNS[nxt])
                i += 2
                continue
            if nxt == _VIRAMA:
                i += 2
                continue
            out.append("ə")  # inherent schwa
            i += 1
            continue
        if ch in _INDEPENDENT_VOWELS:
            out.append(_INDEPENDENT_VOWELS[ch])
        elif ch in _OTHER:
            out.append(_OTHER[ch])
        elif ch != _VIRAMA:
            out.append(ch)
        i += 1
    return "".join(out)
