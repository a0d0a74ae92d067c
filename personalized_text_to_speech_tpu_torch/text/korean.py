"""Korean text → jamo → IPA.

The reference ships only compiled bytecode for this module (see
``text/__pycache__/korean.cpython-38.pyc``; its source is absent from the repo,
which makes the reference frontend un-importable on Python ≠3.8).  The
bytecode's string table shows a g2pK-style pipeline: ``latin_to_hangul`` /
``number_to_hangul`` / ``divide_hangul`` / ``korean_to_ipa`` built on ``jamo``
and ``ko_pron``.

This is a self-contained rebuild: hangul syllable decomposition is pure
codepoint arithmetic (no ``jamo`` dependency needed), numbers use sino-Korean
readings, and the jamo→IPA tables implement standard Korean romanization-level
G2P.  ``ko_pron`` is used when installed for dictionary-grade pronunciations.
"""

from __future__ import annotations

import re

try:  # pragma: no cover - depends on environment
    import ko_pron as _ko_pron  # type: ignore
except Exception:  # pragma: no cover
    _ko_pron = None


# Hangul syllable block arithmetic: U+AC00 + (initial*21 + medial)*28 + final
_CHO = [
    "ㄱ", "ㄲ", "ㄴ", "ㄷ", "ㄸ", "ㄹ", "ㅁ", "ㅂ", "ㅃ", "ㅅ", "ㅆ",
    "ㅇ", "ㅈ", "ㅉ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ",
]
_JUNG = [
    "ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ", "ㅙ",
    "ㅚ", "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ",
]
_JONG = [
    "", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ", "ㄼ",
    "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ", "ㅈ",
    "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ",
]


def divide_hangul(text: str) -> str:
    """Decompose hangul syllable blocks into compatibility jamo."""
    out = []
    for ch in text:
        code = ord(ch)
        if 0xAC00 <= code <= 0xD7A3:
            idx = code - 0xAC00
            cho, rest = divmod(idx, 21 * 28)
            jung, jong = divmod(rest, 28)
            out.append(_CHO[cho])
            out.append(_JUNG[jung])
            if jong:
                out.append(_JONG[jong])
        else:
            out.append(ch)
    return "".join(out)


# Latin letter names spelled in hangul (for acronyms in Korean text)
_LATIN_TO_HANGUL = [
    (re.compile(p, re.IGNORECASE), r)
    for p, r in [
        ("a", "에이"), ("b", "비"), ("c", "시"), ("d", "디"), ("e", "이"),
        ("f", "에프"), ("g", "지"), ("h", "에이치"), ("i", "아이"),
        ("j", "제이"), ("k", "케이"), ("l", "엘"), ("m", "엠"), ("n", "엔"),
        ("o", "오"), ("p", "피"), ("q", "큐"), ("r", "아르"), ("s", "에스"),
        ("t", "티"), ("u", "유"), ("v", "브이"), ("w", "더블유"),
        ("x", "엑스"), ("y", "와이"), ("z", "제트"),
    ]
]


def latin_to_hangul(text: str) -> str:
    for regex, replacement in _LATIN_TO_HANGUL:
        text = re.sub(regex, replacement, text)
    return text


_SINO_DIGITS = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_SINO_UNITS = ["", "십", "백", "천"]
_SINO_GROUPS = ["", "만", "억", "조"]


def _four_to_hangul(n: int) -> str:
    out = []
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            continue
        if d == 1 and pos > 0:
            out.append(_SINO_UNITS[pos])
        else:
            out.append(_SINO_DIGITS[d] + _SINO_UNITS[pos])
    return "".join(out)


def number_to_hangul(text: str) -> str:
    """Replace arabic numbers with sino-Korean readings."""

    def convert(m: re.Match) -> str:
        n = int(m.group(0))
        if n == 0:
            return _SINO_DIGITS[0]
        groups = []
        while n:
            groups.append(n % 10000)
            n //= 10000
        parts = []
        for i in range(len(groups) - 1, -1, -1):
            if groups[i]:
                parts.append(_four_to_hangul(groups[i]) + _SINO_GROUPS[i])
        return "".join(parts)

    return re.sub(r"\d+", convert, text)


# jamo → IPA-ish (lazy) mapping; onset/coda context handled coarsely.
_JAMO_TO_IPA = {
    "ㄱ": "k", "ㄲ": "k͈", "ㄴ": "n", "ㄷ": "t", "ㄸ": "t͈", "ㄹ": "ɾ",
    "ㅁ": "m", "ㅂ": "p", "ㅃ": "p͈", "ㅅ": "s", "ㅆ": "s͈", "ㅇ": "ŋ",
    "ㅈ": "tɕ", "ㅉ": "tɕ͈", "ㅊ": "tɕʰ", "ㅋ": "kʰ", "ㅌ": "tʰ",
    "ㅍ": "pʰ", "ㅎ": "h",
    "ㅏ": "a", "ㅐ": "ɛ", "ㅑ": "ja", "ㅒ": "jɛ", "ㅓ": "ʌ", "ㅔ": "e",
    "ㅕ": "jʌ", "ㅖ": "je", "ㅗ": "o", "ㅘ": "wa", "ㅙ": "wɛ", "ㅚ": "we",
    "ㅛ": "jo", "ㅜ": "u", "ㅝ": "wʌ", "ㅞ": "we", "ㅟ": "wi", "ㅠ": "ju",
    "ㅡ": "ɯ", "ㅢ": "ɰi", "ㅣ": "i",
}


# compound (double) codas split into (kept coda, liaison onset)
_CODA_SPLIT = {
    "ㄳ": ("ㄱ", "ㅅ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄶ": ("ㄴ", "ㅎ"),
    "ㄺ": ("ㄹ", "ㄱ"), "ㄻ": ("ㄹ", "ㅁ"), "ㄼ": ("ㄹ", "ㅂ"),
    "ㄽ": ("ㄹ", "ㅅ"), "ㄾ": ("ㄹ", "ㅌ"), "ㄿ": ("ㄹ", "ㅍ"),
    "ㅀ": ("ㄹ", "ㅎ"), "ㅄ": ("ㅂ", "ㅅ"),
}

# syllable-final neutralization (받침 7-sound rule) in IPA
_CODA_NEUT = {
    "ㄱ": "k", "ㄲ": "k", "ㅋ": "k",
    "ㄷ": "t", "ㅌ": "t", "ㅅ": "t", "ㅆ": "t", "ㅈ": "t", "ㅊ": "t",
    "ㅎ": "t",
    "ㅂ": "p", "ㅍ": "p",
    "ㄴ": "n", "ㅁ": "m", "ㅇ": "ŋ", "ㄹ": "l",
}

_VOICED_STOP = {"k": "g", "t": "d", "p": "b", "tɕ": "dʑ"}
_ASPIRATE = {"ㄱ": "ㅋ", "ㄷ": "ㅌ", "ㅂ": "ㅍ", "ㅈ": "ㅊ"}
_PLAIN_ONSETS = {"ㄱ", "ㄷ", "ㅂ", "ㅈ"}
_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅈ": "ㅉ", "ㅅ": "ㅆ"}
# double codas simplify to their OBSTRUENT before a consonant
# (읽다→익따, 삶→삼; before a vowel the liaison split above applies instead)
_CODA_SIMPLIFY = {"ㄺ": "ㄱ", "ㄻ": "ㅁ", "ㄿ": "ㅍ"}
# aspirate carried by a following ㅎ onto a neutralized obstruent coda
# (못하다→모타다, 입학→이팍)
_NEUT_ASPIRATE = {"k": "ㅋ", "t": "ㅌ", "p": "ㅍ"}


def _hangul_to_ipa_builtin(text: str) -> str:
    """Jamo → IPA with the core sandhi rules the reference gets from
    ko_pron (reference text/korean.py:125-180): liaison, coda
    neutralization, nasal assimilation, lateralization, post-obstruent
    ㄹ nasalization, ㅎ-aspiration merge, and intervocalic voicing of
    plain stops."""
    # decompose into [onset, vowel, coda] syllables; None breaks sandhi
    sylls = []
    for ch in text:
        code = ord(ch)
        if 0xAC00 <= code <= 0xD7A3:
            idx = code - 0xAC00
            cho, rest = divmod(idx, 21 * 28)
            jung, jong = divmod(rest, 28)
            sylls.append([_CHO[cho], _JUNG[jung], _JONG[jong] or None])
        else:
            sylls.append(ch)

    # pass 1 (jamo level): split double codas, liaison, ㅎ-merges
    for i, s in enumerate(sylls):
        if not isinstance(s, list):
            continue
        nxt = sylls[i + 1] if i + 1 < len(sylls) else None
        nxt = nxt if isinstance(nxt, list) else None
        if s[2] in _CODA_SPLIT:
            keep, extra = _CODA_SPLIT[s[2]]
            if extra == "ㅎ":
                s[2] = keep  # ㄶ/ㅀ: ㅎ drops… (괜찮아요 → 괜차나요)
                if nxt is not None and nxt[0] in _ASPIRATE:
                    nxt[0] = _ASPIRATE[nxt[0]]  # …or aspirates (않다 → 안타)
            elif nxt is not None and nxt[0] == "ㅇ":
                s[2], nxt[0] = keep, extra  # 값이 → 갑시
            else:
                # before a consonant the cluster simplifies (읽다 → 익-)
                s[2] = _CODA_SIMPLIFY.get(s[2], keep)
                # …and a plain onset tenses (앉다 → 안따), which also
                # shields it from intervocalic voicing in pass 3
                if nxt is not None and nxt[0] in _TENSE:
                    nxt[0] = _TENSE[nxt[0]]
        if nxt is None:
            continue
        # coda ㅎ: aspirates a following plain onset, silent before vowel
        if s[2] == "ㅎ":
            if nxt[0] in _ASPIRATE:
                s[2], nxt[0] = None, _ASPIRATE[nxt[0]]  # 좋다 → 조타
            elif nxt[0] == "ㅇ":
                s[2] = None  # 좋아 → 조아
        # plain liaison: coda shifts onto a vowel-initial syllable
        elif s[2] is not None and nxt[0] == "ㅇ" and s[2] != "ㅇ":
            moved = s[2]
            # palatalization at the boundary: 같이 → 가치, 굳이 → 구지
            if nxt[1] == "ㅣ" and moved in ("ㄷ", "ㅌ"):
                moved = "ㅈ" if moved == "ㄷ" else "ㅊ"
            s[2], nxt[0] = None, moved  # 한국어 → 한구거
        # onset ㅎ aspirates a preceding obstruent coda: directly for
        # ㄱㄷㅂㅈ (막히다 → 마키다, ㅈ keeps its palatal place), via the
        # neutralized class otherwise (못하다 → 모타다)
        elif s[2] in _ASPIRATE and nxt[0] == "ㅎ":
            s[2], nxt[0] = None, _ASPIRATE[s[2]]
        elif s[2] is not None and nxt[0] == "ㅎ" and _CODA_NEUT.get(
            s[2]
        ) in _NEUT_ASPIRATE:
            s[2], nxt[0] = None, _NEUT_ASPIRATE[_CODA_NEUT[s[2]]]

    # pass 2 (IPA level): neutralize codas, assimilate across boundaries
    units = []  # ("on"|"v"|"coda", ipa) or ("chr", ch)
    for i, s in enumerate(sylls):
        if not isinstance(s, list):
            units.append(("chr", s))
            continue
        nxt = sylls[i + 1] if i + 1 < len(sylls) else None
        nxt = nxt if isinstance(nxt, list) else None
        if s[0] != "ㅇ":
            on_ipa = _JAMO_TO_IPA.get(s[0], "")
            # palatalization: ㅅ/ㅆ before i or a j-glide → ɕ (시 → ɕi)
            if s[0] in ("ㅅ", "ㅆ") and _JAMO_TO_IPA.get(s[1], "")[:1] in (
                "i", "j"
            ):
                on_ipa = "ɕ͈" if s[0] == "ㅆ" else "ɕ"
            units.append(("on", on_ipa))
        units.append(("v", _JAMO_TO_IPA.get(s[1], "")))
        if s[2] is not None:
            coda = _CODA_NEUT.get(s[2], "")
            if nxt is not None:
                n_on = nxt[0]
                if coda in ("k", "t", "p"):
                    if n_on in ("ㄴ", "ㅁ"):
                        # nasal assimilation: 합니다 → 함니다
                        coda = {"k": "ŋ", "t": "n", "p": "m"}[coda]
                    elif n_on == "ㄹ":
                        # obstruent+ㄹ: both nasalize (십리 → 심니)
                        coda = {"k": "ŋ", "t": "n", "p": "m"}[coda]
                        nxt[0] = "ㄴ"
                    elif coda == "t" and n_on in ("ㅅ", "ㅆ"):
                        coda = "s"  # 있습니다 → issɯmnida
                elif coda == "n" and n_on == "ㄹ":
                    coda = "l"  # lateralization: 신라 → 실라
                elif coda == "l" and n_on == "ㄴ":
                    nxt[0] = "ㄹ"  # lateralization: 설날 → 설랄
                elif coda in ("m", "ŋ") and n_on == "ㄹ":
                    nxt[0] = "ㄴ"  # 음력 → 음녁
            units.append(("coda", coda))

    # pass 3: intervocalic voicing of plain stops + ㄹ/ㄴㄹ handling
    out = []
    for i, (kind, ipa) in enumerate(units):
        if kind == "on":
            prev = units[i - 1] if i else None
            voiced_left = prev is not None and (
                prev[0] == "v" or (prev[0] == "coda" and prev[1] in "nmŋl")
            )
            if voiced_left and ipa in _VOICED_STOP:
                ipa = _VOICED_STOP[ipa]  # 한국어 → hangugə
            elif ipa == "ɾ" and prev is not None and prev[0] == "coda" \
                    and prev[1] == "l":
                ipa = "l"  # 실라 → ɕilla
        out.append(ipa if kind != "chr" else ipa)
    return "".join(out)


def korean_to_lazy_ipa(text: str) -> str:
    text = latin_to_hangul(text)
    text = number_to_hangul(text)
    if _ko_pron is not None:
        try:
            words = text.split(" ")
            ipa_words = [
                _ko_pron.romanise(w, "ipa") if re.search(r"[가-힣]", w) else w
                for w in words
            ]
            return " ".join(ipa_words)
        except Exception:
            pass
    return _hangul_to_ipa_builtin(text)


# narrow-IPA → cjke_cleaners2 vocabulary substitutions, so Korean output maps
# fully into the shared 68-symbol table (otherwise ʌ/ɕ/tense marks etc. are
# silently dropped at ID-mapping time and synthesis is garbled)
_IPA_TO_VOCAB = [
    ("t͡ɕ", "tʃ"), ("d͡ʑ", "dʑ"), ("tɕ", "tʃ"), ("dʑ", "dʑ"),
    ("͈", ""), ("͉", ""), ("̚", "#"), ("͡", ""),
    ("ɕ", "ʃ"), ("ʌ", "ə"), ("ɰ", "ɯ"), ("ɲ", "n^"), ("ɭ", "l"),
    ("ʎ", "l"), ("ʰ", "ʰ"), ("r", "ɾ"), ("ː", ""),
]


def korean_to_ipa(text: str) -> str:
    """The cjke_cleaners2 Korean hook: lazy IPA folded into the shared
    symbol vocabulary."""
    text = korean_to_lazy_ipa(text)
    for pat, rep in _IPA_TO_VOCAB:
        text = text.replace(pat, rep)
    return text
