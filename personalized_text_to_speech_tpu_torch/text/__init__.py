"""Text frontend: raw tagged text → cleaned IPA → symbol-ID sequences.

API parity with the reference frontend (reference ``text/__init__.py:11-61``):

* ``text_to_sequence(text, symbols, cleaner_names)`` — clean + map to IDs,
  silently skipping characters outside the vocabulary,
* ``cleaned_text_to_sequence(cleaned_text, symbols)`` — map pre-cleaned IPA,
* ``sequence_to_text(sequence, symbols)`` — inverse mapping,
* ``_clean_text(text, cleaner_names)`` — run named cleaner pipeline,
* ``intersperse(seq, item)`` — insert the blank symbol between tokens
  (reference ``commons.py:24-27``), used when ``add_blank`` is set.

Unlike the reference (which crashes on import when the KO/SA/TH modules are
missing — see reference ``text/cleaners.py:2-7`` where only ``.pyc`` files
exist for those), cleaners here degrade gracefully: each language backend
reports availability and raises an actionable error only when actually used.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from personalized_text_to_speech_tpu_torch.text import cleaners as _cleaners_mod
from personalized_text_to_speech_tpu_torch.text.symbols import SYMBOLS

__all__ = [
    "text_to_sequence",
    "cleaned_text_to_sequence",
    "sequence_to_text",
    "intersperse",
    "SYMBOLS",
]


def _symbol_table(symbols: Optional[Sequence[str]]) -> Dict[str, int]:
    if symbols is None:
        symbols = SYMBOLS
    return {s: i for i, s in enumerate(symbols)}


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name!r}")
        text = cleaner(text)
    return text


def text_to_sequence(
    text: str,
    symbols: Optional[Sequence[str]] = None,
    cleaner_names: Sequence[str] = ("cjke_cleaners2",),
) -> List[int]:
    """Convert raw (language-tagged) text into a list of symbol IDs.

    Characters produced by the cleaners that are not in the vocabulary are
    skipped, matching the reference's behaviour (``text/__init__.py:24-28``).
    """
    table = _symbol_table(symbols)
    clean = _clean_text(text, cleaner_names) if cleaner_names else text
    return [table[ch] for ch in clean if ch in table]


def cleaned_text_to_sequence(
    cleaned_text: str, symbols: Optional[Sequence[str]] = None
) -> List[int]:
    """Map already-cleaned IPA text to symbol IDs (``text/__init__.py:33-42``)."""
    table = _symbol_table(symbols)
    return [table[ch] for ch in cleaned_text if ch in table]


def sequence_to_text(
    sequence: Sequence[int], symbols: Optional[Sequence[str]] = None
) -> str:
    syms = list(symbols) if symbols is not None else SYMBOLS
    return "".join(syms[i] for i in sequence)


def intersperse(seq: Sequence[int], item: int = 0) -> List[int]:
    """Insert ``item`` between every element and at both ends.

    ``[a, b] -> [item, a, item, b, item]`` (reference ``commons.py:24-27``);
    the blank gives the alignment search somewhere to dwell between phonemes.
    """
    out = [item] * (len(seq) * 2 + 1)
    out[1::2] = list(seq)
    return out
