"""Symbol vocabulary for the trilingual IPA frontend.

The vocabulary must match the reference's ``cjke_cleaners2`` symbol table
byte-for-byte and index-for-index (reference ``text/symbols.py:54-57,73`` and
``configs/finetune_speaker.json:53``) so that pretrained checkpoints remain
loadable: index 0 is the pad/blank symbol ``_`` that is also interspersed
between phonemes, indices 1..7 are punctuation, and the rest are IPA letters,
suprasegmentals and the tone-arrow set used by the ZH/JA G2P.

68 symbols total.
"""

PAD = "_"
PUNCTUATION = ",.!?-~…"
LETTERS = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑ "

SYMBOLS = [PAD] + list(PUNCTUATION) + list(LETTERS)

SPACE_ID = SYMBOLS.index(" ")

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}

# Historic alternative vocabularies supported by the reference for other
# cleaner pipelines (kept for config compatibility; training configs carry the
# actual table in their JSON "symbols" field).
CLEANER_SYMBOL_SETS = {
    "cjke_cleaners2": SYMBOLS,
}
