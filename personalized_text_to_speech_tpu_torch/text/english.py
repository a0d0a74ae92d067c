"""English text normalization + grapheme-to-IPA.

Pipeline parity with the reference (reference ``text/english.py:160-188``):
ASCII-fold → lowercase → abbreviation expansion → number/currency/ordinal
normalization → IPA conversion → (for ``english_to_ipa2``) dark-l marking and
the r/ʤ/ʧ substitutions.

The reference depends on ``unidecode``, ``inflect`` and ``eng_to_ipa``; none of
those are required here:

* ASCII folding uses ``unidecode`` when installed, else a Unicode-NFKD fold,
* number normalization is a built-in English number-to-words engine,
* G2P uses ``eng_to_ipa`` when installed, else a built-in lexicon +
  letter-to-sound rules (lower fidelity than a CMUdict lookup, but fully
  standalone; install ``eng_to_ipa`` for dictionary-grade output).
"""

from __future__ import annotations

import re
import unicodedata

try:  # optional, higher-quality transliteration
    from unidecode import unidecode as _unidecode  # type: ignore
except Exception:  # pragma: no cover - depends on environment
    _unidecode = None

try:  # optional, dictionary-based IPA
    import eng_to_ipa as _eng_to_ipa  # type: ignore
except Exception:  # pragma: no cover - depends on environment
    _eng_to_ipa = None


# --------------------------------------------------------------------------
# ASCII folding
# --------------------------------------------------------------------------

# CJK punctuation that NFKD folding silently drops but unidecode (the
# reference's transliterator) maps to ASCII — the JA/ZH mark handling
# relies on 。→"." and 、→"," surviving the fold (reference
# japanese.py:103 keeps sentence marks through unidecode)
_CJK_PUNCT = str.maketrans({
    "。": ". ", "、": ", ", "，": ", ", "．": ". ",
    "「": '"', "」": '"', "『": '"', "』": '"', "・": " ",
})


def ascii_fold(text: str) -> str:
    """Transliterate to ASCII. Uses unidecode when available, else NFKD."""
    if _unidecode is not None:
        return _unidecode(text)
    folded = unicodedata.normalize("NFKD", text.translate(_CJK_PUNCT))
    return "".join(ch for ch in folded if ord(ch) < 128)


# --------------------------------------------------------------------------
# Abbreviations (the standard keithito/tacotron set, reference english.py:32-51)
# --------------------------------------------------------------------------

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = re.sub(regex, replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text)


# --------------------------------------------------------------------------
# Number-to-words (standalone replacement for the reference's inflect usage)
# --------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits_to_words(n: int, andword: str = "") -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits_to_words(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "") -> str:
    """Cardinal words for a non-negative integer, e.g. 1234 ->
    'one thousand two hundred thirty-four' (andword='' like the reference)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n == 0:
        return "zero"
    parts = []
    for scale_value, scale_name in _SCALES:
        if n >= scale_value:
            count, n = divmod(n, scale_value)
            parts.append(_three_digits_to_words(count, andword) + " " + scale_name)
    if n:
        parts.append(_three_digits_to_words(n, andword))
    return " ".join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    hyph_head, _, hyph_last = last.rpartition("-")
    core = hyph_last
    if core in _ORDINAL_SPECIAL:
        ordinal = _ORDINAL_SPECIAL[core]
    elif core.endswith("y"):
        ordinal = core[:-1] + "ieth"
    else:
        ordinal = core + "th"
    rebuilt = (hyph_head + "-" if hyph_head else "") + ordinal
    return (head + " " if head else "") + rebuilt


def _year_to_words(n: int) -> str:
    """Pairwise digit grouping for years, e.g. 1985 -> 'nineteen eighty-five',
    1906 -> 'nineteen oh six' (reference english.py:131-143 semantics)."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + number_to_words(n % 100)
    if n % 100 == 0:
        return number_to_words(n // 100) + " hundred"
    hi, lo = divmod(n, 100)
    if lo < 10:
        lo_words = "oh " + _ONES[lo]
    else:
        lo_words = _two_digits_to_words(lo)
    return _two_digits_to_words(hi) + " " + lo_words


_COMMA_NUMBER_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"[0-9]+(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        return _year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_COMMA_NUMBER_RE, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_POUNDS_RE, r"\1 pounds", text)
    text = re.sub(_DOLLARS_RE, _expand_dollars, text)
    text = re.sub(_DECIMAL_RE, lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_ORDINAL_RE, lambda m: number_to_ordinal_words(int(m.group(0)[:-2])), text)
    text = re.sub(_NUMBER_RE, _expand_number, text)
    return text


# --------------------------------------------------------------------------
# Built-in G2P fallback: small lexicon + letter-to-sound rules.
# Output style matches eng_to_ipa (CMU-derived IPA, ˈ stress marks).
# --------------------------------------------------------------------------

_LEXICON = {
    "a": "ə", "an": "ən", "the": "ðə", "i": "aɪ", "you": "ju", "he": "hi",
    "she": "ʃi", "it": "ɪt", "we": "wi", "they": "ðeɪ", "me": "mi",
    "my": "maɪ", "your": "jər", "his": "hɪz", "her": "hər", "its": "ɪts",
    "our": "aʊər", "their": "ðɛr", "this": "ðɪs", "that": "ðæt",
    "these": "ðiz", "those": "ðoʊz", "is": "ɪz", "am": "æm", "are": "ər",
    "was": "wəz", "were": "wər", "be": "bi", "been": "bɪn", "being": "biɪŋ",
    "have": "hæv", "has": "hæz", "had": "hæd", "do": "du", "does": "dəz",
    "did": "dɪd", "will": "wɪl", "would": "wʊd", "can": "kæn",
    "could": "kʊd", "should": "ʃʊd", "shall": "ʃæl", "may": "meɪ",
    "might": "maɪt", "must": "məst", "and": "ænd", "or": "ɔr", "but": "bət",
    "if": "ɪf", "then": "ðɛn", "than": "ðæn", "because": "bɪˈkɔz",
    "so": "soʊ", "not": "nɑt", "no": "noʊ", "yes": "jɛs", "of": "əv",
    "to": "tu", "in": "ɪn", "on": "ɑn", "at": "æt", "by": "baɪ",
    "for": "fɔr", "with": "wɪð", "about": "əˈbaʊt", "against": "əˈgɛnst",
    "between": "bɪˈtwin", "into": "ˈɪntu", "through": "θru",
    "during": "ˈdərɪŋ", "before": "bɪˈfɔr", "after": "ˈæftər",
    "above": "əˈbəv", "below": "bɪˈloʊ", "from": "frəm", "up": "əp",
    "down": "daʊn", "out": "aʊt", "off": "ɔf", "over": "ˈoʊvər",
    "under": "ˈəndər", "again": "əˈgɛn", "further": "ˈfərðər",
    "once": "wəns", "here": "hir", "there": "ðɛr", "when": "wɛn",
    "where": "wɛr", "why": "waɪ", "how": "haʊ", "all": "ɔl", "any": "ˈɛni",
    "both": "boʊθ", "each": "iʧ", "few": "fju", "more": "mɔr",
    "most": "moʊst", "other": "ˈəðər", "some": "səm", "such": "səʧ",
    "only": "ˈoʊnli", "own": "oʊn", "same": "seɪm", "very": "ˈvɛri",
    "just": "ʤəst", "one": "wən", "two": "tu", "three": "θri",
    "four": "fɔr", "five": "faɪv", "six": "sɪks", "seven": "ˈsɛvən",
    "eight": "eɪt", "nine": "naɪn", "ten": "tɛn", "eleven": "ɪˈlɛvən",
    "twelve": "twɛlv", "twenty": "ˈtwɛnti", "thirty": "ˈθərdi",
    "forty": "ˈfɔrti", "fifty": "ˈfɪfti", "hundred": "ˈhəndrəd",
    "thousand": "ˈθaʊzənd", "million": "ˈmɪljən", "billion": "ˈbɪljən",
    "first": "fərst", "second": "ˈsɛkənd", "third": "θərd",
    "people": "ˈpipəl", "time": "taɪm", "day": "deɪ", "year": "jɪr",
    "way": "weɪ", "thing": "θɪŋ", "man": "mæn", "woman": "ˈwʊmən",
    "world": "wərld", "life": "laɪf", "hand": "hænd", "part": "pɑrt",
    "child": "ʧaɪld", "eye": "aɪ", "place": "pleɪs", "work": "wərk",
    "week": "wik", "case": "keɪs", "point": "pɔɪnt",
    "government": "ˈgəvərmənt", "company": "ˈkəmpəni", "number": "ˈnəmbər",
    "group": "grup", "problem": "ˈprɑbləm", "fact": "fækt", "good": "gʊd",
    "new": "nu", "old": "oʊld", "great": "greɪt", "high": "haɪ",
    "small": "smɔl", "large": "lɑrʤ", "long": "lɔŋ", "little": "ˈlɪtəl",
    "right": "raɪt", "big": "bɪg", "different": "ˈdɪfərənt",
    "important": "ɪmˈpɔrtənt", "public": "ˈpəblɪk", "bad": "bæd",
    "able": "ˈeɪbəl", "say": "seɪ", "said": "sɛd", "get": "gɛt",
    "got": "gɑt", "make": "meɪk", "made": "meɪd", "go": "goʊ",
    "went": "wɛnt", "know": "noʊ", "knew": "nu", "take": "teɪk",
    "took": "tʊk", "see": "si", "saw": "sɔ", "come": "kəm",
    "came": "keɪm", "think": "θɪŋk", "thought": "θɔt", "look": "lʊk",
    "want": "wɑnt", "give": "gɪv", "gave": "geɪv", "use": "juz",
    "used": "juzd", "find": "faɪnd", "found": "faʊnd", "tell": "tɛl",
    "told": "toʊld", "ask": "æsk", "seem": "sim", "feel": "fil",
    "felt": "fɛlt", "try": "traɪ", "leave": "liv", "left": "lɛft",
    "call": "kɔl", "hello": "hɛˈloʊ", "hi": "haɪ", "goodbye": "gʊdˈbaɪ",
    "please": "pliz", "thank": "θæŋk", "thanks": "θæŋks",
    "sorry": "ˈsɑri", "test": "tɛst", "voice": "vɔɪs", "speech": "spiʧ",
    "sound": "saʊnd", "audio": "ˈɔdioʊ", "text": "tɛkst",
    "language": "ˈlæŋgwəʤ", "english": "ˈɪŋglɪʃ", "chinese": "ʧaɪˈniz",
    "japanese": "ˌʤæpəˈniz", "korean": "kɔˈriən", "model": "ˈmɑdəl",
    "speaker": "ˈspikər", "custom": "ˈkəstəm", "quick": "kwɪk",
    "brown": "braʊn", "fox": "fɑks", "jumps": "ʤəmps", "jumped": "ʤəmpt",
    "lazy": "ˈleɪzi", "dog": "dɔg", "cat": "kæt", "water": "ˈwɔtər",
    "fire": "ˈfaɪər", "earth": "ərθ", "air": "ɛr", "love": "ləv",
    "house": "haʊs", "school": "skul", "friend": "frɛnd",
    "family": "ˈfæməli", "mother": "ˈməðər", "father": "ˈfɑðər",
    "morning": "ˈmɔrnɪŋ", "night": "naɪt", "today": "təˈdeɪ",
    "tomorrow": "təˈmɑˌroʊ", "yesterday": "ˈjɛstərˌdeɪ",
    "point": "pɔɪnt", "dollars": "ˈdɑlərz", "dollar": "ˈdɑlər",
    "cents": "sɛnts", "cent": "sɛnt", "pounds": "paʊndz",
    "percent": "pərˈsɛnt", "zero": "ˈzɪroʊ", "oh": "oʊ",
    "computer": "kəmˈpjutər", "system": "ˈsɪstəm", "music": "ˈmjuzɪk",
    "story": "ˈstɔri", "read": "rid", "reading": "ˈridɪŋ",
    "book": "bʊk", "beautiful": "ˈbjutəfəl", "weather": "ˈwɛðər",
    "city": "ˈsɪti", "country": "ˈkəntri", "question": "ˈkwɛsʧən",
    "answer": "ˈænsər", "word": "wərd", "words": "wərdz",
    "sentence": "ˈsɛntəns", "synthesis": "ˈsɪnθəsəs",
    # high-frequency words, second tranche
    "been": "bɪn", "than": "ðæn", "now": "naʊ", "also": "ˈɔlsoʊ",
    "well": "wɛl", "even": "ˈivɪn", "back": "bæk", "us": "əs",
    "much": "məʧ", "still": "stɪl", "too": "tu", "many": "ˈmɛni",
    "never": "ˈnɛvər", "really": "ˈrɪli", "always": "ˈɔlˌweɪz",
    "often": "ˈɔfən", "something": "ˈsəmθɪŋ", "nothing": "ˈnəθɪŋ",
    "everything": "ˈɛvriθɪŋ", "anything": "ˈɛniˌθɪŋ",
    "someone": "ˈsəmˌwən", "everyone": "ˈɛvriˌwən", "anyone": "ˈɛniˌwən",
    "because": "bɪˈkɔz", "before": "bɪˈfɔr", "around": "əˈraʊnd",
    "another": "əˈnəðər", "together": "təˈgɛðər", "between": "bɪˈtwin",
    "without": "wɪˈθaʊt", "however": "haʊˈɛvər", "perhaps": "pərˈhæps",
    "people": "ˈpipəl", "person": "ˈpərsən", "children": "ˈʧɪldrən",
    "woman": "ˈwʊmən", "women": "ˈwɪmən", "men": "mɛn", "boy": "bɔɪ",
    "girl": "gərl", "baby": "ˈbeɪbi", "name": "neɪm", "home": "hoʊm",
    "room": "rum", "door": "dɔr", "window": "ˈwɪndoʊ", "table": "ˈteɪbəl",
    "chair": "ʧɛr", "bed": "bɛd", "food": "fud", "bread": "brɛd",
    "milk": "mɪlk", "coffee": "ˈkɔfi", "tea": "ti", "sun": "sən",
    "moon": "mun", "star": "stɑr", "sky": "skaɪ", "rain": "reɪn",
    "snow": "snoʊ", "wind": "wɪnd", "tree": "tri", "flower": "ˈflaʊər",
    "grass": "græs", "bird": "bərd", "fish": "fɪʃ", "horse": "hɔrs",
    "animal": "ˈænəməl", "river": "ˈrɪvər", "mountain": "ˈmaʊntən",
    "ocean": "ˈoʊʃən", "sea": "si", "road": "roʊd", "street": "strit",
    "car": "kɑr", "train": "treɪn", "plane": "pleɪn", "boat": "boʊt",
    "ship": "ʃɪp", "walk": "wɔk", "run": "rən", "ran": "ræn",
    "jump": "ʤəmp", "sit": "sɪt", "stand": "stænd", "sleep": "slip",
    "eat": "it", "drink": "drɪŋk", "open": "ˈoʊpən", "close": "kloʊs",
    # verb inflections of "close" voice the s (the adjective entry above
    # feeds "closely"/"closer"; the bare verb/adj split is contextual —
    # _resolve_heteronym)
    "closed": "kloʊzd", "closing": "ˈkloʊzɪŋ", "closes": "ˈkloʊzɪz",
    "start": "stɑrt", "stop": "stɑp", "play": "pleɪ", "sing": "sɪŋ",
    "dance": "dæns", "write": "raɪt", "wrote": "roʊt", "draw": "drɔ",
    "speak": "spik", "spoke": "spoʊk", "listen": "ˈlɪsən", "hear": "hir",
    "heard": "hərd", "watch": "wɑʧ", "show": "ʃoʊ", "help": "hɛlp",
    "learn": "lərn", "teach": "tiʧ", "study": "ˈstədi", "understand":
    "ˌəndərˈstænd", "remember": "rɪˈmɛmbər", "forget": "fərˈgɛt",
    "believe": "bɪˈliv", "hope": "hoʊp", "wish": "wɪʃ", "need": "nid",
    "buy": "baɪ", "bought": "bɑt", "sell": "sɛl", "pay": "peɪ",
    "money": "ˈməni", "price": "praɪs", "free": "fri", "open": "ˈoʊpən",
    "happy": "ˈhæpi", "sad": "sæd", "angry": "ˈæŋgri", "afraid": "əˈfreɪd",
    "tired": "taɪərd", "hungry": "ˈhəŋgri", "warm": "wɔrm", "cold": "koʊld",
    "hot": "hɑt", "cool": "kul", "fast": "fæst", "slow": "sloʊ",
    "early": "ˈərli", "late": "leɪt", "soon": "sun", "young": "jəŋ",
    "easy": "ˈizi", "hard": "hɑrd", "strong": "strɔŋ", "weak": "wik",
    "rich": "rɪʧ", "poor": "pur", "clean": "klin", "dirty": "ˈdərti",
    "full": "fʊl", "empty": "ˈɛmpti", "heavy": "ˈhɛvi", "light": "laɪt",
    "dark": "dɑrk", "deep": "dip", "wide": "waɪd", "narrow": "ˈnɛroʊ",
    "true": "tru", "false": "fɔls", "real": "ril", "sure": "ʃʊr",
    "ready": "ˈrɛdi", "busy": "ˈbɪzi", "quiet": "ˈkwaɪət", "loud": "laʊd",
    "nice": "naɪs", "fine": "faɪn", "best": "bɛst", "better": "ˈbɛtər",
    "worse": "wərs", "worst": "wərst", "next": "nɛkst", "last": "læst",
    "few": "fju", "several": "ˈsɛvrəl", "enough": "ɪˈnəf", "less": "lɛs",
    "least": "list", "own": "oʊn", "whole": "hoʊl", "half": "hæf",
    "quarter": "ˈkwɔrtər", "minute": "ˈmɪnət", "hour": "ˈaʊər",
    "second": "ˈsɛkənd", "month": "mənθ", "season": "ˈsizən",
    "spring": "sprɪŋ", "summer": "ˈsəmər", "autumn": "ˈɔtəm",
    "winter": "ˈwɪntər", "monday": "ˈmənˌdeɪ", "friday": "ˈfraɪˌdeɪ",
    "sunday": "ˈsənˌdeɪ", "week": "wik", "weekend": "ˈwiˌkɛnd",
    "january": "ˈʤænjuˌɛri", "evening": "ˈivnɪŋ", "afternoon": "ˌæftərˈnun",
    "letter": "ˈlɛtər", "paper": "ˈpeɪpər", "page": "peɪʤ",
    "picture": "ˈpɪkʧər", "movie": "ˈmuvi", "game": "geɪm",
    "song": "sɔŋ", "color": "ˈkələr", "red": "rɛd", "blue": "blu",
    "green": "grin", "yellow": "ˈjɛloʊ", "black": "blæk", "white": "waɪt",
    "body": "ˈbɑdi", "head": "hɛd", "face": "feɪs", "hair": "hɛr",
    "mouth": "maʊθ", "ear": "ir", "nose": "noʊz", "arm": "ɑrm",
    "leg": "lɛg", "foot": "fʊt", "heart": "hɑrt", "mind": "maɪnd",
    "idea": "aɪˈdiə", "thought": "θɔt", "dream": "drim", "truth": "truθ",
    "reason": "ˈrizən", "example": "ɪgˈzæmpəl", "kind": "kaɪnd",
    "type": "taɪp", "group": "grup", "list": "lɪst", "line": "laɪn",
    "side": "saɪd", "top": "tɑp", "bottom": "ˈbɑtəm", "middle": "ˈmɪdəl",
    "end": "ɛnd", "front": "frənt", "left": "lɛft", "center": "ˈsɛntər",
    "north": "nɔrθ", "south": "saʊθ", "east": "ist", "west": "wɛst",
    "country": "ˈkəntri", "state": "steɪt", "town": "taʊn",
    "building": "ˈbɪldɪŋ", "office": "ˈɔfəs", "store": "stɔr",
    "hospital": "ˈhɑˌspɪtəl", "church": "ʧərʧ", "park": "pɑrk",
    "garden": "ˈgɑrdən", "farm": "fɑrm", "land": "lænd", "ground": "graʊnd",
    "floor": "flɔr", "wall": "wɔl", "roof": "ruf", "kitchen": "ˈkɪʧən",
    "teacher": "ˈtiʧər", "student": "ˈstudənt", "doctor": "ˈdɑktər",
    "friend": "frɛnd", "neighbor": "ˈneɪbər", "family": "ˈfæməli",
    "brother": "ˈbrəðər", "sister": "ˈsɪstər", "son": "sən",
    "daughter": "ˈdɔtər", "husband": "ˈhəzbənd", "wife": "waɪf",
    "job": "ʤɑb", "business": "ˈbɪznəs", "war": "wɔr", "peace": "pis",
    "law": "lɔ", "rule": "rul", "power": "ˈpaʊər", "change": "ʧeɪnʤ",
    "history": "ˈhɪstəri", "science": "ˈsaɪəns", "art": "ɑrt",
    "nature": "ˈneɪʧər", "machine": "məˈʃin", "phone": "foʊn",
    "television": "ˈtɛləˌvɪʒən", "internet": "ˈɪntərˌnɛt",
    "information": "ˌɪnfərˈmeɪʃən", "news": "nuz", "question": "ˈkwɛsʧən",
    "problem": "ˈprɑbləm", "moment": "ˈmoʊmənt", "chance": "ʧæns",
    "course": "kɔrs", "level": "ˈlɛvəl", "order": "ˈɔrdər",
    "result": "rɪˈzəlt", "value": "ˈvælju", "number": "ˈnəmbər",
    "amount": "əˈmaʊnt", "piece": "pis", "pair": "pɛr", "box": "bɑks",
    "bag": "bæg", "cup": "kəp", "glass": "glæs", "plate": "pleɪt",
    "knife": "naɪf", "key": "ki", "clock": "klɑk", "map": "mæp",
    "world": "wərld", "card": "kɑrd", "ball": "bɔl", "gift": "gɪft",
    "please": "pliz", "maybe": "ˈmeɪbi", "almost": "ˈɔlˌmoʊst",
    "already": "ɔˈrɛdi", "again": "əˈgɛn", "away": "əˈweɪ",
    "everywhere": "ˈɛvriˌwɛr", "somewhere": "ˈsəmˌwɛr", "today": "təˈdeɪ",
    "tonight": "təˈnaɪt", "ago": "əˈgoʊ", "yet": "jɛt", "ever": "ˈɛvər",
    # third tranche: irregular spellings the LTS rules mangle (silent
    # letters, odd vowels) + remaining high-frequency vocabulary
    "who": "hu", "whose": "huz", "whom": "hum", "what": "wət",
    "says": "sɛz", "island": "ˈaɪlənd", "honest": "ˈɑnəst",
    "honor": "ˈɑnər", "hours": "ˈaʊərz", "heir": "ɛr", "debt": "dɛt",
    "doubt": "daʊt", "climb": "klaɪm", "comb": "koʊm", "tomb": "tum",
    "womb": "wum", "lamb": "læm", "thumb": "θəm", "limb": "lɪm",
    "sword": "sɔrd", "castle": "ˈkæsəl", "whistle": "ˈwɪsəl",
    "muscle": "ˈməsəl", "colonel": "ˈkərnəl", "choir": "ˈkwaɪər",
    "iron": "ˈaɪərn", "recipe": "ˈrɛsəpi", "naive": "nɑˈiv",
    "genre": "ˈʒɑnrə", "depot": "ˈdipoʊ", "ballet": "bæˈleɪ",
    "bouquet": "buˈkeɪ", "buffet": "bəˈfeɪ", "gourmet": "gʊrˈmeɪ",
    "receipt": "rəˈsit", "subtle": "ˈsətəl", "salmon": "ˈsæmən",
    "yacht": "jɑt", "aisle": "aɪl", "isle": "aɪl", "ache": "eɪk",
    "stomach": "ˈstəmək", "echo": "ˈɛkoʊ", "chorus": "ˈkɔrəs",
    "chaos": "ˈkeɪɑs", "chemistry": "ˈkɛməstri", "character": "ˈkɛrɪktər",
    "christmas": "ˈkrɪsməs", "machine": "məˈʃin", "chef": "ʃɛf",
    "champagne": "ʃæmˈpeɪn", "chicago": "ʃəˈkɑgoʊ", "mustache": "ˈməˌstæʃ",
    "ocean": "ˈoʊʃən", "special": "ˈspɛʃəl", "sugar": "ˈʃʊgər",
    "sure": "ʃʊr", "measure": "ˈmɛʒər", "pleasure": "ˈplɛʒər",
    "treasure": "ˈtrɛʒər", "usual": "ˈjuʒəwəl", "usually": "ˈjuʒəwəli",
    "vision": "ˈvɪʒən", "decision": "dɪˈsɪʒən", "occasion": "əˈkeɪʒən",
    "asia": "ˈeɪʒə", "europe": "ˈjʊrəp", "america": "əˈmɛrəkə",
    "women": "ˈwɪmən", "busy": "ˈbɪzi", "business": "ˈbɪznəs",
    "minute": "ˈmɪnət", "biscuit": "ˈbɪskət", "circuit": "ˈsərkət",
    "build": "bɪld", "built": "bɪlt", "guilt": "gɪlt", "guide": "gaɪd",
    "guitar": "gɪˈtɑr", "guest": "gɛst", "guard": "gɑrd",
    "league": "lig", "tongue": "təŋ", "vague": "veɪg",
    "unique": "juˈnik", "antique": "ænˈtik", "technique": "tɛkˈnik",
    "queue": "kju", "quay": "ki", "suite": "swit", "fruit": "frut",
    "juice": "ʤus", "cruise": "kruz", "bruise": "bruz",
    "soup": "sup", "group": "grup", "through": "θru", "though": "ðoʊ",
    "although": "ɔlˈðoʊ", "thorough": "ˈθəroʊ", "tough": "təf",
    "rough": "rəf", "enough": "ɪˈnəf", "cough": "kɔf", "laugh": "læf",
    "laughed": "læft", "laughter": "ˈlæftər", "daughter": "ˈdɔtər",
    "neighbor": "ˈneɪbər", "weigh": "weɪ", "weight": "weɪt",
    "height": "haɪt", "either": "ˈiðər", "neither": "ˈniðər",
    "friend": "frɛnd", "friends": "frɛndz", "field": "fild",
    "piece": "pis", "believe": "bɪˈliv", "receive": "rəˈsiv",
    "ceiling": "ˈsilɪŋ", "foreign": "ˈfɔrən", "sovereign": "ˈsɑvrən",
    "heart": "hɑrt", "hearth": "hɑrθ", "earth": "ərθ", "early": "ˈərli",
    "learn": "lərn", "heard": "hərd", "search": "sərʧ",
    "blood": "bləd", "flood": "fləd", "door": "dɔr", "floor": "flɔr",
    "poor": "pur", "great": "greɪt", "steak": "steɪk", "break": "breɪk",
    "breakfast": "ˈbrɛkfəst", "bread": "brɛd", "dead": "dɛd",
    "death": "dɛθ", "head": "hɛd", "health": "hɛlθ", "heavy": "ˈhɛvi",
    "weather": "ˈwɛðər", "sweat": "swɛt", "threat": "θrɛt",
    "breath": "brɛθ", "breathe": "brið", "meant": "mɛnt",
    "pretty": "ˈprɪti", "england": "ˈɪŋglənd", "people": "ˈpipəl",
    "police": "pəˈlis", "pizza": "ˈpitsə", "coupon": "ˈkuˌpɑn",
    # high-frequency verbs
    "keep": "kip", "kept": "kɛpt", "let": "lɛt", "put": "pʊt",
    "mean": "min", "means": "minz", "begin": "bɪˈgɪn", "began": "bɪˈgæn",
    "begun": "bɪˈgən", "become": "bɪˈkəm", "became": "bɪˈkeɪm",
    "bring": "brɪŋ", "brought": "brɔt", "carry": "ˈkɛri",
    "catch": "kæʧ", "caught": "kɔt", "choose": "ʧuz", "chose": "ʧoʊz",
    "cut": "kət", "deal": "dil", "dealt": "dɛlt", "die": "daɪ",
    "died": "daɪd", "drive": "draɪv", "drove": "droʊv", "drop": "drɑp",
    "expect": "ɪkˈspɛkt", "fall": "fɔl", "fell": "fɛl", "feed": "fid",
    "fight": "faɪt", "fought": "fɔt", "fill": "fɪl", "finish": "ˈfɪnɪʃ",
    "fly": "flaɪ", "flew": "flu", "follow": "ˈfɑloʊ", "grow": "groʊ",
    "grew": "gru", "happen": "ˈhæpən", "happened": "ˈhæpənd",
    "hold": "hoʊld", "held": "hɛld", "hit": "hɪt", "hurt": "hərt",
    "join": "ʤɔɪn", "kill": "kɪl", "lay": "leɪ", "lead": "lid",
    "led": "lɛd", "lose": "luz", "lost": "lɔst", "meet": "mit",
    "met": "mɛt", "move": "muv", "moved": "muvd", "offer": "ˈɔfər",
    "pass": "pæs", "pick": "pɪk", "plan": "plæn", "pull": "pʊl",
    "push": "pʊʃ", "raise": "reɪz", "reach": "riʧ", "preach": "priʧ",
    "return": "rɪˈtərn",
    "rise": "raɪz", "rose": "roʊz", "save": "seɪv", "send": "sɛnd",
    "sent": "sɛnt", "set": "sɛt", "shake": "ʃeɪk", "shook": "ʃʊk",
    "share": "ʃɛr", "shoot": "ʃut", "shot": "ʃɑt", "sign": "saɪn",
    "sat": "sæt", "spend": "spɛnd", "spent": "spɛnt", "stay": "steɪ",
    "strike": "straɪk", "struck": "strək", "suggest": "səgˈʤɛst",
    "support": "səˈpɔrt", "throw": "θroʊ", "threw": "θru",
    "turn": "tərn", "turned": "tərnd", "visit": "ˈvɪzət",
    "wait": "weɪt", "wake": "weɪk", "woke": "woʊk", "wear": "wɛr",
    "wore": "wɔr", "win": "wɪn", "won": "wən", "wonder": "ˈwəndər",
    "worry": "ˈwəri", "agree": "əˈgri", "allow": "əˈlaʊ",
    "appear": "əˈpɪr", "arrive": "əˈraɪv", "avoid": "əˈvɔɪd",
    "broke": "broʊk", "broken": "ˈbroʊkən", "burn": "bərn",
    "cause": "kɔz", "check": "ʧɛk", "claim": "kleɪm",
    "consider": "kənˈsɪdər", "contain": "kənˈteɪn",
    "continue": "kənˈtɪnju", "control": "kənˈtroʊl", "cover": "ˈkəvər",
    "create": "kriˈeɪt", "cross": "krɔs", "cry": "kraɪ",
    "decide": "ˌdɪˈsaɪd", "describe": "dɪˈskraɪb", "destroy": "dɪˈstrɔɪ",
    "develop": "dɪˈvɛləp", "discuss": "dɪˈskəs", "discover": "dɪˈskəvər",
    "enjoy": "ɛnˈʤɔɪ", "enter": "ˈɛntər", "explain": "ɪkˈspleɪn",
    "fail": "feɪl", "fit": "fɪt", "fix": "fɪks", "force": "fɔrs",
    "form": "fɔrm", "gain": "geɪn", "guess": "gɛs", "handle": "ˈhændəl",
    "hang": "hæŋ", "hate": "heɪt", "hide": "haɪd", "hid": "hɪd",
    "imagine": "ɪˈmæʤən", "improve": "ɪmˈpruv", "include": "ɪnˈklud",
    "increase": "ˈɪnˌkris", "intend": "ɪnˈtɛnd", "invite": "ɪnˈvaɪt",
    "involve": "ɪnˈvɑlv", "lift": "lɪft", "like": "laɪk",
    "live": "lɪv", "lived": "lɪvd", "manage": "ˈmænəʤ", "mark": "mɑrk",
    "matter": "ˈmætər", "mention": "ˈmɛnʃən", "miss": "mɪs",
    "notice": "ˈnoʊtəs", "occur": "əˈkər", "paint": "peɪnt",
    "perform": "pərˈfɔrm", "prepare": "priˈpɛr", "present": "ˈprɛzənt",
    "press": "prɛs", "prevent": "prɪˈvɛnt", "produce": "ˈproʊdus",
    "promise": "ˈprɑməs", "protect": "prəˈtɛkt", "prove": "pruv",
    "provide": "prəˈvaɪd", "realize": "ˈriəˌlaɪz",
    "recognize": "ˈrɛkəgˌnaɪz", "reduce": "rəˈdus", "refuse": "rɪˈfjuz",
    "remain": "rɪˈmeɪn", "remove": "riˈmuv", "repeat": "rɪˈpit",
    "replace": "ˌriˈpleɪs", "reply": "rɪˈplaɪ", "report": "rɪˈpɔrt",
    "require": "ˌriˈkwaɪər", "rest": "rɛst", "ring": "rɪŋ",
    "rang": "ræŋ", "rush": "rəʃ", "seek": "sik", "sought": "sɔt",
    "select": "səˈlɛkt", "separate": "ˈsɛprət", "serve": "sərv",
    "settle": "ˈsɛtəl", "shout": "ʃaʊt", "shut": "ʃət",
    "smile": "smaɪl", "spread": "sprɛd", "stare": "stɛr",
    "stick": "stɪk", "stuck": "stək", "store": "stɔr",
    "succeed": "səkˈsid", "suffer": "ˈsəfər", "suppose": "səˈpoʊz",
    "surprise": "sərˈpraɪz", "survive": "sərˈvaɪv", "talk": "tɔk",
    "talked": "tɔkt", "taste": "teɪst", "tend": "tɛnd", "touch": "təʧ",
    "travel": "ˈtrævəl", "treat": "trit", "trust": "trəst",
    "wander": "ˈwɑndər", "warn": "wɔrn", "wash": "wɑʃ",
    "waste": "weɪst", "wave": "weɪv", "welcome": "ˈwɛlkəm",
    "whisper": "ˈwɪspər", "wrap": "ræp", "written": "ˈrɪtən",
    "walked": "wɔkt", "walking": "ˈwɔkɪŋ", "worked": "wərkt",
    # high-frequency nouns / adjectives
    "action": "ˈækʃən", "age": "eɪʤ", "area": "ˈɛriə",
    "attention": "əˈtɛnʃən", "bank": "bæŋk", "battle": "ˈbætəl",
    "bit": "bɪt", "board": "bɔrd", "care": "kɛr",
    "century": "ˈsɛnʧəri", "chance": "ʧæns", "charge": "ʧɑrʤ",
    "choice": "ʧɔɪs", "class": "klæs", "condition": "kənˈdɪʃən",
    "corner": "ˈkɔrnər", "cost": "kɔst", "couple": "ˈkəpəl",
    "court": "kɔrt", "crowd": "kraʊd", "culture": "ˈkəlʧər",
    "danger": "ˈdeɪnʤər", "date": "deɪt", "decision": "dɪˈsɪʒən",
    "degree": "dɪˈgri", "demand": "dɪˈmænd", "design": "dɪˈzaɪn",
    "detail": "dɪˈteɪl", "difference": "ˈdɪfərəns", "dinner": "ˈdɪnər",
    "direction": "dəˈrɛkʃən", "distance": "ˈdɪstəns", "dream": "drim",
    "dust": "dəst", "duty": "ˈduti", "edge": "ɛʤ",
    "education": "ˌɛʤəˈkeɪʃən", "effect": "ɪˈfɛkt", "effort": "ˈɛfərt",
    "energy": "ˈɛnərʤi", "engine": "ˈɛnʤən", "event": "ɪˈvɛnt",
    "evidence": "ˈɛvədəns", "experience": "ɪkˈspɪriəns",
    "expert": "ˈɛkspərt", "feeling": "ˈfilɪŋ", "figure": "ˈfɪgjər",
    "film": "fɪlm", "finger": "ˈfɪŋgər", "flight": "flaɪt",
    "focus": "ˈfoʊkəs", "forest": "ˈfɔrəst", "future": "ˈfjuʧər",
    "gas": "gæs", "gate": "geɪt", "goal": "goʊl", "gold": "goʊld",
    "growth": "groʊθ", "guard": "gɑrd", "gun": "gən", "guy": "gaɪ",
    "hall": "hɔl", "heat": "hit", "hill": "hɪl", "hole": "hoʊl",
    "holiday": "ˈhɑləˌdeɪ", "hotel": "hoʊˈtɛl", "human": "ˈhjumən",
    "ice": "aɪs", "image": "ˈɪmɪʤ", "impact": "ˈɪmpækt",
    "income": "ˈɪnˌkəm", "industry": "ˈɪndəstri", "interest": "ˈɪntrəst",
    "issue": "ˈɪʃu", "item": "ˈaɪtəm", "judge": "ʤəʤ", "king": "kɪŋ",
    "knowledge": "ˈnɑləʤ", "lady": "ˈleɪdi", "lake": "leɪk",
    "leader": "ˈlidər", "length": "lɛŋkθ", "lesson": "ˈlɛsən",
    "library": "ˈlaɪˌbrɛri", "limit": "ˈlɪmət", "loss": "lɔs",
    "lot": "lɑt", "lunch": "lənʧ", "machine": "məˈʃin",
    "market": "ˈmɑrkət", "marriage": "ˈmɛrɪʤ", "master": "ˈmæstər",
    "material": "məˈtɪriəl", "meal": "mil", "meaning": "ˈminɪŋ",
    "meat": "mit", "meeting": "ˈmitɪŋ", "member": "ˈmɛmbər",
    "memory": "ˈmɛməri", "message": "ˈmɛsəʤ", "metal": "ˈmɛtəl",
    "method": "ˈmɛθəd", "mile": "maɪl", "mistake": "mɪˈsteɪk",
    "modern": "ˈmɑdərn", "mood": "mud", "motion": "ˈmoʊʃən",
    "mouse": "maʊs", "movement": "ˈmuvmənt", "murder": "ˈmərdər",
    "museum": "mjuˈziəm", "nation": "ˈneɪʃən", "neck": "nɛk",
    "network": "ˈnɛˌtwərk", "noise": "nɔɪz", "note": "noʊt",
    "object": "ˈɑbʤɛkt", "officer": "ˈɔfəsər", "oil": "ɔɪl",
    "operation": "ˌɑpəˈreɪʃən", "opinion": "əˈpɪnjən",
    "opportunity": "ˌɑpərˈtunəti", "option": "ˈɑpʃən", "pain": "peɪn",
    "parent": "ˈpɛrənt", "partner": "ˈpɑrtnər", "party": "ˈpɑrti",
    "past": "pæst", "path": "pæθ", "patient": "ˈpeɪʃənt",
    "pattern": "ˈpætərn", "payment": "ˈpeɪmənt", "period": "ˈpɪriəd",
    "phone": "foʊn", "photo": "ˈfoʊˌtoʊ", "phrase": "freɪz",
    "physical": "ˈfɪzɪkəl", "piano": "piˈænoʊ", "pilot": "ˈpaɪlət",
    "pitch": "pɪʧ", "plant": "plænt", "plastic": "ˈplæstɪk",
    "platform": "ˈplætˌfɔrm", "player": "ˈpleɪər", "pocket": "ˈpɑkət",
    "poem": "ˈpoʊəm", "poet": "ˈpoʊət", "poetry": "ˈpoʊətri",
    "policy": "ˈpɑləsi", "politics": "ˈpɑləˌtɪks", "pool": "pul",
    "population": "ˌpɑpjəˈleɪʃən", "position": "pəˈzɪʃən",
    "possible": "ˈpɑsəbəl", "potato": "pəˈteɪˌtoʊ",
    "practice": "ˈpræktəs", "president": "ˈprɛzəˌdɛnt",
    "pressure": "ˈprɛʃər", "pride": "praɪd", "prince": "prɪns",
    "princess": "ˈprɪnˌsɛs", "principle": "ˈprɪnsəpəl", "print": "prɪnt",
    "prison": "ˈprɪzən", "private": "ˈpraɪvət", "prize": "praɪz",
    "process": "ˈprɑˌsɛs", "product": "ˈprɑdəkt",
    "professor": "prəˈfɛsər", "profit": "ˈprɑfət",
    "program": "ˈproʊˌgræm", "project": "ˈprɑʤɛkt",
    "property": "ˈprɑpərti", "purpose": "ˈpərpəs",
    "quality": "ˈkwɑləti", "queen": "kwin", "race": "reɪs",
    "radio": "ˈreɪdiˌoʊ", "range": "reɪnʤ", "rate": "reɪt",
    "record": "ˈrɛkərd", "region": "ˈriʤən", "relationship":
    "riˈleɪʃənˌʃɪp", "religion": "rɪˈlɪʤən", "research": "riˈsərʧ",
    "resource": "ˈriˌsɔrs", "response": "rɪˈspɑns",
    "restaurant": "ˈrɛstəˌrɑnt", "review": "ˌriˈvju", "reward": "rɪˈwɔrd",
    "rhythm": "ˈrɪðəm", "rice": "raɪs", "ride": "raɪd", "risk": "rɪsk",
    "rock": "rɑk", "role": "roʊl", "roll": "roʊl", "route": "rut",
    "safety": "ˈseɪfti", "salt": "sɔlt", "sample": "ˈsæmpəl",
    "sand": "sænd", "scale": "skeɪl", "scene": "sin",
    "schedule": "ˈskɛʤʊl", "scheme": "skim", "science": "ˈsaɪəns",
    "score": "skɔr", "screen": "skrin", "secret": "ˈsikrət",
    "secretary": "ˈsɛkrəˌtɛri", "section": "ˈsɛkʃən",
    "security": "sɪˈkjʊrəti", "sense": "sɛns", "series": "ˈsɪriz",
    "service": "ˈsərvəs", "shadow": "ˈʃædoʊ", "shape": "ʃeɪp",
    "sheet": "ʃit", "shelf": "ʃɛlf", "shell": "ʃɛl", "shift": "ʃɪft",
    "shirt": "ʃərt", "shock": "ʃɑk", "shoe": "ʃu", "shoes": "ʃuz",
    "shop": "ʃɑp", "shoulder": "ˈʃoʊldər", "sight": "saɪt",
    "signal": "ˈsɪgnəl", "silence": "ˈsaɪləns", "silver": "ˈsɪlvər",
    "site": "saɪt", "situation": "ˌsɪʧuˈeɪʃən", "size": "saɪz",
    "skill": "skɪl", "skin": "skɪn", "smoke": "smoʊk",
    "society": "soʊˈsaɪəti", "software": "ˈsɔfˌtwɛr", "soil": "sɔɪl",
    "soldier": "ˈsoʊlʤər", "solution": "səˈluʃən", "source": "sɔrs",
    "space": "speɪs", "speed": "spid", "spirit": "ˈspɪrət",
    "sport": "spɔrt", "spot": "spɑt", "staff": "stæf",
    "stage": "steɪʤ", "standard": "ˈstændərd", "station": "ˈsteɪʃən",
    "status": "ˈstætəs", "steel": "stil", "stone": "stoʊn",
    "strategy": "ˈstrætəʤi", "stream": "strim", "strength": "strɛŋkθ",
    "stress": "strɛs", "structure": "ˈstrəkʧər", "style": "staɪl",
    "subject": "ˈsəbʤɪkt", "success": "səkˈsɛs", "suit": "sut",
    "surface": "ˈsərfəs", "symbol": "ˈsɪmbəl", "situation":
    "ˌsɪʧuˈeɪʃən", "target": "ˈtɑrgət", "task": "tæsk",
    "team": "tim", "technology": "tɛkˈnɑləʤi", "temperature":
    "ˈtɛmprəʧər", "term": "tərm", "theory": "ˈθɪri", "ticket": "ˈtɪkət",
    "title": "ˈtaɪtəl", "tool": "tul", "total": "ˈtoʊtəl",
    "traffic": "ˈtræfɪk", "trip": "trɪp", "trouble": "ˈtrəbəl",
    "university": "ˌjunəˈvərsəti", "valley": "ˈvæli", "variety":
    "vəˈraɪəti", "vehicle": "ˈviɪkəl", "version": "ˈvərʒən",
    "victory": "ˈvɪktəri", "view": "vju", "village": "ˈvɪlɪʤ",
    "visitor": "ˈvɪzətər", "wage": "weɪʤ", "wedding": "ˈwɛdɪŋ",
    "wheel": "wil", "while": "waɪl", "wood": "wʊd", "worker": "ˈwərkər",
    "yard": "jɑrd", "youth": "juθ", "zone": "zoʊn",
    "amazing": "əˈmeɪzɪŋ", "ancient": "ˈeɪnʧənt", "certain": "ˈsərtən",
    "common": "ˈkɑmən", "complete": "kəmˈplit", "correct": "kəˈrɛkt",
    "crazy": "ˈkreɪzi", "current": "ˈkərənt", "dangerous": "ˈdeɪnʤərəs",
    "difficult": "ˈdɪfəkəlt", "entire": "ɪnˈtaɪər", "equal": "ˈikwəl",
    "exact": "ɪgˈzækt", "excellent": "ˈɛksələnt", "famous": "ˈfeɪməs",
    "favorite": "ˈfeɪvərɪt", "final": "ˈfaɪnəl", "foreign": "ˈfɔrən",
    "fresh": "frɛʃ", "funny": "ˈfəni", "general": "ˈʤɛnərəl",
    "gentle": "ˈʤɛntəl", "huge": "hjuʤ", "interesting": "ˈɪntrəstɪŋ",
    "local": "ˈloʊkəl", "lovely": "ˈləvli", "lucky": "ˈləki",
    "main": "meɪn", "major": "ˈmeɪʤər", "modern": "ˈmɑdərn",
    "natural": "ˈnæʧərəl", "necessary": "ˈnɛsəˌsɛri", "normal": "ˈnɔrməl",
    "obvious": "ˈɑbviəs", "ordinary": "ˈɔrdəˌnɛri", "original":
    "əˈrɪʤənəl", "particular": "pərˈtɪkjələr", "perfect": "ˈpərˌfɪkt",
    "personal": "ˈpərsɪnɪl", "popular": "ˈpɑpjələr", "positive":
    "ˈpɑzətɪv", "powerful": "ˈpaʊərfəl", "previous": "ˈpriviəs",
    "proper": "ˈprɑpər", "proud": "praʊd", "recent": "ˈrisənt",
    "regular": "ˈrɛgjələr", "serious": "ˈsɪriəs", "significant":
    "səgˈnɪfɪkənt", "similar": "ˈsɪmələr", "simple": "ˈsɪmpəl",
    "single": "ˈsɪŋgəl", "smart": "smɑrt", "social": "ˈsoʊʃəl",
    "special": "ˈspɛʃəl", "strange": "streɪnʤ", "successful":
    "səkˈsɛsfəl", "sweet": "swit", "terrible": "ˈtɛrəbəl",
    "total": "ˈtoʊtəl", "useful": "ˈjusfəl", "various": "ˈvɛriəs",
    "wonderful": "ˈwəndərfəl", "wrong": "rɔŋ",
    # fourth tranche: high-frequency words from a measured OOV sweep
    # over real prose (tools/eval_g2p.py) — general vocabulary,
    # software/technical terms, and spelled letter names
    "as": "æz",
    "which": "wɪʧ",
    "base": "beɪs",
    "instead": "ɪnˈstɛd",
    "relate": "rɪˈleɪt",
    "alt": "ɔlt",
    "via": "ˈvaɪə",
    "per": "pər",
    "non": "nɑn",
    "etc": "ɛtˈsɛtərə",
    "available": "əˈveɪləbəl",
    "development": "dɪˈvɛləpmənt",
    "multiple": "ˈməltəpəl",
    "additional": "əˈdɪʃənəl",
    "addition": "əˈdɪʃən",
    "requirement": "rɪˈkwaɪərmənt",
    "specific": "spəˈsɪfɪk",
    "specify": "ˈspɛsəˌfaɪ",
    "generate": "ˈʤɛnəˌreɪt",
    "depend": "dɪˈpɛnd",
    "dependency": "dɪˈpɛndənsi",
    "description": "dɪˈskrɪpʃən",
    "define": "dɪˈfaɪn",
    "definition": "ˌdɛfəˈnɪʃən",
    "contribute": "kənˈtrɪbjut",
    "maintain": "meɪnˈteɪn",
    "code": "koʊd",
    "python": "ˈpaɪθɑn",
    "install": "ɪnˈstɔl",
    "installation": "ˌɪnstəˈleɪʃən",
    "github": "ˈgɪtˌhəb",
    "git": "gɪt",
    "documentation": "ˌdɑkjəmənˈteɪʃən",
    "document": "ˈdɑkjəmənt",
    "default": "dɪˈfɔlt",
    "license": "ˈlaɪsəns",
    "package": "ˈpækɪʤ",
    "api": "ˌeɪˌpiˈaɪ",
    "google": "ˈgugəl",
    "add": "æd",
    "import": "ˈɪmpɔrt",
    "export": "ˈɛkspɔrt",
    "file": "faɪl",
    "function": "ˈfəŋkʃən",
    "data": "ˈdeɪtə",
    "block": "blɑk",
    "align": "əˈlaɪn",
    "module": "ˈmɑʤul",
    "environment": "ɪnˈvaɪrənmənt",
    "url": "ˌjuˌɑrˈɛl",
    "release": "rɪˈlis",
    "cloud": "klaʊd",
    "client": "ˈklaɪənt",
    "string": "strɪŋ",
    "format": "ˈfɔrmæt",
    "performance": "pərˈfɔrməns",
    "output": "ˈaʊtˌpʊt",
    "input": "ˈɪnˌpʊt",
    "bug": "bəg",
    "error": "ˈɛrər",
    "command": "kəˈmænd",
    "server": "ˈsərvər",
    "request": "rɪˈkwɛst",
    "feature": "ˈfiʧər",
    "optional": "ˈɑpʃənəl",
    "config": "kənˈfɪg",
    "configuration": "kənˌfɪgjəˈreɪʃən",
    "directory": "dəˈrɛktəri",
    "token": "ˈtoʊkən",
    "update": "əpˈdeɪt",
    "delete": "dɪˈlit",
    "index": "ˈɪndɛks",
    "node": "noʊd",
    "parse": "pɑrs",
    "branch": "brænʧ",
    "merge": "mərʤ",
    "commit": "kəˈmɪt",
    "pip": "pɪp",
    "repository": "rɪˈpɑzəˌtɔri",
    "script": "skrɪpt",
    "syntax": "ˈsɪnˌtæks",
    "array": "əˈreɪ",
    "integer": "ˈɪntəʤər",
    "float": "floʊt",
    "boolean": "ˈbuliən",
    "variable": "ˈvɛriəbəl",
    "parameter": "pəˈræmətər",
    "argument": "ˈɑrgjəmənt",
    "attribute": "ˈætrəˌbjut",
    "instance": "ˈɪnstəns",
    "interface": "ˈɪntərˌfeɪs",
    "framework": "ˈfreɪmˌwərk",
    "runtime": "ˈrənˌtaɪm",
    "compile": "kəmˈpaɪl",
    "debug": "diˈbəg",
    "execute": "ˈɛksəˌkjut",
    "implement": "ˈɪmpləˌmɛnt",
    "implementation": "ˌɪmpləmɛnˈteɪʃən",
    "algorithm": "ˈælgəˌrɪðəm",
    "database": "ˈdeɪtəˌbeɪs",
    "protocol": "ˈproʊtəˌkɔl",
    "hardware": "ˈhɑrdˌwɛr",
    "folder": "ˈfoʊldər",
    "upload": "ˈəpˌloʊd",
    "download": "ˈdaʊnˌloʊd",
    "browser": "ˈbraʊzər",
    "website": "ˈwɛbˌsaɪt",
    "web": "wɛb",
    "email": "ˈiˌmeɪl",
    "online": "ˌɔnˈlaɪn",
    "offline": "ˌɔfˈlaɪn",
    "username": "ˈjuzərˌneɪm",
    "password": "ˈpæsˌwərd",
    "login": "ˈlɔgˌɪn",
    "setting": "ˈsɛtɪŋ",
    "button": "ˈbətən",
    "display": "dɪˈspleɪ",
    "keyboard": "ˈkiˌbɔrd",
    "click": "klɪk",
    "icon": "ˈaɪˌkɑn",
    "menu": "ˈmɛnju",
    "tab": "tæb",
    "filter": "ˈfɪltər",
    "sort": "sɔrt",
    "load": "loʊd",
    "cache": "kæʃ",
    "disk": "dɪsk",
    "thread": "θrɛd",
    "stack": "stæk",
    "loop": "lup",
    "operator": "ˈɑpəˌreɪtər",
    "reference": "ˈrɛfərəns",
    "pointer": "ˈpɔɪntər",
    "address": "ˈæˌdrɛs",
    "buffer": "ˈbəfər",
    "handler": "ˈhændlər",
    "callback": "ˈkɔlˌbæk",
    "session": "ˈsɛʃən",
    "log": "lɔg",
    "trace": "treɪs",
    "metric": "ˈmɛtrɪk",
    "benchmark": "ˈbɛnʧˌmɑrk",
    "latency": "ˈleɪtənsi",
    "throughput": "ˈθruˌpʊt",
    "bandwidth": "ˈbændˌwɪdθ",
    "kernel": "ˈkərnəl",
    "tensor": "ˈtɛnsər",
    "vector": "ˈvɛktər",
    "matrix": "ˈmeɪtrɪks",
    "gradient": "ˈgreɪdiənt",
    "neural": "ˈnʊrəl",
    "frequency": "ˈfrikwənsi",
    "channel": "ˈʧænəl",
    "batch": "bæʧ",
    "epoch": "ˈɛpək",
    "inference": "ˈɪnfərəns",
    "device": "dɪˈvaɪs",
    "chip": "ʧɪp",
    "core": "kɔr",
    "docs": "dɑks",
    "doc": "dɑk",
    "plugin": "ˈpləgˌɪn",
    "widget": "ˈwɪʤət",
    "template": "ˈtɛmplət",
    "schema": "ˈskimə",
    "query": "ˈkwɪri",
    "column": "ˈkɑləm",
    "row": "roʊ",
    "graph": "græf",
    "hash": "hæʃ",
    "encode": "ɪnˈkoʊd",
    "decode": "diˈkoʊd",
    "encrypt": "ɪnˈkrɪpt",
    "secure": "sɪˈkjʊr",
    "certificate": "sərˈtɪfɪkət",
    "none": "nən", "usage": "ˈjusɪʤ", "console": "ˈkɑnˌsoʊl",
    "copyright": "ˈkɑpiˌraɪt", "contribution": "ˌkɑntrəˈbjuʃən",
    "unicode": "ˈjunɪˌkoʊd", "linux": "ˈlɪnəks", "dont": "doʊnt",
    "json": "ˈʤeɪˌsɑn", "width": "wɪdθ", "height": "haɪt",
    "match": "mæʧ", "regex": "ˈrɛʤˌɛks", "async": "ˌeɪˈsɪŋk",
    "sync": "sɪŋk", "backend": "ˈbækˌɛnd", "frontend": "ˈfrəntˌɛnd",
    "null": "nəl", "tuple": "ˈtupəl",
    "iterator": "ˈɪtəˌreɪtər", "readme": "ˈridˌmi", "wheel": "wil",
    "binary": "ˈbaɪnəri", "decimal": "ˈdɛsəməl", "octal": "ˈɑktəl",
    "prefix": "ˈpriˌfɪks", "suffix": "ˈsəˌfɪks", "stream": "strim",
    "whitespace": "ˈwaɪtˌspeɪs",
    "timeout": "ˈtaɪmˌaʊt", "timestamp": "ˈtaɪmˌstæmp",
    "metadata": "ˈmɛtəˌdeɪtə", "namespace": "ˈneɪmˌspeɪs",
    "validate": "ˈvæləˌdeɪt", "validation": "ˌvæləˈdeɪʃən",
    "deprecated": "ˈdɛprəˌkeɪtəd", "legacy": "ˈlɛgəsi",
    "tutorial": "tuˈtɔriəl", "wiki": "ˈwɪki", "forum": "ˈfɔrəm",
    # fifth tranche: measured top OOV fallbacks from the round-4 sweep
    # (tools/eval_g2p.py --top over ~190k tokens of real prose) — common
    # function words the LTS rules mispronounce, high-frequency technical
    # vocabulary, and standard software proper nouns
    "them": "ðɛm", "since": "sɪns", "whether": "ˈwɛðər",
    "given": "ˈgɪvən", "within": "wɪˈðɪn", "across": "əˈkrɔs",
    "every": "ˈɛvri", "itself": "ɪtˈsɛlf", "except": "ɪkˈsɛpt",
    "otherwise": "ˈəðərˌwaɪz", "due": "du", "thus": "ðəs",
    "cannot": "ˈkænɑt", "rather": "ˈræðər", "unless": "ənˈlɛs",
    "inside": "ˌɪnˈsaɪd", "until": "ənˈtɪl", "probably": "ˈprɑbəbli",
    "actually": "ˈækʧuəli", "typically": "ˈtɪpɪkli",
    "manually": "ˈmænjuəli", "fully": "ˈfʊli", "simply": "ˈsɪmpli",
    "directly": "dəˈrɛktli", "explicitly": "ɪkˈsplɪsɪtli",
    "automatically": "ˌɔtəˈmætɪkli", "alternatively": "ɔlˈtərnətɪvli",
    "corresponding": "ˌkɔrəˈspɑndɪŋ", "known": "noʊn", "done": "dən",
    "youre": "jʊr", "youll": "jul", "wont": "woʊnt", "isnt": "ˈɪzənt",
    "doesnt": "ˈdəzənt",
    "access": "ˈæksɛs", "enable": "ɪˈneɪbəl", "content": "ˈkɑntɛnt",
    "coverage": "ˈkəvərɪʤ", "storage": "ˈstɔrɪʤ",
    "terminal": "ˈtərmənəl", "community": "kəˈmjunɪti",
    "behavior": "bɪˈheɪvjər", "behaviour": "bɪˈheɪvjər",
    "summary": "ˈsəməri", "internal": "ɪnˈtərnəl",
    "external": "ɪkˈstərnəl", "prompt": "prɑmpt", "self": "sɛlf",
    "copy": "ˈkɑpi", "mode": "moʊd", "root": "rut", "flag": "flæg",
    "step": "stɛp", "scope": "skoʊp", "port": "pɔrt", "link": "lɪŋk",
    "setup": "ˈsɛtˌəp", "subset": "ˈsəbˌsɛt", "multi": "ˈməlti",
    "extra": "ˈɛkstrə", "generic": "ʤəˈnɛrɪk", "static": "ˈstætɪk",
    "stable": "ˈsteɪbəl", "valid": "ˈvælɪd", "invalid": "ɪnˈvælɪd",
    "basic": "ˈbeɪsɪk", "complex": "kəmˈplɛks", "strict": "strɪkt",
    "split": "splɪt", "progress": "ˈprɑgrɛs", "upgrade": "ˈəpˌgreɪd",
    "configure": "kənˈfɪgjər", "tag": "tæg", "org": "ɔrg",
    "equivalent": "ɪˈkwɪvələnt", "keyword": "ˈkiˌwərd",
    "disable": "dɪsˈeɪbəl", "context": "ˈkɑntɛkst",
    "generation": "ˌʤɛnəˈreɪʃən", "evaluation": "ɪˌvæljuˈeɪʃən",
    "compute": "kəmˈpjut", "incompatible": "ˌɪnkəmˈpætəbəl",
    "compatible": "kəmˈpætəbəl", "compatibility": "kəmˌpætəˈbɪlɪti",
    "info": "ˈɪnfoʊ", "expression": "ɪkˈsprɛʃən", "dev": "dɛv",
    "spec": "spɛk", "overview": "ˈoʊvərˌvju", "accept": "ækˈsɛpt",
    "minor": "ˈmaɪnər", "connection": "kəˈnɛkʃən", "host": "hoʊst",
    "collection": "kəˈlɛkʃən", "component": "kəmˈpoʊnənt",
    "experimental": "ɪkˌspɛrəˈmɛntəl", "max": "mæks", "font": "fɑnt",
    "iterable": "ˈɪtərəbəl", "pipeline": "ˈpaɪpˌlaɪn", "repo": "ˈrɛpoʊ",
    "precision": "prɪˈsɪʒən", "advanced": "ədˈvænst",
    "conduct": "ˈkɑndəkt", "proxy": "ˈprɑksi", "digest": "ˈdaɪʤɛst",
    "accelerate": "ækˈsɛləˌreɪt", "logic": "ˈlɑʤɪk",
    "alternative": "ɔlˈtərnətɪv", "sys": "sɪs", "location": "loʊˈkeɪʃən",
    "monitor": "ˈmɑnətər", "count": "kaʊnt", "dot": "dɑt",
    "interactive": "ˌɪntərˈæktɪv", "integration": "ˌɪntəˈgreɪʃən",
    "representation": "ˌrɛprɪˌzɛnˈteɪʃən", "escape": "ɪˈskeɪp",
    "chat": "ʧæt", "asynchronous": "eɪˈsɪŋkrənəs", "scalar": "ˈskeɪlər",
    "skip": "skɪp", "computation": "ˌkɑmpjuˈteɪʃən", "arg": "ɑrg",
    "alias": "ˈeɪliəs", "init": "ɪˈnɪt", "reset": "riˈsɛt",
    "agent": "ˈeɪʤənt", "websocket": "ˈwɛbˌsɑkɪt",
    "compliance": "kəmˈplaɪəns", "recommend": "ˌrɛkəˈmɛnd",
    "ignore": "ɪgˈnɔr", "native": "ˈneɪtɪv", "post": "poʊst",
    "auto": "ˈɔtoʊ", "global": "ˈgloʊbəl", "regression": "rɪˈgrɛʃən",
    "bump": "bəmp", "unused": "ənˈjuzd", "media": "ˈmidiə",
    "video": "ˈvɪdioʊ", "hub": "həb", "sparse": "spɑrs", "app": "æp",
    "raw": "rɔ", "virtual": "ˈvərʧuəl", "official": "əˈfɪʃəl",
    "low": "loʊ", "minimal": "ˈmɪnəməl", "maintenance": "ˈmeɪntənəns",
    "account": "əˈkaʊnt", "cursor": "ˈkərsər", "signature": "ˈsɪgnəʧər",
    "byte": "baɪt",
    "pypi": "ˈpaɪˌpiˌaɪ", "jupyter": "ˈʤupɪtər", "numpy": "ˈnəmˌpaɪ",
    "pytorch": "ˈpaɪˌtɔrʧ", "scipy": "ˈsaɪˌpaɪ", "cython": "ˈsaɪθɑn",
    "ipython": "ˌaɪˈpaɪθɑn", "pandas": "ˈpændəs",
    "macos": "ˌmækˌoʊˈɛs", "docker": "ˈdɑkər", "gpu": "ˌʤiˌpiˈju",
    "cpu": "ˌsiˌpiˈju", "tpu": "ˌtiˌpiˈju", "os": "ˌoʊˈɛs",
    "io": "ˌaɪˈoʊ", "id": "ˌaɪˈdi", "uri": "ˌjuˌɑrˈaɪ",
    "utf": "ˌjuˌtiˈɛf", "ascii": "ˈæski", "oauth": "ˈoʊˌɔθ",
    "sphinx": "sfɪŋks", "matplotlib": "ˌmætˈplɑtlɪb",
    "tensorflow": "ˈtɛnsərˌfloʊ", "tensorboard": "ˈtɛnsərˌbɔrd",
    "keras": "ˈkɛrəs", "cuda": "ˈkudə", "nvidia": "ɛnˈvɪdiə",
    "intel": "ˈɪntɛl", "torch": "tɔrʧ", "pytest": "ˈpaɪˌtɛst",
    "mypy": "ˈmaɪˌpaɪ", "haiku": "ˈhaɪku", "flax": "flæks",
    "jax": "ʤæks", "conda": "ˈkɑndə", "anaconda": "ˌænəˈkɑndə",
    "apache": "əˈpæʧi", "markdown": "ˈmɑrkˌdaʊn", "latex": "ˈleɪˌtɛk",
    "bash": "bæʃ", "env": "ˈɛnv", "venv": "ˈviˌɛnv", "ci": "ˌsiˈaɪ",
    "register": "ˈrɛʤɪstər", "profile": "ˈproʊˌfaɪl",
    "duplicate": "ˈduplɪkət", "random": "ˈrændəm", "attempt": "əˈtɛmpt",
    "constraint": "kənˈstreɪnt", "introduction": "ˌɪntrəˈdəkʃən",
    "cite": "saɪt", "grid": "grɪd", "expand": "ɪkˈspænd",
    "management": "ˈmænɪʤmənt", "remote": "rɪˈmoʊt",
    "override": "ˌoʊvərˈraɪd", "variant": "ˈvɛriənt",
    "donate": "ˈdoʊˌneɪt", "readable": "ˈridəbəl", "short": "ʃɔrt",
    "axis": "ˈæksɪs", "completion": "kəmˈpliʃən", "active": "ˈæktɪv",
    "await": "əˈweɪt", "lower": "ˈloʊər", "refresh": "rɪˈfrɛʃ",
    "arrow": "ˈæroʊ", "interpreter": "ɪnˈtərprətər", "patch": "pæʧ",
    "union": "ˈjunjən", "tokenizer": "ˈtoʊkəˌnaɪzər",
    "individual": "ˌɪndəˈvɪʤuəl", "execution": "ˌɛksəˈkjuʃən",
    "pickle": "ˈpɪkəl", "quickstart": "ˈkwɪkˌstɑrt", "spam": "spæm",
    "stub": "stəb", "permission": "pərˈmɪʃən",
    "transformation": "ˌtrænsfərˈmeɪʃən", "enterprise": "ˈɛntərˌpraɪz",
    "subscription": "səbˈskrɪpʃən", "utility": "juˈtɪlɪti",
    "entry": "ˈɛntri", "flexible": "ˈflɛksəbəl",
    "checkpoint": "ˈʧɛkˌpɔɪnt", "author": "ˈɔθər", "round": "raʊnd",
    "comment": "ˈkɑˌmɛnt", "ambiguous": "æmˈbɪgjuəs",
    "limitation": "ˌlɪməˈteɪʃən", "visual": "ˈvɪʒuəl",
    "notebook": "ˈnoʊtˌbʊk", "lookup": "ˈlʊkˌəp",
    "alignment": "əˈlaɪnmənt", "dynamic": "daɪˈnæmɪk",
    "activate": "ˈæktəˌveɪt", "bin": "bɪn",
    "compilation": "ˌkɑmpəˈleɪʃən", "sequence": "ˈsikwəns",
    "hook": "hʊk", "sub": "səb", "modify": "ˈmɑdəˌfaɪ",
    "maximum": "ˈmæksəməm", "minimum": "ˈmɪnəməm", "safe": "seɪf",
    "entity": "ˈɛntɪti", "improvement": "ɪmˈpruvmənt",
    "manual": "ˈmænjuəl", "embed": "ɪmˈbɛd", "clone": "kloʊn",
    "initial": "ɪˈnɪʃəl", "builtin": "ˈbɪltˌɪn",
    "interval": "ˈɪntərvəl", "discussion": "dɪˈskəʃən",
    "literal": "ˈlɪtərəl", "unsupported": "ˌənsəˈpɔrtɪd", "leaf": "lif",
    "substitution": "ˌsəbstəˈtuʃən",
    "optimization": "ˌɑptəməˈzeɪʃən",
    "miscellaneous": "ˌmɪsəˈleɪniəs", "grammar": "ˈgræmər",
    "refer": "rəˈfər", "mix": "mɪks", "downstream": "ˈdaʊnˈstrim",
    "explicit": "ɪkˈsplɪsɪt", "arbitrary": "ˈɑrbəˌtrɛri",
    "conversion": "kənˈvərʒən", "replacement": "rɪˈpleɪsmənt",
    "demo": "ˈdɛmoʊ", "clear": "klɪr", "isolated": "ˈaɪsəˌleɪtɪd",
    "render": "ˈrɛndər", "span": "spæn", "lock": "lɑk",
    "indicate": "ˈɪndəˌkeɪt", "detection": "dɪˈtɛkʃən",
    "exception": "ɪkˈsɛpʃən", "expansion": "ɪkˈspænʃən", "nest": "nɛst",
    "dictionary": "ˈdɪkʃəˌnɛri", "distribution": "ˌdɪstrəˈbjuʃən",
    "distributed": "dɪˈstrɪbjətɪd",
    "functionality": "ˌfəŋkʃəˈnælɪti", "convert": "kənˈvərt",
    "quantization": "ˌkwɑntəˈzeɪʃən", "quantized": "ˈkwɑnˌtaɪzd",
    "specification": "ˌspɛsəfəˈkeɪʃən", "badge": "bæʤ",
    "dataset": "ˈdeɪtəˌsɛt", "annotation": "ˌænəˈteɪʃən",
    "ensure": "ɪnˈʃʊr", "serialization": "ˌsɪriələˈzeɪʃən",
    "bind": "baɪnd", "exist": "ɪgˈzɪst", "instruction": "ɪnˈstrəkʃən",
    "changelog": "ˈʧeɪnʤˌlɔg", "application": "ˌæpləˈkeɪʃən",
    "automatic": "ˌɔtəˈmætɪk", "vertex": "ˈvərˌtɛks",
    "extension": "ɪkˈstɛnʃən", "contributor": "kənˈtrɪbjətər",
    "unit": "ˈjunɪt", "partial": "ˈpɑrʃəl",
    "decorator": "ˈdɛkəˌreɪtər", "pure": "pjʊr", "pre": "pri",
    "introduce": "ˌɪntrəˈdus",
    # sixth tranche: round-4 continuation sweep (tools/eval_g2p.py --top 400)
    # — common words the LTS rules mispronounce (aware→ɔoʊr, assume→eɪsəm,
    # compare→kɑmpoʊr), remaining months/weekdays, and high-frequency
    # technical vocabulary incl. initialisms read as letter sequences
    "publish": "ˈpəblɪʃ", "backward": "ˈbækwərd",
    "backwards": "ˈbækwərdz", "efficient": "ɪˈfɪʃənt",
    "efficiency": "ɪˈfɪʃənsi", "mail": "meɪl", "obtain": "əbˈteɪn",
    "creation": "kriˈeɪʃən", "blog": "blɑg", "sponsor": "ˈspɑnsər",
    "consistent": "kənˈsɪstənt", "consistency": "kənˈsɪstənsi",
    "mechanism": "ˈmɛkəˌnɪzəm", "element": "ˈɛləmənt",
    "exponent": "ɪkˈspoʊnənt", "operand": "ˈɑpəˌrænd",
    "marshmallow": "ˈmɑrʃˌmɛloʊ", "gymnasium": "ʤɪmˈneɪziəm",
    "jedi": "ˈʤɛˌdaɪ", "rouge": "ruʒ",
    "accelerator": "ækˈsɛləˌreɪtər", "logo": "ˈloʊgoʊ",
    "capture": "ˈkæpʧər", "snippet": "ˈsnɪpɪt",
    "tabulate": "ˈtæbjəˌleɪt", "registry": "ˈrɛʤɪstri",
    "frozen": "ˈfroʊzən", "toolkit": "ˈtulˌkɪt", "attack": "əˈtæk",
    "dump": "dəmp", "pen": "pɛn", "inspect": "ɪnˈspɛkt",
    "aware": "əˈwɛr", "especially": "ɪˈspɛʃəli",
    "therefore": "ˈðɛrˌfɔr", "else": "ɛls", "forward": "ˈfɔrwərd",
    "label": "ˈleɪbəl", "reverse": "rɪˈvərs", "double": "ˈdəbəl",
    "quite": "kwaɪt", "absolute": "ˈæbsəˌlut", "axes": "ˈækˌsiz",
    "assume": "əˈsum", "compare": "kəmˈpɛr", "according": "əˈkɔrdɪŋ",
    "yourself": "jərˈsɛlf", "whenever": "wɛˈnɛvər", "launch": "lɔnʧ",
    "analysis": "əˈnæləsɪs", "approach": "əˈproʊʧ",
    "comprehensive": "ˌkɑmpriˈhɛnsɪv", "relevant": "ˈrɛləvənt",
    "production": "prəˈdəkʃən", "actual": "ˈækʧuəl",
    "potential": "pəˈtɛnʃəl", "experiment": "ɪkˈspɛrəmənt",
    "parallel": "ˈpɛrəˌlɛl", "semantic": "səˈmæntɪk",
    "respectively": "rɪˈspɛktɪvli", "comparison": "kəmˈpɛrəsən",
    "citation": "saɪˈteɪʃən", "background": "ˈbækˌgraʊnd",
    "transform": "trænsˈfɔrm", "coordinate": "koʊˈɔrdənət",
    "unsigned": "ənˈsaɪnd", "authentication": "ɔˌθɛntəˈkeɪʃən",
    "identical": "aɪˈdɛntɪkəl", "outside": "ˌaʊtˈsaɪd",
    "architecture": "ˈɑrkəˌtɛkʧər", "fuzzy": "ˈfəzi",
    "alpha": "ˈælfə", "comma": "ˈkɑmə", "vulnerable": "ˈvəlnərəbəl",
    "cant": "kænt", "switch": "swɪʧ",
    "professional": "prəˈfɛʃənəl", "relative": "ˈrɛlətɪv",
    "hint": "hɪnt", "frame": "freɪm", "incorrect": "ˌɪnkəˈrɛkt",
    "prefer": "prɪˈfər", "iteration": "ˌɪtəˈreɪʃən",
    "blank": "blæŋk", "constant": "ˈkɑnstənt",
    "explanation": "ˌɛkspləˈneɪʃən", "crash": "kræʃ",
    "contact": "ˈkɑnˌtækt", "extend": "ɪkˈstɛnd",
    "collect": "kəˈlɛkt", "outline": "ˈaʊtˌlaɪn",
    "inline": "ˈɪnˌlaɪn", "evaluate": "ɪˈvæljuˌeɪt",
    "bucket": "ˈbəkɪt", "egg": "ɛg", "trash": "træʃ",
    "express": "ɪkˈsprɛs", "lightweight": "ˈlaɪtˌweɪt",
    "communication": "kəˌmjunəˈkeɪʃən", "digit": "ˈdɪʤɪt",
    "net": "nɛt", "sometimes": "ˈsəmˌtaɪmz", "along": "əˈlɔŋ",
    "workflow": "ˈwərkˌfloʊ", "overflow": "ˈoʊvərˌfloʊ",
    "appropriate": "əˈproʊpriət",
    "vulnerability": "ˌvəlnərəˈbɪlɪti", "february": "ˈfɛbjuˌɛri",
    "march": "mɑrʧ", "april": "ˈeɪprəl", "june": "ʤun",
    "july": "ʤʊˈlaɪ", "august": "ˈɔgəst", "september": "sɛpˈtɛmbər",
    "october": "ɑkˈtoʊbər", "november": "noʊˈvɛmbər",
    "december": "dɪˈsɛmbər", "tuesday": "ˈtuzˌdeɪ",
    "wednesday": "ˈwɛnzˌdeɪ", "thursday": "ˈθərzˌdeɪ",
    "saturday": "ˈsætərˌdeɪ", "editable": "ˈɛdɪtəbəl",
    "generator": "ˈʤɛnəˌreɪtər", "statement": "ˈsteɪtmənt",
    "nor": "nɔr", "upon": "əˈpɑn", "tip": "tɪp",
    "prediction": "prɪˈdɪkʃən", "emoji": "ɪˈmoʊʤi", "rust": "rəst",
    "colour": "ˈkələr", "publication": "ˌpəbləˈkeɪʃən",
    "construct": "kənˈstrəkt", "unpack": "ənˈpæk",
    "abstract": "ˈæbˌstrækt", "hypothesis": "haɪˈpɑθəsɪs",
    "unlike": "ənˈlaɪk", "linear": "ˈlɪniər", "strip": "strɪp",
    "feedback": "ˈfidˌbæk", "classic": "ˈklæsɪk",
    "validator": "ˈvæləˌdeɪtər", "markup": "ˈmɑrkˌəp",
    "reliable": "rɪˈlaɪəbəl", "min": "mɪn", "fake": "feɪk",
    "notation": "noʊˈteɪʃən", "prune": "prun",
    "optimize": "ˈɑptəˌmaɪz", "insertion": "ɪnˈsərʃən",
    "correction": "kəˈrɛkʃən", "billing": "ˈbɪlɪŋ",
    "collective": "kəˈlɛktɪv", "bootstrap": "ˈbutˌstræp",
    "basis": "ˈbeɪsɪs", "simplify": "ˈsɪmpləˌfaɪ",
    "convenience": "kənˈvinjəns", "capability": "ˌkeɪpəˈbɪlɪti",
    "dynamically": "daɪˈnæmɪkli", "submit": "səbˈmɪt",
    "retrieve": "rɪˈtriv", "overhead": "ˈoʊvərˌhɛd",
    "unix": "ˈjunɪks", "lambda": "ˈlæmdə", "reserved": "rɪˈzərvd",
    "cell": "sɛl", "reuse": "riˈjuz", "bound": "baʊnd",
    "detect": "dɪˈtɛkt", "initialization": "ɪˌnɪʃələˈzeɪʃən",
    "ecosystem": "ˈikoʊˌsɪstəm", "traceback": "ˈtreɪsˌbæk",
    "ruff": "rəf", "stat": "stæt", "gmail": "ˈʤiˌmeɪl",
    "discord": "ˈdɪsˌkɔrd", "chunk": "ʧəŋk",
    "fallback": "ˈfɔlˌbæk", "workload": "ˈwərkˌloʊd",
    "serialize": "ˈsɪriəˌlaɪz", "insensitive": "ɪnˈsɛnsɪtɪv",
    "endpoint": "ˈɛndˌpɔɪnt", "integrate": "ˈɪntəˌgreɪt",
    "vertical": "ˈvərtɪkəl", "horizontal": "ˌhɔrəˈzɑntəl",
    "track": "træk", "division": "dɪˈvɪʒən",
    "py": "paɪ", "href": "ˌeɪʧˈrɛf", "ai": "ˌeɪˈaɪ",
    "ip": "ˌaɪˈpi", "uv": "ˌjuˈvi", "eg": "ˌiˈʤi",
    "mit": "ˌɛmˌaɪˈti", "cli": "ˌsiˌɛlˈaɪ", "abc": "ˌeɪˌbiˈsi",
    "ansi": "ˈænsi", "img": "ˈɪmɪʤ", "opencv": "ˌoʊpənˌsiˈvi",
    "dtype": "ˈdiˌtaɪp", "hexdigest": "ˈhɛksˌdaɪʤɛst",
    "codecov": "ˈkoʊdˌkɑv", "dataclass": "ˈdeɪtəˌklæs",
    "urllib": "ˌjuˌɑrˈɛlˌlɪb", "pypy": "ˈpaɪˌpaɪ",
    "sympy": "ˈsɪmˌpaɪ", "pygame": "ˈpaɪˌgeɪm",
    "pydantic": "paɪˈdæntɪk", "asyncio": "eɪˈsɪŋkˌaɪˈoʊ",
    "fonttools": "ˈfɑntˌtulz", "javascript": "ˈʤɑvəˌskrɪpt",
    "bleu": "blu", "lora": "ˈlɔrə", "gui": "ˈgui",
    "setuptools": "ˈsɛtˌəpˌtulz", "posix": "ˈpɑzɪks",
    "seaborn": "ˈsiˌbɔrn", "colab": "ˈkoʊˌlæb",
    "multiprocessing": "ˌməltiˈprɑˌsɛsɪŋ", "pretrained": "priˈtreɪnd",
    "multimodal": "ˌməltiˈmoʊdəl", "scikit": "ˈsaɪˌkɪt",
    "gemini": "ˈʤɛməˌnaɪ", "deepmind": "ˈdipˌmaɪnd",
    "openmp": "ˌoʊpənˌɛmˈpi", "toml": "ˈtɑməl", "nan": "næn",
    "pid": "ˈpɪd",
    # seventh tranche: contraction remnants (the tokenizer strips
    # apostrophes, so they're → theyre; LTS mangled these badly) and
    # measured LTS-error words from tools/eval_g2p.py --top
    "didnt": "ˈdɪdənt", "arent": "ɑrnt", "wasnt": "ˈwəzənt",
    "werent": "wərnt", "hasnt": "ˈhæzənt", "havent": "ˈhævənt",
    "hadnt": "ˈhædənt", "couldnt": "ˈkʊdənt", "wouldnt": "ˈwʊdənt",
    "shouldnt": "ˈʃʊdənt", "youd": "jud", "youve": "juv",
    "theyd": "ðeɪd", "theyll": "ðeɪl", "theyve": "ðeɪv",
    "theyre": "ðɛr", "weve": "wiv", "hes": "hiz", "shes": "ʃiz",
    "whats": "wɑts", "thats": "ðæts", "im": "aɪm",
    "bias": "ˈbaɪəs", "suit": "sut", "suitable": "ˈsutəbəl",
    "determine": "dɪˈtərmɪn", "typo": "ˈtaɪpoʊ",
    "mantissa": "mænˈtɪsə", "domain": "doʊˈmeɪn",
    "removal": "rɪˈmuvəl", "goto": "ˈgoʊtu", "derive": "dɪˈraɪv",
    "rely": "rɪˈlaɪ", "refactor": "riˈfæktər",
    # eighth tranche (round 5): measured top OOV fallbacks from
    # tools/eval_g2p.py --top 400 — short tech vocabulary, productive
    # compound morphemes (lib/var/char/col feed _compound_word), Python-
    # ecosystem proper nouns, and high-frequency prose words the earlier
    # sweeps missed.  "optimism" also powers the -ist/-ism morph rule.
    "int": "ɪnt", "bar": "bɑr", "def": "dɛf", "lib": "lɪb",
    "foo": "fu", "pep": "pɛp", "dict": "dɪkt", "bool": "bul",
    "ast": "æst", "com": "kɑm", "esc": "ɛsk", "mac": "mæk",
    "desc": "dɛsk", "ref": "rɛf", "rel": "rɛl", "opt": "ɑpt",
    "dir": "dɪr", "inf": "ɪnf", "meta": "ˈmɛtə", "math": "mæθ",
    "plus": "pləs", "fetch": "fɛʧ", "depth": "dɛpθ", "fork": "fɔrk",
    "misc": "mɪsk", "ex": "ɛks", "auth": "ɔθ", "var": "vɑr",
    "char": "ʧɑr", "op": "ɑp", "tox": "tɑks", "repl": "ˈrɛpəl",
    "enum": "ˈiˌnəm", "intro": "ˈɪntroʊ", "proto": "ˈproʊtoʊ",
    "param": "pəˈræm", "func": "fəŋk", "gen": "ʤɛn", "len": "lɛn",
    "div": "dɪv", "qty": "ˈkwɑntəti",
    "sydney": "ˈsɪdni", "pandoc": "ˈpænˌdɑk",
    "colorama": "ˌkələˈrɑmə", "cpython": "ˈsiˌpaɪθɑn",
    "pygments": "ˈpɪgmənts", "mujoco": "muˈʤoʊkoʊ",
    "sacrebleu": "ˌsɑkrəˈblu", "narwhal": "ˈnɑrwəl",
    "contrib": "kənˈtrɪb", "argon": "ˈɑrˌgɑn", "runkle": "ˈrəŋkəl",
    "viicos": "ˈviˌkoʊs", "yarl": "jɑrl",
    "idna": "ˌaɪˌdiˌɛnˈeɪ", "cffi": "ˌsiˌɛfˌɛfˈaɪ",
    "attrs": "ˈætərz", "xprof": "ˈɛksˌprɑf",
    "xxhash": "ˌɛksˌɛksˈhæʃ", "psutil": "ˌpiˌɛsˈjutɪl",
    "tide": "taɪd", "lab": "læb", "col": "kɑl",
    "graphviz": "ˈgræfˌvɪz", "swig": "swɪg", "parso": "ˈpɑrsoʊ",
    "travis": "ˈtrævɪs", "dask": "dæsk", "polars": "ˈpoʊlərz",
    "wrapt": "ræpt", "certifi": "ˈsərtəˌfaɪ",
    "harfbuzz": "ˈhɑrfˌbəz", "msgpack": "ˈmɛsɪʤˌpæk",
    "einops": "ˈaɪnˌɑps", "einsum": "ˈaɪnˌsəm", "chex": "ʧɛks",
    "optax": "ˈɑpˌtæks", "blas": "blæs", "rocm": "ˈrɑkəm",
    "toolz": "tulz", "trio": "ˈtrioʊ", "woff": "wɔf",
    "ufo": "ˌjuˌɛfˈoʊ",
    "variation": "ˌvɛriˈeɪʃən", "clip": "klɪp", "edit": "ˈɛdɪt",
    "synchronous": "ˈsɪŋkrənəs",
    "visualization": "ˌvɪʒwələˈzeɪʃən", "extreme": "ɪkˈstrim",
    "agnostic": "ægˈnɑstɪk", "grapheme": "ˈgræˌfim",
    "resample": "riˈsæmpəl", "warranty": "ˈwɔrənti",
    "imply": "ɪmˈplaɪ", "connect": "kəˈnɛkt",
    "similarity": "ˌsɪməˈlɛrɪti", "foundation": "faʊnˈdeɪʃən",
    "interact": "ˌɪntərˈækt", "annotate": "ˈænəˌteɪt",
    "enforce": "ɛnˈfɔrs", "universal": "ˌjunəˈvərsəl",
    "draft": "dræft", "concurrent": "kənˈkərənt",
    "decorate": "ˈdɛkəˌreɪt", "equality": "ɪˈkwɑlɪti",
    "regardless": "rɪˈgɑrdləs", "instantiate": "ɪnˈstænʃiˌeɪt",
    "detector": "dɪˈtɛktər", "assertion": "əˈsərʃən",
    "critical": "ˈkrɪtɪkəl", "exit": "ˈɛgzɪt", "clause": "klɔz",
    "quadratic": "kwɑˈdrætɪk", "benefit": "ˈbɛnəfɪt",
    "normalize": "ˈnɔrməˌlaɪz",
    "normalization": "ˌnɔrmələˈzeɪʃən", "plain": "pleɪn",
    "latter": "ˈlætər", "scientific": "ˌsaɪənˈtɪfɪk",
    "whereby": "wɛrˈbaɪ", "indices": "ˈɪndəˌsiz", "clash": "klæʃ",
    "exchange": "ɪksˈʧeɪnʤ", "tabular": "ˈtæbjələr", "far": "fɑr",
    "prerequisite": "priˈrɛkwəzət", "measurement": "ˈmɛʒərmənt",
    "fragment": "ˈfrægmənt", "bacon": "ˈbeɪkən",
    "flexibility": "ˌflɛksəˈbɪlɪti", "robust": "roʊˈbəst",
    "assert": "əˈsərt", "deliver": "dɪˈlɪvər",
    "verbose": "vərˈboʊs", "retrieval": "rɪˈtrivəl",
    "accessible": "ækˈsɛsəbəl", "constructor": "kənˈstrəktər",
    "infrastructure": "ˈɪnfrəˌstrəkʧər", "physics": "ˈfɪzɪks",
    "mess": "mɛs", "coherence": "koʊˈhɪrəns", "expose": "ɪkˈspoʊz",
    "flatten": "ˈflætən", "undefined": "ˌəndɪˈfaɪnd",
    "convention": "kənˈvɛnʃən", "taken": "ˈteɪkən",
    "recursive": "rɪˈkərsɪv",
    "differentiation": "ˌdɪfəˌrɛnʃiˈeɪʃən", "deploy": "dɪˈplɔɪ",
    "van": "væn", "implicit": "ɪmˈplɪsət", "central": "ˈsɛntrəl",
    "resumable": "rɪˈzuməbəl", "compliant": "kəmˈplaɪənt",
    "banner": "ˈbænər", "awesome": "ˈɔsəm",
    "disruption": "dɪsˈrəpʃən", "slack": "slæk", "trait": "treɪt",
    "govern": "ˈgəvərn", "accurate": "ˈækjərət",
    "credit": "ˈkrɛdɪt", "suggestion": "səgˈʤɛsʧən",
    "represent": "ˌrɛprɪˈzɛnt", "emit": "ɪˈmɪt",
    "translation": "trænzˈleɪʃən", "unnecessary": "ənˈnɛsəˌsɛri",
    "abstraction": "æbˈstrækʃən", "inclusion": "ɪnˈkluʒən",
    "locale": "loʊˈkæl", "positional": "pəˈzɪʃənəl",
    "beyond": "bɪˈjɑnd", "pythonic": "paɪˈθɑnɪk",
    "sanitize": "ˈsænəˌtaɪz", "bare": "bɛr", "restore": "rɪˈstɔr",
    "identify": "aɪˈdɛntəˌfaɪ", "adjust": "əˈʤəst",
    "ratio": "ˈreɪʃiˌoʊ", "rare": "rɛr", "sensitive": "ˈsɛnsətɪv",
    "isolate": "ˈaɪsəˌleɪt", "duration": "dʊˈreɪʃən",
    "among": "əˈməŋ", "magic": "ˈmæʤɪk", "infer": "ɪnˈfər",
    "supply": "səˈplaɪ", "christian": "ˈkrɪsʧən", "bomb": "bɑm",
    "compress": "kəmˈprɛs", "precedence": "ˈprɛsədəns",
    "operate": "ˈɑpəˌreɪt", "contour": "ˈkɑnˌtʊr", "curve": "kərv",
    "direct": "dəˈrɛkt", "restrict": "riˈstrɪkt",
    "reusable": "riˈjuzəbəl", "credential": "krəˈdɛnʃəl",
    "encounter": "ɪnˈkaʊntər", "entirety": "ɪnˈtaɪərti",
    "institution": "ˌɪnstəˈtuʃən", "approximate": "əˈprɑksəmət",
    "elapse": "ɪˈlæps", "desire": "dɪˈzaɪər",
    "percentage": "pərˈsɛntɪʤ", "discourse": "ˈdɪsˌkɔrs",
    "rename": "riˈneɪm", "extract": "ɪkˈstrækt",
    "helpful": "ˈhɛlpfəl", "studio": "ˈstudiˌoʊ",
    "daniel": "ˈdænjəl", "scenario": "səˈnɛriˌoʊ",
    "organization": "ˌɔrgənəˈzeɪʃən",
    "complicated": "ˈkɑmpləˌkeɪtɪd", "verify": "ˈvɛrəˌfaɪ",
    "isolation": "ˌaɪsəˈleɪʃən", "identity": "aɪˈdɛntəti",
    "authority": "əˈθɔrəti", "insert": "ɪnˈsərt",
    "locate": "ˈloʊˌkeɪt", "michael": "ˈmaɪkəl",
    "numerical": "nuˈmɛrɪkəl", "correspond": "ˌkɔrəˈspɑnd",
    "convenient": "kənˈvinjənt", "initialize": "ɪˈnɪʃəˌlaɪz",
    "resolve": "rɪˈzɑlv", "latin": "ˈlætən", "asset": "ˈæˌsɛt",
    "tar": "tɑr", "unknown": "ˌənˈnoʊn", "callable": "ˈkɔləbəl",
    "trail": "treɪl", "affect": "əˈfɛkt",
    "applicable": "ˈæplɪkəbəl", "propagate": "ˈprɑpəˌgeɪt",
    "hug": "həg", "segment": "ˈsɛgmənt", "tune": "tun",
    "extensible": "ɪkˈstɛnsəbəl",
    "deprecation": "ˌdɛprəˈkeɪʃən",
    "independent": "ˌɪndɪˈpɛndənt", "vendor": "ˈvɛndər",
    "fold": "foʊld", "optimism": "ˈɑptəˌmɪzəm",
    # spelled letter names (lone letters in prose read as letter names;
    # "a" and "i" stay words — their letter readings live in _LETTER_NAMES)
    "b": "bi",
    "c": "si",
    "d": "di",
    "e": "i",
    "f": "ɛf",
    "g": "ʤi",
    "h": "eɪʧ",
    "j": "ʤeɪ",
    "k": "keɪ",
    "l": "ɛl",
    "m": "ɛm",
    "n": "ɛn",
    "o": "oʊ",
    "p": "pi",
    "q": "kju",
    "r": "ɑr",
    "s": "ɛs",
    "t": "ti",
    "u": "ju",
    "v": "vi",
    "w": "ˈdəbəlju",
    "x": "ɛks",
    "y": "waɪ",
    "z": "zi",
}

# Letter-to-sound rules, tried longest-match-first at each position.
# (suffix rules are applied before the main scan; the "ed" suffix is
# special-cased in _lts_word so it voicing-assimilates like _past_ipa)
_LTS_SUFFIXES = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ture", "ʧər"), ("tious", "ʃəs"),
    ("cious", "ʃəs"), ("cial", "ʃəl"), ("tial", "ʃəl"), ("ing", "ɪŋ"),
    ("ness", "nəs"), ("ment", "mənt"), ("able", "əbəl"), ("ible", "əbəl"),
    ("ously", "əsli"), ("ous", "əs"), ("ful", "fəl"), ("less", "ləs"),
    ("ly", "li"), ("er", "ər"), ("est", "əst"), ("ed", "d"),
    # round-4 additions (golden-driven, tools/eval_g2p.py --accuracy)
    ("ation", "eɪʃən"), ("ity", "ɪti"), ("ical", "ɪkəl"), ("ic", "ɪk"),
    ("ive", "ɪv"), ("ize", "aɪz"), ("ify", "ɪfaɪ"), ("age", "ɪʤ"),
    ("ance", "əns"), ("ence", "əns"), ("ant", "ənt"), ("ent", "ənt"),
    ("ary", "ɛri"), ("ism", "ˌɪzəm"), ("ist", "ɪst"), ("ate", "eɪt"),
    ("al", "əl"),
]
# longest suffix wins (e.g. "ation" over "tion", "ously" over "ly")
_LTS_SUFFIXES.sort(key=lambda kv: -len(kv[0]))

# end-of-body clusters whose vowel reading the plain scan gets wrong
# ("kind", "bold", "soft", "lost": checked after suffix stripping, so
# "grinder"/"boldly"/"frosting" inherit the right stem vowel)
_LTS_END_RULES = [
    ("ind", "aɪnd"), ("ild", "aɪld"), ("old", "oʊld"),
    ("oft", "ɔft"), ("ost", "ɔst"), ("oss", "ɔs"), ("off", "ɔf"),
]

_LTS_RULES = [
    # digraphs / trigraphs first (longest match wins)
    ("tch", "ʧ"), ("sch", "sk"), ("igh", "aɪ"), ("eigh", "eɪ"),
    ("ought", "ɔt"), ("aught", "ɔt"),
    ("ch", "ʧ"), ("sh", "ʃ"), ("th", "θ"), ("ph", "f"), ("wh", "w"),
    ("ck", "k"), ("ng", "ŋ"), ("nk", "ŋk"), ("qu", "kw"), ("gh", "g"),
    ("kn", "n"),
    ("wr", "r"), ("gn", "n"), ("mb", "m"), ("dge", "ʤ"), ("dg", "ʤ"),
    # vowel teams
    ("eau", "oʊ"), ("iou", "jə"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("ee", "i"), ("ea", "i"), ("ey", "i"),
    ("oa", "oʊ"), ("ow", "oʊ"), ("oo", "u"), ("ou", "aʊ"), ("oi", "ɔɪ"),
    ("oy", "ɔɪ"), ("au", "ɔ"), ("aw", "ɔ"), ("ew", "u"), ("ue", "u"),
    ("ie", "i"), ("ei", "eɪ"),
    ("ar", "ɑr"), ("or", "ɔr"), ("er", "ər"), ("ir", "ər"), ("ur", "ər"),
    # single letters
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "g"), ("h", "h"), ("i", "ɪ"), ("j", "ʤ"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɑ"),
    ("p", "p"), ("r", "r"), ("s", "s"), ("t", "t"), ("u", "ə"),
    ("v", "v"), ("w", "w"), ("x", "ks"), ("y", "j"), ("z", "z"),
]
_LTS_RULES.sort(key=lambda kv: -len(kv[0]))

_SOFT_C_VOWELS = set("eiy")


def _lts_word(word: str, depth: int = 0) -> str:
    """Rule-based grapheme→IPA for out-of-lexicon words."""
    # regular plurals first: convert the stem, then voicing-assimilate the
    # ending like _plural_ipa ("tags"→tægz, "bytes"→baɪts, "stories"→…iz)
    if depth < 1:
        if len(word) > 4 and word.endswith("ies"):
            return _lts_word(word[:-3] + "y", depth + 1) + "z"
        if (
            len(word) > 3
            and word.endswith("s")
            and not word.endswith(("ss", "us", "is", "as", "os"))
        ):
            return _plural_ipa(_lts_word(word[:-1], depth + 1))
    out = []
    # strip one trailing silent e ("make" -> long vowel handled crudely)
    body = word
    suffix_ipa = ""
    past_suffix = False
    for suf, ipa_suf in _LTS_SUFFIXES:
        if body.endswith(suf) and len(body) > len(suf) + 1:
            if suf == "ed" and body.endswith("eed"):
                continue  # feed/exceed: the "ee" team, not a past tense
            if suf == "ed":
                # strip only the "d": a stem-final silent e ("quoted",
                # "craned") then flows through the normal magic-e logic
                body = body[:-1]
                past_suffix = True
                break
            stem = body[: -len(suf)]
            # a real derivational stem has a vowel and ≥3 letters —
            # "glance"/"hoist"/"moist" end in rimes, not suffixes
            if len(stem) < 3 or not any(c in "aeiouy" for c in stem):
                continue
            body = stem
            suffix_ipa = ipa_suf
            break
    silent_e = len(body) > 2 and body.endswith("e") and body[-2] not in "aeiou"
    soften_final = False
    if silent_e:
        body = body[:-1]
        if body.endswith("dg"):
            silent_e = False  # "-dge" keeps its short vowel (fudge, bridge)
        # the stripped e also marks soft final c/g ("since"→s, "charge"→ʤ)
        # — but a doubled letter stays hard ("plugged", "tagged")
        soften_final = body[-1] in "cg" and not (
            len(body) >= 2 and body[-2] == body[-1]
        )
        # magic-e lengthening needs exactly ONE consonant between the last
        # vowel and the e (mode/byte yes; since/dance/glimpse no) — and the
        # letter x spells TWO sounds /ks/, so it blocks it too (taxed, axed)
        if not (len(body) >= 2 and body[-2] in "aeiouy" and body[-1] != "x"):
            silent_e = False
    # end-cluster vowel corrections ("kind"→aɪnd, "soft"→ɔft), before the
    # doubled-consonant collapse so "-oss"/"-off" still see both letters
    tail_ipa = ""
    for end, end_ipa in _LTS_END_RULES:
        if body.endswith(end) and len(body) > len(end):
            body = body[: -len(end)]
            tail_ipa = end_ipa
            break
    # doubled consonant letters read as one sound ("dwell", "glass")
    body = re.sub(r"([bcdfglmnprstz])\1", r"\1", body)
    i = 0
    while i < len(body):
        # word-initial open-syllable "hu-" is /hju/ (human, humid, humor,
        # humane); closed syllables (hundred, husband) fall through to the
        # plain /hə/ scan.  'l' and 'r' are excluded ("hula" is /hu/;
        # "hurry"/"hubby" reach here with their double collapsed, so 'y'
        # is not accepted as the following vowel either.
        if (
            i == 0 and body.startswith("hu") and len(body) >= 4
            and body[2] in "bcdgkmnpstvz" and body[3] in "aeiou"
        ):
            out.append("hju")
            i = 2
            continue
        # context-sensitive soft c/g
        soft_next = (
            i + 1 < len(body) and body[i + 1] in _SOFT_C_VOWELS
        ) or (i == len(body) - 1 and soften_final)
        if body[i] == "x" and i + 1 < len(body) and body[i + 1] == "c" and (
            i + 2 >= len(body) and soften_final
            or body[i + 2 : i + 3] in _SOFT_C_VOWELS
        ):
            out.append("ks")  # "xce"/"xci" cluster: except, exceed
            i += 2
            continue
        if body[i] == "c" and soft_next:
            out.append("s")
            i += 1
            continue
        if body[i] == "g" and soft_next:
            out.append("ʤ")
            i += 1
            continue
        if body[i] == "y" and (i == len(body) - 1 or body[i + 1] not in "aeiou"):
            out.append("i" if i == len(body) - 1 else "ɪ")
            i += 1
            continue
        for pat, ipa_sub in _LTS_RULES:
            if body.startswith(pat, i):
                out.append(ipa_sub)
                i += len(pat)
                break
        else:
            i += 1  # unknown character: drop
    ipa = "".join(out)
    if silent_e:
        # magic-e lengthening of the last short vowel
        for short, long_v in [("æ", "eɪ"), ("ɛ", "i"), ("ɪ", "aɪ"), ("ɑ", "oʊ"), ("ə", "u")]:
            idx = ipa.rfind(short)
            if idx != -1:
                if short == "ə" and idx == 0:
                    long_v = "ju"  # word-initial long u ("use"→jus)
                ipa = ipa[:idx] + long_v + ipa[idx + len(short):]
                break
    ipa += tail_ipa
    if past_suffix:
        return _past_ipa(ipa)  # "nested"→…tɪd, "fixed"→…kst, "used"→…zd
    return ipa + suffix_ipa


_WORD_RE = re.compile(r"[a-z']+|[^a-z']")

# ---- morphological fallback: inflected forms of lexicon words -------------
# English inflection is regular enough that "users", "fixed", "logging",
# "nicely" should resolve through the lexicon entry for their stem instead
# of falling to raw letter-to-sound (the reference's eng_to_ipa dictionary
# covers inflections natively, reference text/english.py:160-166).  Suffix
# phonology follows the standard voicing-assimilation rules.

_VOICELESS_FINAL = set("ptkfθsʃʧh")
_SIBILANT_FINAL = set("szʃʒʧʤ")


def _final_phone(ipa: str) -> str:
    for ch in reversed(ipa):
        if ch not in "ˈˌː":
            return ch
    return ""


def _plural_ipa(ipa: str) -> str:
    f = _final_phone(ipa)
    if f in _SIBILANT_FINAL:
        return ipa + "ɪz"
    if f in _VOICELESS_FINAL:
        return ipa + "s"
    return ipa + "z"


def _past_ipa(ipa: str) -> str:
    f = _final_phone(ipa)
    if f in "td":
        return ipa + "ɪd"
    if f in _VOICELESS_FINAL:
        return ipa + "t"
    return ipa + "d"


def _morph_word(word: str, depth: int = 0):
    """IPA for an out-of-lexicon word via stem lookup + regular suffix
    phonology; None when no lexicon stem matches."""

    def stem_ipa(w: str):
        hit = _LEXICON.get(w)
        if hit is None and depth < 1 and len(w) > 3:
            hit = _morph_word(w, depth + 1)
        return hit

    n = len(word)
    # plural / possessive / 3rd-person -s
    if n > 3 and word.endswith("ies"):
        base = stem_ipa(word[:-3] + "y")
        if base:
            return base + "z"  # "stories": …i + z
    if n > 3 and word.endswith("es"):
        base = stem_ipa(word[:-2])
        if base and _final_phone(base) in _SIBILANT_FINAL:
            return base + "ɪz"  # "fixes"
    if n > 2 and word.endswith("s") and not word.endswith("ss"):
        base = stem_ipa(word[:-1])
        if base:
            return _plural_ipa(base)  # "values", "changes", "users"
    # past tense -ed
    if n > 3 and word.endswith("ied"):
        base = stem_ipa(word[:-3] + "y")
        if base:
            return base + "d"  # "studied": …i + d
    if n > 3 and word.endswith("ed"):
        base = stem_ipa(word[:-1])  # silent-e stems: "released"
        if base is None:
            base = stem_ipa(word[:-2])  # "fixed"
        if base is None and n > 4 and word[-3] == word[-4]:
            base = stem_ipa(word[:-3])  # doubled consonant: "dropped"
        if base:
            return _past_ipa(base)
    # progressive -ing
    if n > 4 and word.endswith("ing"):
        base = stem_ipa(word[:-3] + "e")  # "using"
        if base is None:
            base = stem_ipa(word[:-3])  # "following"
        if base is None and n > 5 and word[-4] == word[-5]:
            base = stem_ipa(word[:-4])  # "logging"
        if base:
            return base + "ɪŋ"
    # adverbial -ly
    if n > 3 and word.endswith("ly"):
        if word.endswith("ily"):
            base = stem_ipa(word[:-3] + "y")
            if base and base.endswith("i"):
                return base[:-1] + "əli"  # "easily"
        base = stem_ipa(word[:-2])
        if base:
            return base + "li"
    # comparative -ier / superlative -iest from -y stems ("easier")
    if n > 4 and word.endswith("ier"):
        base = stem_ipa(word[:-3] + "y")
        if base and base.endswith("i"):
            return base[:-1] + "iər"
    if n > 5 and word.endswith("iest"):
        base = stem_ipa(word[:-4] + "y")
        if base and base.endswith("i"):
            return base[:-1] + "iəst"
    # comparative / agentive -er, superlative -est
    if n > 3 and word.endswith("er"):
        base = stem_ipa(word[:-1])  # silent-e: "nicer", "user"
        if base is None:
            base = stem_ipa(word[:-2])  # "player"
        if base is None and n > 4 and word[-3] == word[-4]:
            base = stem_ipa(word[:-3])  # "bigger"
        if base:
            return base + "ər"
    if n > 4 and word.endswith("est"):
        base = stem_ipa(word[:-2])  # silent-e: "largest"
        if base is None:
            base = stem_ipa(word[:-3])
        if base:
            return base + "əst"
    # derivational -ize from a lexicon stem ("finalize", "realize",
    # "modernize") — the suffix is stress-neutral, so plain concatenation
    # is phonologically right
    if n > 5 and word.endswith("ize"):
        base = stem_ipa(word[:-3])
        if base:
            return base + "aɪz"
    # derivational -ist from a lexicon -ism pair ("optimist"/"optimism",
    # "communist"/"communism"): swap the final /ɪzəm/ for /ɪst/ — the rest
    # of the word (incl. the reduced medial vowels) is identical
    if n > 4 and word.endswith("ist"):
        base = stem_ipa(word[:-3] + "ism")
        if base and base.endswith("ɪzəm"):
            return base[:-4] + "ɪst"
    return None


_COMPOUND_SUFFIX_TAILS = frozenset(
    ("age", "able", "ably", "ability", "less"))
# junction letter pairs that spell one sound — a split across them is
# orthographically implausible. sh is deliberately absent: s|h junctions
# are usually real (dishonest, mishandle).
_JUNCTION_DIGRAPHS = frozenset(("th", "wh", "ph", "gh", "ch"))


def _compound_word(word: str, depth: int = 0):
    """IPA for an OOV closed compound whose parts resolve WITHOUT the
    LTS rules (sourcecode → source+code, datetime → date+time,
    valueerror → value+error).  The first part must be a direct lexicon
    hit (≥3 chars, longest split wins so classnames → class+names, not
    clas+snames); the tail may resolve via the lexicon, morphology, or
    one further compound split (readthedocs → read+the+docs).  Returns
    None when no such split exists, leaving the word to LTS."""
    n = len(word)
    if n < 6:
        return None
    for split in range(n - 3, 1, -1):
        if split == 2 and word[:2] != "py":
            # 2-char heads over-split badly (opera ≠ op+era); "py" is the
            # one productive short tech prefix (pyproject, pytest, pytree)
            # and its false positives are benign (pyrite → paɪ+raɪt ✓)
            continue
        head = _LEXICON.get(word[:split])
        if head is None:
            continue
        tail_word = word[split:]
        if tail_word in _COMPOUND_SUFFIX_TAILS:
            # suffix homographs: shortage is short+-age (ɪʤ), not
            # short+age (eɪʤ) — the LTS suffix rules own these
            continue
        if word[split - 1] + word[split] in _JUNCTION_DIGRAPHS:
            # the junction letters spell a digraph: nowhere is not
            # now+here, heather is not heat+her
            continue
        tail = _LEXICON.get(tail_word) or _morph_word(tail_word)
        if tail is None and depth < 1:
            tail = _compound_word(tail_word, depth + 1)
        if tail is not None:
            # collapse a doubled consonant at the junction
            # (datetime → deɪtaɪm, bookkeeper → bʊkipər)
            if (head[-1] == tail[0]
                    and head[-1] not in "aeiouæɑɔɛɪʊəɜː"):
                tail = tail[1:]
            return head + tail
    return None


# letter names for spelling out initialisms; "a"/"i" here are the letter
# readings (the word readings win elsewhere because spelling only applies
# to vowel-less tokens, which contain neither)
_LETTER_NAMES = {"a": "eɪ", "i": "aɪ"}


def _spell_out(word: str) -> str:
    return " ".join(
        _LETTER_NAMES.get(c) or _LEXICON.get(c, c) for c in word
    )


# --------------------------------------------------------------------------
# Heteronyms: context-dependent readings
# --------------------------------------------------------------------------
# The reference resolves English through eng_to_ipa's dictionary, which is
# context-FREE — "tear the page" and "shed a tear" get the same IPA
# (reference text/english.py:160-166).  This layer disambiguates the
# highest-frequency heteronym pairs from local word context.  The cues are
# deliberately conservative: a cue fires only when it is a near-certain
# signal; anything ambiguous falls back to the pair's statistically
# dominant reading (which matches the context-free lexicon entry, so
# behavior without a cue is unchanged).

# determiners/prepositions that mark the following heteronym as a noun
_DET_BEFORE = frozenset((
    "the", "a", "an", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their", "no", "any", "some", "each",
    "every", "another", "whose", "of",
))
# infinitive marker / modals / negated auxiliaries / subject pronouns that
# mark the following heteronym as a finite or base-form verb
_VERB_BEFORE = frozenset((
    "to", "will", "would", "can", "could", "shall", "should", "may",
    "might", "must", "please", "cannot", "cant", "dont", "doesnt",
    "didnt", "wont", "couldnt", "wouldnt", "shouldnt", "lets",
    "i", "we", "they", "you",
))

# stress-shift noun↔verb pairs: word → (noun reading, verb reading,
# default part of speech when no cue fires).  Inflected -s forms are
# generated below with the regular voicing-assimilated ending.
_NOUN_VERB_HETERONYMS = {
    "record": ("ˈrɛkərd", "rɪˈkɔrd", "n"),
    "present": ("ˈprɛzənt", "priˈzɛnt", "n"),
    "object": ("ˈɑbʤɛkt", "əbˈʤɛkt", "n"),
    "project": ("ˈprɑʤɛkt", "prəˈʤɛkt", "n"),
    "produce": ("ˈproʊdus", "prəˈdus", "v"),
    "permit": ("ˈpərˌmɪt", "pərˈmɪt", "v"),
    "protest": ("ˈproʊˌtɛst", "prəˈtɛst", "n"),
    "suspect": ("ˈsəˌspɛkt", "səˈspɛkt", "n"),
    "contract": ("ˈkɑnˌtrækt", "kənˈtrækt", "n"),
    "conduct": ("ˈkɑndəkt", "kənˈdəkt", "n"),
    "conflict": ("ˈkɑnflɪkt", "kənˈflɪkt", "n"),
    "increase": ("ˈɪnˌkris", "ɪnˈkris", "v"),
    "decrease": ("ˈdiˌkris", "dɪˈkris", "v"),
    "desert": ("ˈdɛzərt", "dɪˈzərt", "n"),
    "refuse": ("ˈrɛfˌjus", "rɪˈfjuz", "v"),
    "content": ("ˈkɑntɛnt", "kənˈtɛnt", "n"),
    "extract": ("ˈɛkˌstrækt", "ɪkˈstrækt", "v"),
    "import": ("ˈɪmˌpɔrt", "ɪmˈpɔrt", "n"),
    "export": ("ˈɛkˌspɔrt", "ɪkˈspɔrt", "n"),
    "digest": ("ˈdaɪʤɛst", "daɪˈʤɛst", "n"),
}
for _w, (_n, _v, _d) in list(_NOUN_VERB_HETERONYMS.items()):
    _NOUN_VERB_HETERONYMS[_w + "s"] = (_plural_ipa(_n), _plural_ipa(_v), _d)
del _w, _n, _v, _d

# next-word cues for the segmental pairs below
_LIVE_ADJ_NEXT = frozenset((
    "music", "concert", "concerts", "stream", "streams", "streaming",
    "show", "shows", "broadcast", "broadcasts", "performance",
    "performances", "audience", "event", "events", "coverage", "album",
    "recording", "demo", "tv", "video", "feed", "wire", "wires",
))
_LIVE_ADJ_PREV = frozenset((
    "is", "are", "was", "were", "go", "goes", "going", "went", "gone",
    "now",
))
_TEAR_VERB_NEXT = frozenset((
    "up", "down", "apart", "off", "through", "into", "open", "it",
    "them", "the", "a", "an", "your", "my", "his", "her", "their",
    "our", "its",
))
_READ_PAST_BEFORE = frozenset((
    "have", "has", "had", "was", "were", "been", "already", "ive",
    "weve", "theyve", "youve", "hes", "shes", "id", "hed",
))
_LEAD_METAL_NEXT = frozenset((
    "pipe", "pipes", "paint", "poisoning", "acid", "pencil", "pencils",
    "shield", "shielding", "exposure", "levels",
))
_DOVE_VERB_CUE_PREV = frozenset(("he", "she", "i", "we", "they", "it"))
_DOVE_VERB_CUE_NEXT = frozenset((
    "in", "into", "under", "down", "off", "deep", "deeper", "for",
    "toward", "towards", "headfirst", "beneath", "below",
))
_BOW_BEND_NEXT = frozenset(("to", "down", "before", "deeply", "politely", "low"))
_BOW_BEND_PREV = frozenset(("take", "takes", "took", "taking", "final", "deep"))
_CLOSE_ADJ_PREV = frozenset(("so", "too", "very", "how", "as", "quite",
                             "really", "pretty"))
_CLOSE_ADJ_NEXT = frozenset(("to", "by", "enough"))
_CLOSE_VERB_NEXT = frozenset((
    "the", "a", "an", "it", "them", "this", "that", "your", "my",
    "his", "her", "their", "our", "its", "down", "all",
))
_BE_BEFORE = frozenset(("is", "are", "was", "were", "be", "been",
                        "being", "get", "gets", "got", "getting"))


def _resolve_heteronym(word: str, prev: str, nxt: str, prev2: str = ""):
    """IPA for ``word`` chosen from (prev, next) word context; None when
    the word is not a known heteronym (normal lexicon path applies).
    ``prev2`` (two words back, same clause) catches a determiner with one
    intervening modifier: "a parking permit", "fresh produce"."""
    spec = _NOUN_VERB_HETERONYMS.get(word)
    if spec is not None:
        noun, verb, default = spec
        if word == "produce" and prev in ("fresh", "local", "organic",
                                          "farm", "seasonal"):
            return noun
        if prev in _VERB_BEFORE:
            return verb
        if prev in _DET_BEFORE:
            return noun
        if prev2 in _VERB_BEFORE:
            return verb
        if prev2 in _DET_BEFORE:
            return noun
        return noun if default == "n" else verb
    if word == "read":
        return "rɛd" if prev in _READ_PAST_BEFORE else "rid"
    if word == "live":
        if nxt in _LIVE_ADJ_NEXT or prev in _LIVE_ADJ_PREV:
            return "laɪv"
        return "lɪv"
    if word == "lives":
        # plural of "life" after a possessor/determiner; 3rd-person verb
        # otherwise ("she lives in Tokyo")
        return "laɪvz" if prev in _DET_BEFORE else "lɪvz"
    if word in ("tear", "tears"):
        z = "z" if word.endswith("s") else ""
        if prev in _VERB_BEFORE:
            return "tɛr" + z
        if prev in _DET_BEFORE:
            return "tɪr" + z
        if nxt in _TEAR_VERB_NEXT:
            return "tɛr" + z
        return "tɪr" + z
    if word == "wind":
        return "waɪnd" if (nxt in ("up", "down") or prev == "to") else "wɪnd"
    if word == "wound":
        if nxt in ("up", "around", "down", "tightly") or \
                prev in _DOVE_VERB_CUE_PREV:
            return "waʊnd"
        return "wund"
    if word == "lead":
        return "lɛd" if nxt in _LEAD_METAL_NEXT else "lid"
    if word == "dove":
        if prev in _DOVE_VERB_CUE_PREV or nxt in _DOVE_VERB_CUE_NEXT:
            return "doʊv"
        return "dəv"
    if word == "bow":
        if nxt in _BOW_BEND_NEXT or prev in _BOW_BEND_PREV:
            return "baʊ"
        return "boʊ"
    if word == "close":
        if prev in _VERB_BEFORE:
            return "kloʊz"
        if nxt in _CLOSE_ADJ_NEXT or prev in _CLOSE_ADJ_PREV:
            return "kloʊs"
        if nxt in _CLOSE_VERB_NEXT:
            return "kloʊz"
        return "kloʊs"
    if word in ("use", "uses"):
        noun = prev in _DET_BEFORE or prev in ("in", "no")
        if word == "use":
            return "jus" if noun else "juz"
        return "ˈjusɪz" if noun else "ˈjuzɪz"
    if word == "used":
        # habitual "used to" is /just/; the passive keeps /juzd/
        # ("it is used to measure")
        if nxt == "to" and prev not in _BE_BEFORE:
            return "just"
        return "juzd"
    if word == "bass":
        if nxt in ("fishing", "fish") or \
                prev in ("largemouth", "smallmouth", "sea", "striped"):
            return "bæs"
        return "beɪs"
    return None


# punctuation that ends a heteronym's context window: cues never cross a
# clause boundary ("…with a tear. Up next…" must not read "tear up")
_CLAUSE_BREAK_RE = re.compile(r"[.!?;:,()\[\]\"—-]")


def _builtin_convert(text: str) -> str:
    toks = _WORD_RE.findall(text)
    # word-token stream with clause-local neighbors for heteronym context
    is_word = [bool(t) and t[0].isalpha() for t in toks]
    parts = []
    for i, tok in enumerate(toks):
        if not is_word[i]:
            parts.append(tok)
            continue
        word = tok.replace("'", "")
        prev = prev2 = nxt = ""
        for j in range(i - 1, -1, -1):
            if is_word[j]:
                if not prev:
                    prev = toks[j].replace("'", "")
                    continue
                prev2 = toks[j].replace("'", "")
                break
            if _CLAUSE_BREAK_RE.search(toks[j]):
                break
        for j in range(i + 1, len(toks)):
            if is_word[j]:
                nxt = toks[j].replace("'", "")
                break
            if _CLAUSE_BREAK_RE.search(toks[j]):
                break
        het = _resolve_heteronym(word, prev, nxt, prev2)
        if het is not None:
            parts.append(het)
            continue
        if len(word) > 1 and not any(c in "aeiouy" for c in word):
            # no vowel ⇒ not pronounceable as a word: spell it
            # ("http" → letter names, like a human reader would)
            parts.append(_spell_out(word))
            continue
        parts.append(
            _LEXICON.get(word) or _morph_word(word)
            or _compound_word(word) or _lts_word(word)
        )
    return "".join(parts)


# --------------------------------------------------------------------------
# Public pipeline (reference english.py:156-188)
# --------------------------------------------------------------------------

_LAZY_IPA = [(re.compile(p), r) for p, r in [
    ("r", "ɹ"), ("æ", "e"), ("ɑ", "a"), ("ɔ", "o"), ("ð", "z"), ("θ", "s"),
    ("ɛ", "e"), ("ɪ", "i"), ("ʊ", "u"), ("ʒ", "ʥ"), ("ʤ", "ʥ"), ("ˈ", "↓"),
]]

_LAZY_IPA2 = [(re.compile(p), r) for p, r in [
    ("r", "ɹ"), ("ð", "z"), ("θ", "s"), ("ʒ", "ʑ"), ("ʤ", "dʑ"), ("ˈ", "↓"),
]]

_IPA_TO_IPA2 = [(re.compile(p), r) for p, r in [
    ("r", "ɹ"), ("ʤ", "dʒ"), ("ʧ", "tʃ"),
]]


def mark_dark_l(text: str) -> str:
    """Mark syllable-final (dark) l as ɫ (reference english.py:156-157)."""
    return re.sub(r"l([^aeiouæɑɔəɛɪʊ ]*(?: |$))", lambda m: "ɫ" + m.group(1), text)


def english_to_ipa(text: str) -> str:
    text = ascii_fold(text).lower()
    text = expand_abbreviations(text)
    text = normalize_numbers(text)
    if _eng_to_ipa is not None:
        phonemes = _eng_to_ipa.convert(text)
        phonemes = phonemes.replace("*", "")  # eng_to_ipa OOV marker
    else:
        phonemes = _builtin_convert(text)
    return collapse_whitespace(phonemes)


def english_to_lazy_ipa(text: str) -> str:
    text = english_to_ipa(text)
    for regex, replacement in _LAZY_IPA:
        text = re.sub(regex, replacement, text)
    return text


def english_to_ipa2(text: str) -> str:
    """The cjke_cleaners2 English path (reference english.py:176-181)."""
    text = english_to_ipa(text)
    text = mark_dark_l(text)
    for regex, replacement in _IPA_TO_IPA2:
        text = re.sub(regex, replacement, text)
    return text.replace("...", "…")


def english_to_lazy_ipa2(text: str) -> str:
    text = english_to_ipa(text)
    for regex, replacement in _LAZY_IPA2:
        text = re.sub(regex, replacement, text)
    return text
