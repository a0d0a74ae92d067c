"""Mandarin Chinese text normalization + grapheme-to-IPA.

Pipeline parity with the reference (reference ``text/mandarin.py:236-326``):
arabic numbers → Chinese numerals → word segmentation → per-syllable bopomofo
with tone marks → IPA with tone arrows ``→ ↑ ↓↑ ↓`` → glide/syllabic-consonant
post rules.

The reference depends on ``cn2an`` (numbers), ``jieba`` (segmentation) and
``pypinyin`` (hanzi→bopomofo).  Here:

* number conversion is a built-in Chinese-numeral engine,
* segmentation uses ``jieba`` when installed, else per-character,
* hanzi→pinyin uses ``pypinyin`` when installed, else a built-in embedded
  table of ~3000 characters plus word-level polyphone overrides
  (``hanzi_pinyin_data.py``) covering everyday and news text; the
  pinyin→bopomofo→IPA conversion itself is pure table data and always active.
  Unknown exotic characters are logged (never silently dropped).

A ``pinyin_to_ipa()`` entry point also accepts tone-numbered pinyin directly
(e.g. ``"ni3 hao3"``), which needs no external dependency at all.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

try:  # pragma: no cover - depends on environment
    from pypinyin import lazy_pinyin as _lazy_pinyin, Style as _PinyinStyle  # type: ignore
except Exception:  # pragma: no cover
    _lazy_pinyin = None
    _PinyinStyle = None

try:  # pragma: no cover - depends on environment
    import jieba as _jieba  # type: ignore
except Exception:  # pragma: no cover
    _jieba = None


# --------------------------------------------------------------------------
# Numbers → Chinese numerals (standalone replacement for cn2an.an2cn)
# --------------------------------------------------------------------------

_CN_DIGITS = "零一二三四五六七八九"
_CN_UNITS = ["", "十", "百", "千"]
_CN_GROUP_UNITS = ["", "万", "亿", "万亿"]


def _four_digits_to_cn(n: int) -> str:
    """0-9999 → Chinese, with internal zeros collapsed (e.g. 1005 一千零五)."""
    if n == 0:
        return _CN_DIGITS[0]
    out = []
    zero_pending = False
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append(_CN_DIGITS[0])
            zero_pending = False
        out.append(_CN_DIGITS[d] + _CN_UNITS[pos])
    return "".join(out)


def int_to_chinese(n: int) -> str:
    if n < 0:
        return "负" + int_to_chinese(-n)
    if n == 0:
        return _CN_DIGITS[0]
    groups: List[int] = []
    while n:
        groups.append(n % 10000)
        n //= 10000
    out = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        piece = _four_digits_to_cn(g)
        # a leading zero is required when the higher group leaves a gap
        if out and (g < 1000):
            out.append(_CN_DIGITS[0])
        out.append(piece + _CN_GROUP_UNITS[i])
    text = "".join(out)
    # 一十X → 十X at the very front, matching common usage (cn2an behaviour)
    if text.startswith("一十"):
        text = text[1:]
    return text


def arabic_to_chinese(num: str) -> str:
    """'123' → '一百二十三'; '1.5' → '一点五'."""
    if "." in num:
        int_part, frac = num.split(".", 1)
        frac_cn = "".join(_CN_DIGITS[int(d)] for d in frac if d.isdigit())
        return int_to_chinese(int(int_part or "0")) + "点" + frac_cn
    return int_to_chinese(int(num))


def number_to_chinese(text: str) -> str:
    """Replace arabic number spans with Chinese numerals (reference
    ``mandarin.py:236-240``)."""
    return re.sub(r"\d+(?:\.\d+)?", lambda m: arabic_to_chinese(m.group(0)), text)


# --------------------------------------------------------------------------
# Pinyin syllable → bopomofo (pure data; standard zhuyin correspondence)
# --------------------------------------------------------------------------

_PY_INITIALS = {
    "zh": "ㄓ", "ch": "ㄔ", "sh": "ㄕ",
    "b": "ㄅ", "p": "ㄆ", "m": "ㄇ", "f": "ㄈ", "d": "ㄉ", "t": "ㄊ",
    "n": "ㄋ", "l": "ㄌ", "g": "ㄍ", "k": "ㄎ", "h": "ㄏ", "j": "ㄐ",
    "q": "ㄑ", "x": "ㄒ", "r": "ㄖ", "z": "ㄗ", "c": "ㄘ", "s": "ㄙ",
}

_PY_FINALS = {
    "iong": "ㄩㄥ", "iang": "ㄧㄤ", "uang": "ㄨㄤ", "ueng": "ㄨㄥ",
    "iao": "ㄧㄠ", "ian": "ㄧㄢ", "uai": "ㄨㄞ", "uan": "ㄨㄢ",
    "üan": "ㄩㄢ", "van": "ㄩㄢ", "ang": "ㄤ", "eng": "ㄥ", "ong": "ㄨㄥ",
    "ing": "ㄧㄥ", "ia": "ㄧㄚ", "ie": "ㄧㄝ", "iu": "ㄧㄡ", "in": "ㄧㄣ",
    "ua": "ㄨㄚ", "uo": "ㄨㄛ", "ui": "ㄨㄟ", "un": "ㄨㄣ", "üe": "ㄩㄝ",
    "ve": "ㄩㄝ", "ün": "ㄩㄣ", "vn": "ㄩㄣ", "ai": "ㄞ", "ei": "ㄟ",
    "ao": "ㄠ", "ou": "ㄡ", "an": "ㄢ", "en": "ㄣ", "er": "ㄦ",
    "a": "ㄚ", "o": "ㄛ", "e": "ㄜ", "ê": "ㄝ", "i": "ㄧ", "u": "ㄨ",
    "ü": "ㄩ", "v": "ㄩ",
}

# whole-syllable (zero-initial) spellings
_PY_WHOLE = {
    "yi": "ㄧ", "wu": "ㄨ", "yu": "ㄩ", "ye": "ㄧㄝ", "ya": "ㄧㄚ",
    "yao": "ㄧㄠ", "you": "ㄧㄡ", "yan": "ㄧㄢ", "yin": "ㄧㄣ",
    "yang": "ㄧㄤ", "ying": "ㄧㄥ", "yong": "ㄩㄥ", "wa": "ㄨㄚ",
    "wo": "ㄨㄛ", "wai": "ㄨㄞ", "wei": "ㄨㄟ", "wan": "ㄨㄢ",
    "wen": "ㄨㄣ", "wang": "ㄨㄤ", "weng": "ㄨㄥ", "yue": "ㄩㄝ",
    "yuan": "ㄩㄢ", "yun": "ㄩㄣ", "er": "ㄦ", "a": "ㄚ", "o": "ㄛ",
    "e": "ㄜ", "ai": "ㄞ", "ei": "ㄟ", "ao": "ㄠ", "ou": "ㄡ",
    "an": "ㄢ", "en": "ㄣ", "ang": "ㄤ", "eng": "ㄥ",
}

_TONE_MARKS = {1: "ˉ", 2: "ˊ", 3: "ˇ", 4: "ˋ", 5: "˙", 0: "˙"}


def pinyin_syllable_to_bopomofo(syllable: str) -> str:
    """'ni3' → 'ㄋㄧˇ'. Accepts tone digit 0-5 (0/5 = neutral, absent = 1st)."""
    m = re.fullmatch(r"([a-zü êv]+?)([0-5])?", syllable.strip().lower())
    if not m:
        return syllable
    base, tone = m.group(1), int(m.group(2) or 1)
    if base in _PY_WHOLE:
        bopo = _PY_WHOLE[base]
    else:
        initial = ""
        for cand in ("zh", "ch", "sh"):
            if base.startswith(cand):
                initial = cand
                break
        if not initial and base[:1] in _PY_INITIALS:
            initial = base[:1]
        final = base[len(initial):]
        # u after j/q/x is ü
        if initial in ("j", "q", "x") and final.startswith("u"):
            final = "ü" + final[1:]
            final = {"üan": "üan", "ün": "ün", "üe": "üe", "ü": "ü"}.get(final, final)
        if final in ("i", "") and initial in ("zh", "ch", "sh", "r", "z", "c", "s"):
            bopo = _PY_INITIALS[initial]  # syllabic: zhi/chi/shi/ri/zi/ci/si
        else:
            bopo = _PY_INITIALS.get(initial, "") + _PY_FINALS.get(final, final)
    return bopo + _TONE_MARKS[tone]


# --------------------------------------------------------------------------
# Built-in hanzi → tone-numbered pinyin fallback (frequent characters)
# --------------------------------------------------------------------------

_HANZI_PINYIN: Dict[str, str] = {
    "的": "de5", "一": "yi1", "是": "shi4", "了": "le5", "我": "wo3",
    "不": "bu4", "人": "ren2", "在": "zai4", "他": "ta1", "有": "you3",
    "这": "zhe4", "个": "ge4", "上": "shang4", "们": "men5", "来": "lai2",
    "到": "dao4", "时": "shi2", "大": "da4", "地": "di4", "为": "wei4",
    "子": "zi3", "中": "zhong1", "你": "ni3", "说": "shuo1", "生": "sheng1",
    "国": "guo2", "年": "nian2", "着": "zhe5", "就": "jiu4", "那": "na4",
    "和": "he2", "要": "yao4", "她": "ta1", "出": "chu1", "也": "ye3",
    "得": "de5", "里": "li3", "后": "hou4", "自": "zi4", "以": "yi3",
    "会": "hui4", "家": "jia1", "可": "ke3", "下": "xia4", "而": "er2",
    "过": "guo4", "天": "tian1", "去": "qu4", "能": "neng2", "对": "dui4",
    "小": "xiao3", "多": "duo1", "然": "ran2", "于": "yu2", "心": "xin1",
    "学": "xue2", "么": "me5", "之": "zhi1", "都": "dou1", "好": "hao3",
    "看": "kan4", "起": "qi3", "发": "fa1", "当": "dang1", "没": "mei2",
    "成": "cheng2", "只": "zhi3", "如": "ru2", "事": "shi4", "把": "ba3",
    "还": "hai2", "用": "yong4", "第": "di4", "样": "yang4", "道": "dao4",
    "想": "xiang3", "作": "zuo4", "种": "zhong3", "开": "kai1", "美": "mei3",
    "总": "zong3", "从": "cong2", "无": "wu2", "情": "qing2", "己": "ji3",
    "面": "mian4", "最": "zui4", "女": "nü3", "但": "dan4", "现": "xian4",
    "前": "qian2", "些": "xie1", "所": "suo3", "同": "tong2", "日": "ri4",
    "手": "shou3", "又": "you4", "行": "xing2", "意": "yi4", "动": "dong4",
    "方": "fang1", "期": "qi1", "它": "ta1", "头": "tou2", "经": "jing1",
    "长": "chang2", "儿": "er2", "回": "hui2", "位": "wei4", "分": "fen1",
    "爱": "ai4", "老": "lao3", "因": "yin1", "很": "hen3", "给": "gei3",
    "名": "ming2", "法": "fa3", "间": "jian1", "斯": "si1", "知": "zhi1",
    "世": "shi4", "什": "shen2", "两": "liang3", "次": "ci4", "身": "shen1",
    "者": "zhe3", "被": "bei4", "高": "gao1", "已": "yi3", "亲": "qin1",
    "其": "qi2", "进": "jin4", "此": "ci3", "话": "hua4", "常": "chang2",
    "与": "yu3", "活": "huo2", "正": "zheng4", "感": "gan3", "见": "jian4",
    "明": "ming2", "问": "wen4", "力": "li4", "理": "li3", "尔": "er3",
    "点": "dian3", "文": "wen2", "几": "ji3", "定": "ding4", "本": "ben3",
    "公": "gong1", "特": "te4", "做": "zuo4", "外": "wai4", "孩": "hai2",
    "相": "xiang1", "西": "xi1", "果": "guo3", "走": "zou3", "将": "jiang1",
    "月": "yue4", "十": "shi2", "实": "shi2", "向": "xiang4", "声": "sheng1",
    "车": "che1", "全": "quan2", "信": "xin4", "重": "zhong4", "三": "san1",
    "机": "ji1", "工": "gong1", "物": "wu4", "气": "qi4", "每": "mei3",
    "并": "bing4", "别": "bie2", "真": "zhen1", "打": "da3", "太": "tai4",
    "新": "xin1", "比": "bi3", "才": "cai2", "便": "bian4", "夫": "fu1",
    "再": "zai4", "书": "shu1", "部": "bu4", "水": "shui3", "像": "xiang4",
    "眼": "yan3", "等": "deng3", "体": "ti3", "却": "que4", "加": "jia1",
    "电": "dian4", "主": "zhu3", "界": "jie4", "门": "men2", "利": "li4",
    "海": "hai3", "受": "shou4", "听": "ting1", "表": "biao3", "德": "de2",
    "少": "shao3", "克": "ke4", "代": "dai4", "员": "yuan2", "许": "xu3",
    "先": "xian1", "口": "kou3", "由": "you2", "死": "si3", "安": "an1",
    "写": "xie3", "性": "xing4", "马": "ma3", "光": "guang1", "白": "bai2",
    "或": "huo4", "住": "zhu4", "难": "nan2", "望": "wang4", "教": "jiao1",
    "命": "ming4", "花": "hua1", "结": "jie2", "乐": "le4", "色": "se4",
    "更": "geng4", "拉": "la1", "东": "dong1", "神": "shen2", "记": "ji4",
    "处": "chu4", "让": "rang4", "母": "mu3", "父": "fu4", "应": "ying1",
    "直": "zhi2", "字": "zi4", "场": "chang3", "平": "ping2", "报": "bao4",
    "友": "you3", "关": "guan1", "放": "fang4", "至": "zhi4", "张": "zhang1",
    "认": "ren4", "接": "jie1", "告": "gao4", "入": "ru4", "笑": "xiao4",
    "内": "nei4", "英": "ying1", "军": "jun1", "候": "hou4", "民": "min2",
    "岁": "sui4", "往": "wang3", "何": "he2", "度": "du4", "山": "shan1",
    "觉": "jue2", "路": "lu4", "带": "dai4", "万": "wan4", "男": "nan2",
    "边": "bian1", "风": "feng1", "解": "jie3", "叫": "jiao4", "任": "ren4",
    "金": "jin1", "快": "kuai4", "原": "yuan2", "吃": "chi1", "妈": "ma1",
    "变": "bian4", "通": "tong1", "师": "shi1", "立": "li4", "象": "xiang4",
    "数": "shu4", "四": "si4", "失": "shi1", "满": "man3", "战": "zhan4",
    "远": "yuan3", "格": "ge2", "士": "shi4", "音": "yin1", "轻": "qing1",
    "目": "mu4", "条": "tiao2", "呢": "ne5", "病": "bing4", "始": "shi3",
    "达": "da2", "深": "shen1", "完": "wan2", "今": "jin1", "提": "ti2",
    "求": "qiu2", "清": "qing1", "王": "wang2", "化": "hua4", "空": "kong1",
    "业": "ye4", "思": "si1", "切": "qie4", "怎": "zen3", "非": "fei1",
    "找": "zhao3", "片": "pian4", "罗": "luo2", "钱": "qian2", "语": "yu3",
    "元": "yuan2", "喜": "xi3", "曾": "ceng2", "离": "li2", "飞": "fei1",
    "科": "ke1", "言": "yan2", "干": "gan4", "流": "liu2", "欢": "huan1",
    "约": "yue1", "各": "ge4", "即": "ji2", "指": "zhi3", "合": "he2",
    "反": "fan3", "题": "ti2", "必": "bi4", "该": "gai1", "论": "lun4",
    "交": "jiao1", "终": "zhong1", "林": "lin2", "请": "qing3", "医": "yi1",
    "晚": "wan3", "制": "zhi4", "球": "qiu2", "决": "jue2", "传": "chuan2",
    "画": "hua4", "保": "bao3", "读": "du2", "运": "yun4", "及": "ji2",
    "则": "ze2", "房": "fang2", "早": "zao3", "院": "yuan4", "量": "liang4",
    "苦": "ku3", "火": "huo3", "布": "bu4", "品": "pin3", "近": "jin4",
    "坐": "zuo4", "产": "chan3", "答": "da2", "星": "xing1", "精": "jing1",
    "视": "shi4", "五": "wu3", "连": "lian2", "司": "si1", "巴": "ba1",
    "奇": "qi2", "管": "guan3", "类": "lei4", "未": "wei4", "朋": "peng2",
    "且": "qie3", "婚": "hun1", "台": "tai2", "夜": "ye4", "青": "qing1",
    "北": "bei3", "队": "dui4", "久": "jiu3", "乎": "hu1", "越": "yue4",
    "观": "guan1", "落": "luo4", "尽": "jin4", "形": "xing2", "影": "ying3",
    "红": "hong2", "爸": "ba4", "百": "bai3", "令": "ling4", "周": "zhou1",
    "吧": "ba5", "识": "shi2", "步": "bu4", "希": "xi1", "亚": "ya4",
    "术": "shu4", "留": "liu2", "市": "shi4", "半": "ban4", "热": "re4",
    "送": "song4", "兴": "xing4", "造": "zao4", "谈": "tan2", "容": "rong2",
    "极": "ji2", "随": "sui2", "演": "yan3", "收": "shou1", "首": "shou3",
    "根": "gen1", "讲": "jiang3", "整": "zheng3", "式": "shi4", "取": "qu3",
    "照": "zhao4", "办": "ban4", "强": "qiang2", "石": "shi2", "古": "gu3",
    "华": "hua2", "谁": "shei2", "拿": "na2", "计": "ji4", "您": "nin2",
    "装": "zhuang1", "似": "si4", "足": "zu2", "双": "shuang1", "妻": "qi1",
    "尼": "ni2", "转": "zhuan3", "诉": "su4", "米": "mi3", "称": "cheng1",
    "节": "jie2", "测": "ce4", "试": "shi4", "谢": "xie4", "习": "xi2",
    "速": "su4", "级": "ji2", "歌": "ge1", "唱": "chang4", "六": "liu4",
    "七": "qi1", "八": "ba1", "九": "jiu3", "零": "ling2", "两": "liang3",
    "千": "qian1", "亿": "yi4", "负": "fu4", "汉": "han4", "普": "pu3",
    "雨": "yu3", "雪": "xue3", "云": "yun2", "跑": "pao3", "慢": "man4",
}

# extend the curated core with the embedded several-thousand-character table
# and word-level polyphone overrides (hanzi_pinyin_data.py) — full standalone
# coverage of everyday/news text; curated entries above take precedence
from personalized_text_to_speech_tpu_torch.text.hanzi_pinyin_data import (  # noqa: E402
    load_hanzi_pinyin as _load_hanzi_pinyin,
    load_word_pinyin as _load_word_pinyin,
)

for _ch, _py in _load_hanzi_pinyin().items():
    _HANZI_PINYIN.setdefault(_ch, _py)
_WORD_PINYIN: Dict[str, List[str]] = _load_word_pinyin()

from personalized_text_to_speech_tpu_torch.text.hanzi_trad_data import (  # noqa: E402
    TRAD_TO_SIMP as _TRAD_TO_SIMP,
)

import logging as _logging  # noqa: E402

_logger = _logging.getLogger(__name__)
_warned_hanzi: set = set()


def hanzi_available() -> bool:
    """True when full-coverage hanzi→pinyin conversion is possible."""
    return _lazy_pinyin is not None


_WORD_PINYIN_MAXLEN = max((len(w) for w in _WORD_PINYIN), default=1)


def _word_to_bopomofo(word: str) -> List[str]:
    """One CJK word → list of bopomofo syllables with tone marks."""
    if _lazy_pinyin is not None and _PinyinStyle is not None:
        sylls = _lazy_pinyin(word, style=_PinyinStyle.BOPOMOFO)
        # pypinyin leaves 1st tone unmarked; append ˉ like the reference
        # (reference mandarin.py:252-253)
        return [re.sub(r"([ㄅ-ㄩ])$", r"\1ˉ", s) for s in sylls]
    if word in _WORD_PINYIN:  # polyphone override at word granularity
        return [pinyin_syllable_to_bopomofo(s) for s in _WORD_PINYIN[word]]
    # jieba emits compound tokens (有意思, 很漂亮, 开得, 孩子们) that an
    # exact-match lookup misses: greedy longest-match decomposition lets
    # the word overrides fire inside them — the role pypinyin's phrase
    # dictionary plays in the reference path — before falling back to
    # per-character defaults
    out = []
    i, n = 0, len(word)
    while i < n:
        hit = None
        for length in range(min(_WORD_PINYIN_MAXLEN, n - i), 1, -1):
            cand = word[i : i + length]
            if cand in _WORD_PINYIN:
                hit = _WORD_PINYIN[cand]
                break
        if hit is not None:
            out.extend(pinyin_syllable_to_bopomofo(s) for s in hit)
            i += length
            continue
        ch = word[i]
        py = _HANZI_PINYIN.get(ch)
        if py is None and re.match(r"[一-鿿]", ch):
            # never drop a character silently: log once per char (the id
            # mapper would otherwise skip it without a trace)
            if ch not in _warned_hanzi:
                _warned_hanzi.add(ch)
                _logger.warning(
                    "no pinyin reading for %r (U+%04X) — passed through; "
                    "install pypinyin for exotic-character coverage",
                    ch, ord(ch),
                )
        out.append(pinyin_syllable_to_bopomofo(py) if py else ch)
        i += 1
    return out


# --------------------------------------------------------------------------
# Mandarin tone sandhi (opt-in, beyond the reference)
#
# The reference's pipeline is plain ``lazy_pinyin`` (reference
# ``mandarin.py:248``), which applies NO tone sandhi — 不是 comes out
# bu4shi4, 你好 ni3hao3.  Real Mandarin speech says bu2shi4 / ni2hao3.
# Because retrofitting sandhi changes the emitted symbol sequence (and so
# breaks byte-parity with reference-trained checkpoints), it ships gated:
# off by default, enabled per call (``tone_sandhi=True``), globally
# (``set_tone_sandhi(True)``) or via ``PTTS_ZH_SANDHI=1``.
# --------------------------------------------------------------------------

_TONE_CHARS = "ˉˊˇˋ˙"

_tone_sandhi_enabled = os.environ.get(
    "PTTS_ZH_SANDHI", "0"
).lower() not in ("0", "", "false", "no")


def set_tone_sandhi(enabled: bool) -> None:
    """Globally enable/disable Mandarin tone sandhi (default: off)."""
    global _tone_sandhi_enabled
    _tone_sandhi_enabled = bool(enabled)


# --------------------------------------------------------------------------
# Erhua (儿化) fusion (opt-in, beyond the reference)
#
# The reference reads suffix 儿 as a full ér syllable (plain lazy_pinyin:
# 玩儿 → wan2 er2), but northern-Mandarin speech fuses it into the previous
# syllable's rime (玩儿 wár, 一点儿 yìdiǎnr, 味儿 wèr).  Like tone sandhi
# above, fusion changes the emitted symbol sequence, so it ships gated:
# off by default, per call (``erhua=True``), globally (``set_erhua(True)``)
# or via ``PTTS_ZH_ERHUA=1``.
# --------------------------------------------------------------------------

_erhua_enabled = os.environ.get(
    "PTTS_ZH_ERHUA", "0"
).lower() not in ("0", "", "false", "no")


def set_erhua(enabled: bool) -> None:
    """Globally enable/disable erhua (儿化) fusion (default: off)."""
    global _erhua_enabled
    _erhua_enabled = bool(enabled)


# words whose final 儿 is a real ér syllable, never the erhua suffix
_ERHUA_EXCEPTIONS = frozenset({
    "女儿", "婴儿", "幼儿", "孤儿", "男儿", "健儿", "少儿", "宠儿",
    "育儿", "托儿", "胎儿", "新生儿", "混血儿", "儿儿",
})

_APICAL_INITIALS = "ㄓㄔㄕㄖㄗㄘㄙ"


def _erhua_fuse(sylls: List[str]) -> None:
    """Fuse the trailing ㄦ syllable into the previous one (in place).

    Standard Beijing coda rules on the bopomofo rime: -ai/-an → -ar,
    -ei/-en → -er, -ang → nasality dropped → -ar, -eng/-ing/-ong → ŋ
    dropped, apical rimes (zhi/zi …) and bare -i/-ü gain a schwa.  The
    fused vowel+ㄦ digraphs are converted by dedicated rows at the head of
    the IPA/romaji tables (they cannot occur in un-fused text, where ㄦ
    only ever starts a syllable)."""
    base = sylls[-2]
    tone = base[-1] if base and base[-1] in _TONE_CHARS else ""
    body = base[:-1] if tone else base
    if body.endswith(("ㄞ", "ㄢ", "ㄤ")):
        body = body[:-1] + "ㄚ"
    elif body.endswith(("ㄟ", "ㄣ")):
        body = body[:-1] + "ㄜ"
    elif body.endswith("ㄥ"):
        body = body[:-1]
        if not body.endswith(("ㄧ", "ㄨ", "ㄩ")):
            body += "ㄜ"
    elif body and body[-1] in _APICAL_INITIALS:
        body += "ㄜ"
    sylls[-2] = body + "ㄦ" + tone
    del sylls[-1]


def _syllable_tone(syll: str) -> Optional[str]:
    return syll[-1] if syll and syll[-1] in _TONE_CHARS else None


def _retone(syll: str, mark: str) -> str:
    return syll[:-1] + mark if _syllable_tone(syll) else syll


def _apply_tone_sandhi(run: List[List]) -> None:
    """Apply standard Mandarin tone sandhi to a run of adjacent hanzi words.

    ``run`` is a list of ``[word, sylls]`` pairs (mutated in place), with no
    intervening punctuation.  Rules:

    * third-tone chains: a 3rd tone directly before another 3rd tone becomes
      2nd, left-to-right against original tones (3-3-3 → 2-2-3), within and
      across word boundaries;
    * 不 before a 4th tone → 2nd (不是 bu2shi4);
    * 一: ordinal after 第 stays 1st; between a reduplicated pair (看一看)
      → neutral; before a 4th tone → 2nd (一个 yi2ge4); before tones 1-3
      → 4th (一天 yi4tian1).
    """
    flat: List[tuple] = []  # (sylls_list, index_within, hanzi_char_or_None)
    for word, sylls in run:
        chars = list(word) if len(word) == len(sylls) else [None] * len(sylls)
        for k, ch in enumerate(chars):
            flat.append((sylls, k, ch))

    # third-tone chains (reads the not-yet-modified right neighbour, so a
    # maximal chain resolves to 2...2-3)
    for i in range(len(flat) - 1):
        s, k, _ = flat[i]
        ns, nk, _ = flat[i + 1]
        if _syllable_tone(s[k]) == "ˇ" and _syllable_tone(ns[nk]) == "ˇ":
            s[k] = _retone(s[k], "ˊ")

    for i, (s, k, ch) in enumerate(flat):
        if ch not in ("不", "一"):
            continue
        nxt = flat[i + 1] if i + 1 < len(flat) else None
        prv = flat[i - 1] if i > 0 else None
        next_tone = _syllable_tone(nxt[0][nxt[1]]) if nxt else None
        if ch == "不":
            if next_tone == "ˋ":
                s[k] = _retone(s[k], "ˊ")
        else:  # 一
            prev_ch = prv[2] if prv else None
            next_ch = nxt[2] if nxt else None
            if prev_ch == "第":
                continue
            if prev_ch == "一" or next_ch == "一":
                continue  # 一一 (one-by-one) keeps both 1st tones
            if prev_ch is not None and prev_ch == next_ch:
                s[k] = _retone(s[k], "˙")
            elif next_tone == "ˋ":
                s[k] = _retone(s[k], "ˊ")
            elif next_tone in ("ˉ", "ˊ", "ˇ"):
                s[k] = _retone(s[k], "ˋ")


def chinese_to_bopomofo(
    text: str,
    tone_sandhi: Optional[bool] = None,
    erhua: Optional[bool] = None,
) -> str:
    """Hanzi text → space-separated-per-word bopomofo (reference
    ``mandarin.py:243-257``)."""
    if tone_sandhi is None:
        tone_sandhi = _tone_sandhi_enabled
    if erhua is None:
        erhua = _erhua_enabled
    text = text.replace("、", "，").replace("；", "，").replace("：", "，")
    if _lazy_pinyin is None:
        # builtin fallback only: fold traditional variants onto the
        # simplified forms the embedded table is keyed on (準備→准备);
        # identity on simplified text, and BEFORE segmentation so the
        # (simplified) jieba dictionary segments traditional input too.
        # pypinyin reads traditional natively — its path stays untouched.
        text = "".join(_TRAD_TO_SIMP.get(ch, ch) for ch in text)
    if _jieba is not None:
        words = _jieba.lcut(text, cut_all=False)
    else:
        words = list(text)
    pieces: List = []  # str literal | [word, sylls]
    for word in words:
        if not re.search(r"[一-鿿]", word):
            pieces.append(word)
            continue
        pieces.append([word, _word_to_bopomofo(word)])
    if tone_sandhi:
        run: List[List] = []
        for p in pieces + [None]:  # sentinel flushes the last run
            if isinstance(p, list):
                run.append(p)
            else:
                if run:
                    _apply_tone_sandhi(run)
                run = []
    if erhua:  # after sandhi: fusion collapses the syllable/char pairing
        for p in pieces:
            if (
                isinstance(p, list)
                and len(p[0]) >= 2
                and p[0].endswith("儿")
                and p[0] not in _ERHUA_EXCEPTIONS
                and len(p[1]) == len(p[0])
                and p[1][-1].startswith("ㄦ")
            ):
                _erhua_fuse(p[1])
    out = ""
    for p in pieces:
        if isinstance(p, str):
            out += p
            continue
        if out != "":
            out += " "
        out += "".join(p[1])
    return out


# --------------------------------------------------------------------------
# Latin letters spelled in bopomofo (reference mandarin.py:11-38)
# --------------------------------------------------------------------------

_LATIN_TO_BOPOMOFO = [
    (re.compile(p, re.IGNORECASE), r)
    for p, r in [
        ("a", "ㄟˉ"), ("b", "ㄅㄧˋ"), ("c", "ㄙㄧˉ"), ("d", "ㄉㄧˋ"),
        ("e", "ㄧˋ"), ("f", "ㄝˊㄈㄨˋ"), ("g", "ㄐㄧˋ"), ("h", "ㄝˇㄑㄩˋ"),
        ("i", "ㄞˋ"), ("j", "ㄐㄟˋ"), ("k", "ㄎㄟˋ"), ("l", "ㄝˊㄛˋ"),
        ("m", "ㄝˊㄇㄨˋ"), ("n", "ㄣˉ"), ("o", "ㄡˉ"), ("p", "ㄆㄧˉ"),
        ("q", "ㄎㄧㄡˉ"), ("r", "ㄚˋ"), ("s", "ㄝˊㄙˋ"), ("t", "ㄊㄧˋ"),
        ("u", "ㄧㄡˉ"), ("v", "ㄨㄧˉ"), ("w", "ㄉㄚˋㄅㄨˋㄌㄧㄡˋ"),
        ("x", "ㄝˉㄎㄨˋㄙˋ"), ("y", "ㄨㄞˋ"), ("z", "ㄗㄟˋ"),
    ]
]


def latin_to_bopomofo(text: str) -> str:
    for regex, replacement in _LATIN_TO_BOPOMOFO:
        text = re.sub(regex, replacement, text)
    return text


# --------------------------------------------------------------------------
# Bopomofo → IPA (the cjke_cleaners2 table, reference mandarin.py:112-171)
# --------------------------------------------------------------------------

_BOPOMOFO_TO_IPA = [
    # erhua digraphs first (produced only by _erhua_fuse; in un-fused text
    # ㄦ never follows a vowel letter, so these rows are inert otherwise)
    ("ㄚㄦ", "aɻ"), ("ㄛㄦ", "oɻ"), ("ㄜㄦ", "əɻ"), ("ㄝㄦ", "ɛɻ"),
    ("ㄨㄦ", "uɻ"), ("ㄧㄦ", "iəɻ"), ("ㄩㄦ", "ɥəɻ"),
    ("ㄡㄦ", "oʊɻ"), ("ㄠㄦ", "ɑʊɻ"),
    ("ㄅㄛ", "p⁼wo"), ("ㄆㄛ", "pʰwo"), ("ㄇㄛ", "mwo"), ("ㄈㄛ", "fwo"),
    ("ㄧㄢ", "jɛn"), ("ㄩㄢ", "ɥæn"), ("ㄧㄣ", "in"), ("ㄩㄣ", "ɥn"),
    ("ㄧㄥ", "iŋ"), ("ㄨㄥ", "ʊŋ"), ("ㄩㄥ", "jʊŋ"),
    ("ㄅ", "p⁼"), ("ㄆ", "pʰ"), ("ㄇ", "m"), ("ㄈ", "f"), ("ㄉ", "t⁼"),
    ("ㄊ", "tʰ"), ("ㄋ", "n"), ("ㄌ", "l"), ("ㄍ", "k⁼"), ("ㄎ", "kʰ"),
    ("ㄏ", "x"), ("ㄐ", "tʃ⁼"), ("ㄑ", "tʃʰ"), ("ㄒ", "ʃ"),
    ("ㄓ", "ts`⁼"), ("ㄔ", "ts`ʰ"), ("ㄕ", "s`"), ("ㄖ", "ɹ`"),
    ("ㄗ", "ts⁼"), ("ㄘ", "tsʰ"), ("ㄙ", "s"), ("ㄚ", "a"), ("ㄛ", "o"),
    ("ㄜ", "ə"), ("ㄝ", "ɛ"), ("ㄞ", "aɪ"), ("ㄟ", "eɪ"), ("ㄠ", "ɑʊ"),
    ("ㄡ", "oʊ"), ("ㄢ", "an"), ("ㄣ", "ən"), ("ㄤ", "ɑŋ"), ("ㄥ", "əŋ"),
    ("ㄦ", "əɻ"), ("ㄧ", "i"), ("ㄨ", "u"), ("ㄩ", "ɥ"),
    ("ˉ", "→"), ("ˊ", "↑"), ("ˇ", "↓↑"), ("ˋ", "↓"), ("˙", ""),
    ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("—", "-"),
]

# romaji variant used by chinese_to_romaji (reference mandarin.py:41-98)
_BOPOMOFO_TO_ROMAJI = [
    # erhua digraphs (see _BOPOMOFO_TO_IPA)
    ("ㄚㄦ", "aɻ"), ("ㄛㄦ", "oɻ"), ("ㄜㄦ", "əɻ"), ("ㄝㄦ", "eɻ"),
    ("ㄨㄦ", "uɻ"), ("ㄧㄦ", "iəɻ"), ("ㄩㄦ", "ɥəɻ"),
    ("ㄡㄦ", "ouɻ"), ("ㄠㄦ", "auɻ"),
    ("ㄅㄛ", "p⁼wo"), ("ㄆㄛ", "pʰwo"), ("ㄇㄛ", "mwo"), ("ㄈㄛ", "fwo"),
    ("ㄧㄢ", "yeNN"), ("ㄢ", "aNN"), ("ㄧㄣ", "iNN"), ("ㄣ", "əNN"),
    ("ㄤ", "aNg"), ("ㄧㄥ", "iNg"), ("ㄨㄥ", "uNg"), ("ㄩㄥ", "yuNg"),
    ("ㄥ", "əNg"),
    ("ㄅ", "p⁼"), ("ㄆ", "pʰ"), ("ㄇ", "m"), ("ㄈ", "f"), ("ㄉ", "t⁼"),
    ("ㄊ", "tʰ"), ("ㄋ", "n"), ("ㄌ", "l"), ("ㄍ", "k⁼"), ("ㄎ", "kʰ"),
    ("ㄏ", "h"), ("ㄐ", "ʧ⁼"), ("ㄑ", "ʧʰ"), ("ㄒ", "ʃ"),
    ("ㄓ", "ʦ`⁼"), ("ㄔ", "ʦ`ʰ"), ("ㄕ", "s`"), ("ㄖ", "ɹ`"),
    ("ㄗ", "ʦ⁼"), ("ㄘ", "ʦʰ"), ("ㄙ", "s"), ("ㄚ", "a"), ("ㄛ", "o"),
    ("ㄜ", "ə"), ("ㄝ", "e"), ("ㄞ", "ai"), ("ㄟ", "ei"), ("ㄠ", "au"),
    ("ㄡ", "ou"), ("ㄦ", "əɻ"), ("ㄧ", "i"), ("ㄨ", "u"), ("ㄩ", "ɥ"),
    ("ˉ", "→"), ("ˊ", "↑"), ("ˇ", "↓↑"), ("ˋ", "↓"), ("˙", ""),
    ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("—", "-"),
]


def _apply_table(text: str, table) -> str:
    for pat, rep in table:
        text = text.replace(pat, rep)
    return text


def bopomofo_to_ipa(text: str) -> str:
    return _apply_table(text, _BOPOMOFO_TO_IPA)


def bopomofo_to_romaji(text: str) -> str:
    return _apply_table(text, _BOPOMOFO_TO_ROMAJI)


# --------------------------------------------------------------------------
# Public pipelines
# --------------------------------------------------------------------------

def _ipa_glide_apical(text: str) -> str:
    """The cjke_cleaners2 post-table rewrites (reference
    ``mandarin.py:308-313``): glide i/u→j/w before vowels, then
    apical-vowel insertion after retroflex/dental sibilants."""
    text = re.sub(r"i([aoe])", r"j\1", text)
    text = re.sub(r"u([aoəe])", r"w\1", text)
    text = re.sub(r"([sɹ]`[⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ`\2", text).replace("ɻ", "ɹ`")
    text = re.sub(r"([s][⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ\2", text)
    return text


def chinese_to_ipa(text: str) -> str:
    """The cjke_cleaners2 Chinese path (reference ``mandarin.py:304-314``)."""
    text = number_to_chinese(text)
    text = chinese_to_bopomofo(text)
    text = latin_to_bopomofo(text)
    text = bopomofo_to_ipa(text)
    return _ipa_glide_apical(text)


def chinese_to_romaji(text: str) -> str:
    text = number_to_chinese(text)
    text = chinese_to_bopomofo(text)
    text = latin_to_bopomofo(text)
    text = bopomofo_to_romaji(text)
    text = re.sub(r"i([aoe])", r"y\1", text)
    text = re.sub(r"u([aoəe])", r"w\1", text)
    text = re.sub(r"([ʦsɹ]`[⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ`\2", text).replace("ɻ", "ɹ`")
    text = re.sub(r"([ʦs][⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ\2", text)
    return text


_ROMAJI_TO_LAZY_IPA = [(re.compile(p, re.IGNORECASE), r) for p, r in [
    ("ʃy", "ʃ"), ("ʧʰy", "ʧʰ"), ("ʧ⁼y", "ʧ⁼"), ("NN", "n"), ("Ng", "ŋ"),
    ("y", "j"), ("h", "x"),
]]


def chinese_to_lazy_ipa(text: str) -> str:
    text = chinese_to_romaji(text)
    for regex, replacement in _ROMAJI_TO_LAZY_IPA:
        text = re.sub(regex, replacement, text)
    return text


def pinyin_to_ipa(pinyin_text: str) -> str:
    """Dependency-free entry point: tone-numbered pinyin → cjke_cleaners2 IPA.

    ``"ni3 hao3"`` → ``"ni↓↑xɑʊ↓↑"``-style output, matching what
    ``chinese_to_ipa`` produces for the corresponding hanzi.
    """
    sylls = [pinyin_syllable_to_bopomofo(s) for s in pinyin_text.split()]
    bopo = "".join(sylls)
    return _ipa_glide_apical(bopomofo_to_ipa(bopo))
