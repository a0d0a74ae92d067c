"""Thai text normalization.

The reference ships only compiled bytecode for this module (strings show
``num_thai`` number conversion plus latin→thai-letter-name tables).  This is a
self-contained rebuild of both.
"""

from __future__ import annotations

import re

_THAI_DIGITS = ["ศูนย์", "หนึ่ง", "สอง", "สาม", "สี่", "ห้า", "หก", "เจ็ด", "แปด", "เก้า"]
_THAI_UNITS = ["", "สิบ", "ร้อย", "พัน", "หมื่น", "แสน", "ล้าน"]


def _int_to_thai(n: int) -> str:
    if n == 0:
        return _THAI_DIGITS[0]
    if n >= 10_000_000:
        return _int_to_thai(n // 1_000_000) + "ล้าน" + (
            _int_to_thai(n % 1_000_000) if n % 1_000_000 else ""
        )
    digits = str(n)
    out = []
    L = len(digits)
    for i, d_ch in enumerate(digits):
        d = int(d_ch)
        pos = L - i - 1
        if d == 0:
            continue
        if pos == 1 and d == 1:
            out.append(_THAI_UNITS[1])  # 1x → สิบ
        elif pos == 1 and d == 2:
            out.append("ยี่" + _THAI_UNITS[1])  # 2x → ยี่สิบ
        elif pos == 0 and d == 1 and L > 1:
            out.append("เอ็ด")  # trailing 1 → เอ็ด
        else:
            out.append(_THAI_DIGITS[d] + _THAI_UNITS[pos])
    return "".join(out)


def num_to_thai(text: str) -> str:
    return re.sub(r"\d+", lambda m: _int_to_thai(int(m.group(0))), text)


_LATIN_TO_THAI = [
    (re.compile(p, re.IGNORECASE), r)
    for p, r in [
        ("a", "เอ"), ("b", "บี"), ("c", "ซี"), ("d", "ดี"), ("e", "อี"),
        ("f", "เอฟ"), ("g", "จี"), ("h", "เอช"), ("i", "ไอ"), ("j", "เจ"),
        ("k", "เค"), ("l", "แอล"), ("m", "เอ็ม"), ("n", "เอ็น"), ("o", "โอ"),
        ("p", "พี"), ("q", "คิว"), ("r", "อาร์"), ("s", "เอส"), ("t", "ที"),
        ("u", "ยู"), ("v", "วี"), ("w", "ดับเบิลยู"), ("x", "เอกซ์"),
        ("y", "วาย"), ("z", "แซด"),
    ]
]


def latin_to_thai(text: str) -> str:
    for regex, replacement in _LATIN_TO_THAI:
        text = re.sub(regex, replacement, text)
    return text
