"""English number verbalization (self-contained replacement for `inflect`).

Covers the behaviors the reference frontend relies on
(zonos/conditioning.py:74-140): cardinal words, ordinals, year-style
grouping for 1000<n<3000, currency, and decimals.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + (f"-{_ONES[ones]}" if ones else "")


def number_to_words(n: int, andword: str = "") -> str:
    """Spell a non-negative integer. ``andword`` inserted before the final
    sub-hundred group when non-empty (e.g. ``"and"`` for British style)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 100:
        return _below_hundred(n)
    parts: list[str] = []
    rem = n
    for scale, name in _SCALES:
        if rem >= scale:
            parts.append(number_to_words(rem // scale) + " " + name)
            rem %= scale
    if rem:
        if andword:
            parts.append(andword + " " + _below_hundred(rem))
        else:
            parts.append(_below_hundred(rem))
    return " ".join(parts)


def number_to_words_grouped(n: int, group: int = 2, zero: str = "oh") -> str:
    """Digit-group reading, e.g. 1984 -> "nineteen eighty-four" (group=2)."""
    s = str(n)
    if len(s) % group:
        s = s.zfill(len(s) + group - len(s) % group)
    words = []
    for i in range(0, len(s), group):
        chunk = int(s[i : i + group])
        if chunk == 0:
            words.append(" ".join([zero] * group))
        elif s[i] == "0" and group == 2:
            words.append(zero + " " + _ONES[chunk])
        else:
            words.append(_below_hundred(chunk) if group == 2 else number_to_words(chunk))
    return " ".join(words)


def ordinal_to_words(n: int) -> str:
    """Spell an ordinal: 21 -> "twenty-first"."""
    words = number_to_words(n)
    head, sep, last = words.rpartition("-")
    if not sep:
        head, sep, last = words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        tail = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        tail = last[:-1] + "ieth"
    elif last == "hundred" or last in ("thousand", "million", "billion", "trillion"):
        tail = last + "th"
    else:
        tail = last + "th"
    return head + sep + tail if sep else tail
