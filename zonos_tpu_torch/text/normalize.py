"""Text cleaning before G2P.

Behavior parity with the reference pipeline (zonos/conditioning.py:74-209):
English-style number/currency/ordinal expansion for most languages, and a
Japanese path (NFKC + digit->kanji + tokenizer readings) that uses sudachipy
when installed and a self-contained fallback otherwise.
"""

from __future__ import annotations

import re
import unicodedata

from zonos_tpu_torch.text.numbers_en import (
    number_to_words,
    number_to_words_grouped,
    ordinal_to_words,
)

_COMMA_NUMBER = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL = re.compile(r"[0-9]+(st|nd|rd|th)")
_NUMBER = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    parts = m.group(1).split(".")
    if len(parts) > 2:
        return m.group(1) + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    dollar_unit = "dollar" if dollars == 1 else "dollars"
    cent_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {dollar_unit}"
    if cents:
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1000 < n < 3000 (matches zonos/conditioning.py:118-130)
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words_grouped(num, group=2, zero="oh")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _COMMA_NUMBER.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS.sub(r"\1 pounds", text)
    text = _DOLLARS.sub(_expand_dollars, text)
    text = _DECIMAL.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ORDINAL.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _NUMBER.sub(_expand_number, text)
    return text


# --- Japanese ---------------------------------------------------------------

_KANJI_DIGITS = "〇一二三四五六七八九"
_KANJI_SCALES = [(10**8, "億"), (10**4, "万"), (10**3, "千"), (10**2, "百"), (10, "十")]


def number_to_kanji(n: int) -> str:
    """Minimal kanji numeral speller (fallback for the `kanjize` dependency)."""
    if n == 0:
        return "零"
    out = []
    for scale, name in _KANJI_SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            if scale >= 10**4:
                out.append(number_to_kanji(q) + name)
            else:
                out.append(("" if q == 1 else _KANJI_DIGITS[q]) + name)
    if n:
        out.append(_KANJI_DIGITS[n])
    return "".join(out)


def _sudachi_tokenizer():
    try:
        from sudachipy import Dictionary, SplitMode  # type: ignore

        tok = Dictionary(dict="full").create()
        return lambda text: " ".join(m.reading_form() for m in tok.tokenize(text, SplitMode.A))
    except Exception:
        return None


_SUDACHI = None
_SUDACHI_TRIED = False


def normalize_jp_text(text: str) -> str:
    global _SUDACHI, _SUDACHI_TRIED
    text = unicodedata.normalize("NFKC", text)
    text = re.sub(r"\d+", lambda m: number_to_kanji(int(m.group(0))), text)
    if not _SUDACHI_TRIED:
        _SUDACHI = _sudachi_tokenizer()
        _SUDACHI_TRIED = True
    if _SUDACHI is not None:
        return _SUDACHI(text)
    return text  # fallback: leave readings to the G2P stage


def clean(texts: list[str], languages: list[str]) -> list[str]:
    out = []
    for text, language in zip(texts, languages):
        lang = language.split("-")[0]
        if lang == "ja":
            out.append(normalize_jp_text(text))
        elif lang in ("cmn", "zh", "yue", "hak"):
            # digits may be pinyin tone marks (ni3 hao3); leave them for the
            # zh converter, which strips tones per syllable (text/scripts.py)
            out.append(text)
        else:
            from zonos_tpu_torch.text.numbers_i18n import (
                normalize_numbers_i18n,
                supported,
            )

            if supported(language):
                # native cardinals (espeak parity: "23" -> "veintitrés",
                # not English "twenty-three" through Spanish letter rules)
                out.append(normalize_numbers_i18n(text, language))
            else:
                out.append(normalize_numbers(text))
    return out
