"""Cardinal number-to-words for the built-in G2P's major languages.

The reference reads digits aloud through eSpeak's own per-language number
grammars (zonos/conditioning.py phonemizes raw text; espeak expands "23"
to "veintitrés"/"dreiundzwanzig"/...).  Without espeak, the builtin
pipeline previously expanded every language with ENGLISH words — a
Spanish sentence got "twenty-three" run through Spanish letter rules.
This module supplies native cardinals for es/de/fr/it/pt/ru (the languages
with word-phonology support; ja has its own kanji path in normalize.py).

Coverage: integers up to 999,999,999 plus decimal-comma readings
("1,5" -> "eins Komma fünf").  Deliberate simplifications, documented:
Russian uses nominative forms throughout (espeak does the same), grammatical
gender agreement is fixed to the counting form (один/una/un), and ordinals
stay unexpanded (digit-suffix ordinals are an English orthography).
"""

from __future__ import annotations

import re


# --------------------------------------------------------------------------
# Per-language cardinal spellers
# --------------------------------------------------------------------------


def _es(n: int) -> str:
    if n == 0:
        return "cero"
    units = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
             "siete", "ocho", "nueve", "diez", "once", "doce", "trece",
             "catorce", "quince", "dieciséis", "diecisiete", "dieciocho",
             "diecinueve", "veinte"]
    veinti = ["", "veintiuno", "veintidós", "veintitrés", "veinticuatro",
              "veinticinco", "veintiséis", "veintisiete", "veintiocho",
              "veintinueve"]
    tens = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
    hundreds = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]

    def below_100(n):
        if n <= 20:
            return units[n]
        if n < 30:
            return veinti[n - 20]
        t, u = divmod(n, 10)
        return tens[t] + (f" y {units[u]}" if u else "")

    def below_1000(n):
        if n == 100:
            return "cien"
        h, r = divmod(n, 100)
        parts = [hundreds[h]] if h else []
        if r:
            parts.append(below_100(r))
        return " ".join(parts)

    def apocope(w):  # veintiuno mil -> veintiún mil, treinta y uno -> ... un
        if w.endswith("veintiuno"):
            return w[: -len("veintiuno")] + "veintiún"
        if w.endswith("uno"):
            return w[:-1]
        return w

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        head = "mil" if th == 1 else f"{apocope(below_1000(th))} mil"
        return head + (f" {below_1000(r)}" if r else "")
    m, r = divmod(n, 10**6)
    head = "un millón" if m == 1 else f"{apocope(_es(m))} millones"
    return head + (f" {_es(r)}" if r else "")


def _de(n: int) -> str:
    if n == 0:
        return "null"
    units = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
             "sieben", "acht", "neun", "zehn", "elf", "zwölf", "dreizehn",
             "vierzehn", "fünfzehn", "sechzehn", "siebzehn", "achtzehn",
             "neunzehn"]
    tens = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]

    def ein(u):  # "eins" -> "ein" inside compounds
        return "ein" if u == 1 else units[u]

    def below_100(n):
        if n < 20:
            return units[n]
        t, u = divmod(n, 10)
        return (f"{ein(u)}und{tens[t]}" if u else tens[t])

    def below_1000(n):
        h, r = divmod(n, 100)
        out = f"{ein(h)}hundert" if h else ""
        return out + (below_100(r) if r else "")

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        return f"{below_1000(th) if th > 1 else 'ein'}tausend" + (below_1000(r) if r else "")
    m, r = divmod(n, 10**6)
    head = "eine Million" if m == 1 else f"{_de(m)} Millionen"
    return head + (f" {_de(r)}" if r else "")


def _fr(n: int) -> str:
    units = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
    tens = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante",
            60: "soixante"}

    def below_100(n, final=True):
        if n < 20:
            return units[n]
        if n < 70:
            t, u = divmod(n, 10)
            base = tens[t * 10]
            if u == 1:
                return f"{base} et un"
            return base + (f"-{units[u]}" if u else "")
        if n < 80:  # soixante-dix .. soixante-dix-neuf
            r = n - 60
            return "soixante et onze" if n == 71 else f"soixante-{units[r]}"
        # quatre-vingt(s)
        r = n - 80
        if r == 0:
            return "quatre-vingts" if final else "quatre-vingt"
        return f"quatre-vingt-{units[r]}"

    def below_1000(n, final=True):
        h, r = divmod(n, 100)
        if h == 0:
            return below_100(r, final)
        head = "cent" if h == 1 else f"{units[h]} cent"
        if r == 0:
            return head + ("s" if h > 1 and final else "")
        return f"{head} {below_100(r, final)}"

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        head = "mille" if th == 1 else f"{below_1000(th, final=False)} mille"
        return head + (f" {below_1000(r)}" if r else "")
    m, r = divmod(n, 10**6)
    head = "un million" if m == 1 else f"{_fr(m)} millions"
    return head + (f" {_fr(r)}" if r else "")


def _it(n: int) -> str:
    units = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
             "sette", "otto", "nove", "dieci", "undici", "dodici", "tredici",
             "quattordici", "quindici", "sedici", "diciassette", "diciotto",
             "diciannove"]
    tens = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
            "settanta", "ottanta", "novanta"]

    def below_100(n):
        if n < 20:
            return units[n]
        t, u = divmod(n, 10)
        base = tens[t]
        if u in (1, 8):  # vowel elision: ventuno, ventotto
            base = base[:-1]
        if u == 3:
            return base + "tré"
        return base + (units[u] if u else "")

    def below_1000(n):
        h, r = divmod(n, 100)
        head = ("cento" if h == 1 else units[h] + "cento") if h else ""
        if not r:
            return head
        tail = below_100(r)
        if head and tail.startswith("o"):
            head = head[:-1]  # vowel elision: centotto, centottanta
        return head + tail

    def drop_uno_o(w):  # ventuno + mila -> ventunmila
        return w[:-1] if w.endswith("uno") else w

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        head = "mille" if th == 1 else drop_uno_o(below_1000(th)) + "mila"
        return head + (below_1000(r) if r else "")
    m, r = divmod(n, 10**6)
    head = "un milione" if m == 1 else f"{drop_uno_o(_it(m))} milioni"
    return head + (f" {_it(r)}" if r else "")


def _pt(n: int) -> str:
    units = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
             "sete", "oito", "nove", "dez", "onze", "doze", "treze",
             "catorze", "quinze", "dezasseis", "dezassete", "dezoito",
             "dezanove"]
    tens = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta",
            "setenta", "oitenta", "noventa"]
    hundreds = ["", "cento", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]

    def below_100(n):
        if n < 20:
            return units[n]
        t, u = divmod(n, 10)
        return tens[t] + (f" e {units[u]}" if u else "")

    def below_1000(n):
        if n == 100:
            return "cem"
        h, r = divmod(n, 100)
        parts = [hundreds[h]] if h else []
        if r:
            parts.append(below_100(r))
        return " e ".join(parts)

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        head = "mil" if th == 1 else f"{below_1000(th)} mil"
        if not r:
            return head
        joiner = " e " if (r < 100 or r % 100 == 0) else " "
        return head + joiner + below_1000(r)
    m, r = divmod(n, 10**6)
    head = "um milhão" if m == 1 else f"{_pt(m)} milhões"
    return head + (f" e {_pt(r)}" if r else "")


def _ru(n: int) -> str:
    units = ["ноль", "один", "два", "три", "четыре", "пять", "шесть",
             "семь", "восемь", "девять", "десять", "одиннадцать",
             "двенадцать", "тринадцать", "четырнадцать", "пятнадцать",
             "шестнадцать", "семнадцать", "восемнадцать", "девятнадцать"]
    tens = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят",
            "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
    hundreds = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]

    def plural(n, forms):  # Russian 3-form agreement
        if n % 100 in range(11, 15):
            return forms[2]
        if n % 10 == 1:
            return forms[0]
        if n % 10 in (2, 3, 4):
            return forms[1]
        return forms[2]

    def below_1000(n, fem=False):
        parts = []
        h, r = divmod(n, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                w = units[r]
                if fem and r == 1:
                    w = "одна"
                elif fem and r == 2:
                    w = "две"
                parts.append(w)
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t])
                if u:
                    w = units[u]
                    if fem and u == 1:
                        w = "одна"
                    elif fem and u == 2:
                        w = "две"
                    parts.append(w)
        return " ".join(parts) if parts else units[0]

    if n < 1000:
        return below_1000(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        head = f"{below_1000(th, fem=True)} {plural(th, ('тысяча', 'тысячи', 'тысяч'))}"
        return head + (f" {below_1000(r)}" if r else "")
    m, r = divmod(n, 10**6)
    head = f"{below_1000(m)} {plural(m, ('миллион', 'миллиона', 'миллионов'))}"
    return head + (f" {_ru(r)}" if r else "")


_SPELLERS = {"es": _es, "de": _de, "fr": _fr, "it": _it, "pt": _pt, "ru": _ru}
_DECIMAL_WORD = {"es": "coma", "de": "Komma", "fr": "virgule", "it": "virgola",
                 "pt": "vírgula", "ru": "запятая"}
_DIGIT_WORDS = {
    lang: [sp(i) for i in range(10)] for lang, sp in _SPELLERS.items()
}

# euro amounts ("5 €", "€5", "5,50 €") read as "<cardinal> euro(s)
# [<cardinal> cent-word]" — the regional currency the reference gets from
# espeak's grammars; other currency symbols fall through to the plain
# number reading
_EURO = {"es": ("euro", "euros", "céntimo", "céntimos"),
         "de": ("Euro", "Euro", "Cent", "Cent"),
         "fr": ("euro", "euros", "centime", "centimes"),
         "it": ("euro", "euro", "centesimo", "centesimi"),
         "pt": ("euro", "euros", "cêntimo", "cêntimos"),
         "ru": ("евро", "евро", "цент", "центов")}
# attributive "one" before a noun (Spanish apocope un, German ein)
_ONE_ATTR = {"es": "un", "de": "ein", "fr": "un", "it": "un", "pt": "um",
             "ru": "один"}

# European digit grouping uses dots (1.234.567) and a decimal comma (1,5);
# plain "word, 5" commas must survive, so the decimal comma requires digits
# on BOTH sides with no space
_GROUPED = re.compile(r"\b\d{1,3}(?:\.\d{3})+\b")
# amounts must be complete numbers: 3-decimal figures like "1,599 €" fall
# through to the plain decimal reading instead of being split mid-number
_EURO_RE = re.compile(
    r"(?:€\s*(\d+(?:,\d{1,2})?)(?!\d|,\d)"
    r"|(?<![\d,])(\d+(?:,\d{1,2})?)(?!\d|,\d)\s*€)")
_DECIMAL_COMMA = re.compile(r"(\d+),(\d+)")
_INT = re.compile(r"\d+")


def supported(language: str) -> bool:
    return language.split("-")[0] in _SPELLERS


def number_to_words_i18n(n: int, language: str) -> str:
    lang = language.split("-")[0]
    sp = _SPELLERS[lang]
    if n < 10**9:
        return sp(n)
    # larger magnitudes: read digit by digit (espeak-style fallback)
    return " ".join(_DIGIT_WORDS[lang][int(c)] for c in str(n))


def normalize_numbers_i18n(text: str, language: str) -> str:
    """Expand digits in ``text`` to native cardinal words."""
    lang = language.split("-")[0]
    sp_word = lambda n: number_to_words_i18n(n, lang)
    text = _GROUPED.sub(lambda m: m.group(0).replace(".", ""), text)

    def euro(m: re.Match) -> str:
        amount = m.group(1) or m.group(2)
        unit_one, unit_many, cent_one, cent_many = _EURO[lang]
        whole, _, cents = amount.partition(",")
        n = int(whole)
        head = _ONE_ATTR[lang] if n == 1 else sp_word(n)
        out = f"{head} {unit_one if n == 1 else unit_many}"
        if cents:
            c = int(cents) * (10 if len(cents) == 1 else 1)
            chead = _ONE_ATTR[lang] if c == 1 else sp_word(c)
            out += f" {chead} {cent_one if c == 1 else cent_many}"
        return out

    text = _EURO_RE.sub(euro, text)
    digits = _DIGIT_WORDS[lang]
    text = _DECIMAL_COMMA.sub(
        lambda m: f"{sp_word(int(m.group(1)))} {_DECIMAL_WORD[lang]} "
                  + " ".join(digits[int(c)] for c in m.group(2)),
        text,
    )
    return _INT.sub(lambda m: sp_word(int(m.group(0))), text)
