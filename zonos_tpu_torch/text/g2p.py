"""Grapheme-to-phoneme conversion (IPA out).

Capability replacement for the reference's eSpeak-NG pipeline
(zonos/conditioning.py:212-292): same public surface —
``phonemize(texts, languages) -> list[str]`` with punctuation preserved,
stress marks, and the ``:phonemize(grapheme)/IPA/`` manual-override syntax —
but with a dependency-free built-in engine so the framework runs on machines
without the eSpeak C library.  When the ``phonemizer`` package + espeak-ng
are installed they are used instead (bit-compatibility with the reference).

The built-in engine:
- **English** ("en" family): exception lexicon + ordered context-sensitive
  letter-to-sound rules (see ``g2p_rules_en``), ARPABET -> IPA.
- **Phonemic-orthography languages** (es, de, it, fr, pt, ...): per-language
  digraph/grapheme -> IPA tables.
- **Fallback**: identity over letters (the model's symbol table includes the
  ASCII alphabet, so unknown languages degrade to grapheme conditioning).
"""

from __future__ import annotations

import functools
import logging
import re

from zonos_tpu_torch.text import g2p_rules_en as EN
from zonos_tpu_torch.text.normalize import clean

logger = logging.getLogger("zonos_tpu_torch.text.g2p")

_PHONEMIZE_ESCAPE = re.compile(r"(:phonemize(?:\((.*?)\))?/([^/]+)/)")
# any Unicode letters (accented Latin included) plus apostrophes — an
# ASCII-only class split "días" at the í and leaked raw accents downstream
_WORD_RE = re.compile(r"[^\W\d_]+(?:'[^\W\d_]+)*")


# ---------------------------------------------------------------------------
# Built-in English engine
# ---------------------------------------------------------------------------


def _match_context(pattern: str, text: str, start: int, forward: bool) -> bool:
    """Match a context pattern outward from ``start`` (exclusive)."""
    i = start
    step = 1 if forward else -1
    atoms = pattern if forward else pattern[::-1]
    for atom in atoms:
        ch = text[i] if 0 <= i < len(text) else " "
        if atom == "#":
            if ch not in EN.VOWELS:
                return False
            while 0 <= i + step < len(text) and text[i + step] in EN.VOWELS:
                i += step
        elif atom == "^":
            if not ch.isalpha() or ch in EN.VOWELS:
                return False
        elif atom == ":":
            while 0 <= i < len(text) and text[i].isalpha() and text[i] not in EN.VOWELS:
                i += step
            i -= step  # consumed zero-or-more; compensate the loop's step
        elif atom == ".":
            if ch not in EN.VOICED_CONS:
                return False
        elif atom == "@":
            if not any(
                text[max(0, i - len(c) + 1) : i + 1] == c if not forward else text[i : i + len(c)] == c
                for c in EN.LONG_U_CONS
            ):
                return False
        elif atom == " ":
            if ch.isalpha():
                return False
        else:
            if ch != atom:
                return False
        i += step
    return True


def _rules_for_letter() -> dict[str, list[tuple[str, str, str, str]]]:
    table: dict[str, list] = {}
    for rule in EN.RULES:
        table.setdefault(rule[0][0], []).append(rule)
    return table


_RULE_TABLE = _rules_for_letter()


def _apply_rules_en(word: str) -> list[str]:
    """Letter-to-sound pass over one lowercase word -> ARPABET tokens.

    Uses the native C++ rule engine (csrc/g2p_engine.cpp) when built; the
    Python matcher below is the identical-behavior fallback.
    """
    from zonos_tpu_torch.text.native import get_engine

    native = get_engine()
    if native is not None:
        return native(word).split()
    phones: list[str] = []
    i = 0
    while i < len(word):
        ch = word[i]
        matched = False
        for grapheme, left, right, out in _RULE_TABLE.get(ch, ()):  # ordered
            if word[i : i + len(grapheme)] != grapheme:
                continue
            if left and not _match_context(left, word, i - 1, forward=False):
                continue
            if right and not _match_context(right, word, i + len(grapheme), forward=True):
                continue
            if out:
                phones.extend(out.split())
            i += len(grapheme)
            matched = True
            break
        if not matched:
            i += 1  # unmappable character: drop
    return phones


def _strip_stress(token: str) -> tuple[str, str]:
    if token and token[-1] in "012":
        return token[:-1], token[-1]
    return token, ""


def _arpa_to_ipa(tokens: list[str], default_stress_first: bool = False) -> str:
    """Convert ARPABET tokens to an IPA string with espeak-style stress marks."""
    out: list[str] = []
    syllable_starts: list[int] = []  # index in `out` where each vowel's syllable starts
    stresses: list[str] = []
    last_boundary = 0
    for tok in tokens:
        base, stress = _strip_stress(tok)
        if base in EN.ARPA_VOWELS:
            ipa = EN.ARPA_TO_IPA.get(tok if stress == "0" and tok in EN.ARPA_TO_IPA else base, "")
            syllable_starts.append(last_boundary)
            stresses.append(stress)
            out.append(ipa)
            last_boundary = len(out)
        else:
            ipa = EN.ARPA_TO_IPA.get(base, "")
            out.append(ipa)
    # choose stressed syllable
    mark_at = None
    for idx, s in enumerate(stresses):
        if s == "1":
            mark_at = syllable_starts[idx]
            break
    if mark_at is None and default_stress_first and syllable_starts:
        mark_at = syllable_starts[0]
    if mark_at is not None and len(syllable_starts) > 1:
        out.insert(mark_at, "ˈ")
    return "".join(out)


def _lex(lw: str) -> list[str] | None:
    """Lexicon lookup: curated core first, then the frequency supplement."""
    if lw in EN.LEXICON:
        return EN.LEXICON[lw].split()
    from zonos_tpu_torch.text.lexicon_en import SUPPLEMENT

    if lw in SUPPLEMENT:
        return SUPPLEMENT[lw].split()
    return None


_SIBILANTS = ("S", "Z", "SH", "ZH", "CH", "JH")
_VOICELESS = ("P", "T", "K", "F", "TH")


def _add_s(stem: list[str]) -> list[str]:
    """Regular plural / 3rd-person -s with English voicing assimilation."""
    base, _ = _strip_stress(stem[-1])
    if base in _SIBILANTS:
        return stem + ["AH0", "Z"]
    if base in _VOICELESS:
        return stem + ["S"]
    return stem + ["Z"]


def _add_d(stem: list[str]) -> list[str]:
    """Regular past -ed with voicing assimilation."""
    base, _ = _strip_stress(stem[-1])
    if base in ("T", "D"):
        return stem + ["AH0", "D"]
    if base in ("P", "K", "F", "TH", "S", "SH", "CH"):
        return stem + ["T"]
    return stem + ["D"]


def _stem_candidates(lw: str, n: int) -> list[str]:
    """Orthographic stems for a suffix of length ``n``: plain strip, silent-e
    restore (mak+ing -> make), and doubled-consonant undo (stopp+ed -> stop)."""
    s = lw[:-n]
    cands = [s, s + "e"]
    if len(s) >= 2 and s[-1] == s[-2] and s[-1] not in "aeiou":
        cands.append(s[:-1])
    return cands


def _english_morphology(lw: str) -> list[str] | None:
    """Derive OOV words from lexicon stems: plural/past/progressive (with
    silent-e / consonant-doubling / y->i stem recovery and voicing
    assimilation), comparatives, and common derivational suffixes.  Mirrors
    the coverage eSpeak-NG's en_rules gets from its suffix machinery."""
    stem = _lex(lw)
    if stem:
        return stem
    # y -> i inflections first (cities, tried, happily, happiness)
    if lw.endswith("ies") and (stem := _lex(lw[:-3] + "y")):
        return _add_s(stem)
    if lw.endswith("ied") and (stem := _lex(lw[:-3] + "y")):
        return _add_d(stem)
    if lw.endswith("ily") and (stem := _lex(lw[:-3] + "y")):
        if _strip_stress(stem[-1])[0] == "IY":
            stem = stem[:-1] + ["AH0"]
        return stem + ["L", "IY0"]
    if lw.endswith("iness") and (stem := _lex(lw[:-5] + "y")):
        return stem + ["N", "AH0", "S"]
    if lw.endswith("es"):
        # silent-e stems drop only the 's' (uses -> use); checked first so
        # "uses" doesn't resolve to "us" + es (mirrors the -ed ordering)
        for c in [lw[:-1]] + _stem_candidates(lw, 2):
            if (stem := _lex(c)) is not None:
                return _add_s(stem)
    if lw.endswith("s") and not lw.endswith("ss"):
        if (stem := _lex(lw[:-1])) is not None:
            return _add_s(stem)
    if lw.endswith("ed"):
        # silent-e stems drop only the 'd' (used -> use); checked first so
        # "used" doesn't resolve to "us" + ed
        for c in [lw[:-1]] + _stem_candidates(lw, 2):
            if (stem := _lex(c)) is not None:
                return _add_d(stem)
    if lw.endswith("ing"):
        for c in _stem_candidates(lw, 3):
            if (stem := _lex(c)) is not None:
                return stem + ["IH0", "NG"]
    for suffix, extra in (
        ("ly", ["L", "IY0"]),
        ("ness", ["N", "AH0", "S"]),
        ("ment", ["M", "AH0", "N", "T"]),
        ("ful", ["F", "AH0", "L"]),
        ("less", ["L", "AH0", "S"]),
        ("er", ["ER0"]),
        ("est", ["AH0", "S", "T"]),
    ):
        if lw.endswith(suffix):
            for c in _stem_candidates(lw, len(suffix)):
                if (stem := _lex(c)) is not None:
                    return stem + extra
    return None


# Latinate suffixes carry predictable stress the plain letter rules cannot
# place: the suffix phones below are attached to the rule-derived stem, and
# ``stress_prev`` suffixes stress the stem's LAST vowel (penultimate-stress
# family: -ic, -ity, -ical, ...).
_LATINATE = (
    ("ation", ["EY1", "SH", "AH0", "N"], False),
    ("ician", ["IH1", "SH", "AH0", "N"], False),
    ("ition", ["IH1", "SH", "AH0", "N"], False),
    ("ology", ["AA1", "L", "AH0", "JH", "IY0"], False),
    ("ography", ["AA1", "G", "R", "AH0", "F", "IY0"], False),
    ("icity", ["IH1", "S", "AH0", "T", "IY0"], False),
    ("ical", ["IH0", "K", "AH0", "L"], True),
    ("ity", ["IH0", "T", "IY0"], True),
    ("ic", ["IH0", "K"], True),
)


def _english_latinate(lw: str) -> list[str] | None:
    for suffix, phones, stress_prev in _LATINATE:
        if not lw.endswith(suffix) or len(lw) - len(suffix) < 2:
            continue
        stem_arpa = _apply_rules_en(lw[: -len(suffix)])
        if stress_prev:
            for i in range(len(stem_arpa) - 1, -1, -1):
                if _strip_stress(stem_arpa[i])[0] in EN.ARPA_VOWELS:
                    stem_arpa[i] = _strip_stress(stem_arpa[i])[0] + "1"
                    break
        return stem_arpa + phones
    return None


@functools.lru_cache(maxsize=65536)
def _english_word_to_ipa(word: str) -> str:
    lw = word.lower()
    arpa = _english_morphology(lw)
    if arpa is not None:
        return _arpa_to_ipa(arpa)
    arpa = _english_latinate(lw)
    if arpa is not None:
        return _arpa_to_ipa(arpa)
    return _arpa_to_ipa(_apply_rules_en(lw), default_stress_first=True)


# ---------------------------------------------------------------------------
# Phonemic-orthography languages
# ---------------------------------------------------------------------------

# Ordered (grapheme, ipa) maps; longest-first matching.
_PHONEMIC_TABLES: dict[str, list[tuple[str, str]]] = {
    "es": [
        ("ch", "ʧ"), ("ll", "ʎ"), ("rr", "r"), ("qu", "k"), ("gue", "ɡe"),
        ("gui", "ɡi"), ("ñ", "ɲ"), ("j", "x"), ("z", "θ"),
        # Castilian c before front vowels is θ; the i of -cia- is a glide
        ("cia", "θja"), ("cie", "θje"), ("cio", "θjo"), ("ci", "θi"),
        ("ce", "θe"),
        # g before front vowels is the velar fricative (gente -> xente)
        ("ge", "xe"), ("gi", "xi"), ("gé", "xˈe"), ("gí", "xˈi"),
        # rising diphthongs (bueno -> bweno, tierra -> tjera)
        ("ue", "we"), ("ua", "wa"), ("ui", "wi"), ("ie", "je"),
        ("v", "b"),
        ("c", "k"), ("h", ""), ("y", "ʝ"), ("g", "ɡ"), ("a", "a"), ("e", "e"),
        ("i", "i"), ("o", "o"), ("u", "u"), ("ü", "u"), ("á", "ˈa"),
        ("é", "ˈe"), ("í", "ˈi"), ("ó", "ˈo"), ("ú", "ˈu"),
    ],
    "de": [
        ("sch", "ʃ"), ("tsch", "ʧ"), ("ch", "ç"), ("ei", "aɪ"), ("ie", "iː"),
        ("eu", "ɔʏ"), ("äu", "ɔʏ"), ("au", "aʊ"),
        # st/sp are ʃt/ʃp word-initially ONLY (_word_pre injects the ʃ;
        # ist/Fenster keep plain st — the old blanket rule said ɪʃt)
        ("ß", "s"), ("w", "v"), ("v", "f"), ("z", "ts"), ("ẑ", "z"), ("j", "j"),
        ("ä", "ɛ"), ("ö", "ø"), ("ü", "y"), ("g", "ɡ"), ("a", "a"),
        ("e", "ɛ"), ("i", "ɪ"), ("o", "ɔ"), ("u", "ʊ"), ("qu", "kv"),
        # identity entries for the CLOSED long vowels _word_pre injects
        # (h-lengthening) — without them the table's lax single-letter
        # rules would re-map the injected quality (geːt -> ɡɛːt)
        ("aː", "aː"), ("eː", "eː"), ("iː", "iː"), ("oː", "oː"),
        ("uː", "uː"), ("ɛː", "ɛː"), ("øː", "øː"), ("yː", "yː"),
    ],
    "it": [
        # ci/gi/gli/sci before a vowel: the i is a silent palatal marker
        # (giorno -> dʒorno, grazie -> ttsje), kept as /i/ only when it
        # carries the syllable (vicino -> vitʃino)
        ("glia", "ʎa"), ("glie", "ʎe"), ("glio", "ʎo"), ("gliu", "ʎu"),
        ("gli", "ʎ"), ("gn", "ɲ"),
        ("scia", "ʃa"), ("scie", "ʃe"), ("scio", "ʃo"), ("sciu", "ʃu"),
        ("sci", "ʃi"), ("sce", "ʃe"), ("ch", "k"), ("gh", "ɡ"),
        ("cia", "ʧa"), ("cio", "ʧo"), ("ciu", "ʧu"), ("ci", "ʧi"),
        ("ce", "ʧe"),
        ("gia", "ʤa"), ("gio", "ʤo"), ("giu", "ʤu"), ("gi", "ʤi"),
        ("ge", "ʤe"),
        # z is the affricate ts; zz geminates (pizza -> pittsa); the
        # intervocalic -zi- geminate (grazie -> ɡrattsje) is a _word_pre
        # rewrite so word-initial zio/zia stay plain
        ("zz", "tts"), ("z", "ts"),
        # uo: falling diphthong (buono -> bwɔno)
        ("uo", "wɔ"), ("qu", "kw"), ("ss", "s"), ("ẕ", "z"),
        ("g", "ɡ"), ("c", "k"), ("h", ""),
        ("a", "a"), ("e", "e"), ("i", "i"),
        ("o", "o"), ("u", "u"), ("à", "ˈa"), ("è", "ˈɛ"), ("é", "ˈe"),
        ("ì", "ˈi"), ("ò", "ˈɔ"), ("ù", "ˈu"),
    ],
    # nasal vowels arrive pre-rewritten by _word_pre as vowel + combining
    # tilde (what espeak emits; the tilde maps to UNK at tokenization — the
    # same ids the reference pipeline produces, conditioning.py:146-156 has
    # no tilde either); the tilde passes through the table via its identity
    # entry
    "fr": [
        ("eau", "o"), ("ou", "u"), ("oi", "wa"), ("ch", "ʃ"), ("gn", "ɲ"),
        ("ai", "ɛ"), ("ei", "ɛ"), ("au", "o"), ("eu", "ø"), ("é", "e"), ("è", "ɛ"),
        ("ê", "ɛ"), ("à", "a"), ("â", "ɑ"), ("î", "i"), ("ï", "i"),
        ("ô", "o"), ("û", "y"), ("ù", "y"), ("œ", "œ"), ("ç", "s"),
        ("ll", "l"), ("tt", "t"), ("ss", "s"), ("mm", "m"), ("nn", "n"),
        ("pp", "p"), ("rr", "r"), ("j", "ʒ"), ("g", "ɡ"), ("u", "y"),
        ("e", "ə"), ("a", "a"), ("i", "i"), ("o", "ɔ"), ("qu", "k"),
        ("c", "k"), ("h", ""), ("̃", "̃"),
    ],
    "pt": [
        ("ch", "ʃ"), ("lh", "ʎ"), ("nh", "ɲ"), ("ão", "ɐw"), ("õe", "ojn"),
        ("ã", "ɐn"), ("õ", "on"), ("qu", "k"), ("ç", "s"), ("j", "ʒ"),
        ("x", "ʃ"), ("ce", "se"), ("ci", "si"), ("c", "k"), ("ss", "s"),
        ("g", "ɡ"), ("á", "ˈa"), ("é", "ˈɛ"), ("ê", "ˈe"),
        ("í", "ˈi"), ("ó", "ˈɔ"), ("ô", "ˈo"), ("ú", "ˈu"), ("â", "ˈɐ"),
        ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
    ],
    # ---- tier-2 languages (r4 verdict #4): the proven table + word-
    # phonology recipe applied to nl/pl/tr/cs/ro.  Transcription convention
    # follows the published dictionary standard per language (Wiktionary
    # notation — e.g. the Polish retroflex series ʂ/ʐ/tʂ, Czech ɦ and
    # lax ɪ), cross-validated word-by-word in
    # tests/fixtures/dictionary_ipa.json.
    "nl": [
        # long-vowel digraphs and diphthongs first
        ("sch", "sx"), ("ch", "x"), ("ng", "ŋ"), ("nj", "ɲ"),
        ("aai", "aːj"), ("ooi", "oːj"), ("oei", "uj"), ("tj", "tʲ"),
        ("ij", "ɛi"), ("ei", "ɛi"), ("ui", "œy"), ("ou", "ʌu"), ("au", "ʌu"),
        ("oe", "u"), ("eu", "øː"), ("ie", "i"),
        ("aa", "aː"), ("ee", "eː"), ("oo", "oː"), ("uu", "yː"), ("nk", "ŋk"),
        ("g", "ɣ"), ("w", "ʋ"), ("v", "v"), ("z", "z"), ("j", "j"),
        ("y", "i"), ("c", "k"), ("qu", "kʋ"),
        ("a", "ɑ"), ("e", "ɛ"), ("i", "ɪ"), ("o", "ɔ"), ("u", "ʏ"),
        ("é", "eː"), ("ë", "ə"),
    ],
    "pl": [
        # palatal series: C+i before a vowel is the soft consonant alone
        ("szcz", "ʂtʂ"), ("sz", "ʂ"), ("cz", "tʂ"), ("rz", "ʐ"), ("ż", "ʐ"),
        ("dż", "dʐ"), ("dzia", "dʑa"), ("dzie", "dʑɛ"), ("dzio", "dʑɔ"),
        ("dziu", "dʑu"), ("dzi", "dʑi"), ("dź", "dʑ"), ("dz", "dz"),
        ("sia", "ɕa"), ("sie", "ɕɛ"), ("sio", "ɕɔ"), ("siu", "ɕu"),
        ("si", "ɕi"), ("ś", "ɕ"),
        ("zia", "ʑa"), ("zie", "ʑɛ"), ("zio", "ʑɔ"), ("ziu", "ʑu"),
        ("zi", "ʑi"), ("ź", "ʑ"),
        ("cia", "tɕa"), ("cie", "tɕɛ"), ("cio", "tɕɔ"), ("ciu", "tɕu"),
        ("ci", "tɕi"), ("ć", "tɕ"),
        ("nia", "ɲa"), ("nie", "ɲɛ"), ("nio", "ɲɔ"), ("niu", "ɲu"),
        ("ni", "ɲi"), ("ń", "ɲ"),
        ("ch", "x"), ("h", "x"), ("w", "v"), ("ł", "w"), ("c", "ts"),
        ("g", "ɡ"), ("j", "j"), ("y", "ɨ"), ("ó", "u"), ("ą", "ɔ̃"), ("ę", "ɛ̃"),
        ("e", "ɛ"), ("o", "ɔ"), ("a", "a"), ("i", "i"), ("u", "u"),
        ("̃", "̃"),
    ],
    "tr": [
        # k/g palatalize next to front vowels (Wiktionary c/ɟ); ĸ is the
        # _word_pre marker for a syllable-final palatalized k (orthographic
        # c is the affricate, so the IPA c must be injected indirectly)
        ("ğ", "ː"), ("ç", "tʃ"), ("ş", "ʃ"), ("c", "dʒ"), ("ĸ", "c"),
        ("j", "ʒ"),
        ("y", "j"), ("ı", "ɯ"), ("ö", "ø"), ("ü", "y"),
        ("ge", "ɟe"), ("gi", "ɟi"), ("gö", "ɟø"), ("gü", "ɟy"),
        ("ke", "ce"), ("ki", "ci"), ("kö", "cø"), ("kü", "cy"),
        ("g", "ɡ"), ("r", "ɾ"),
        ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
        ("â", "aː"), ("î", "iː"), ("û", "uː"),
    ],
    "cs": [
        ("ch", "x"), ("č", "tʃ"), ("š", "ʃ"), ("ž", "ʒ"), ("c", "ts"),
        ("g", "ɡ"), ("h", "ɦ"), ("j", "j"),
        # ě palatalizes the preceding dental; mě is mɲɛ
        ("dě", "ɟɛ"), ("tě", "cɛ"), ("ně", "ɲɛ"), ("mě", "mɲɛ"), ("ě", "jɛ"),
        ("di", "ɟɪ"), ("ti", "cɪ"), ("ni", "ɲɪ"),
        ("dí", "ɟiː"), ("tí", "ciː"), ("ní", "ɲiː"),
        ("ď", "ɟ"), ("ť", "c"), ("ň", "ɲ"),
        ("i", "ɪ"), ("y", "ɪ"), ("í", "iː"), ("ý", "iː"),
        ("e", "ɛ"), ("é", "ɛː"), ("á", "aː"), ("ó", "oː"), ("ú", "uː"),
        ("ů", "uː"), ("a", "a"), ("o", "o"), ("u", "u"), ("w", "v"),
    ],
    "fi": [
        # Finnish is near-1:1: doubled letters are length (vowels and
        # consonants both); a is back ɑ, ä/ö front æ/ø (Wiktionary notation)
        ("aa", "ɑː"), ("ee", "eː"), ("ii", "iː"), ("oo", "oː"),
        ("uu", "uː"), ("yy", "yː"), ("ää", "æː"), ("öö", "øː"),
        ("kk", "kː"), ("pp", "pː"), ("tt", "tː"), ("ll", "lː"),
        ("mm", "mː"), ("nn", "nː"), ("rr", "rː"), ("ss", "sː"),
        ("hh", "hː"), ("dd", "dː"), ("gg", "ɡː"), ("bb", "bː"),
        ("ff", "fː"), ("vv", "ʋː"), ("jj", "jː"),
        ("nkk", "ŋkː"), ("nk", "ŋk"), ("ng", "ŋː"),
        ("a", "ɑ"), ("ä", "æ"), ("ö", "ø"), ("y", "y"), ("v", "ʋ"),
        ("j", "j"), ("g", "ɡ"), ("w", "ʋ"), ("c", "k"), ("å", "oː"),
        ("x", "ks"),
    ],
    "hu": [
        # digraph geminates first, then digraphs, then letter geminates
        ("ccs", "tʃː"), ("ssz", "sː"), ("zzs", "ʒː"), ("tty", "cː"),
        ("ggy", "ɟː"), ("nny", "ɲː"), ("lly", "jː"),
        ("dzs", "dʒ"), ("dz", "dz"),
        ("cs", "tʃ"), ("sz", "s"), ("zs", "ʒ"), ("gy", "ɟ"), ("ty", "c"),
        ("ny", "ɲ"), ("ly", "j"),
        ("bb", "bː"), ("cc", "tsː"), ("dd", "dː"), ("ff", "fː"),
        ("gg", "ɡː"), ("kk", "kː"), ("ll", "lː"), ("mm", "mː"),
        ("nn", "nː"), ("pp", "pː"), ("rr", "rː"), ("ss", "ʃː"),
        ("tt", "tː"), ("vv", "vː"), ("zz", "zː"),
        ("s", "ʃ"), ("c", "ts"), ("g", "ɡ"), ("j", "j"), ("w", "v"),
        ("a", "ɒ"), ("á", "aː"), ("e", "ɛ"), ("é", "eː"), ("i", "i"),
        ("í", "iː"), ("o", "o"), ("ó", "oː"), ("ö", "ø"), ("ő", "øː"),
        ("u", "u"), ("ú", "uː"), ("ü", "y"), ("ű", "yː"), ("y", "i"),
    ],
    "ro": [
        ("ă", "ə"), ("â", "ɨ"), ("î", "ɨ"), ("ș", "ʃ"), ("ş", "ʃ"),
        ("ț", "ts"), ("ţ", "ts"), ("j", "ʒ"),
        ("che", "ke"), ("chi", "ki"), ("ghe", "ɡe"), ("ghi", "ɡi"),
        ("ce", "tʃe"), ("ci", "tʃi"), ("ge", "dʒe"), ("gi", "dʒi"),
        ("c", "k"), ("g", "ɡ"), ("h", "h"),
        ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
        # ĵ: _word_pre marker for final asyllabic -i after a vowel
        # (orthographic j is ʒ, so the glide must be injected indirectly)
        ("ʲ", "ʲ"), ("w", "w"), ("ĵ", "j"),
    ],
}


# Word-level exceptions for languages whose orthography is only mostly
# phonemic.  French needs them most: silent final letters and irregular
# function words dominate everyday text.
_WORD_LEXICONS: dict[str, dict[str, str]] = {
    "fr": {
        "est": "ɛ", "et": "e", "es": "ɛ", "aux": "o", "eux": "ø",
        "les": "le", "des": "de", "mes": "me", "tes": "te", "ses": "se",
        "un": "œ̃", "une": "yn", "je": "ʒə", "vous": "vu", "nous": "nu",
        "ils": "il", "elles": "ɛl", "tout": "tu", "tous": "tus",
        "pas": "pa", "plaît": "plɛ", "monsieur": "məsjø", "oui": "wi",
        "temps": "tɑ̃", "beaucoup": "boku", "deux": "dø", "trois": "tʁwa",
        "en": "ɑ̃", "on": "ɔ̃", "dans": "dɑ̃", "sans": "sɑ̃", "bien": "bjɛ̃",
        "très": "tʁɛ", "avec": "avɛk", "chez": "ʃe", "mais": "mɛ",
        # number words whose final consonants defy the silent-final rules
        "vingt": "vɛ̃", "cinq": "sɛ̃k", "six": "sis", "dix": "dis",
        "sept": "sɛt", "huit": "ɥit", "neuf": "nœf", "vingts": "vɛ̃",
        "an": "ɑ̃", "ans": "ɑ̃",
    },
    # function words where espeak's output departs from the letter tables
    # (closed-syllable vowel quality, vocalized final r)
    "de": {
        "dem": "dem", "den": "den", "der": "dɛə", "des": "dɛs",
        "dir": "diə", "mir": "miə", "wir": "viə", "er": "ɛə",
        "ihr": "iə", "für": "fyə", "nur": "nuə", "vor": "foə",
        "guten": "ɡutən", "ein": "aɪn", "eine": "aɪnə",
    },
    "pt": {
        "por": "pur", "como": "komu", "com": "kon", "um": "un",
        "uma": "umɐ", "de": "dɨ", "do": "du", "da": "dɐ",
        "os": "uʃ", "o": "u", "e": "i", "é": "ɛ",
    },
    # Dutch function words with reduced/irregular vowels the letter tables
    # cannot derive (het/een reduce; ik/is keep lax vowels before the
    # open-syllable lengthening rule would apply)
    "nl": {
        "het": "ət", "een": "ən", "de": "də", "je": "jə", "ik": "ɪk",
        "is": "ɪs", "en": "ɛn", "hoe": "hu", "wat": "ʋɑt", "dat": "dɑt",
        "niet": "nit", "met": "mɛt", "er": "ər", "ook": "oːk",
        # compound-linking / open-syllable e is schwa or eː by lexeme, not
        # spelling — pin the common greetings and the language name
        "goedemorgen": "ɣudəmɔrɣən", "goedemiddag": "ɣudəmɪdɑx",
        "goedenavond": "ɣudənaːvɔnt", "nederlands": "neːdərlɑnts",
        "nederland": "neːdərlɑnt",
    },
    "ro": {
        # word-initial e- is iotated in the copula/pronoun family only
        "este": "jeste", "e": "je", "el": "jel", "ei": "jej", "ele": "jele",
        "eu": "jew", "ești": "jeʃtʲ",
    },
    "cs": {
        # 'v' / 'k' prepositions vocalize with the following word; alone
        # they surface as plain consonants
        "v": "f", "k": "k", "s": "s", "z": "z",
    },
}
_FR_SILENT_FINALS = "estdxzp"
_FR_NASAL_MAP = {
    "oin": "wɛ̃", "ain": "ɛ̃", "ein": "ɛ̃", "ien": "jɛ̃",
    "on": "ɔ̃", "om": "ɔ̃", "an": "ɑ̃", "am": "ɑ̃", "en": "ɑ̃", "em": "ɑ̃",
    "in": "ɛ̃", "im": "ɛ̃", "un": "œ̃", "yn": "ɛ̃",
}


def _word_pre(word: str, lang: str) -> str:
    """Orthographic word-level adjustments before the grapheme table.

    The rewrites may inject IPA characters directly (ə, ŋ, ʃ, ɨ, ...):
    ``_phonemic_word_to_ipa`` passes unmatched alphabetic characters
    through verbatim, so injected phones survive the table pass."""
    if lang == "fr" and len(word) > 2:
        # soften c/g before front vowels FIRST (the conditioning e may be
        # stripped as silent below): merci -> mersi, mange -> mɑ̃ʒ
        word = re.sub(r"c(?=[eiyéèê])", "s", word)
        word = re.sub(r"g(?=[eiéèê])", "ʒ", word)
        if word.endswith("es") and len(word) > 3:
            word = word[:-2]  # -es plural: both letters silent
        elif word.endswith("er") and len(word) > 3:
            word = word[:-2] + "é"  # -er infinitives/nouns: /e/ (parler);
            # é, not e — a plain e would be re-stripped as silent below
        elif word[-1] in _FR_SILENT_FINALS and word[-1] != word[-2]:
            word = word[:-1]
        if word and word[-1] == "e" and len(word) > 2:
            word = word[:-1]  # silent final e (after a first strip: -tes etc.)
        # nasal vowels (espeak style, combining tilde) when the n/m closes
        # the syllable — not before a vowel or another nasal (bonne, animal)
        word = re.sub(
            r"(oin|ain|ein|ien|on|om|an|am|en|em|in|im|un|yn)"
            r"(?=[bcdfɡgjklpqrstvwxzʒʃs]|$)",
            lambda m: _FR_NASAL_MAP[m.group(1)], word)
        # closed final syllable: e before a pronounced final consonant
        # cluster is open-mid (belle -> bɛl, mer -> mɛr)
        word = re.sub(r"e(?=[bdfklmnprstvzʒʃ]{1,2}$)", "ɛ", word)
    if lang == "de":
        # -chen diminutive keeps ç regardless of the preceding letter
        if len(word) > 4 and word.endswith("chen"):
            word = word[:-4] + "çən"
        # st/sp -> ʃt/ʃp word-initially only (Stein -> ʃtaɪn, ist -> ɪst)
        word = re.sub(r"^s(?=[tp])", "ʃ", word)
        # s voices to z before a vowel word-initially and between vowels
        # (Sohn -> zoːn, Rose -> roːzə) — via the ẑ marker, since
        # orthographic z is the affricate ts; coda/cluster s stays voiceless
        word = re.sub(r"^s(?=[aeiouäöüy])", "ẑ", word)
        word = re.sub(r"(?<=[aeiouäöüy])s(?=[aeiouäöüy])", "ẑ", word)
        # lengthening h: silent, and the vowel takes its CLOSED long
        # quality (geht -> ɡeːt, not the table's lax ɛ; Sohn -> zoːn)
        _DE_LONG = {"a": "aː", "e": "eː", "i": "iː", "o": "oː", "u": "uː",
                    "ä": "ɛː", "ö": "øː", "ü": "yː", "y": "yː"}
        word = re.sub(r"([aeiouäöüy])h(?=[^aeiouäöü]|$)",
                      lambda m: _DE_LONG[m.group(1)], word)
        # degeminate double consonants (Wetter -> vɛtə, not vɛttɛr)
        word = re.sub(r"([bcdfgklmnprstv])\1", r"\1", word)
        # velar nasal: -ng is ŋ (Zeitung), not n+ɡ
        word = word.replace("ng", "ŋ")
        # unstressed endings reduce to schwa; word-final -er/-r vocalize
        if len(word) > 3:
            for suf, rep in (("en", "ən"), ("er", "ə"), ("el", "əl"),
                             ("e", "ə")):
                if word.endswith(suf):
                    word = word[: -len(suf)] + rep
                    break
        # final obstruent devoicing (liegt -> likt, Tag -> tak)
        word = re.sub(r"b(?=[st]?$)", "p", word)
        word = re.sub(r"d(?=[st]?$)", "t", word)
        word = re.sub(r"(?<!ŋ)g(?=[st]?$)", "k", word)
    if lang == "es":
        # intervocalic lenition (espeak es house style): b/d/g between a
        # vowel and a vowel/liquid soften to β/ð/ɣ (todo -> toðo, negro ->
        # neɣɾo); word-initial stops stay stops
        word = re.sub(r"(?<=[aeiouáéíóú])b(?=[aeiouáéíóúrl])", "β", word)
        word = re.sub(r"(?<=[aeiouáéíóú])d(?=[aeiouáéíóúrl])", "ð", word)
        # intervocalic gu+e/i: lenite AND consume the silent u (seguir ->
        # seɣir) so the table's gue/gui rules aren't needed there
        word = re.sub(r"(?<=[aeiouáéíóú])gu(?=[eiéí])", "ɣ", word)
        word = re.sub(r"(?<=[aeiouáéíóú])g(?=[aoáóúrl]|u(?![eiéí]))", "ɣ", word)
    if lang == "it":
        # intervocalic -zi- + vowel geminates (grazie -> ɡrattsje, azione ->
        # attsjone — espeak's raddoppiamento context); word-initial zio/zia
        # keep the plain affricate via the z table entry
        word = re.sub(r"(?<=[aeiou])zi(?=[aeou])", "ttsj", word)
        # intervocalic single s voices to z (casa -> kaza); ss stays /s/
        # via its own table entry.  The marker ẕ avoids the table's
        # orthographic z -> ts affricate rule
        word = re.sub(r"(?<=[aeiou])s(?=[aeiou])", "ẕ", word)
    if lang == "pt":
        # European Portuguese reductions (espeak 'pt' is pt-PT):
        # coda s -> ʃ (estás -> ...taʃ), final unstressed o -> u, e -> ɨ;
        # initial es- -> ɨʃ
        if len(word) > 2:
            if word.endswith("o"):
                word = word[:-1] + "u"
            elif word.endswith("os"):
                word = word[:-2] + "us"
            elif word.endswith("e"):
                word = word[:-1] + "ɨ"
            elif word.endswith("es"):
                word = word[:-2] + "ɨs"
        word = re.sub(r"s(?=[^aeiouáéêíóôúâãõ]|$)", "ʃ", word)
        word = re.sub(r"^e(?=ʃ)", "ɨ", word)
    if lang == "nl" and len(word) > 2:
        # final obstruent devoicing (goed -> ɣut, dag -> dax via ch)
        word = re.sub(r"b$", "p", word)
        word = re.sub(r"d(?=s?$)", "t", word)
        word = re.sub(r"g$", "ch", word)
        # unstressed endings reduce to schwa — only after a consonant
        # (weer/been keep their long-vowel digraph)
        for suf, rep in (("en", "ən"), ("er", "ər"), ("el", "əl"),
                         ("es", "əs"), ("e", "ə")):
            if (word.endswith(suf) and len(word) > len(suf) + 1
                    and word[-len(suf) - 1] not in "aeiou"):
                word = word[: -len(suf)] + rep
                break
        # open-syllable lengthening for a/o/u (single V + single C + V);
        # e stays out — unstressed e is schwa, which spelling cannot tell
        word = re.sub(r"([aou])(?=[bcdfghjklmnpqrstvwxz][aeiouyəɪ])", r"\1\1", word)
        # degeminate double consonants AFTER lengthening, so the fake open
        # syllable a degeminate creates cannot lengthen (alles -> ɑləs)
        word = re.sub(r"([bdfgklmnprst])\1", r"\1", word)
    if lang == "pl" and len(word) > 1:
        # nasal vowels: denasalize word-finally (ę) and assimilate to a
        # following stop's place (dziękuję -> dʑɛŋkujɛ, piękna -> pjɛŋkna);
        # the rewrites inject orthographic e/o so the palatal digraph rules
        # (sie/dzie/...) still see their conditioning vowel
        word = re.sub(r"ę$", "e", word)
        word = re.sub(r"ę(?=[pb])", "em", word)
        word = re.sub(r"ą(?=[pb])", "om", word)
        word = re.sub(r"ę(?=[td]|c(?![zi])|dz(?!i))", "en", word)
        word = re.sub(r"ą(?=[td]|c(?![zi])|dz(?!i))", "on", word)
        word = re.sub(r"ę(?=[kg])", "eŋ", word)
        word = re.sub(r"ą(?=[kg])", "oŋ", word)
        # i after a labial/velar before a vowel is the glide j
        word = re.sub(r"(?<=[bpfvmwkg])i(?=[aeouyęą])", "j", word)
        # w devoices next to voiceless obstruents (wszystko -> fʂɨstkɔ)
        word = re.sub(r"w(?=[pt]|k(?!u)|[sc][zi]?|ś|ć|f|x|ch)", "f", word)
        word = re.sub(r"(?<=[ptks])w", "f", word)
        # final obstruent devoicing
        word = re.sub(r"b$", "p", word)
        word = re.sub(r"d$", "t", word)
        word = re.sub(r"g$", "k", word)
        word = re.sub(r"(?<![rcsd])z$", "s", word)
        word = re.sub(r"ż$", "ʂ", word)
        word = re.sub(r"rz$", "ʂ", word)
        word = re.sub(r"w$", "f", word)
    if lang == "tr":
        # syllable-final k after a front vowel (possibly across r)
        # palatalizes (Türkçe -> tyɾctʃe) — via the ĸ marker (orthographic
        # c is the affricate); a geminate kk keeps its first half plain
        # (teşekkür -> teʃekcyɾ, Wiktionary /te.ʃekˈcyɾ/)
        word = re.sub(r"(?<=[eiöü])k(?=[^aeıioöuük]|$)", "ĸ", word)
        word = re.sub(r"(?<=[eiöü]r)k(?=[^aeıioöuük]|$)", "ĸ", word)
        # dark (velarized) l in back-vowel contexts
        word = re.sub(r"l(?=[aıou])", "ɫ", word)
        word = re.sub(r"(?<=[aıou])l(?=[^aeıioöuü]|$)", "ɫ", word)
    if lang == "cs" and len(word) > 1:
        # v assimilates to voiceless before voiceless obstruents
        # (všechno -> fʃɛxno)
        word = re.sub(r"v(?=[sšcčktp])", "f", word)
        # final obstruent devoicing
        word = re.sub(r"b$", "p", word)
        word = re.sub(r"d$", "t", word)
        word = re.sub(r"g$", "k", word)
        word = re.sub(r"z$", "s", word)
        word = re.sub(r"ž$", "š", word)
        word = re.sub(r"v$", "f", word)
        word = re.sub(r"h$", "ch", word)
    if lang == "ro" and len(word) > 2:
        # u between vowels is the glide w (ziua -> ziwa)
        word = re.sub(r"(?<=[aeiouăâî])u(?=[aeiouăâî])", "w", word)
        # word-final -i: asyllabic — a glide after a vowel (mai -> maĵ -> j;
        # orthographic j is ʒ, hence the marker), a palatalization of the
        # final consonant otherwise (faci -> fatʃʲ); the soft c/g spell out
        # first so the table's ci/gi rules don't see a bare consonant
        word = re.sub(r"(?<=[aeou])i$", "ĵ", word)
        word = re.sub(r"ci$", "tʃʲ", word)
        word = re.sub(r"gi$", "dʒʲ", word)
        word = re.sub(r"(?<=[bdfhklmnpqrsştțvzșț])i$", "ʲ", word)
    return word


def _phonemic_word_to_ipa(word: str, table: list[tuple[str, str]]) -> str:
    table_sorted = sorted(table, key=lambda kv: -len(kv[0]))
    out = []
    i = 0
    lw = word.lower()
    while i < len(lw):
        for g, ipa in table_sorted:
            if lw.startswith(g, i):
                out.append(ipa)
                i += len(g)
                break
        else:
            ch = lw[i]
            out.append(ch if ch.isalpha() else "")
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


@functools.cache
def _espeak_backend(language: str):
    """Return a phonemizer EspeakBackend, or None if unavailable.

    Honors ``PHONEMIZER_ESPEAK_LIBRARY`` (an explicit libespeak-ng path, the
    same escape hatch the reference documents for macOS installs —
    zonos/conditioning.py:71-72)."""
    try:
        import os

        lib = os.environ.get("PHONEMIZER_ESPEAK_LIBRARY")
        if lib:
            from phonemizer.backend.espeak.wrapper import EspeakWrapper  # type: ignore

            EspeakWrapper.set_library(lib)
        from phonemizer.backend import EspeakBackend  # type: ignore

        from zonos_tpu_torch.text.symbols import PUNCTUATION

        return EspeakBackend(
            language,
            preserve_punctuation=True,
            with_stress=True,
            language_switch="remove-flags",
            punctuation_marks=PUNCTUATION,
        )
    except Exception:
        return None


def _builtin_phonemize_segment(text: str, language: str) -> str:
    """Phonemize one free-text segment, preserving punctuation/spacing."""
    from zonos_tpu_torch.text.scripts import convert_script, guard_unmapped

    lang = language.split("-")[0]

    converted = convert_script(text, language)
    if converted is not None:
        out = guard_unmapped(converted, text, language)
        return re.sub(r"\s+", " ", out).strip()

    def repl(m: re.Match) -> str:
        word = m.group(0)
        if lang == "en":
            return _english_word_to_ipa(word)
        lex = _WORD_LEXICONS.get(lang)
        if lex is not None and word.lower() in lex:
            return lex[word.lower()]
        table = _PHONEMIC_TABLES.get(lang)
        if table is not None:
            return _phonemic_word_to_ipa(_word_pre(word.lower(), lang), table)
        return word  # grapheme fallback: letters are in the symbol table

    out = guard_unmapped(_WORD_RE.sub(repl, text), text, language)
    return re.sub(r"\s+", " ", out).strip()


def phonemize(texts: list[str], languages: list[str]) -> list[str]:
    """Text -> IPA phoneme strings (ref surface: zonos/conditioning.py:233-292).

    Handles the ``:phonemize(grapheme)/IPA/`` and ``:phonemize/IPA/`` manual
    escape syntaxes: the IPA payload passes through verbatim.
    """
    texts = clean(texts, languages)
    results = []
    for text, language in zip(texts, languages):
        segments = _PHONEMIZE_ESCAPE.split(text)
        parts: list[str] = []
        i = 0
        while i < len(segments):
            seg = segments[i]
            if seg and seg.startswith(":phonemize"):
                ipa = segments[i + 2]
                parts.append(ipa)
                i += 3
            elif seg:
                backend = _espeak_backend(language)
                if backend is not None:
                    parts.append(backend.phonemize([seg], strip=True)[0])
                else:
                    parts.append(_builtin_phonemize_segment(seg, language))
                i += 1
            else:
                i += 1
        results.append("".join(parts))
    return results
