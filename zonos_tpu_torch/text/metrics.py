"""Phoneme error rate (PER) between IPA strings (the port of
zonos_tpu/text/metrics.py).

Quantifies the built-in G2P engine against the espeak golden fixtures
(tests/fixtures/espeak_golden.json, numbers in docs/TEXT_FRONTEND.md).
"""

from __future__ import annotations

# Pure-notation equivalences folded before comparison, so PER measures
# phonological disagreement rather than transcription style: rhotic symbol
# choice, affricate ligature vs digraph, ASCII-vs-IPA g, and length/stress
# marks (which espeak emits inconsistently across versions).  The syllabic
# mark (U+0329) is not folded: the engine never emits syllabicity, so
# folding it would hide a real disagreement.
_FOLD = str.maketrans({
    "ɹ": "r", "ɾ": "r", "ʁ": "r", "ɐ": "ə", "g": "ɡ", "ʋ": "v",
    "ˈ": None, "ˌ": None, "ː": None, "ˑ": None, "̃": None, "͡": None,
    "̯": None,  # non-syllabic diphthong diacritic (uo̯): notation only
    ".": None, " ": None, "\t": None, "\n": None,
})
_LIGATURES = [("ʧ", "tʃ"), ("ʤ", "dʒ"), ("ʦ", "ts"), ("ʣ", "dz")]
_PUNCT = set(";:,.!?¡¿—…\"«»“”() *~-/\\&'")


def normalize_ipa(s: str) -> str:
    for lig, digraph in _LIGATURES:
        s = s.replace(lig, digraph)
    s = s.translate(_FOLD)
    return "".join(ch for ch in s if ch not in _PUNCT)


def _edit_row(a: str, b: str, free_start: bool) -> list[int]:
    """The last row of the edit-distance table of ``a`` against ``b``;
    with ``free_start`` skipping a prefix of ``b`` costs nothing."""
    prev = [0] * (len(b) + 1) if free_start else list(range(len(b) + 1))
    for i, ac in enumerate(a, 1):
        cur = [i]
        for j, bc in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ac != bc)))
        prev = cur
    return prev


def phoneme_error_rate(hyp: str, ref: str) -> float:
    """Levenshtein distance over normalized IPA characters / len(ref)."""
    h, r = normalize_ipa(hyp), normalize_ipa(ref)
    if not r:
        return 0.0 if not h else 1.0
    return _edit_row(r, h, free_start=False)[-1] / len(r)


def substring_per(needle: str, haystack: str) -> float:
    """Best (lowest) edit distance of ``needle`` against any substring of
    ``haystack``, / len(needle): approximate word-in-sentence agreement
    (semi-global alignment: haystack characters before and after the match
    are free)."""
    n, h = normalize_ipa(needle), normalize_ipa(haystack)
    if not n:
        return 0.0
    return min(_edit_row(n, h, free_start=True)) / len(n)


def corpus_per(pairs: list[tuple[str, str]]) -> float:
    """Length-weighted corpus PER over (hypothesis, reference) pairs."""
    num = sum(phoneme_error_rate(h, r) * len(normalize_ipa(r)) for h, r in pairs)
    den = sum(len(normalize_ipa(r)) for _, r in pairs)
    return num / max(den, 1)
