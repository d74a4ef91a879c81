"""Phoneme symbol table and tokenizer.

The id space must match the reference exactly so that real checkpoints'
phoneme embedding tables line up: 4 special ids, then punctuation, ASCII
letters, and IPA characters in the reference's enumeration order
(zonos/conditioning.py:146-156).
"""

from __future__ import annotations

import warnings

import numpy as np

PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
_NUM_SPECIAL = 4

PUNCTUATION = ';:,.!?¡¿—…"«»“”() *~-/\\&'
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
IPA_LETTERS = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)

SYMBOLS = [*PUNCTUATION, *LETTERS, *IPA_LETTERS]
SYMBOL_TO_ID = {s: i + _NUM_SPECIAL for i, s in enumerate(SYMBOLS)}
SYMBOL_VOCAB_SIZE = _NUM_SPECIAL + len(SYMBOLS)

_warned: set[str] = set()


def get_symbol_ids(text: str) -> list[int]:
    """Map each character of an IPA string to its symbol id (UNK if unmapped)."""
    ids = []
    for ch in text:
        sid = SYMBOL_TO_ID.get(ch)
        if sid is None:
            if ch not in _warned:
                _warned.add(ch)
                warnings.warn(f"phoneme symbol {ch!r} not in table; mapping to UNK", stacklevel=2)
            sid = UNK_ID
        ids.append(sid)
    return ids


def tokenize_phonemes(phoneme_strings: list[str]) -> tuple[np.ndarray, list[int]]:
    """BOS + ids + EOS per string, left-padded with PAD to the batch max.

    Left padding (matching zonos/conditioning.py:186-191) keeps the end of the
    phoneme prefix adjacent to the audio tokens that follow it.
    Returns ``(ids [B, T_max] int32, lengths)``.
    """
    seqs = [[BOS_ID, *get_symbol_ids(s), EOS_ID] for s in phoneme_strings]
    lengths = [len(s) for s in seqs]
    longest = max(lengths)
    out = np.full((len(seqs), longest), PAD_ID, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, longest - len(s) :] = s
    return out, lengths
