"""Host-side text frontend: normalization, grapheme-to-phoneme, tokenization.

This subsystem replaces the reference's eSpeak-NG/phonemizer/inflect/sudachipy
dependency stack (zonos/conditioning.py:57-315).  It is pure host
preprocessing — the device only ever sees int32 phoneme-symbol ids.

Backends for G2P, in priority order:
1. eSpeak-NG via the ``phonemizer`` package, when installed (bit-compatible
   with the reference).
2. The built-in native rule engine (C++ core + Python fallback) — a
   deterministic IPA transcriber with an English lexicon+rules and
   phonemic-orthography rules for the other supported languages.
"""

from zonos_tpu_torch.text.symbols import (
    BOS_ID,
    EOS_ID,
    PAD_ID,
    UNK_ID,
    SYMBOL_VOCAB_SIZE,
    get_symbol_ids,
    tokenize_phonemes,
)
from zonos_tpu_torch.text.g2p import phonemize
from zonos_tpu_torch.text.normalize import clean, normalize_numbers

__all__ = [
    "BOS_ID",
    "EOS_ID",
    "PAD_ID",
    "UNK_ID",
    "SYMBOL_VOCAB_SIZE",
    "get_symbol_ids",
    "tokenize_phonemes",
    "phonemize",
    "clean",
    "normalize_numbers",
]
