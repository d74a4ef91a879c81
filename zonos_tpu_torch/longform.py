"""Long-form synthesis: arbitrary-length text through a 30-s-capped model
(the port of zonos_tpu/longform.py; the same segmentation, seed schedule,
carry slicing and prefix-attached decode, over the port's ``Zonos``).

The model is hard-capped at 30 s of audio per generation (ref
model.py:229, CONDITIONING_README.md:62 "The model's maximum is 30
seconds"); the reference handles longer material only via the SRT pipeline
(per-subtitle segmentation, srt_generate.py).  This module makes plain
long text a first-class input:

1. **Sentence segmentation** (host-side, dependency-free): split on
   terminal punctuation with an abbreviation guard; overlong sentences are
   hard-wrapped at word boundaries.
2. **Duration-aware packing**: sentences are greedily packed into segments
   whose estimated duration (phoneme count / speaking_rate — the same
   estimate the SRT rate solver uses, srt_generate.py:394-456) stays under
   ``max_segment_seconds``.
3. **Voice continuity**: each segment is generated with the previous
   segment's last ``carry_frames`` codes as its audio prefix, so prosody
   and timbre flow across the seam (the audio-prefix mechanism the model
   already supports, ref model.py:288-292).
4. **Receptive-field-safe joins**: each segment is DAC-decoded *with* its
   carried prefix codes and the prefix samples are trimmed after decode, so
   every emitted sample has full left context — the same margin discipline
   as `Zonos.stream_generate`.
"""

from __future__ import annotations

import logging
import re
from typing import Sequence

import numpy as np

log = logging.getLogger("zonos_tpu_torch.longform")

# Common abbreviations that end with '.' but do not end a sentence.
_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g",
    "i.e", "cf", "al", "inc", "ltd", "co", "corp", "dept", "fig", "no",
    "vol", "approx",
}

_SENT_END = re.compile(r"([.!?…]+)(\s+|$)")


def split_sentences(text: str) -> list[str]:
    """Rule-based sentence splitter (no deps, language-agnostic fallback).

    Splits after ``.!?…`` followed by whitespace unless the preceding word
    is a known abbreviation, a single initial ("J."), or a number ("3.14"
    never matches — no whitespace).  Text with no terminal punctuation
    comes back as one sentence."""
    sentences = []
    start = 0
    for m in _SENT_END.finditer(text):
        end = m.end()
        word = text[start : m.start()].rsplit(None, 1)[-1] if text[start : m.start()].strip() else ""
        w = word.rstrip(".").lower()
        if m.group(1).startswith(".") and (w in _ABBREV or (len(w) == 1 and w.isalpha())):
            continue  # abbreviation / initial — not a boundary
        s = text[start:end].strip()
        if s:
            sentences.append(s)
        start = end
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


def _wrap_long(sentence: str, max_units: int, count_units) -> list[str]:
    """Hard-wrap a sentence at word boundaries so no piece exceeds
    ``max_units`` (by ``count_units``, e.g. phoneme estimate)."""
    if count_units(sentence) <= max_units:
        return [sentence]
    words = sentence.split()
    pieces, cur = [], []
    for w in words:
        cand = " ".join(cur + [w])
        if cur and count_units(cand) > max_units:
            pieces.append(" ".join(cur))
            cur = [w]
        else:
            cur.append(w)
    if cur:
        pieces.append(" ".join(cur))
    return pieces


def pack_segments(
    sentences: Sequence[str],
    speaking_rate: float = 15.0,
    max_segment_seconds: float = 25.0,
    phoneme_counts: Sequence[int] | None = None,
) -> list[str]:
    """Greedily pack sentences into segments under the duration budget.

    Duration estimate = phonemes / speaking_rate (phonemes default to a
    chars-based proxy of ~0.9 phonemes/char when counts aren't given —
    conservative for en).  Sentences longer than the budget by themselves
    are word-wrapped first."""
    budget = max(max_segment_seconds * speaking_rate, 1.0)  # in phonemes

    if phoneme_counts is not None:
        counts = {s: c for s, c in zip(sentences, phoneme_counts)}
        count = lambda s: counts.get(s, int(len(s) * 0.9))  # noqa: E731
    else:
        count = lambda s: max(int(len(s) * 0.9), 1)  # noqa: E731

    units: list[str] = []
    for s in sentences:
        units.extend(_wrap_long(s, int(budget), count))

    segments, cur, cur_n = [], [], 0
    for s in units:
        n = count(s)
        if cur and cur_n + n > budget:
            segments.append(" ".join(cur))
            cur, cur_n = [], 0
        cur.append(s)
        cur_n += n
    if cur:
        segments.append(" ".join(cur))
    return segments


def segment_texts(
    text: str,
    language: str = "en-us",
    speaking_rate: float = 15.0,
    max_segment_seconds: float = 25.0,
) -> list[str]:
    """Shared long-form prologue: sentences -> phoneme counts -> packed
    duration-budgeted segments (used by both the offline path below and the
    serving layer)."""
    from zonos_tpu_torch.text import phonemize

    sentences = split_sentences(text)
    if not sentences:
        raise ValueError("no text to synthesize")
    ph = phonemize(sentences, [language] * len(sentences))
    return pack_segments(sentences, speaking_rate, max_segment_seconds,
                         phoneme_counts=[len(p) for p in ph])


def synthesize_long(
    model,
    text: str,
    language: str = "en-us",
    speaker=None,
    cond_overrides: dict | None = None,
    sampling_params=None,
    cfg_scale: float = 2.0,
    seed: int = 423,
    max_segment_seconds: float = 25.0,
    carry_frames: int = 43,
    max_new_tokens: int = 86 * 30,
    progress_bar: bool = False,
    on_segment=None,
    initial_prefix_codes: np.ndarray | None = None,
    retries: int = 2,
    step_callback=None,
    generate_fn=None,
    decode_fn=None,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Synthesize arbitrary-length ``text`` -> (waveform float32 [S], per-
    segment codes).  ``cond_overrides`` are extra make_cond_dict kwargs
    (emotion, pitch_std, speaking_rate, ...).  ``on_segment(i, n, wav)`` is
    called after each segment (progress / incremental writing).
    ``step_callback(seg_idx, n_segments, step, max_steps)`` is called per
    decode chunk inside each segment (fine-grained UI progress — the
    step-callback contract of zonos/model.py:430-432 lifted to long-form);
    raise from it to abort the whole synthesis mid-segment (cancel).

    ``generate_fn(cond_dict, prefix_codes, seed, max_new_tokens, callback)
    -> codes [K, T]`` and ``decode_fn(codes [K, T]) -> wav [S]`` override
    the per-segment generation/vocode (defaults: ``model.generate`` /
    ``model.autoencoder.decode``).  The serving layer routes segments
    through its continuous batcher with these hooks, so the SAME seam
    discipline (seed schedule, carry slicing, prefix-attached decode)
    yields bit-identical long-form audio online and offline
    (tests/test_torch_port_server.py).

    Each segment after the first is generated from the previous segment's
    last ``carry_frames`` codes (audio-prefix continuity) and decoded with
    that prefix attached, trimming its samples — joins carry full vocoder
    left-context.  ``initial_prefix_codes`` ([K, P] or [1, K, P]) seeds the
    FIRST segment the same way (user prefix audio / leading silence); like
    `Zonos.generate`, those frames are not part of the output.
    Deterministic in ``seed`` (per-segment fold-in); a segment that
    degenerates to instant EOS is retried up to ``retries`` times with a
    shifted seed before being skipped with a warning."""
    from zonos_tpu_torch.conditioning import make_cond_dict

    overrides = dict(cond_overrides or {})
    rate = float(overrides.get("speaking_rate", 15.0))
    segments = segment_texts(text, language, rate, max_segment_seconds)

    if generate_fn is None:
        def generate_fn(cond, prefix_codes, seg_seed, max_tokens, cb):
            # bucket the phoneme length to 32, as JAX's path does (there, to
            # reuse one compiled program): the server's carry path pads the
            # same way, so both give the same audio
            prefix_cond = model.prepare_conditioning(cond, pad_to_multiple=32)
            return model.generate(
                prefix_cond,
                audio_prefix_codes=None if prefix_codes is None else prefix_codes[None, ...],
                max_new_tokens=max_tokens,
                cfg_scale=cfg_scale,
                batch_size=1,
                sampling_params=sampling_params,
                seed=seg_seed,
                progress_bar=progress_bar,
                callback=cb,
            )[0]  # [K, T_new] — generate strips the carried prefix itself
    if decode_fn is None:
        def decode_fn(dec_in):
            return np.asarray(model.autoencoder.decode(dec_in[None, ...])[0, 0])

    wavs: list[np.ndarray] = []
    all_codes: list[np.ndarray] = []
    carry: np.ndarray | None = None
    if initial_prefix_codes is not None:
        carry = np.asarray(initial_prefix_codes)
        if carry.ndim == 3:
            carry = carry[0]
    for i, seg in enumerate(segments):
        cond = make_cond_dict(text=seg, speaker=speaker, language=language,
                              **overrides)
        cb = None
        if step_callback is not None:
            n_seg = len(segments)
            cb = (lambda i=i, n=n_seg: lambda _frame, step, total:
                  step_callback(i, n, step, total) is not False)()
        for attempt in range(retries + 1):
            codes = np.asarray(generate_fn(
                cond, carry, seed + i + attempt * 7919, max_new_tokens, cb))
            if codes.shape[-1] > 0:
                break
        if codes.shape[-1] == 0:  # degenerate after retries: instant EOS
            log.warning("segment %d/%d produced no audio after %d attempts; "
                        "its text is skipped: %.60s...",
                        i + 1, len(segments), retries + 1, seg)
            carry = None
            continue
        all_codes.append(codes)
        # decode WITH the carried context attached, trim its samples: every
        # emitted sample then has full vocoder left-context
        dec_in = codes if carry is None else np.concatenate([carry, codes], -1)
        prefix_len = dec_in.shape[-1] - codes.shape[-1]
        wav = np.asarray(decode_fn(dec_in))
        hop = wav.shape[-1] // dec_in.shape[-1]  # 512 for the 44.1k codec
        wav = wav[prefix_len * hop:]
        wavs.append(wav)
        if on_segment is not None:
            on_segment(i, len(segments), wav)
        carry = dec_in[:, -min(carry_frames, dec_in.shape[-1]):]
    if not wavs:
        raise RuntimeError("all segments produced no audio")
    return np.concatenate(wavs), all_codes
