"""Training dataset: manifests, DAC-code caching, per-example preparation
(zonos_tpu/data/dataset.py); the ingest side of
``zonos_tpu_torch/parallel/train.py``.  Pipeline:

    manifest / LJSpeech dir / wav+txt dir
        -> TrainExample (audio path, text, language, conditioning overrides)
        -> prepare_examples: phonemize text, DAC-encode audio (disk-cached),
           optional per-example speaker embedding, derived speaking_rate
        -> PreparedExample (numpy arrays only — loader-ready)

Design notes:
- DAC encoding is the expensive step (the full conv encoder a clip, K5 on the
  card); codes are cached on disk as `.npy` keyed by the xxh3-64 content hash
  of the audio file under a codec tag, so re-runs and resumed jobs never
  re-encode (the speaker DB's discipline, zonos_tpu_torch/speaker_db.py).
  The tag (``dac44k-torch``) differs from the JAX package's, so one cache
  directory never mixes the two packages' codes unnoticed.
- speaking_rate is derived from the data when not given: phonemes per
  second over the clip's coded duration (frames / 86.13 Hz), capped at the
  conditioner's max of 40 — the same quantity the reference's SRT rate
  solver computes from phoneme count / available seconds
  (srt_generate.py:394-456).
- The speaker embedding for each example is computed from the example's own
  audio (voice-cloning target), through an injectable `speaker_fn` so tests
  and speaker-unconditional runs skip the tower.
"""

from __future__ import annotations

import csv
import json
import logging
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from zonos_tpu_torch.conditioning import LANGUAGE_TO_ID, supported_language_codes
from zonos_tpu_torch.text import phonemize, tokenize_phonemes

logger = logging.getLogger("zonos_tpu_torch.data")

FRAME_RATE = 86.1328125  # 44100 / 512 — ref model.py:229 uses 86


@dataclass
class TrainExample:
    """One utterance: where the audio is, what is said, how it is said."""

    audio: str
    text: str
    language: str = "en-us"
    # Optional conditioning overrides (None -> default / derived):
    speaker_wav: str | None = None  # defaults to `audio` itself
    emotion: Sequence[float] | None = None
    fmax: float | None = None
    pitch_std: float | None = None
    speaking_rate: float | None = None  # derived from data when None
    vqscore_8: Sequence[float] | None = None
    ctc_loss: float | None = None
    dnsmos_ovrl: float | None = None
    speaker_noised: bool | None = None


@dataclass
class PreparedExample:
    """Loader-ready: numpy only, no strings, no file paths."""

    phonemes: np.ndarray  # [T_ph] int32
    codes: np.ndarray  # [K, T_c] int32
    values: dict = field(default_factory=dict)  # name -> np.ndarray [1, dim]
    speaker: np.ndarray | None = None  # [1, 128] float32


# ---------------------------------------------------------------------------
# Manifest readers
# ---------------------------------------------------------------------------


def read_manifest(path: str | Path) -> list[TrainExample]:
    """JSONL manifest: one object per line with at least {"audio", "text"}.

    Recognized optional keys: language, speaker_wav, emotion, fmax,
    pitch_std, speaking_rate, vqscore_8, ctc_loss, dnsmos_ovrl,
    speaker_noised.  Relative audio paths resolve against the manifest's
    directory."""
    path = Path(path)
    base = path.parent
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "audio" not in d or "text" not in d:
                raise ValueError(f"{path}:{ln}: manifest line needs 'audio' and 'text'")
            audio = d.pop("audio")
            if not Path(audio).is_absolute():
                audio = str(base / audio)
            spk = d.pop("speaker_wav", None)
            if spk is not None and not Path(spk).is_absolute():
                spk = str(base / spk)
            known = {k: d[k] for k in (
                "text", "language", "emotion", "fmax", "pitch_std", "speaking_rate",
                "vqscore_8", "ctc_loss", "dnsmos_ovrl", "speaker_noised") if k in d}
            out.append(TrainExample(audio=audio, speaker_wav=spk, **known))
    return out


def scan_ljspeech(root: str | Path, language: str = "en-us") -> list[TrainExample]:
    """LJSpeech layout: ``metadata.csv`` with ``id|raw_text|normalized_text``
    rows and ``wavs/<id>.wav`` clips.  Uses the normalized text column when
    present."""
    root = Path(root)
    meta = root / "metadata.csv"
    if not meta.exists():
        raise FileNotFoundError(f"no metadata.csv under {root}")
    out = []
    with open(meta, newline="") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if not row:
                continue
            clip_id = row[0].strip()
            text = (row[2] if len(row) > 2 and row[2].strip() else row[1]).strip()
            wav = root / "wavs" / f"{clip_id}.wav"
            out.append(TrainExample(audio=str(wav), text=text, language=language))
    return out


def scan_dir(root: str | Path, language: str = "en-us") -> list[TrainExample]:
    """Directory of ``<name>.wav`` + ``<name>.txt`` transcript sidecars."""
    root = Path(root)
    out = []
    for wav in sorted(root.rglob("*.wav")):
        txt = wav.with_suffix(".txt")
        if txt.exists():
            out.append(TrainExample(audio=str(wav), text=txt.read_text().strip(),
                                    language=language))
    return out


# ---------------------------------------------------------------------------
# DAC-code disk cache
# ---------------------------------------------------------------------------


class CodesCache:
    """Encode audio files to DAC codes with a content-addressed disk cache.

    Keys are ``xxh3_64(file bytes)`` (the speaker DB's hash) under a
    ``codec_tag`` namespace so codes from different codec weights never mix
    (random-weight runs vs a real checkpoint, a retrained codec, the JAX
    package's codes).  ``autoencoder``: anything with the port's
    ``DACAutoencoder`` ``preprocess`` and ``encode`` (the card's by default).
    """

    def __init__(self, autoencoder=None, cache_dir: str | Path = ".codes_cache",
                 codec_tag: str = "dac44k-torch"):
        self._dac = autoencoder
        self.cache_dir = Path(cache_dir) / codec_tag
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.encode_calls = 0  # observability / tests

    @property
    def dac(self):
        if self._dac is None:
            from zonos_tpu_torch.models.dac import DACAutoencoder

            self._dac = DACAutoencoder()
        return self._dac

    def _path(self, file_hash: str) -> Path:
        return self.cache_dir / file_hash[:1] / f"{file_hash}.npy"

    def encode_file(self, audio_path: str) -> np.ndarray:
        """-> codes [K, T] int32 (cached)."""
        from zonos_tpu_torch.speaker_db import hash_audio_file

        h = hash_audio_file(audio_path)
        p = self._path(h)
        if p.exists():
            return np.load(p)
        from zonos_tpu_torch.audio.io import load_audio, to_mono

        wav, sr = load_audio(audio_path)
        wav = self.dac.preprocess(to_mono(wav), sr)
        codes = self.dac.encode(wav[None, ...])[0].astype(np.int32)  # [K, T]
        self.encode_calls += 1
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp.npy")
        np.save(tmp, codes)
        tmp.replace(p)  # atomic: concurrent/killed jobs never see partial files
        return codes


# ---------------------------------------------------------------------------
# Preparation: TrainExample -> PreparedExample
# ---------------------------------------------------------------------------

_EMOTION_DEFAULT = np.asarray([[1.0, 0.05, 0.05, 0.05, 0.05, 0.05, 0.1, 0.2]], np.float32)
_DEFAULTS = {
    # renormalized to sum 1, as make_cond_dict does (ref conditioning.py:493-494)
    "emotion": _EMOTION_DEFAULT / _EMOTION_DEFAULT.sum(),
    "fmax": np.asarray([[22050.0]], np.float32),
    "pitch_std": np.asarray([[20.0]], np.float32),
    "vqscore_8": np.asarray([[0.78] * 8], np.float32),
    "ctc_loss": np.asarray([[0.0]], np.float32),
    "dnsmos_ovrl": np.asarray([[4.0]], np.float32),
    "speaker_noised": np.asarray([[0]], np.int32),
}


def prepare_examples(
    examples: Sequence[TrainExample],
    codes_cache: CodesCache,
    speaker_fn: Callable[[str], np.ndarray] | None = None,
    on_error: str = "raise",
    frame_rate: float = FRAME_RATE,
) -> list[PreparedExample]:
    """Phonemize + encode + assemble conditioning values for each example.

    ``speaker_fn(path) -> [1,1,128] or [1,128]`` computes the speaker
    embedding (typically `SpeakerUtils.get_speaker_embedding`, which caches);
    None leaves ``speaker`` unset so the conditioner's learned uncond vector
    is used.  ``on_error="skip"`` drops unreadable files instead of raising
    (batch-job resilience, like the reference's per-file try/except —
    srt_generate.py:61-66)."""
    # Language validation honors on_error too: one bad manifest row must not
    # abort a run the caller asked to continue past bad rows.
    kept: list[tuple[TrainExample, str]] = []
    for e in examples:
        lang = e.language.lower().replace("_", "-")
        if lang not in supported_language_codes:
            if on_error == "skip":
                continue
            raise ValueError(f"unsupported language {e.language!r} for {e.audio}")
        kept.append((e, lang))
    # Phonemize in one host batch per language (espeak startup amortized).
    # The builtin frontend raises ValueError for uncoverable rows (mislabeled
    # script, 'cmn' without pypinyin, ...) — with on_error="skip" one bad row
    # must not abort the batch, so fall back to per-row phonemization and
    # drop only the rows that raise.
    texts = [e.text for e, _ in kept]
    langs = [lang for _, lang in kept]
    try:
        phoneme_strs = phonemize(texts, langs)
    except ValueError:
        if on_error != "skip":
            raise
        kept2: list[tuple[TrainExample, str]] = []
        phoneme_strs = []
        for (e, lang) in kept:
            try:
                phoneme_strs.append(phonemize([e.text], [lang])[0])
                kept2.append((e, lang))
            except ValueError:
                logger.warning("skipping %s: phonemization failed", e.audio)
        kept = kept2

    out: list[PreparedExample] = []
    for (ex, lang), ph in zip(kept, phoneme_strs):
        try:
            codes = codes_cache.encode_file(ex.audio)
            ids, _ = tokenize_phonemes([ph])
            ids = ids[0].astype(np.int32)  # [T_ph], no padding at B=1
            speaker = None
            if speaker_fn is not None:
                speaker = np.asarray(
                    speaker_fn(ex.speaker_wav or ex.audio), np.float32
                ).reshape(1, -1)
        except Exception:
            if on_error == "skip":
                continue
            raise

        dur_s = codes.shape[-1] / frame_rate
        rate = (ex.speaking_rate if ex.speaking_rate is not None
                else estimate_speaking_rate(len(ids), dur_s))
        values = {
            "speaking_rate": np.asarray([[rate]], np.float32),
            "language_id": np.asarray([[LANGUAGE_TO_ID[lang]]], np.int32),
        }
        for name in ("emotion", "fmax", "pitch_std", "vqscore_8", "ctc_loss",
                     "dnsmos_ovrl", "speaker_noised"):
            v = getattr(ex, name)
            if v is None:
                values[name] = _DEFAULTS[name]
            else:
                arr = np.asarray(v, _DEFAULTS[name].dtype).reshape(1, -1)
                if name == "emotion":
                    arr = arr / arr.sum(axis=-1, keepdims=True)
                values[name] = arr
        out.append(PreparedExample(phonemes=ids, codes=codes, values=values,
                                   speaker=speaker))
    return out


def total_audio_seconds(prepared: Sequence[PreparedExample]) -> float:
    return float(sum(p.codes.shape[-1] for p in prepared)) / FRAME_RATE


def estimate_speaking_rate(n_phonemes: int, seconds: float) -> float:
    """Phonemes/second, capped at the conditioner max (ref srt solver cap 40,
    srt_generate.py:394-456)."""
    return min(n_phonemes / max(seconds, 1e-6), 40.0)


def frames_for_seconds(seconds: float) -> int:
    return int(math.ceil(seconds * FRAME_RATE))
