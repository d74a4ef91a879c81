"""WAV read/write and resampling with scipy + stdlib.

WAV via scipy.io.wavfile (int16/int32/float32 handled), polyphase resampling
via scipy.signal.resample_poly (a windowed-sinc kernel).  The JAX package's
native C++ resampler is not carried over: scipy is the reference it matches.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Returns (wav [channels, samples] float32 in [-1,1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 1:
        wav = wav[None, :]
    else:
        wav = wav.T  # [channels, samples]
    return wav, int(sr)


def save_audio(path: str, wav: np.ndarray, sr: int) -> None:
    """wav [channels, samples] or [samples] float in [-1,1] -> 16-bit WAV."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.T  # [samples, channels]
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if sr_from == sr_to:
        return np.asarray(wav, np.float32)
    g = math.gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    return resample_poly(np.asarray(wav, np.float64), up, down, axis=-1).astype(np.float32)


def to_mono(wav: np.ndarray) -> np.ndarray:
    """[channels, samples] -> [1, samples] by channel average."""
    if wav.ndim == 1:
        return wav[None, :]
    return wav.mean(axis=0, keepdims=True)
