"""Log-mel filterbank frontend for the speaker tower, on the host in numpy
(a copy of zonos_tpu/models/speaker/mel.py, so both packages give the same
features).

Parity target: torchaudio MelSpectrogram(16000, n_fft=512, win=400, hop=160,
n_mels=80) + log(x+1e-6) + per-mel mean subtraction over time
(ref: zonos/speaker_cloning.py:12-34).  torchaudio defaults reproduced here:
hann window, center=True with reflect padding, power=2 magnitude, HTK mel
scale, no filterbank normalization.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Triangular HTK-scale filterbank [n_mels, n_fft//2+1] (torchaudio-compatible)."""
    fmax = fmax or sr / 2
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fb = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.clip(np.minimum(up, down), 0, None)
    return fb.astype(np.float32)


def log_mel_features(
    wav: np.ndarray,
    sr: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> np.ndarray:
    """wav [B, T] -> mean-normalized log-mel [B, n_mels, frames]."""
    wav = np.atleast_2d(np.asarray(wav, np.float32))
    pad = n_fft // 2
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    # frame
    n_frames = 1 + (x.shape[1] - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[:, idx]  # [B, frames, n_fft]
    # torchaudio pads the window to n_fft (centered)
    wpad = np.zeros(n_fft, np.float32)
    start = (n_fft - win_length) // 2
    wpad[start : start + win_length] = window
    spec = np.abs(np.fft.rfft(frames * wpad, axis=-1)) ** 2  # power
    fb = mel_filterbank(sr, n_fft, n_mels)
    mel = np.einsum("btf,mf->bmt", spec, fb)
    logmel = np.log(mel + 1e-6)
    return (logmel - logmel.mean(axis=2, keepdims=True)).astype(np.float32)
