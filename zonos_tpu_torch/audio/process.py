"""Waveform post-processing: silence trimming and click-free fades.

Semantics match the reference post-chain (zonos/autoencoder.py:49-90,
233-241): energy-threshold edge trimming limited to 16 frames or 1/4 of the
audio, a linear 512-sample fade-in, and a logarithmic fade-out over at most
20 x 512 samples (or 1/4 of the audio).
"""

from __future__ import annotations

import numpy as np


def trim_silence(wav: np.ndarray, threshold: float = 1e-5, frame_size: int = 512) -> np.ndarray:
    """wav [1, samples] -> trimmed wav (leading/trailing low-energy frames cut)."""
    assert wav.ndim == 2 and wav.shape[0] == 1, "expected mono [1, samples]"
    T = wav.shape[1]
    num_frames = min((T // frame_size) // 4, 16)

    start = 0
    for i in range(num_frames):
        frame = wav[:, i * frame_size : (i + 1) * frame_size]
        if (frame**2).mean() > threshold:
            start = i * frame_size
            break

    # Trailing scan starts at i=1: the reference's i=0 slice wav[:, -512:0]
    # is empty (NaN energy, never matches), so the final frame is never
    # tested and speech running to the very end is kept
    # (zonos/autoencoder.py:80-85).  Like the reference, a loud frame found
    # at i>=1 is itself cut (end = start of that frame) — asymmetric with
    # the leading scan, but that is the parity contract.
    end = T
    for i in range(1, num_frames):
        frame = wav[:, -((i + 1) * frame_size) : -(i * frame_size)]
        if (frame**2).mean() > threshold:
            end = T - (i + 1) * frame_size
            break

    if start > 0 or end < T:
        return wav[:, start:end]
    return wav


def fade_in_out(wav: np.ndarray, blocksize: int = 512, max_blocks: int = 20) -> np.ndarray:
    """Linear fade-in over one block; log fade-out (1 -> 1e-10) over up to
    ``max_blocks`` blocks, capped at 1/4 of the audio."""
    wav = np.array(wav, np.float32, copy=True)
    T = wav.shape[-1]
    n = min(blocksize, T)
    wav[..., :n] *= np.linspace(0.0, 1.0, n, dtype=np.float32)
    num_blocks = min((T // blocksize) // 4, max_blocks)
    if num_blocks > 0:
        m = num_blocks * blocksize
        wav[..., -m:] *= np.logspace(0, -10, m, dtype=np.float32)
    return wav
