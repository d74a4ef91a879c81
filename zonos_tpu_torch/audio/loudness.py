"""ITU-R BS.1770-4 integrated loudness (LUFS) — replaces pyloudnorm.

The reference normalizes decoded audio to a target LUFS with pyloudnorm
(zonos/autoencoder.py:172-186).  This is a self-contained implementation of
the same standard: K-weighting (shelving + high-pass biquads) -> 400 ms
blocks with 75% overlap -> absolute gate at -70 LUFS -> relative gate at
-10 LU below the absolute-gated mean.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def _k_weighting_coeffs(sr: float):
    """BS.1770 stage-1 shelving + stage-2 high-pass biquads for sample rate sr."""
    # Stage 1: high-shelf (pre-filter), spec values defined at 48 kHz,
    # re-derived for sr via the analog prototype (pyloudnorm's method).
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array(
        [(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0, (Vh - Vb * K / Q + K * K) / a0]
    )
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])

    # Stage 2: high-pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + K / Q + K * K
    b_hp = np.array([1.0, -2.0, 1.0]) / a0
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(wav: np.ndarray, sr: int, block_size: float = 0.400) -> float:
    """wav [channels, samples] float -> integrated loudness in LUFS."""
    wav = np.atleast_2d(np.asarray(wav, np.float64))
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    x = lfilter(b2, a2, lfilter(b1, a1, wav, axis=-1), axis=-1)

    T = x.shape[-1]
    step = int(sr * block_size * 0.25)  # 75% overlap
    blk = int(sr * block_size)
    if T < blk or step == 0:
        raise ValueError("audio too short for loudness measurement")
    n_blocks = (T - blk) // step + 1
    idx = np.arange(blk)[None, :] + step * np.arange(n_blocks)[:, None]
    # mean-square energy per block per channel -> summed over channels
    z = np.einsum("cbs->b", x[:, idx] ** 2) / blk  # [n_blocks]
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(z)

    abs_gate = lk > -70.0
    if not abs_gate.any():
        return -np.inf
    z_abs = z[abs_gate].mean()
    rel_thresh = -0.691 + 10.0 * np.log10(z_abs) - 10.0
    rel_gate = abs_gate & (lk > rel_thresh)
    if not rel_gate.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(z[rel_gate].mean()))


def normalize_loudness(wav: np.ndarray, sr: int, target_lufs: float = -19.0) -> np.ndarray:
    """Apply gain so integrated loudness hits target (ref semantics:
    zonos/autoencoder.py:172-186, incl. the short-audio 100 ms block size)."""
    wav = np.asarray(wav, np.float32)
    try:
        block = 0.400 if wav.shape[-1] > 2.0 * sr else 0.100
        loudness = integrated_loudness(wav, sr, block_size=block)
        if not np.isfinite(loudness):
            return wav
        gain = 10.0 ** ((target_lufs - loudness) / 20.0)
        return wav * gain
    except ValueError:
        return wav
